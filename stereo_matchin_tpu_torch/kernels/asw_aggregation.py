"""Wrappers of the CUDA aggregation kernels K1 (`asw_den`) and K2
(`asw_pass`) in csrc/asw_aggregation.cu.

They replace the TPU kernels asw_den_dres, asw_vpass_dres and
asw_hpass_dres (stereo_matchin_tpu/kernels/asw_aggregation_dres.py) in
the port's (D, H, W) layout; the disparity offset `d0` (any int >= 0)
covers the TPU package's d-chunked grid kernels as well.  The plain
versions are ops/aggregation.py `asw_den_plain` / `asw_pass_plain`: a CPU
tensor takes them, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import LAUNCHES, check_tensor, raise_on_error, require_cuda
from ._build import library
from ..ops.aggregation import asw_den_plain, asw_pass_plain


@functools.cache
def _lib():
    lib = library()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.asw_den_f32.argtypes = [p, p, p, i, i, i, i, i, f, p]
    lib.asw_den_f32.restype = i
    lib.asw_pass_f32.argtypes = [p, p, p, p, p, i, i, i, i, i, f, i, p]
    lib.asw_pass_f32.restype = i
    return lib


def _check_strips(wl, wr):
    if wl.dim() != 3 or wl.shape[0] % 2 != 1:
        raise ValueError(f"strips must be (T, H, W) with odd T, got "
                         f"{tuple(wl.shape)}")
    check_tensor("wl", wl, wl.shape)
    check_tensor("wr", wr, wl.shape, device=wl.device)


def asw_den(wl: torch.Tensor, wr: torch.Tensor, eps: float, d0: int = 0,
            num_disp: int = 1) -> torch.Tensor:
    """K1: den[d, y, x] = eps + sum_t wl[t, y, x] * wr[t, y, max(x-d0-d, 0)].

    wl, wr: (T, H, W) f32.  Returns (num_disp, H, W) f32."""
    _check_strips(wl, wr)
    if d0 < 0 or num_disp < 1:
        raise ValueError(f"need d0 >= 0 and num_disp >= 1, got {d0}, {num_disp}")
    if wl.device.type == "cpu":
        return asw_den_plain(wl, wr, eps, d0, num_disp)
    require_cuda(wl, wr)
    T, H, W = wl.shape
    out = torch.empty((num_disp, H, W), dtype=torch.float32, device=wl.device)
    with torch.cuda.device(wl.device):
        stream = torch.cuda.current_stream(wl.device).cuda_stream
        rc = _lib().asw_den_f32(wl.data_ptr(), wr.data_ptr(), out.data_ptr(),
                                T, H, W, num_disp, d0, eps, stream)
    raise_on_error(rc, "asw_den")
    LAUNCHES["asw_den"] += 1
    return out


def asw_pass(cost: torch.Tensor, wl: torch.Tensor, wr: torch.Tensor,
             den: torch.Tensor, eps: float, axis: int,
             d0: int = 0) -> torch.Tensor:
    """K2: one aggregation pass over cost (D, H, W); axis 1 = vertical taps,
    2 = horizontal.  den: asw_den of the same strips.  Returns (D, H, W)."""
    _check_strips(wl, wr)
    if axis not in (1, 2):
        raise ValueError(f"axis must be 1 (vertical) or 2 (horizontal), got {axis}")
    if d0 < 0:
        raise ValueError(f"need d0 >= 0, got {d0}")
    if cost.dim() != 3:
        raise ValueError(f"cost must be (D, H, W), got {tuple(cost.shape)}")
    T, H, W = wl.shape
    D = cost.shape[0]
    check_tensor("cost", cost, (D, H, W), device=wl.device)
    check_tensor("den", den, (D, H, W), device=wl.device)
    if cost.device.type == "cpu":
        return asw_pass_plain(cost, wl, wr, den, eps, axis, d0)
    require_cuda(cost, wl, wr, den)
    out = torch.empty_like(cost)
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream(cost.device).cuda_stream
        rc = _lib().asw_pass_f32(cost.data_ptr(), wl.data_ptr(), wr.data_ptr(),
                                 den.data_ptr(), out.data_ptr(), T, H, W, D,
                                 d0, eps, axis, stream)
    raise_on_error(rc, "asw_pass")
    LAUNCHES["asw_pass_v" if axis == 1 else "asw_pass_h"] += 1
    return out
