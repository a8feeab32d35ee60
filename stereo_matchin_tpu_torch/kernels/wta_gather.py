"""Wrappers of the CUDA WTA kernels K3 (`two_min`) and K4 (`wta_diag`) in
csrc/wta_gather.cu.

They replace two_min_pallas and wta_diag_pallas
(stereo_matchin_tpu/kernels/wta_gather.py).  K4 reads the epipolar
diagonal straight from the (D, H, W) volume, so the TPU package's sheared
copy (build_diag) and its pads have no counterpart.  The plain versions
are ops/wta_fast.py `_two_min_plain` / `_diag_two_min_plain`: a CPU
tensor takes them, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import LAUNCHES, check_tensor, raise_on_error, require_cuda
from ._build import library
from ..ops.wta_fast import _diag_two_min_plain, _two_min_plain


@functools.cache
def _lib():
    lib = library()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.two_min_f32.argtypes = [p, p, p, p, p, p, i, i, i, f, p]
    lib.two_min_f32.restype = i
    lib.wta_diag_f32.argtypes = [p, p, p, p, p, p, p, p, i, i, i, f, p]
    lib.wta_diag_f32.restype = i
    return lib


def _check_cost_and_penalty(cost, sc, ct):
    if cost.dim() != 3:
        raise ValueError(f"cost must be (D, H, W), got {tuple(cost.shape)}")
    check_tensor("cost", cost, cost.shape)
    if (sc is None) != (ct is None):
        raise ValueError("penalty scale and center come together or not at all")
    if sc is not None:
        check_tensor("penalty_scale", sc, cost.shape[1:], device=cost.device)
        check_tensor("penalty_center", ct, cost.shape[1:], device=cost.device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def two_min(cost: torch.Tensor, sc: torch.Tensor | None = None,
            ct: torch.Tensor | None = None, big: float = 1e5):
    """K3: ascending-d two-min of cost + sc*|ct - d| (penalty optional).

    Returns (c1, c2, d1 int32), each (H, W): ties to the lowest d; if
    nothing is below `big`, c1 = c2 = big and d1 = 0."""
    _check_cost_and_penalty(cost, sc, ct)
    if cost.device.type == "cpu":
        return _two_min_plain(cost, sc, ct, big)
    pen = () if sc is None else (sc, ct)
    require_cuda(cost, *pen)
    D, H, W = cost.shape
    c1 = torch.empty((H, W), dtype=torch.float32, device=cost.device)
    c2 = torch.empty_like(c1)
    d1 = torch.empty((H, W), dtype=torch.int32, device=cost.device)
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream(cost.device).cuda_stream
        rc = _lib().two_min_f32(cost.data_ptr(), _ptr(sc), _ptr(ct),
                                c1.data_ptr(), c2.data_ptr(), d1.data_ptr(),
                                D, H, W, big, stream)
    raise_on_error(rc, "two_min")
    LAUNCHES["two_min"] += 1
    return c1, c2, d1


def wta_diag(cost: torch.Tensor, d1: torch.Tensor,
             sc: torch.Tensor | None = None, ct: torch.Tensor | None = None,
             big: float = 1e5):
    """K4: target-view two-min over b in [max(1, d1-x), d1] of
    cost[b, y, x-d1+b] + sc*|ct - (d1-b)|, ties to the largest b, plus the
    tail base plane cost[b0, y, clip(x-d1+b0)] with b0 = max(d1-x, 0).

    d1: (H, W) int32 in [0, D-1].  Returns (c1, c2, b int32, base)."""
    _check_cost_and_penalty(cost, sc, ct)
    check_tensor("d1", d1, cost.shape[1:], dtype=torch.int32,
                 device=cost.device)
    if cost.device.type == "cpu":
        return _diag_two_min_plain(cost, d1, sc, ct, big)
    pen = () if sc is None else (sc, ct)
    require_cuda(cost, d1, *pen)
    D, H, W = cost.shape
    c1 = torch.empty((H, W), dtype=torch.float32, device=cost.device)
    c2 = torch.empty_like(c1)
    base = torch.empty_like(c1)
    b = torch.empty((H, W), dtype=torch.int32, device=cost.device)
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream(cost.device).cuda_stream
        rc = _lib().wta_diag_f32(cost.data_ptr(), d1.data_ptr(), _ptr(sc),
                                 _ptr(ct), c1.data_ptr(), c2.data_ptr(),
                                 b.data_ptr(), base.data_ptr(), D, H, W, big,
                                 stream)
    raise_on_error(rc, "wta_diag")
    LAUNCHES["wta_diag"] += 1
    return c1, c2, b, base
