"""Wrappers of the CUDA kernels K9 (`support_w`, the support-weight strips)
and K10 (`refine_pass`, the refinement passes) in csrc/asw_refine.cu, and
their plan (`strip_tiles`).

They replace no pallas_call: they are the port's counterparts of what XLA
fuses in the JAX package's jitted ASW frame, the per-tap chains of
stereo_matchin_tpu/ops/support.py `support_weights` and
stereo_matchin_tpu/ops/refinement.py `refine_pass_v` / `refine_pass_h`.
The plain versions are ops/support.py `support_weights` and
ops/refinement.py `refine_pass_v` / `refine_pass_v_win` / `refine_pass_h`
with kernels="jnp": a CPU tensor takes them, a CUDA tensor launches the
kernel or raises.

The plan is one thread per output pixel: a block of BLOCK = (bx, by)
threads owns bx columns of by output rows; each thread walks the T taps
in order (unrolled where T == BAKED_TAPS) and writes its pixel's outputs.
tests/test_torch_refine_tiles.py walks it in numpy as the CUDA code
indexes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import LAUNCHES, check_tensor, raise_on_error, require_cuda
from ._build import library
from ..ops.refinement import refine_pass_h, refine_pass_v, refine_pass_v_win
from ..ops.support import support_weights, weight_scales

BLOCK = (128, 2)                # threads along x, output rows a block
BAKED_TAPS = 33                 # the tap count compiled in (kBakedTaps)
GRID_Y = 65_535                 # the most blocks along grid y
MODES = {"v": 0, "win": 1, "h": 2}


class StripPlan(NamedTuple):
    bx: int            # threads along x
    by: int            # output rows a block
    grid: tuple        # (blocks along x, blocks along y)
    baked: bool        # T compiled in (T == BAKED_TAPS)


def strip_tiles(T: int, H: int, W: int) -> StripPlan:
    """The plan of one K9 or K10 launch over an (H, W) output with T taps.
    Raises ValueError for an even T or a grid too tall: the kernels have
    no other route."""
    if T < 1 or T % 2 == 0:
        raise ValueError(f"need an odd tap count, got T={T}")
    bx, by = BLOCK
    grid = (-(-W // bx), -(-H // by))
    if grid[1] > GRID_Y:
        raise ValueError(f"no strip plan for {H} rows: the grid holds "
                         f"{GRID_Y * by}")
    return StripPlan(bx, by, grid, T == BAKED_TAPS)


@functools.cache
def _lib():
    lib = library()
    p, i, f, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.support_w_f32.argtypes = [p, p, i, i, i, i, i, i, i, i, f, f,
                                  i, i, i, i, p]
    lib.support_w_f32.restype = i
    lib.refine_pass_f32.argtypes = [i, p, q, p, p, p, p, p, i, i, i, f,
                                    i, i, i, i, p]
    lib.refine_pass_f32.restype = i
    lib.expf_f32.argtypes = [p, p, q, p]
    lib.expf_f32.restype = i
    return lib


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def support_w(img: torch.Tensor, radius: int, gamma_c: float, gamma_p: float,
              axis: int, row0: int = 0, h_glob: int | None = None,
              rows: tuple | None = None) -> torch.Tensor:
    """K9: the support strip of img (H, W, 3) in [0, 1] along `axis` (0:
    vertical taps, 1: horizontal), as ops.support_weights computes it (row0
    and h_glob anchor the distance term of axis 0 in frame rows).  rows =
    (y_first, h_out): output only image rows y_first .. y_first + h_out - 1
    (default: all).  Returns (T, h_out, W) f32, T = 2 * radius + 1."""
    if img.dim() != 3 or img.shape[2] != 3:
        raise ValueError(f"img must be (H, W, 3), got {tuple(img.shape)}")
    if axis not in (0, 1) or radius < 0:
        raise ValueError(f"need axis 0 or 1 and radius >= 0, got {axis}, "
                         f"{radius}")
    H, W = img.shape[:2]
    check_tensor("img", img, (H, W, 3))
    y_first, h_out = (0, H) if rows is None else rows
    if y_first < 0 or h_out < 0 or y_first + h_out > H:
        raise ValueError(f"rows {tuple(rows)} leave the image's {H} rows")
    h_glob = H if h_glob is None else h_glob
    if img.device.type == "cpu":
        w = support_weights(img, radius, gamma_c, gamma_p, axis, row0, h_glob,
                            kernels="jnp")
        return w[:, y_first:y_first + h_out].contiguous()
    T = 2 * radius + 1
    plan = strip_tiles(T, h_out, W)
    img = img.contiguous()
    require_cuda(img)
    inv_c, inv_p = weight_scales(gamma_c, gamma_p)
    out = torch.empty((T, h_out, W), dtype=torch.float32, device=img.device)
    with torch.cuda.device(img.device):
        rc = _lib().support_w_f32(
            img.data_ptr(), out.data_ptr(), T, H, W, y_first, h_out, axis,
            row0, h_glob, inv_c, inv_p, plan.bx, plan.by, plan.grid[0],
            plan.grid[1], _stream(img))
    raise_on_error(rc, "support_w")
    LAUNCHES["support_w"] += 1
    return out


def _check_strip(w: torch.Tensor):
    """w: (T, H, W) f32 with odd T."""
    if w.dim() != 3 or w.shape[0] % 2 != 1:
        raise ValueError(f"w must be (T, H, W) with odd T, got "
                         f"{tuple(w.shape)}")
    check_tensor("w", w, w.shape)


def _readable_strip(w: torch.Tensor):
    """(w, its tap stride): w itself where its planes hold contiguous rows
    and do not overlap (a view of rows of a larger strip is read in
    place), else a contiguous copy."""
    T, H, W = w.shape
    if w.device.type != "cuda":
        raise ValueError(f"CUDA kernel called on a {w.device} tensor")
    if (W > 1 and w.stride(2) != 1) or (H > 1 and w.stride(1) != W) or (
            T > 1 and w.stride(0) < H * W):
        w = w.contiguous()
    return w, (w.stride(0) if T > 1 else H * W)


def refine_pass(w: torch.Tensor, d: torch.Tensor, conf: torch.Tensor,
                eps: float, mode: str, dv: torch.Tensor | None = None):
    """K10: one refinement pass over w (T, H, W); returns (value, den),
    each (H, W).  mode "v": d, conf (H, W), rows clamped
    (ops.refine_pass_v); "win": d, conf (H + T - 1, W) of real rows, output
    row y reads rows y .. y + T - 1 (ops.refine_pass_v_win); "h": d the
    vertical pass's value, dv its den, conf (H, W), columns clamped
    (ops.refine_pass_h)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    _check_strip(w)
    T, H, W = w.shape
    rows = H + T - 1 if mode == "win" else H
    check_tensor("d", d, (rows, W), device=w.device)
    check_tensor("conf", conf, (rows, W), device=w.device)
    if mode == "h":
        if dv is None:
            raise ValueError("mode 'h' needs the vertical pass's den (dv)")
        check_tensor("dv", dv, (H, W), device=w.device)
    elif dv is not None:
        raise ValueError(f"mode {mode!r} takes no dv")
    R = (T - 1) // 2
    if w.device.type == "cpu":
        if mode == "v":
            return refine_pass_v(w, d, conf, R, eps, kernels="jnp")
        if mode == "win":
            return refine_pass_v_win(w, d, conf, eps, kernels="jnp")
        return refine_pass_h(w, d, dv, conf, R, eps, kernels="jnp")
    plan = strip_tiles(T, H, W)
    w, w_tap = _readable_strip(w)
    d, conf = d.contiguous(), conf.contiguous()
    dv = None if dv is None else dv.contiguous()
    require_cuda(d, conf, *(() if dv is None else (dv,)))
    value = torch.empty((H, W), dtype=torch.float32, device=w.device)
    den = torch.empty_like(value)
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(w.device):
        rc = _lib().refine_pass_f32(
            MODES[mode], w.data_ptr(), w_tap, d.data_ptr(), ptr(dv),
            conf.data_ptr(), value.data_ptr(), den.data_ptr(), T, H, W, eps,
            plan.bx, plan.by, plan.grid[0], plan.grid[1], _stream(w))
    raise_on_error(rc, f"refine_pass {mode}")
    LAUNCHES["refine_" + mode] += 1
    return value, den


def expf(x: torch.Tensor) -> torch.Tensor:
    """expf of every element of a contiguous CUDA f32 tensor, compiled as
    K9 compiles it (no launch count: it is on no path)."""
    check_tensor("x", x, x.shape)
    require_cuda(x)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _lib().expf_f32(x.data_ptr(), y.data_ptr(), x.numel(),
                             _stream(x))
    raise_on_error(rc, "expf")
    return y
