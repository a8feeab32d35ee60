"""Wrappers of the CUDA WTA kernels K3 (`two_min`), K4 (`wta_diag`) and
K11 (`wta_merge`) in csrc/wta_gather.cu.

K3 and K4 replace two_min_pallas and wta_diag_pallas
(stereo_matchin_tpu/kernels/wta_gather.py).  K4 reads the epipolar
diagonal straight from the (D, H, W) volume, so the TPU package's sheared
copy (build_diag) and its pads have no counterpart.  K11 replaces no
pallas_call: it is the port's counterpart of the XLA fusion of the JAX
package's WTA epilogue (stereo_matchin_tpu/ops/wta_fast.py
`_tail_and_merge` and the two confidences), one thread per pixel.  The
plain versions are ops/wta_fast.py `_two_min_plain` /
`_diag_two_min_plain` / `_wta_epilogue_plain`: a CPU tensor takes them, a
CUDA tensor launches the kernel or raises.

K4 walks each pixel's diagonal in two passes: the first `diag_head(D)`
planes of every diagonal, then the rest of the longer diagonals of warps
that hold at most K4_SPARSE of them, from a queue, so warps stay full
where a few pixels have outlying d1 (tests/test_torch_wta_tiles.py walks
this in numpy as the CUDA code indexes).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import LAUNCHES, check_tensor, raise_on_error, require_cuda
from ._build import library
from ..ops.wta_fast import (_diag_two_min_plain, _two_min_plain,
                            _wta_epilogue_plain)

# K4: the planes of each diagonal in the first pass, and the most lanes of
# a warp that leave the rest of theirs to the second (compiled in:
# csrc/wta_gather.cu kSparseK4).
K4_HEAD = 64
K4_SPARSE = 8


@functools.cache
def _lib():
    lib = library()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.two_min_f32.argtypes = [p, p, p, p, p, p, i, i, i, i, f, p]
    lib.two_min_f32.restype = i
    lib.wta_diag_f32.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, f, i, p]
    lib.wta_diag_f32.restype = i
    lib.wta_merge_f32.argtypes = [p] * 13 + [i, i, i, f, p]
    lib.wta_merge_f32.restype = i
    return lib


def diag_head(D: int) -> int:
    """The planes of each diagonal that K4's first pass walks: K4_HEAD, at
    most D.  Where it is at least D - 1 the first pass walks every
    diagonal and the second is not launched."""
    head = min(K4_HEAD, max(D, 1))
    if head < 1:
        raise ValueError(f"K4 is not compiled for a first pass of {head} "
                         f"planes (K4_HEAD {K4_HEAD})")
    return head


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
            ct: torch.Tensor | None = None, big: float = 1e5, d0: int = 0):
    """K3: ascending-d two-min of cost + sc*|ct - (d0 + d)| (penalty
    optional); plane d of cost holds disparity d0 + d (a disp shard).

    Returns (c1, c2, d1 int32), each (H, W), d1 the plane index: ties to
    the lowest d; if nothing is below `big`, c1 = c2 = big and d1 = 0."""
    _check_cost_and_penalty(cost, sc, ct)
    if d0 < 0:
        raise ValueError(f"need d0 >= 0, got {d0}")
    if cost.device.type == "cpu":
        return _two_min_plain(cost, sc, ct, big, d0)
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
                                D, H, W, d0, big, stream)
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
    head = diag_head(D)
    if H * W >= 2 ** 31 - 1:
        raise ValueError(f"K4 indexes pixels in int32: {H * W} is too many")
    c1 = torch.empty((H, W), dtype=torch.float32, device=cost.device)
    c2 = torch.empty_like(c1)
    base = torch.empty_like(c1)
    b = torch.empty((H, W), dtype=torch.int32, device=cost.device)
    queue = (torch.empty(H * W + 1, dtype=torch.int32, device=cost.device)
             if head < D - 1 else None)
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream(cost.device).cuda_stream
        rc = _lib().wta_diag_f32(cost.data_ptr(), d1.data_ptr(), _ptr(sc),
                                 _ptr(ct), c1.data_ptr(), c2.data_ptr(),
                                 b.data_ptr(), base.data_ptr(), _ptr(queue),
                                 D, H, W, big, head, stream)
    raise_on_error(rc, "wta_diag")
    LAUNCHES["wta_diag"] += 1
    return c1, c2, b, base


def wta_merge(c1: torch.Tensor, c2: torch.Tensor, d1: torch.Tensor,
              mc1: torch.Tensor, mc2: torch.Tensor, md: torch.Tensor,
              base: torch.Tensor, sc: torch.Tensor | None,
              ct: torch.Tensor | None, big: float, D: int):
    """K11: the WTA epilogue from K3's (c1, c2, d1) and K4's (mc1, mc2, md,
    base), all (H, W); sc, ct: the target view's penalty maps or None; D:
    the volume's planes.  Returns (disp_ref, conf_ref, disp_target,
    conf_target), (H, W) f32: d1 as f32, (c2 - c1) / c2, and the clamped
    tail merged with K4's scan (ops/wta_fast.py _tail_and_merge)."""
    if c1.dim() != 2:
        raise ValueError(f"c1 must be (H, W), got {tuple(c1.shape)}")
    if D < 1:
        raise ValueError(f"need D >= 1, got {D}")
    shape, dev = c1.shape, c1.device
    f32, i32 = torch.float32, torch.int32
    for name, t, dtype in (("c1", c1, f32), ("c2", c2, f32), ("d1", d1, i32),
                           ("mc1", mc1, f32), ("mc2", mc2, f32),
                           ("md", md, i32), ("base", base, f32)):
        check_tensor(name, t, shape, dtype=dtype, device=dev)
    if (sc is None) != (ct is None):
        raise ValueError("penalty scale and center come together or not at all")
    pen = () if sc is None else (sc, ct)
    for name, t in zip(("penalty_scale", "penalty_center"), pen):
        check_tensor(name, t, shape, device=dev)
    if dev.type == "cpu":
        return _wta_epilogue_plain(c1, c2, d1, mc1, mc2, md, base, sc, ct, big,
                                   D)
    require_cuda(c1, c2, d1, mc1, mc2, md, base, *pen)
    H, W = shape
    outs = [torch.empty((H, W), dtype=torch.float32, device=dev)
            for _ in range(4)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().wta_merge_f32(
            c1.data_ptr(), c2.data_ptr(), d1.data_ptr(), mc1.data_ptr(),
            mc2.data_ptr(), md.data_ptr(), base.data_ptr(), _ptr(sc), _ptr(ct),
            *(o.data_ptr() for o in outs), D, H, W, big, stream)
    raise_on_error(rc, "wta_merge")
    LAUNCHES["wta_merge"] += 1
    return tuple(outs)
