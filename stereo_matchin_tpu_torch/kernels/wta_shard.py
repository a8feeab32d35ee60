"""Wrappers of the sharded WTA's CUDA kernels K13 (`epipolar_segment`) and
K14 (`shard_merge`) in csrc/wta_shard.cu.

Neither replaces a pallas_call: they are the port's counterparts of the
XLA fusions of the JAX package's jitted shard program
(stereo_matchin_tpu/parallel/wta_sharded.py): K13 one disp shard's
segment of the epipolar target scan (`epipolar_partial`'s fori_loop), K14
the merges of the shards' all-gathered (n, 3, H, W) summaries
(`reference_scan_sharded`'s fold, and `target_scan_sharded`'s with the
WTA's maps).  The plain versions are parallel/wta_sharded.py's
`epipolar_partial` + `stack_two_min`, `merge_reference_gathered` and
`merge_target_gathered` + `wta_result`: a CPU tensor takes them, a CUDA
tensor launches the kernel or raises.  Both count their launches, K14's
two modes under one name.

K13's plan (`segment_plan`, csrc/wta_shard.cu's, read through ctypes): a
block owns a segment of one row (the row split into equal segments), its
pixels' trackers in registers; it stages the planes that a share of its
columns walk through a ring of windows in shared memory, each window the
columns its pixels read of one plane, and walks the other planes of its
pixels through a queue, one pixel a thread (buffered in the ring where
no plane is staged).  A launch whose grid of segment blocks would be
small takes the pixel walk instead: one thread a pixel, direct loads.
A shape whose ring does not fit a block's shared memory is refused.
tests/test_torch_wta_shard_tiles.py walks that schedule in numpy.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import LAUNCHES, check_tensor, raise_on_error, require_cuda
from ._build import library
from ..ops.wta import WTAResult


PLAN_KEYS = ("threads", "pix", "ring", "share", "n_seg", "seg", "slot",
             "smem", "min_grid")
WALKS = {"auto": 0, "pixel": 1, "segment": 2}


def segment_plan(W: int, n_local: int, total_disp: int) -> dict:
    """K13's plan for a row of W >= 1 columns, as csrc/wta_shard.cu
    epipolar_segment_plan decides it (builds the library): {"threads": a
    block's, "pix": pixels a thread, "ring": windows in the ring, "share":
    a staged plane reaches 1 / share of its block's columns, "n_seg":
    segments a row, "seg": columns a segment (the last one ragged),
    "slot": floats a ring window, "smem": the block's shared memory,
    "min_grid": the least H * n_seg blocks with which a launch takes the
    segment walk (fewer: the pixel walk)}.  Raises ValueError where the
    block does not fit."""
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    _lib().epipolar_segment_plan(W, n_local, total_disp, out)
    plan = dict(zip(PLAN_KEYS, out))
    if plan["smem"] == 0:
        raise ValueError(
            f"epipolar_segment: a ring of {plan['ring']} windows of "
            f"{plan['slot']} floats, a queue of {plan['seg']} pixels and "
            f"{n_local} planes' counts does not fit a block's shared memory")
    return plan


@functools.cache
def _lib():
    lib = library()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.epipolar_segment_f32.argtypes = [p] * 5 + [i] * 6 + [f, p]
    lib.epipolar_segment_f32.restype = i
    lib.epipolar_segment_walk_f32.argtypes = [p] * 5 + [i] * 6 + [f, i, p]
    lib.epipolar_segment_walk_f32.restype = i
    lib.epipolar_segment_plan.argtypes = [i, i, i, p]
    lib.epipolar_segment_plan.restype = None
    lib.shard_merge_reference_f32.argtypes = [p, i, i, i, f, p, p, p, p]
    lib.shard_merge_reference_f32.restype = i
    lib.shard_merge_target_f32.argtypes = [p, i, i, i, f] + [p] * 8
    lib.shard_merge_target_f32.restype = i
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def epipolar_segment(cost: torch.Tensor, d1: torch.Tensor, d0: int,
                     n_local: int, total_disp: int,
                     sc: torch.Tensor | None = None,
                     ct: torch.Tensor | None = None,
                     big: float = 1e5, walk: str = "auto") -> torch.Tensor:
    """K13: one shard's segment of the epipolar target scan, stacked.

    cost: (Dl, H, W) f32, plane k holding global disparity d0 + k; d1:
    (H, W) int32 global disparities; sc, ct: the penalty sc * |ct - i| of
    scan step i, or both None; n_local (1 .. Dl): the shard's planes;
    total_disp: the padded depth; walk: "auto" (the segment walk where its
    grid holds segment_plan's min_grid blocks, else the pixel walk),
    "segment" or "pixel" (both held to the plain version by the card's
    tests).  Returns (3, H, W) f32: c1, c2 and the best global plane's
    int32 bits (parallel/wta_sharded.py stack_two_min)."""
    from ..parallel.wta_sharded import epipolar_partial, stack_two_min

    if cost.dim() != 3:
        raise ValueError(f"cost must be (Dl, H, W), got {tuple(cost.shape)}")
    Dl, H, W = cost.shape
    check_tensor("cost", cost, cost.shape)
    check_tensor("d1", d1, (H, W), dtype=torch.int32, device=cost.device)
    if (sc is None) != (ct is None):
        raise ValueError("penalty scale and center come together or not at all")
    pen = () if sc is None else (sc, ct)
    for name, x in zip(("penalty_scale", "penalty_center"), pen):
        check_tensor(name, x, (H, W), device=cost.device)
    if not 1 <= n_local <= Dl:
        raise ValueError(f"need 1 <= n_local <= {Dl} planes, got {n_local}")
    if d0 < 0 or total_disp < 1:
        raise ValueError(f"need d0 >= 0 and total_disp >= 1, got {d0} and "
                         f"{total_disp}")
    if walk not in WALKS:
        raise ValueError(f"walk must be one of {list(WALKS)}, got {walk!r}")
    if cost.device.type == "cpu":
        return stack_two_min(epipolar_partial(cost, d1, d0, n_local,
                                              total_disp, sc, ct, big))
    require_cuda(cost, d1, *pen)
    if H * W >= 2 ** 31:
        raise ValueError("epipolar_segment: the kernel indexes fewer than "
                         "2^31 pixels")
    if H * W:
        segment_plan(W, n_local, total_disp)
    out = torch.empty((3, H, W), dtype=torch.float32, device=cost.device)
    with torch.cuda.device(cost.device):
        rc = _lib().epipolar_segment_walk_f32(
            cost.data_ptr(), d1.data_ptr(), _ptr(sc), _ptr(ct),
            out.data_ptr(), Dl, H, W, d0, n_local, total_disp, big,
            WALKS[walk], _stream(cost.device))
    raise_on_error(rc, "epipolar_segment")
    LAUNCHES["epipolar_segment"] += 1
    return out


def _check_gathered(g: torch.Tensor):
    if g.dim() != 4 or g.shape[1] != 3 or g.shape[0] < 1:
        raise ValueError(f"need the gathered (n, 3, H, W) summaries, got "
                         f"{tuple(g.shape)}")
    check_tensor("gathered", g, g.shape)


def shard_merge_reference(g: torch.Tensor, big: float = 1e5):
    """K14, reference mode: the shards' summaries (n, 3, H, W) folded in
    ascending shard order by two_min_combine, d = 0 where c1 is not below
    big.  Returns TwoMin(c1, c2, d int32), each (H, W)
    (parallel/wta_sharded.py merge_reference_gathered)."""
    from ..parallel.wta_sharded import TwoMin, merge_reference_gathered

    _check_gathered(g)
    if g.device.type == "cpu":
        return merge_reference_gathered(g, big)
    require_cuda(g)
    n, _, H, W = g.shape
    c1 = torch.empty((H, W), dtype=torch.float32, device=g.device)
    c2 = torch.empty_like(c1)
    d = torch.empty((H, W), dtype=torch.int32, device=g.device)
    with torch.cuda.device(g.device):
        rc = _lib().shard_merge_reference_f32(
            g.data_ptr(), n, H, W, big, c1.data_ptr(), c2.data_ptr(),
            d.data_ptr(), _stream(g.device))
    raise_on_error(rc, "shard_merge reference")
    LAUNCHES["shard_merge"] += 1
    return TwoMin(c1, c2, d)


def shard_merge_target(g: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
                       d_ref: torch.Tensor, big: float = 1e5) -> WTAResult:
    """K14, target mode: the shards' epipolar segments (n, 3, H, W) folded
    in descending shard order (ascending scan step) from (big, big,
    d_ref), and the WTA's maps with the reference merge's (c1, c2, d_ref):
    d_ref and d_t as f32, (c2 - c1) / c2 of both (parallel/wta_sharded.py
    merge_target_gathered + wta_result)."""
    from ..parallel.wta_sharded import merge_target_gathered, wta_result

    _check_gathered(g)
    H, W = g.shape[2:]
    for name, x, dtype in (("c1", c1, torch.float32), ("c2", c2, torch.float32),
                           ("d_ref", d_ref, torch.int32)):
        check_tensor(name, x, (H, W), dtype=dtype, device=g.device)
    if g.device.type == "cpu":
        return wta_result(c1, c2, d_ref, *merge_target_gathered(g, d_ref, big))
    require_cuda(g, c1, c2, d_ref)
    outs = [torch.empty((H, W), dtype=torch.float32, device=g.device)
            for _ in range(4)]
    with torch.cuda.device(g.device):
        rc = _lib().shard_merge_target_f32(
            g.data_ptr(), g.shape[0], H, W, big, c1.data_ptr(), c2.data_ptr(),
            d_ref.data_ptr(), *(o.data_ptr() for o in outs),
            _stream(g.device))
    raise_on_error(rc, "shard_merge target")
    LAUNCHES["shard_merge"] += 1
    return WTAResult(*outs)
