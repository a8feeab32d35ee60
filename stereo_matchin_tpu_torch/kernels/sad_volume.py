"""Wrapper of the CUDA SAD cost-volume kernel K6 (`sad_volume`) in
csrc/sad_volume.cu.

It replaces sad_volume_t_pallas (stereo_matchin_tpu/kernels/sad_volume.py)
in the port's (D, H, W) layout.  The plain version is ops/cost.py
`sad_cost_volume`: a CPU tensor takes it, a CUDA tensor launches the
kernel or raises.

The tile plan is `sad_tiles`: a block owns SAD_TX columns of one row (4 a
thread) and a chunk of dc planes; it stages the chunk's pre-scaled right
segment once and each thread slides a window of 4 right colours down the
chunk's planes, one 16-byte store a plane.  The wrapper passes the plan to
the CUDA entry point, which refuses one off its compiled layout;
tests/test_torch_sad_tiles.py walks it in numpy as the CUDA code indexes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import LAUNCHES, check_tensor, raise_on_error, require_cuda
from ._build import library
from ..ops.cost import sad_cost_volume


# K6's shape, compiled into csrc/sad_volume.cu (kSadThreads, kSadTx,
# kSadDc), and the plan's chunking.
SAD_THREADS = 128               # threads a block
SAD_TX = 4 * SAD_THREADS        # columns a block: 4 consecutive a thread
SAD_DC = 32                     # planes a chunk at most
SAD_BLOCKS = 1056               # blocks the plan aims at: 8 per SM of 132
GRID_YZ = 65_535                # the most blocks along grid y and z


class SadPlan(NamedTuple):
    dc: int            # planes a chunk
    chunks: int        # chunks of planes along grid z
    grid: tuple        # (column tiles, rows, chunks)
    pitch: int         # words of one staged channel plane: the segment's
                       # SAD_TX + dc - 1 positions, one pad word every 32
    shared_bytes: int  # three channel planes: 12 * pitch


def sad_tiles(D: int, H: int, W: int) -> SadPlan:
    """The plan of one K6 launch: a block owns SAD_TX columns of one row
    and a chunk of dc planes.  Chunks hold at most SAD_DC planes and are as
    many more as bring the grid to SAD_BLOCKS blocks, and equal.  Raises
    ValueError where the grid is too tall or a plane passes 2^31 - 1
    pixels: the kernel has no other route."""
    if D < 1 or H < 1 or W < 1:
        raise ValueError(f"no K6 plan for D={D}, {H}x{W}")
    if H * W > 2**31 - 1:
        raise ValueError(f"no K6 plan for {H}x{W}: a plane passes 2^31 - 1 "
                         f"pixels")
    gx = -(-W // SAD_TX)
    chunks = max(-(-D // SAD_DC), min(D, -(-SAD_BLOCKS // (gx * H))))
    dc = -(-D // chunks)
    chunks = -(-D // dc)
    if H > GRID_YZ or chunks > GRID_YZ:
        raise ValueError(f"no K6 plan for {H} rows in {chunks} chunks: the "
                         f"grid holds {GRID_YZ} along y and z")
    n = SAD_TX + dc - 1
    pitch = n + (n >> 5) + 1
    return SadPlan(dc, chunks, (gx, H, chunks), pitch, 12 * pitch)


@functools.cache
def _lib():
    lib = library()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sad_volume_f32.argtypes = [p, p, p, i, i, i, i, f, i, i, i, p]
    lib.sad_volume_f32.restype = i
    return lib


def sad_volume(left: torch.Tensor, right: torch.Tensor, num_disp: int,
               scale: float = 1.0, d0: int = 0) -> torch.Tensor:
    """K6: cost[d, y, x] = (|l0 s - r0 s| + |l1 s - r1 s|) + |l2 s - r2 s|
    with r read at (y, max(x - d0 - d, 0)).

    left, right: (H, W, 3) f32.  Returns (num_disp, H, W) f32."""
    if left.dim() != 3 or left.shape[2] != 3:
        raise ValueError(f"images must be (H, W, 3), got {tuple(left.shape)}")
    check_tensor("left", left, left.shape)
    check_tensor("right", right, left.shape, device=left.device)
    if d0 < 0 or num_disp < 1:
        raise ValueError(f"need d0 >= 0 and num_disp >= 1, got {d0}, {num_disp}")
    if left.device.type == "cpu":
        return sad_cost_volume(left, right, num_disp, scale, d0)
    require_cuda(left, right)
    H, W = left.shape[:2]
    plan = sad_tiles(num_disp, H, W)
    out = torch.empty((num_disp, H, W), dtype=torch.float32, device=left.device)
    with torch.cuda.device(left.device):
        stream = torch.cuda.current_stream(left.device).cuda_stream
        rc = _lib().sad_volume_f32(left.data_ptr(), right.data_ptr(),
                                   out.data_ptr(), num_disp, H, W, d0, scale,
                                   plan.dc, plan.chunks, plan.shared_bytes,
                                   stream)
    raise_on_error(rc, "sad_volume")
    LAUNCHES["sad_volume"] += 1
    return out
