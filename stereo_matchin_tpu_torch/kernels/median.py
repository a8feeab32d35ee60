"""Wrapper of the CUDA 3x3 median kernel K12 (`median3x3`) in
csrc/median.cu.

It replaces no pallas_call: it is the port's counterpart of the XLA fusion
of stereo_matchin_tpu/ops/median.py `median3x3` (the 19-exchange selection
network over nine edge-clamped taps) in the JAX package's jitted frames.
The plain version is ops/median.py `median3x3_plain`: a CPU tensor takes
it, a CUDA tensor launches the kernel or raises.

The plan (`median_tiles`, csrc/median.cu's, read through ctypes): tiles
of a row's elements (channel c of pixel x is element x * C + c, so a tile
needs no division by C) by `ty` rows, each staged with its one-row and
C-element halo in shared memory, clamped to the frame's edges.
tests/test_torch_median.py walks those tiles in numpy.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import LAUNCHES, check_tensor, raise_on_error, require_cuda
from ._build import library
from ..ops.median import median3x3_plain

def median_tiles(H: int, W: int, C: int) -> tuple[int, int, int, int]:
    """(threads, ty, gx, gy): elements of a row a tile, rows a tile, tiles
    along a row's W * C elements and down the H rows, as csrc/median.cu
    median3x3_plan decides them (builds the library).  Raises ValueError
    where no tile fits (C above ~1470)."""
    out = (ctypes.c_int * 5)()
    _lib().median3x3_plan(H, W, C, out)
    if out[1] == 0:
        raise ValueError(f"median3x3: a tile of {C} channels does not fit "
                         f"a block's shared memory")
    return tuple(out[:4])


@functools.cache
def _lib():
    lib = library()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.median3x3_f32.argtypes = [p, p, i, i, i, p]
    lib.median3x3_f32.restype = i
    lib.median3x3_plan.argtypes = [i, i, i, p]
    lib.median3x3_plan.restype = None
    return lib


def median3x3(img: torch.Tensor) -> torch.Tensor:
    """K12: the per-channel 3x3 median with clamp-to-edge reads of img,
    (H, W) or (H, W, C) f32 with finite values.  Returns a contiguous
    tensor of img's shape."""
    if img.dim() not in (2, 3):
        raise ValueError(f"img must be (H, W) or (H, W, C), got "
                         f"{tuple(img.shape)}")
    check_tensor("img", img, img.shape)
    if img.device.type == "cpu":
        return median3x3_plain(img)
    img = img.contiguous()
    require_cuda(img)
    H, W = img.shape[:2]
    C = img.shape[2] if img.dim() == 3 else 1
    if img.numel() >= 2 ** 31:
        raise ValueError("median3x3: the kernel indexes fewer than 2^31 "
                         "elements")
    if img.numel() and median_tiles(H, W, C)[3] > 65535:
        raise ValueError(f"median3x3: {H} rows need more than 65535 tiles")
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = _lib().median3x3_f32(img.data_ptr(), out.data_ptr(), H, W, C,
                                  stream)
    raise_on_error(rc, "median3x3")
    LAUNCHES["median3x3"] += 1
    return out
