"""Wrapper of the CUDA SAD cost-volume kernel K6 (`sad_volume`) in
csrc/sad_volume.cu.

It replaces sad_volume_t_pallas (stereo_matchin_tpu/kernels/sad_volume.py)
in the port's (D, H, W) layout.  The plain version is ops/cost.py
`sad_cost_volume`: a CPU tensor takes it, a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import LAUNCHES, check_tensor, raise_on_error, require_cuda
from ._build import library
from ..ops.cost import sad_cost_volume


@functools.cache
def _lib():
    lib = library()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sad_volume_f32.argtypes = [p, p, p, i, i, i, i, f, p]
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
    out = torch.empty((num_disp, H, W), dtype=torch.float32, device=left.device)
    with torch.cuda.device(left.device):
        stream = torch.cuda.current_stream(left.device).cuda_stream
        rc = _lib().sad_volume_f32(left.data_ptr(), right.data_ptr(),
                                   out.data_ptr(), num_disp, H, W, d0, scale,
                                   stream)
    raise_on_error(rc, "sad_volume")
    LAUNCHES["sad_volume"] += 1
    return out
