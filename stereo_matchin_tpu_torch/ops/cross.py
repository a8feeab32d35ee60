"""Adaptive cross (arm) construction for the cross-based method; PyTorch
port of `stereo_matchin_tpu/ops/cross.py` (reference kernels/cross.cl
`Cross`).

For each pixel and each of the four directions the walk extends the arm
while the neighbour's colour stays within tau of the *anchor* pixel on all
three channels and the neighbour lies in the frame; the first failure
freezes the arm.  With the legacy quirk (cross.cl:607-609) the checks run
at distances 3..L+1 instead of 2..L; arms lie in [1, L] either way.

`cross_arms` is the plain version of the CUDA kernel K5
(kernels/cross_oii.py `cross_arms`).  Its `row0`/`h_glob` anchoring is the
JAX package's `parallel/cross_sharded.py` `_cross_arms_tiled`: a band or
shard of rows walks with the frame's borders, not its own.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import edge_pad

# (dy, dx) per output plane: h-, h+, v-, v+.
_DIRS = ((0, -1), (0, 1), (-1, 0), (1, 0))


def cross_arms(img: torch.Tensor, arm_len: int = 25, tau: float = 0.10,
               legacy_quirk: bool = True, row0: int = 0,
               h_glob: int | None = None) -> torch.Tensor:
    """img: (H, W, 3) f32 in [0, 1].  Returns (4, H, W) int32 arm planes
    [h-, h+, v-, v+], the minus arms stored negative (cross.cl:679-682).

    The similarity test is |nb - p| < tau in f32, with tau rounded to f32
    as the JAX package and the kernel compare it.

    img holds frame rows row0 .. row0 + H - 1 of an h_glob-row frame
    (default: the whole frame).  The in-frame test runs on each row's
    frame index clamped to [0, h_glob - 1], so a row past the frame
    border walks within the border row's bounds (the vote reads arms with
    the reference's CLAMP_TO_EDGE); colours are read from `img` with its
    edge rows replicated."""
    H, W = img.shape[0], img.shape[1]
    h_glob = H if h_glob is None else h_glob
    dev = img.device
    p = img.movedim(-1, 0)                                   # (3, H, W)
    M = arm_len + 1
    ext = edge_pad(edge_pad(p, M, M, 1), M, M, 2)
    tau32 = float(np.float32(tau))
    ys = (torch.arange(H, device=dev) + row0).clamp_(0, h_glob - 1)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    first = 3 if legacy_quirk else 2
    arm = torch.ones((4, H, W), dtype=torch.int32, device=dev)
    alive = torch.ones((4, H, W), dtype=torch.bool, device=dev)
    for dist in range(first, first + arm_len - 1):
        for i, (dy, dx) in enumerate(_DIRS):
            oy, ox = M + dy * dist, M + dx * dist
            nb = ext[:, oy:oy + H, ox:ox + W]
            sim = ((nb - p).abs() < tau32).all(dim=0)
            ny, nx = ys + dy * dist, xs + dx * dist
            inb = (ny >= 0) & (ny <= h_glob - 1) & (nx >= 0) & (nx <= W - 1)
            alive[i] &= sim & inb
            arm[i] += alive[i].to(torch.int32)
    # [-1, 1, -1, 1], made on the device: a CUDA graph capture allows no
    # copy from the host.
    sign = torch.arange(4, dtype=torch.int32, device=dev) % 2 * 2 - 1
    return sign[:, None, None] * arm
