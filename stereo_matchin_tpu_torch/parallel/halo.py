"""Ring halo exchange for row-tiled images and cost volumes; the port of
`stereo_matchin_tpu/parallel/halo.py`.

Each rank of the mesh's row group owns a contiguous strip of image rows.
Every vertically reaching op (3x3 median, cross arms, vertical supports,
aggregation and refinement, the OII vertical pass, the histogram vote)
needs up to `halo` rows from each neighbour: rank i of the row group
receives rank i-1's last `halo` rows and rank i+1's first ones, in one
batch of sends and receives (parallel/comm.py, staged through the host
under gloo).  The first and last ranks replicate their own edge row
instead, which is the reference's CLAMP_TO_EDGE sampler at the *global*
border (`_edge_fill`).

The exchanged tile is cat([top_halo, x, bottom_halo]), so the ordinary
clamp-to-edge ops run on it exactly: interior shards never clamp (reach
<= halo) and border shards clamp onto replicated global edges.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.common import edge_pad
from .comm import exchange, group_rank


def _edge_fill(x: torch.Tensor, halo: int, axis: int, take_first: bool):
    """The tile's own global-edge row, `halo` times."""
    row = x.narrow(axis, 0 if take_first else x.shape[axis] - 1, 1)
    return torch.cat([row] * halo, dim=axis)


def exchange_halo(x: torch.Tensor, halo: int, group, axis: int = 0):
    """x padded with `halo` rows of neighbour data along `axis`.

    A one-rank axis edge-pads (the global clamp-to-edge).  On more ranks,
    raises where `halo` exceeds the local rows: one neighbour must cover
    the halo."""
    if halo <= 0:
        return x
    n = dist.get_world_size(group)
    if n == 1:
        return edge_pad(x, halo, halo, axis)
    size = x.shape[axis]
    if halo > size:
        raise ValueError(f"a halo of {halo} rows needs at least {halo} local "
                         f"rows, the shard has {size}")
    i = group_rank(group)
    shape = list(x.shape)
    shape[axis] = halo
    sends, recvs = {}, {}
    if i > 0:                    # my first rows go up, rank i-1's last come down
        sends[i - 1] = x.narrow(axis, 0, halo)
        recvs[i - 1] = shape
    if i < n - 1:
        sends[i + 1] = x.narrow(axis, size - halo, halo)
        recvs[i + 1] = shape
    got = exchange(sends, recvs, group, x)
    top = got[i - 1] if i > 0 else _edge_fill(x, halo, axis, True)
    bot = got[i + 1] if i < n - 1 else _edge_fill(x, halo, axis, False)
    return torch.cat([top, x, bot], dim=axis)


def crop_halo(x: torch.Tensor, halo: int, axis: int = 0):
    """Drop the `halo` rows added by exchange_halo."""
    if halo <= 0:
        return x
    return x.narrow(axis, halo, x.shape[axis] - 2 * halo)
