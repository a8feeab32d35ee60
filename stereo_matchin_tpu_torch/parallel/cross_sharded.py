"""Sharded cross-based pipeline over the (batch, row, disp) mesh; the port
of `stereo_matchin_tpu/parallel/cross_sharded.py`.

Frames over batch, image rows over row with halo exchange, cost-volume
planes over disp.  The taps OII and vote are translation-invariant, so a
shard's maps equal the single-device `cross_pipeline` with
`oii_impl="taps"` bit for bit (pinned by tests), and the kernels' equal
their plain versions.

Vertical reaches served by the halo: the arms walk to distance
arm_len + 1; the OII vertical window and the vote's vertical taps reach
arm_len; the rest is row-local.  One halo of arm_len + 1 rows covers the
arms and the rows whose horizontal arms the vote re-reads.  A shard runs
every stage on its padded tile (rows row0 - halo .. row0 + H_loc + halo -
1 of the frame) and crops the centre:
  * the arm walk's in-frame test uses GLOBAL rows, clamped to the frame
    (row0 = shard row0 - halo, h_glob = H: K5's anchoring, negative on the
    first row shard), so tile rows past the frame border walk as the
    border row does, which is what the vote's CLAMP_TO_EDGE reads;
  * so that they also see the border row's colours, the median-filtered
    tile's rows past the frame border are set to the border row's
    (`_clamp_to_frame`): a median of replicated input rows is not the
    border row's median;
  * the OII vertical pass drops global row 0 and rows past H - 1 (K7 v's
    row0/h_glob anchoring);
  * the vote re-counts the border row: the exchanged halo of the initial
    map replicates it at the frame border, so no mask is needed.

On the "kernels" route (kernels.oii_route of cfg.oii_impl) a shard runs
K5 on both padded views, K6 at d0 with scale 1 over the padded rows, K7 h
and K7 v at d0 (v anchored as above), and K8 vote_h / vote_v over the
padded tile with the full D; "taps" and "prefix" run the same stages'
plain versions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import ops
from ..config import StereoConfig
from ..kernels import oii_route
from .comm import all_gather
from .halo import exchange_halo
from .mesh import local_shard
from .ops_tiled import median3x3_tiled


class ShardedCrossResult(NamedTuple):
    initial: torch.Tensor       # (B_loc, H_loc, W) [0,1]
    final: torch.Tensor         # (B_loc, H_loc, W) [0,1]
    median_left: torch.Tensor   # (B_loc, H_loc, W, 3)


def _clamp_to_frame(x_pad, row0: int, h_glob: int):
    """Rows of a padded tile (frame rows row0 .. row0 + Hp - 1) that lie
    past the frame border, replaced by the border row of the tile."""
    idx = torch.arange(x_pad.shape[0], device=x_pad.device) + row0
    return x_pad.index_select(0, idx.clamp_(0, h_glob - 1) - row0)


def _argmin_disp_sharded(aggr, d0: int, group):
    """Global argmin over the disp shards, ties to the lowest global d:
    one all-gather of each shard's (min, d0 + argmin), merged with '<' in
    ascending shard order."""
    c_loc = aggr.amin(dim=0)
    d_loc = (torch.argmin(aggr, dim=0) + d0).to(torch.int32)
    g = all_gather(torch.stack([c_loc, d_loc.view(torch.float32)]), group)
    c, d = g[0, 0], g[0, 1].contiguous().view(torch.int32)
    for s in range(1, g.shape[0]):               # ascending d = tie order
        take = g[s, 0] < c
        c = torch.where(take, g[s, 0], c)
        d = torch.where(take, g[s, 1].contiguous().view(torch.int32), d)
    return d


def _cross_tile(left, right, cfg: StereoConfig, row0: int, h_glob: int,
                d0: int, d_local: int, row_group, disp_group):
    """One shard's cross pipeline for one pair (H_loc, W, 3)."""
    L = cfg.arm_len
    H_loc = left.shape[0]
    halo = L + 1
    top = row0 - halo                                # frame row of tile row 0
    route = oii_route(cfg.oii_impl, left)
    if route == "kernels":
        from ..kernels.cross_oii import cross_arms, oii_pass
        from ..kernels.sad_volume import sad_volume
    else:
        cross_arms, oii_pass = ops.cross_arms, ops.oii_pass_plain
        sad_volume = ops.sad_cost_volume

    # Median-filtered views on the padded tile (the median reaches 1 row).
    ml_pad, mr_pad = (
        _clamp_to_frame(ops.median3x3(exchange_halo(img, halo + 1,
                                                    row_group))[1:-1],
                        top, h_glob)
        for img in (left, right))
    quirk = cfg.legacy_cross_arm_quirk
    arms_l = cross_arms(ml_pad, L, cfg.tau, quirk, top, h_glob)
    arms_r = cross_arms(mr_pad, L, cfg.tau, quirk, top, h_glob)

    # Cost shard over the padded rows (the OII vertical pass reads them).
    n_real = cfg.num_disp - d0
    cost = sad_volume(ml_pad, mr_pad, d_local, 1.0, d0)
    temp = oii_pass(cost, arms_l, arms_r, L, 2, d0)
    del cost
    aggr = oii_pass(temp, arms_l, arms_r, L, 1, d0, top, h_glob)
    del temp
    aggr = aggr[:, halo:halo + H_loc]
    if n_real < d_local:                             # the disp padding
        aggr = aggr.clone()
        aggr[max(n_real, 0):] = cfg.big

    initial = ops.disparity_to_image(_argmin_disp_sharded(aggr, d0, disp_group),
                                     cfg.d_max, cfg.quantize_maps)
    # Vote over the padded tile with the full D, then the centre rows.
    voted = ops.histogram_vote(exchange_halo(initial, halo, row_group), arms_l,
                               cfg.d_max, quantize=cfg.quantize_maps,
                               arm_len=L, impl=cfg.oii_impl)[halo:halo + H_loc]
    final = median3x3_tiled(exchange_halo(voted, 1, row_group))
    return ShardedCrossResult(initial=initial, final=final,
                              median_left=ml_pad[halo:halo + H_loc])


def make_cross_sharded(cfg: StereoConfig, mesh):
    """The sharded cross pipeline over `mesh`: f(left, right) takes the
    global (B, H, W, 3) pair on every rank and returns this rank's
    (B / batch, H / row, W[, 3]) block of each map (see make_asw_sharded).
    The histogram vote runs with the full disparity count on every disp
    shard (its input is a map, not the cost volume)."""
    if cfg.median_dispatch_quirk:
        raise ValueError(
            "median_dispatch_quirk models the reference's truncated "
            "full-frame Median dispatches (golden comparisons only) and "
            "is not implemented by the sharded pipeline; use cross_pipeline")
    sh = local_shard(mesh)
    d0, d_local, _ = sh.planes(cfg.num_disp)

    def f(left: torch.Tensor, right: torch.Tensor) -> ShardedCrossResult:
        if left.shape != right.shape or left.dim() != 4 or left.shape[3] != 3:
            raise ValueError(f"need two (B, H, W, 3) batches, got "
                             f"{tuple(left.shape)} and {tuple(right.shape)}")
        lb, rb = sh.block(left), sh.block(right)
        h_loc = lb.shape[1]
        frames = [_cross_tile(l, r, cfg, sh.row * h_loc, left.shape[1], d0,
                              d_local, sh.row_group, sh.disp_group)
                  for l, r in zip(lb, rb)]
        return ShardedCrossResult(*(torch.stack(m) for m in zip(*frames)))

    return f
