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

Each compute segment between two collectives runs as one step of a stage
runner `run(name, fn, *args)` (utils.replay_stage by default: a CUDA graph
per step on the card; utils.call_stage: eager), the exchanges and the
all-gather eagerly between them: "cross_local" (the medians, arms, cost,
OII passes and the shard's min and argmin; the volume never leaves it),
"cross_merge" (the global argmin and the initial map), "cross_vote" and
"cross_median".
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import ops
from ..config import StereoConfig
from ..kernels import oii_route
from ..utils import graphs
from . import comm
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


def _cross_local(left_pad, right_pad, cfg: StereoConfig, top: int,
                 h_glob: int, d0: int, d_local: int):
    """After the image exchanges (halo + 1 rows): the median-filtered views
    on the padded tile, both views' arms, the cost shard over the padded
    rows (the OII vertical pass reads them), the OII passes, the centre
    rows with the disp padding pinned, and this shard's min and d0 +
    argmin.  Returns (median_left, arms_l, (2, H_loc, W) summary: the
    min and the argmin's int32 bits in a float32 plane)."""
    L = cfg.arm_len
    halo = L + 1
    H_loc = left_pad.shape[0] - 2 * (halo + 1)
    if oii_route(cfg.oii_impl, left_pad) == "kernels":
        from ..kernels.cross_oii import cross_arms, oii_pass
        from ..kernels.sad_volume import sad_volume
    else:
        cross_arms, oii_pass = ops.cross_arms, ops.oii_pass_plain
        sad_volume = ops.sad_cost_volume
    # The median reaches 1 row.
    ml_pad, mr_pad = (_clamp_to_frame(ops.median3x3(img, cfg.kernels)[1:-1],
                                      top, h_glob)
                      for img in (left_pad, right_pad))
    quirk = cfg.legacy_cross_arm_quirk
    arms_l = cross_arms(ml_pad, L, cfg.tau, quirk, top, h_glob)
    arms_r = cross_arms(mr_pad, L, cfg.tau, quirk, top, h_glob)
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
    d_loc = (torch.argmin(aggr, dim=0) + d0).to(torch.int32)
    return (ml_pad[halo:halo + H_loc], arms_l,
            torch.stack([aggr.amin(dim=0), d_loc.view(torch.float32)]))


def _cross_merge(g, cfg: StereoConfig):
    """After the all-gather of the (n, 2, H_loc, W) summaries: the global
    argmin, ties to the lowest global d ('<' in ascending shard order),
    as the initial map."""
    c, d = g[0, 0], g[0, 1].contiguous().view(torch.int32)
    for s in range(1, g.shape[0]):               # ascending d = tie order
        take = g[s, 0] < c
        c = torch.where(take, g[s, 0], c)
        d = torch.where(take, g[s, 1].contiguous().view(torch.int32), d)
    return ops.disparity_to_image(d, cfg.d_max, cfg.quantize_maps)


def _cross_vote(initial_pad, arms_l, cfg: StereoConfig):
    """After the exchange of the initial map: the vote over the padded
    tile with the full D, then its centre rows."""
    halo = cfg.arm_len + 1
    voted = ops.histogram_vote(initial_pad, arms_l, cfg.d_max,
                               quantize=cfg.quantize_maps, arm_len=cfg.arm_len,
                               impl=cfg.oii_impl)
    return voted[halo:voted.shape[0] - halo]


def _cross_tile(left, right, cfg: StereoConfig, row0: int, h_glob: int,
                d0: int, d_local: int, row_group, disp_group, run):
    """One shard's cross pipeline for one pair (H_loc, W, 3)."""
    halo = cfg.arm_len + 1
    median_left, arms_l, summary = run(
        "cross_local", _cross_local, exchange_halo(left, halo + 1, row_group),
        exchange_halo(right, halo + 1, row_group), cfg, row0 - halo, h_glob,
        d0, d_local)
    initial = run("cross_merge", _cross_merge,
                  comm.all_gather(summary, disp_group), cfg)
    voted = run("cross_vote", _cross_vote,
                exchange_halo(initial, halo, row_group), arms_l, cfg)
    final = run("cross_median", median3x3_tiled,
                exchange_halo(voted, 1, row_group), cfg.kernels)
    return ShardedCrossResult(initial=initial, final=final,
                              median_left=median_left)


def make_cross_sharded(cfg: StereoConfig, mesh, run=graphs.replay_stage):
    """The sharded cross pipeline over `mesh`: f(left, right) takes the
    global (B, H, W, 3) pair on every rank and returns this rank's
    (B / batch, H / row, W[, 3]) block of each map (see make_asw_sharded).
    The histogram vote runs with the full disparity count on every disp
    shard (its input is a map, not the cost volume).  run: the stage runner
    of the shard's steps (the module's docstring), replaying CUDA graphs by
    default (utils.call_stage: eager)."""
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
        with graphs.STAGES.hold():
            frames = [_cross_tile(l, r, cfg, sh.row * h_loc, left.shape[1],
                                  d0, d_local, sh.row_group, sh.disp_group,
                                  run)
                      for l, r in zip(lb, rb)]
        return ShardedCrossResult(*(torch.stack(m) for m in zip(*frames)))

    return f
