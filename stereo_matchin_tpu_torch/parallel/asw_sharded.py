"""Sharded iterative-ASW pipeline over a (batch, row, disp) mesh; the port
of `stereo_matchin_tpu/parallel/asw_sharded.py`.

  batch — each rank owns whole frames (B / batch of them);
  row   — image rows are tiled: every vertically reaching stage exchanges
          a halo with the row neighbours (one `radius`-row exchange of the
          volume per aggregation round, one of the four stacked maps per
          refinement round, one row before the median);
  disp  — cost-volume planes are sharded: the WTA and WTA_REF merge the
          per-shard two-min summaries (parallel/wta_sharded.py).

D is padded up to a multiple of the disp shards with `big`-cost planes,
which never win the sequential trackers; the pad planes are pinned to
`big` again after the aggregation (weighted means of `big` drift when the
support sums underflow eps).

On CUDA tensors (cfg.kernels, kernels.use_kernels) a shard runs K1
`asw_den` at its d0 for both axes, the windowed K2 `asw_pass_win` on each
round's exchanged (Dl, H_loc + 2R, W) tile (its weights cover the centre
rows only, so nothing is cropped), K2 h at d0, K3 `two_min` at d0, K13
`epipolar_segment` and K14 `shard_merge` for the target scan and the
merges (parallel/wta_sharded.py), K9
`support_w` for the strips (the vertical ones on the centre rows of the
exchanged image tile, at the shard's frame rows) and K10 `refine_win` and
`refine_h` for the refinement passes, K6 `sad_volume` for the SAD cost
at d0 and K12 `median3x3` for the median, as on the unsharded path;
elsewhere the plain versions of the same kernels.  The maps
equal models.asw.asw_pipeline's bit for bit (tests pin sharded ==
unsharded); only the schedule is distributed.

Each compute segment between two collectives runs as steps of a stage
runner `run(name, fn, *args)` with the shard's offsets and cfg as static
arguments: utils.replay_stage by default (on CUDA tensors each step
replays a CUDA graph, the port's counterpart of the JAX package's jit
over shard_map), utils.call_stage eagerly.  The halo exchanges and the
all-gathers run eagerly between the steps.  A frame: "asw_weights" (the
support strips, the SAD cost and K1's denominators), r x "asw_round" (one
graph), "asw_pin" where the disp padding needs it, the WTA's steps
(parallel/wta_sharded.py), "asw_consistency", "asw_refine_weights", k x
("asw_refine", the WTA_REF's steps, "asw_refine_consistency"),
"asw_filled" (the UNORM8 round trip) and "asw_median".  The weights, the
rounds' volume and the pinned volume are resident steps
(utils/graphs.py): on the card the later steps read them where their
graphs wrote them, instead of a clone and a copy of each in a slot.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from .. import ops
from ..config import StereoConfig
from ..kernels import use_kernels
from ..ops.common import edge_pad
from ..utils import graphs
from .halo import exchange_halo
from .mesh import local_shard
from .ops_tiled import median3x3_tiled, support_weights_tiled
from .wta_sharded import wta_refined_sharded, wta_sharded


class ShardedASWResult(NamedTuple):
    disparity: torch.Tensor          # (B_loc, H_loc, W) [0,1] final median-filtered map
    filled: torch.Tensor             # (B_loc, H_loc, W) [0,1] occlusion-filled map
    consistency_pre: torch.Tensor    # (B_loc, H_loc, W, 3)
    consistency_post: torch.Tensor   # (B_loc, H_loc, W, 3)
    wta_left: torch.Tensor           # (B_loc, H_loc, W)
    wta_right: torch.Tensor          # (B_loc, H_loc, W)


def _to_image(d, cfg: StereoConfig):
    return ops.disparity_to_image(d, cfg.d_max, cfg.quantize_maps)


def _local_halo(x, halo: int, group, axis: int = 0):
    """Edge-pad stand-in for exchange_halo, DIAGNOSTIC ONLY: the same
    shapes and per-shard compute, but the halo rows are the shard's own
    replicated edges, so seam values are WRONG on multi-shard rows.
    Timing halo_mode="local" against "exchange" isolates the row axis's
    share of communication and synchronisation."""
    return x if halo <= 0 else edge_pad(x, halo, halo, axis)


def _pin_pad_planes(c, n_real: int, big: float):
    """Planes past the frame's D (the disp padding) set to `big`."""
    if n_real < c.shape[0]:
        c = c.clone()
        c[max(n_real, 0):] = big
    return c


def _aggregators(cfg: StereoConfig, like):
    """(asw_den, asw_pass, asw_pass_win): K1 and K2 on a CUDA tensor, their
    plain versions elsewhere."""
    if use_kernels(cfg.kernels, like):
        from ..kernels.asw_aggregation import asw_den, asw_pass, asw_pass_win
        return asw_den, asw_pass, asw_pass_win
    return ops.asw_den_plain, ops.asw_pass_plain, ops.asw_pass_win_plain


def _strips(left_pad, right_pad, left, right, cfg: StereoConfig, row0: int,
            h_glob: int, gamma_c: float, gamma_p: float):
    """(wv_l, wv_r, wh_l, wh_r): the vertical strips of the centre rows
    (global-row distance term) and the horizontal ones."""
    R = cfg.radius
    sw = partial(support_weights_tiled, radius=R, row_start=row0,
                 h_global=h_glob, halo=max(R, 1), gamma_c=gamma_c,
                 gamma_p=gamma_p, kernels=cfg.kernels)
    return (sw(left_pad), sw(right_pad),
            ops.support_weights(left, R, gamma_c, gamma_p, 1,
                                kernels=cfg.kernels),
            ops.support_weights(right, R, gamma_c, gamma_p, 1,
                                kernels=cfg.kernels))


@graphs.resident
def _weights(left_pad, right_pad, left, right, cfg: StereoConfig, row0: int,
             h_glob: int, d0: int, d_local: int):
    """After the image exchanges: the support strips, the SAD cost at d0
    (its disp padding pinned) and the denominators of both axes (K1 at
    d0).  Returns (wv_l, wv_r, wh_l, wh_r, den_v, den_h, cost)."""
    wv_l, wv_r, wh_l, wh_r = _strips(left_pad, right_pad, left, right, cfg,
                                     row0, h_glob, cfg.gamma_c, cfg.gamma_p)
    cost = _pin_pad_planes(ops.sad_cost(left, right, d_local, 255.0, d0,
                                        cfg.kernels), cfg.num_disp - d0,
                           cfg.big)
    asw_den = _aggregators(cfg, cost)[0]
    return (wv_l, wv_r, wh_l, wh_r,
            asw_den(wv_l, wv_r, cfg.eps, d0, d_local),
            asw_den(wh_l, wh_r, cfg.eps, d0, d_local), cost)


@graphs.resident
def _round(tile, wv_l, wv_r, den_v, wh_l, wh_r, den_h, cfg: StereoConfig,
           d0: int):
    """One aggregation round after its volume exchange: the windowed K2 on
    the exchanged (Dl, H_loc + 2R, W) tile, then K2 h at d0."""
    _, asw_pass, asw_pass_win = _aggregators(cfg, tile)
    aggr = asw_pass_win(tile, wv_l, wv_r, den_v, cfg.eps, d0)
    return asw_pass(aggr, wh_l, wh_r, den_h, cfg.eps, 2, d0)


@graphs.resident
def _pin(aggr, n_real: int, big: float):
    """The aggregated volume with its disp padding pinned to big again."""
    return _pin_pad_planes(aggr, n_real, big)


def _consistency(disp_ref, conf_ref, disp_target, conf_target,
                 cfg: StereoConfig):
    """After the WTA: its UNORM8 maps, the consistency check and the red
    diagnostic.  Returns (wta_left_img, wta_right_img, maps, red), maps the
    (4, H_loc, W) stack the refinement rounds exchange: filled and right
    maps on the disparity grid, both confidences."""
    wta_left_img = _to_image(disp_ref, cfg)
    wta_right_img = _to_image(disp_target, cfg)
    cons = ops.consistency(wta_left_img * cfg.d_max, wta_right_img * cfg.d_max,
                           conf_ref, conf_target)
    maps = torch.stack([cons.filled, wta_right_img * cfg.d_max, cons.conf_ref,
                        cons.conf_target])
    return (wta_left_img, wta_right_img, maps,
            ops.red_diagnostic(wta_left_img, cons.consistent))


@graphs.resident
def _refine_weights(left_pad, right_pad, left, right, cfg: StereoConfig,
                    row0: int, h_glob: int):
    """The refinement's support strips (wv_l, wv_r, wh_l, wh_r)."""
    return _strips(left_pad, right_pad, left, right, cfg, row0, h_glob,
                   cfg.ref_gamma_c, cfg.ref_gamma_p)


def _refine(pads, rv_l, rv_r, rh_l, rh_r, cfg: StereoConfig):
    """One refinement round after the exchange of its stacked maps (4,
    H_loc + 2R, W): both views' refinement passes.  Returns (val_l, den_l,
    val_r, den_r)."""
    R, eps, kern = cfg.radius, cfg.eps, cfg.kernels
    fq_pad, rq_pad, cr_pad, ct_pad = pads
    centre = slice(R, pads.shape[1] - R)
    vv_l, dv_l = ops.refine_pass_v_win(rv_l, fq_pad, cr_pad, eps, kern)
    val_l, den_l = ops.refine_pass_h(rh_l, vv_l, dv_l, cr_pad[centre], R, eps,
                                     kern)
    vv_r, dv_r = ops.refine_pass_v_win(rv_r, rq_pad, ct_pad, eps, kern)
    val_r, den_r = ops.refine_pass_h(rh_r, vv_r, dv_r, ct_pad[centre], R, eps,
                                     kern)
    return val_l, den_l, val_r, den_r


def _refine_consistency(disp_ref, conf_ref, disp_target, conf_target, maps,
                        cfg: StereoConfig):
    """After a WTA_REF: the consistency check on its maps (with the
    reference's WTA_REF confidence quirk, cfg.wta_ref_conf_bug) and the red
    diagnostic.  Returns (maps, red) for the next round."""
    if cfg.wta_ref_conf_bug:
        conf_ref, conf_target = conf_target, maps[3]
    left_img = _to_image(disp_ref, cfg)
    right_q = _to_image(disp_target, cfg) * cfg.d_max
    c = ops.consistency(left_img * cfg.d_max, right_q, conf_ref, conf_target)
    return (torch.stack([c.filled, right_q, c.conf_ref, c.conf_target]),
            ops.red_diagnostic(left_img, c.consistent))


def _filled(maps, cfg: StereoConfig):
    """The filled map's UNORM8 round trip."""
    if cfg.quantize_maps:
        return ops.image_from_q(maps[0], cfg.d_max)
    return ops.to_unit(maps[0], cfg.d_max)


def _asw_tile(left, right, cfg: StereoConfig, row0: int, h_glob: int,
              d0: int, d_local: int, d_pad: int, row_group, disp_group,
              exchange, run):
    """One shard's ASW pipeline for one pair: left/right (H_loc, W, 3)
    row strips.  Returns the shard's row strips of every output map."""
    R = cfg.radius
    left_pad = exchange(left, max(R, 1), row_group)
    right_pad = exchange(right, max(R, 1), row_group)
    wv_l, wv_r, wh_l, wh_r, den_v, den_h, aggr = run(
        "asw_weights", _weights, left_pad, right_pad, left, right, cfg, row0,
        h_glob, d0, d_local)
    for _ in range(cfg.r_iters):
        # The exchanged tile takes the volume's name, so an eager round
        # frees the volume before its passes and the tile after them.
        aggr = exchange(aggr, R, row_group, axis=1)
        aggr = run("asw_round", _round, aggr, wv_l, wv_r, den_v, wh_l, wh_r,
                   den_h, cfg, d0)
    del wv_l, wv_r, wh_l, wh_r, den_v, den_h
    n_real = cfg.num_disp - d0
    if n_real < d_local:
        aggr = run("asw_pin", _pin, aggr, n_real, cfg.big)

    res = wta_sharded(aggr, d0, d_local, d_pad, disp_group, cfg.big,
                      cfg.kernels, run)
    wta_left_img, wta_right_img, maps, red_pre = run(
        "asw_consistency", _consistency, *res, cfg)
    red_post = red_pre
    rv_l, rv_r, rh_l, rh_r = run("asw_refine_weights", _refine_weights,
                                 left_pad, right_pad, left, right, cfg, row0,
                                 h_glob)
    for _ in range(cfg.k_iters):
        vals = run("asw_refine", _refine, exchange(maps, R, row_group, axis=1),
                   rv_l, rv_r, rh_l, rh_r, cfg)
        r = wta_refined_sharded(aggr, d0, d_local, d_pad, disp_group, *vals,
                                cfg.penalty, cfg.big, cfg.kernels, run)
        maps, red_post = run("asw_refine_consistency", _refine_consistency,
                             *r, maps, cfg)

    filled_img = run("asw_filled", _filled, maps, cfg)
    disparity = run("asw_median", median3x3_tiled,
                    exchange(filled_img, 1, row_group), cfg.kernels)
    return ShardedASWResult(disparity=disparity, filled=filled_img,
                            consistency_pre=red_pre, consistency_post=red_post,
                            wta_left=wta_left_img, wta_right=wta_right_img)


def make_asw_sharded(cfg: StereoConfig, mesh, halo_mode: str = "exchange",
                     run=graphs.replay_stage):
    """The sharded ASW pipeline over `mesh` (parallel.build_mesh).

    Returns f(left, right): every rank passes the global (B, H, W, 3)
    pair, on its device, and gets its own (B / batch, H / row, W[, 3])
    block of each map (the disp shards of a block get identical blocks;
    parallel.gather_blocks assembles the full maps).  Raises unless B and
    H divide over the batch and row shards.

    halo_mode: "exchange" (default) trades real neighbour halos; "local"
    edge-pads instead -- the same compute, no communication, wrong seam
    values -- to isolate the row axis's share (see _local_halo).

    run: the stage runner of the shard's steps (the module's docstring),
    replaying CUDA graphs by default (utils.call_stage: eager).  A frame
    holds its step graphs (utils/graphs.py StageGraphs.hold)."""
    if halo_mode not in ("exchange", "local"):
        raise ValueError(f"halo_mode must be 'exchange' or 'local', got "
                         f"{halo_mode!r}")
    sh = local_shard(mesh)
    d0, d_local, d_pad = sh.planes(cfg.num_disp)
    exchange = exchange_halo if halo_mode == "exchange" else _local_halo

    def f(left: torch.Tensor, right: torch.Tensor) -> ShardedASWResult:
        if left.shape != right.shape or left.dim() != 4 or left.shape[3] != 3:
            raise ValueError(f"need two (B, H, W, 3) batches, got "
                             f"{tuple(left.shape)} and {tuple(right.shape)}")
        lb, rb = sh.block(left), sh.block(right)
        h_loc = lb.shape[1]
        with graphs.STAGES.hold():
            frames = [_asw_tile(l, r, cfg, sh.row * h_loc, left.shape[1], d0,
                                d_local, d_pad, sh.row_group, sh.disp_group,
                                exchange, run)
                      for l, r in zip(lb, rb)]
        return ShardedASWResult(*(torch.stack(m) for m in zip(*frames)))

    return f
