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
rows only, so nothing is cropped), K2 h at d0 and K3 `two_min` at d0;
elsewhere the plain versions of the same kernels.  The SAD cost is the
plain `ops.sad_cost_volume` at d0, as on the unsharded path.  The maps
equal models.asw.asw_pipeline's bit for bit (tests pin sharded ==
unsharded); only the schedule is distributed.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from .. import ops
from ..config import StereoConfig
from ..kernels import use_kernels
from ..ops.common import edge_pad
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


def _asw_tile(left, right, cfg: StereoConfig, row0: int, h_glob: int,
              d0: int, d_local: int, d_pad: int, row_group, disp_group,
              exchange):
    """One shard's ASW pipeline for one pair: left/right (H_loc, W, 3)
    row strips.  Returns the shard's row strips of every output map."""
    R, eps = cfg.radius, cfg.eps
    halo_img = max(R, 1)
    left_pad = exchange(left, halo_img, row_group)
    right_pad = exchange(right, halo_img, row_group)

    # Support strips: centre rows, global-row distance term.
    sw = partial(support_weights_tiled, radius=R, row_start=row0,
                 h_global=h_glob, halo=halo_img)
    wv_l = sw(left_pad, gamma_c=cfg.gamma_c, gamma_p=cfg.gamma_p)
    wv_r = sw(right_pad, gamma_c=cfg.gamma_c, gamma_p=cfg.gamma_p)
    wh_l = ops.support_weights(left, R, cfg.gamma_c, cfg.gamma_p, 1)
    wh_r = ops.support_weights(right, R, cfg.gamma_c, cfg.gamma_p, 1)

    n_real = cfg.num_disp - d0
    cost = ops.sad_cost_volume(left, right, d_local, 255.0, d0)
    cost = _pin_pad_planes(cost, n_real, cfg.big)
    if use_kernels(cfg.kernels, cost):
        from ..kernels.asw_aggregation import asw_den, asw_pass, asw_pass_win
    else:
        asw_den, asw_pass, asw_pass_win = (
            ops.asw_den_plain, ops.asw_pass_plain, ops.asw_pass_win_plain)
    den_v = asw_den(wv_l, wv_r, eps, d0, d_local)
    den_h = asw_den(wh_l, wh_r, eps, d0, d_local)
    aggr = cost
    del cost
    for _ in range(cfg.r_iters):
        aggr = asw_pass_win(exchange(aggr, R, row_group, axis=1), wv_l, wv_r,
                            den_v, eps, d0)
        aggr = asw_pass(aggr, wh_l, wh_r, den_h, eps, 2, d0)
    aggr = _pin_pad_planes(aggr, n_real, cfg.big)

    res = wta_sharded(aggr, d0, d_local, d_pad, disp_group, cfg.big,
                      cfg.kernels)
    wta_left_img = _to_image(res.disp_ref, cfg)
    wta_right_img = _to_image(res.disp_target, cfg)
    cons = ops.consistency(wta_left_img * cfg.d_max, wta_right_img * cfg.d_max,
                           res.conf_ref, res.conf_target)
    red_post = red_pre = ops.red_diagnostic(wta_left_img, cons.consistent)

    rv_l = sw(left_pad, gamma_c=cfg.ref_gamma_c, gamma_p=cfg.ref_gamma_p)
    rv_r = sw(right_pad, gamma_c=cfg.ref_gamma_c, gamma_p=cfg.ref_gamma_p)
    rh_l = ops.support_weights(left, R, cfg.ref_gamma_c, cfg.ref_gamma_p, 1)
    rh_r = ops.support_weights(right, R, cfg.ref_gamma_c, cfg.ref_gamma_p, 1)

    filled_q, right_q = cons.filled, wta_right_img * cfg.d_max
    conf_ref, conf_tar = cons.conf_ref, cons.conf_target
    for _ in range(cfg.k_iters):
        # One exchange for the four maps of a round, stacked.
        fq_pad, rq_pad, cr_pad, ct_pad = exchange(
            torch.stack([filled_q, right_q, conf_ref, conf_tar]), R,
            row_group, axis=1)
        vv_l, dv_l = ops.refine_pass_v_win(rv_l, fq_pad, cr_pad, eps)
        val_l, den_l = ops.refine_pass_h(rh_l, vv_l, dv_l, conf_ref, R, eps)
        vv_r, dv_r = ops.refine_pass_v_win(rv_r, rq_pad, ct_pad, eps)
        val_r, den_r = ops.refine_pass_h(rh_r, vv_r, dv_r, conf_tar, R, eps)
        r = wta_refined_sharded(aggr, d0, d_local, d_pad, disp_group, val_l,
                                den_l, val_r, den_r, cfg.penalty, cfg.big,
                                cfg.kernels)
        if cfg.wta_ref_conf_bug:
            new_conf_ref, new_conf_tar = r.conf_target, conf_tar
        else:
            new_conf_ref, new_conf_tar = r.conf_ref, r.conf_target
        left_img = _to_image(r.disp_ref, cfg)
        right_q = _to_image(r.disp_target, cfg) * cfg.d_max
        c = ops.consistency(left_img * cfg.d_max, right_q, new_conf_ref,
                            new_conf_tar)
        red_post = ops.red_diagnostic(left_img, c.consistent)
        filled_q, conf_ref, conf_tar = c.filled, c.conf_ref, c.conf_target

    filled_img = (ops.image_from_q(filled_q, cfg.d_max) if cfg.quantize_maps
                  else ops.to_unit(filled_q, cfg.d_max))
    disparity = median3x3_tiled(exchange(filled_img, 1, row_group))
    return ShardedASWResult(disparity=disparity, filled=filled_img,
                            consistency_pre=red_pre, consistency_post=red_post,
                            wta_left=wta_left_img, wta_right=wta_right_img)


def make_asw_sharded(cfg: StereoConfig, mesh, halo_mode: str = "exchange"):
    """The sharded ASW pipeline over `mesh` (parallel.build_mesh).

    Returns f(left, right): every rank passes the global (B, H, W, 3)
    pair, on its device, and gets its own (B / batch, H / row, W[, 3])
    block of each map (the disp shards of a block get identical blocks;
    parallel.gather_blocks assembles the full maps).  Raises unless B and
    H divide over the batch and row shards.

    halo_mode: "exchange" (default) trades real neighbour halos; "local"
    edge-pads instead -- the same compute, no communication, wrong seam
    values -- to isolate the row axis's share (see _local_halo)."""
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
        frames = [_asw_tile(l, r, cfg, sh.row * h_loc, left.shape[1], d0,
                            d_local, d_pad, sh.row_group, sh.disp_group,
                            exchange)
                  for l, r in zip(lb, rb)]
        return ShardedASWResult(*(torch.stack(m) for m in zip(*frames)))

    return f
