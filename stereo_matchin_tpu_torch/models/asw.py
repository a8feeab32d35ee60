"""Iterative ASW stereo pipeline (Kowalczuk/Psota/Perez 2013), end to end;
PyTorch port of `stereo_matchin_tpu/models/asw.py` `asw_pipeline_impl`.

Reference driver: main.cpp:412-758 — asw_Aggr -> support weights ->
r x [vertical -> horizontal aggregation] -> WTA -> consistency ->
k x [refinement (L, R) -> WTA_REF -> consistency] -> median.

The support and refinement weights depend only on the input images, so
they are computed once (`asw_weights`) and handed to
`asw_pipeline_from_weights`; a test can hand in the JAX package's weights
instead (convert.weights_from_jax).  Everything runs on the device of the
input tensors; cfg.kernels picks the CUDA kernels or the plain ops for
the aggregation and the WTAs (see kernels.use_kernels).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereo_matchin_tpu.config import StereoConfig

from .. import ops


class ASWWeights(NamedTuple):
    """Support-weight strips, each (T, H, W) f32, T = 2*radius + 1."""
    wv_l: torch.Tensor   # aggregation, vertical taps, left view
    wh_l: torch.Tensor   # aggregation, horizontal taps, left view
    wv_r: torch.Tensor
    wh_r: torch.Tensor
    rv_l: torch.Tensor   # refinement gammas, vertical taps, left view
    rh_l: torch.Tensor
    rv_r: torch.Tensor
    rh_r: torch.Tensor


class ASWResult(NamedTuple):
    disparity: torch.Tensor         # (H, W) [0,1] image — asw_disparity.png (median-filtered)
    filled: torch.Tensor            # (H, W) [0,1] image — occlusion-filled, pre-median
    consistency_pre: torch.Tensor   # (H, W, 3) red diagnostic after initial WTA
    consistency_post: torch.Tensor  # (H, W, 3) red diagnostic after last refinement
    wta_left: torch.Tensor          # (H, W) [0,1] initial left WTA image
    wta_right: torch.Tensor         # (H, W) [0,1] initial derived right WTA image
    aggregated_cost: torch.Tensor   # (D, H, W) final aggregated volume


def asw_weights(left: torch.Tensor, right: torch.Tensor,
                cfg: StereoConfig) -> ASWWeights:
    """The eight weight strips of one frame, from the raw (H, W, 3) pair."""
    R = cfg.radius
    sw = ops.support_weights
    rv_l, rh_l = ops.refinement_weights(left, R, cfg.ref_gamma_c, cfg.ref_gamma_p)
    rv_r, rh_r = ops.refinement_weights(right, R, cfg.ref_gamma_c, cfg.ref_gamma_p)
    return ASWWeights(
        wv_l=sw(left, R, cfg.gamma_c, cfg.gamma_p, axis=0),
        wh_l=sw(left, R, cfg.gamma_c, cfg.gamma_p, axis=1),
        wv_r=sw(right, R, cfg.gamma_c, cfg.gamma_p, axis=0),
        wh_r=sw(right, R, cfg.gamma_c, cfg.gamma_p, axis=1),
        rv_l=rv_l, rh_l=rh_l, rv_r=rv_r, rh_r=rh_r)


def asw_pipeline(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig,
                 crop: tuple = (0, 0)) -> ASWResult:
    """left/right: (H, W, 3) float32 in [0, 1] on the UNORM8 grid, on one
    device (the ASW method never median-filters its inputs)."""
    if tuple(crop) != (0, 0):
        raise NotImplementedError(
            "crop is not ported yet (ROADMAP A9, band drivers)")
    return asw_pipeline_from_weights(left, right, asw_weights(left, right, cfg),
                                     cfg)


def _to_image(d, cfg: StereoConfig):
    return ops.disparity_to_image(d, cfg.d_max, cfg.quantize_maps)


def asw_pipeline_from_weights(left: torch.Tensor, right: torch.Tensor,
                              weights: ASWWeights,
                              cfg: StereoConfig) -> ASWResult:
    """The pipeline after the weights: SAD cost -> aggregation -> WTA ->
    consistency -> k refinement rounds -> median."""
    if cfg.aggr_d_chunks:
        raise NotImplementedError(
            "aggr_d_chunks is not ported yet (ROADMAP A9, band drivers)")
    if left.shape != right.shape or left.dim() != 3 or left.shape[2] != 3:
        raise ValueError(f"need two (H, W, 3) images, got {tuple(left.shape)} "
                         f"and {tuple(right.shape)}")
    R, kern = cfg.radius, cfg.kernels
    w = weights
    cost0 = ops.sad_cost_volume(left, right, cfg.num_disp, scale=255.0)
    aggr = ops.asw_aggregate(cost0, w.wv_l, w.wv_r, w.wh_l, w.wh_r, R,
                             cfg.r_iters, cfg.eps, kernels=kern)

    res = ops.wta_fast(aggr, big=cfg.big, kernels=kern)
    wta_left_img = _to_image(res.disp_ref, cfg)
    wta_right_img = _to_image(res.disp_target, cfg)
    # Consistency reads the images back * d_max (consist.cl:24-25).
    cons = ops.consistency(wta_left_img * cfg.d_max, wta_right_img * cfg.d_max,
                           res.conf_ref, res.conf_target)
    red_post = red_pre = ops.red_diagnostic(wta_left_img, cons.consistent)

    filled_q, right_q = cons.filled, wta_right_img * cfg.d_max
    conf_ref, conf_tar = cons.conf_ref, cons.conf_target
    for _ in range(cfg.k_iters):
        val_l, den_l = ops.refine_view(w.rv_l, w.rh_l, filled_q, conf_ref, R,
                                       cfg.eps)
        val_r, den_r = ops.refine_view(w.rv_r, w.rh_r, right_q, conf_tar, R,
                                       cfg.eps)
        r = ops.wta_refined_fast(aggr, val_l, den_l, val_r, den_r, cfg.penalty,
                                 big=cfg.big, kernels=kern)
        if cfg.wta_ref_conf_bug:
            # asw_wta_ref.cl:63-66: the reference confidence gets the TARGET
            # confidence; the target buffer keeps its previous value.
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
    return ASWResult(
        disparity=ops.median3x3(filled_img),
        filled=filled_img,
        consistency_pre=red_pre,
        consistency_post=red_post,
        wta_left=wta_left_img,
        wta_right=wta_right_img,
        aggregated_cost=aggr,
    )
