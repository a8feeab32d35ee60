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
the weight strips (K9), the SAD cost (K6), the aggregation (K1/K2), the
WTAs (K3/K4 and their epilogue K11), the refinement passes (K10) and the
median (K12) (see kernels.use_kernels).

cfg.aggr_d_chunks = n runs the SAD cost and the aggregation ladder per
disparity chunk of ceil(D / n) planes (`_chunk_geometry`), so the (D, H, W)
volumes of the ladder never coexist; `crop` sheds rows right after the
aggregation for the band drivers (models/tiled.py, models/wavefront.py).
Neither changes a value of the rows kept.

Every stage of a frame goes through a `run(name, fn, *args)` callable
under the reference TSV's stage names (utils.call_stage by default;
bench.harness.StageTimer.run times them).  `asw_pipeline_debug` keeps
every round's WTA maps, as the reference's debug build dumps them, and
`asw_pipeline_batched` runs (B, H, W, 3) pairs frame by frame.

`asw_pipeline_impl` is the frame as eager ops; `asw_pipeline` (and so
`asw_pipeline_batched`) replays it from a CUDA graph captured once per
signature (utils.graphs), as the JAX package jits asw_pipeline_impl.
`asw_pipeline_debug` replays `asw_pipeline_debug_impl` the same way.
`asw_pipeline_from_weights` and `asw_pipeline_debug_from_weights` stay
eager; their stages replay stage graphs where the caller passes
utils.graphs.replay_stage as `run`, as bench.harness does.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from ..config import StereoConfig
from .. import ops
from ..utils import graphs
from ..utils.profiling import call_stage


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


def asw_weights(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig,
                run=call_stage) -> ASWWeights:
    """The eight weight strips of one frame, from the raw (H, W, 3) pair:
    the support strips as stage "supp_w", the refinement strips as
    "ref_w" (a stage outside the reference's columns)."""
    R = cfg.radius
    ref = (R, cfg.ref_gamma_c, cfg.ref_gamma_p)
    sup = (R, cfg.gamma_c, cfg.gamma_p)
    refinement_weights = partial(ops.refinement_weights, kernels=cfg.kernels)
    support_weights = partial(ops.support_weights, kernels=cfg.kernels)
    rv_l, rh_l = run("ref_w", refinement_weights, left, *ref)
    rv_r, rh_r = run("ref_w", refinement_weights, right, *ref)
    return ASWWeights(
        wv_l=run("supp_w", support_weights, left, *sup, 0),
        wh_l=run("supp_w", support_weights, left, *sup, 1),
        wv_r=run("supp_w", support_weights, right, *sup, 0),
        wh_r=run("supp_w", support_weights, right, *sup, 1),
        rv_l=rv_l, rh_l=rh_l, rv_r=rv_r, rh_r=rh_r)


def asw_pipeline_impl(left: torch.Tensor, right: torch.Tensor,
                      cfg: StereoConfig, crop: tuple = (0, 0)) -> ASWResult:
    """The frame as a chain of eager ops (the JAX package's
    asw_pipeline_impl); `asw_pipeline` replays it from a CUDA graph.

    left/right: (H, W, 3) float32 in [0, 1] on the UNORM8 grid, on one
    device (the ASW method never median-filters its inputs).

    crop=(top, bottom): drop that many rows right after the aggregation
    (the JAX package's asw_pipeline_impl contract): the result covers rows
    top .. H - bottom, and rows within k*radius + 1 of a cropped edge see
    clamped refinement reads, so a band driver keeps only rows past them."""
    return asw_pipeline_from_weights(left, right, asw_weights(left, right, cfg),
                                     cfg, crop)


def asw_pipeline(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig,
                 crop: tuple = (0, 0)) -> ASWResult:
    """asw_pipeline_impl(left, right, cfg, crop), captured once per
    signature (shapes, dtype, device, cfg, crop) as a CUDA graph and
    replayed on CUDA tensors (utils.graphs), as the JAX package jits it;
    called directly on CPU tensors.  Each call returns fresh tensors."""
    return graphs.replay(asw_pipeline_impl, (left, right), (cfg, tuple(crop)))


def _to_image(d, cfg: StereoConfig):
    return ops.disparity_to_image(d, cfg.d_max, cfg.quantize_maps)


def _chunk_geometry(D: int, n_chunks: int):
    """Chunks of ceil(D / n) planes; the last may be smaller (planes past D
    are never computed).  Returns (chunk, number of chunks)."""
    chunk = -(-D // max(n_chunks, 1))
    return chunk, -(-D // chunk)


def _check_pair(left, right):
    if left.shape != right.shape or left.dim() != 3 or left.shape[2] != 3:
        raise ValueError(f"need two (H, W, 3) images, got {tuple(left.shape)} "
                         f"and {tuple(right.shape)}")


def ladder_levels(left: torch.Tensor, right: torch.Tensor, w: ASWWeights,
                  cfg: StereoConfig, run=call_stage):
    """SAD cost -> r x (vertical, horizontal) passes (ops.asw_levels), per
    disparity chunk (cfg.aggr_d_chunks; 0 = one chunk).  Each chunk builds
    its cost planes d0 .. d0 + n - 1 from the images and runs the ladder
    with its offset d0 (on CUDA: K1/K2 with d0).  Yields (d0, j, c) for
    every chunk and level j = 0 .. r, c the chunk's (n, H, W) SAD cost
    (j = 0, stage "aggr", the reference's asw_Aggr) or output of level
    j.  The vertical passes run as stage "v_aggr", the horizontal ones as
    "h_aggr", each axis's denominator (K1) first in its stage."""
    D = cfg.num_disp
    chunk, _ = _chunk_geometry(D, cfg.aggr_d_chunks)
    for d0 in range(0, D, chunk):
        n = min(chunk, D - d0)
        levels = ops.asw_levels(run("aggr", ops.sad_cost, left, right, n,
                                    255.0, d0, cfg.kernels),
                                w.wv_l, w.wv_r, w.wh_l, w.wh_r, cfg.radius,
                                cfg.r_iters, cfg.eps, kernels=cfg.kernels,
                                d0=d0, run_v=partial(run, "v_aggr"),
                                run_h=partial(run, "h_aggr"))
        for j, c in enumerate(levels):
            yield d0, j, c
        # Free the chunk before the next chunk's cost is built (on the
        # plain route its SAD temporaries; K6 builds none).
        del c


def aggregate(left: torch.Tensor, right: torch.Tensor, weights: ASWWeights,
              cfg: StereoConfig, crop: tuple = (0, 0),
              run=call_stage) -> torch.Tensor:
    """The aggregated (D, H', W) volume (`ladder_levels`' last level); each
    chunk sheds the crop rows before it lands in the result."""
    _check_pair(left, right)
    D, H, W = cfg.num_disp, left.shape[0], left.shape[1]
    c_top, c_bot = crop
    if c_top < 0 or c_bot < 0 or c_top + c_bot >= H:
        raise ValueError(f"crop {tuple(crop)} leaves no rows of {H}")
    out = None
    for d0, j, c in ladder_levels(left, right, weights, cfg, run):
        if j < cfg.r_iters:
            continue
        c = c[:, c_top:H - c_bot]
        if c.shape[0] == D:                  # one chunk
            return c.contiguous()
        if out is None:
            out = torch.empty((D, H - c_top - c_bot, W), dtype=c.dtype,
                              device=c.device)
        out[d0:d0 + c.shape[0]] = c
        del c                                # see ladder_levels
    return out


def asw_pipeline_from_weights(left: torch.Tensor, right: torch.Tensor,
                              weights: ASWWeights, cfg: StereoConfig,
                              crop: tuple = (0, 0),
                              run=call_stage) -> ASWResult:
    """The pipeline after the weights: SAD cost -> aggregation -> WTA ->
    consistency -> k refinement rounds -> median, each stage through
    run(name, fn, *args) under the reference TSV's stage names
    (bench.harness.StageTimer.run times them)."""
    aggr = aggregate(left, right, weights, cfg, crop, run)
    return asw_postaggregate(aggr, weights, cfg, crop, run)


def asw_postaggregate(aggr: torch.Tensor, weights: ASWWeights,
                      cfg: StereoConfig, crop: tuple = (0, 0),
                      run=call_stage) -> ASWResult:
    """Everything after the aggregation: WTA -> consistency -> k refinement
    rounds -> median (main.cpp:516-614); the JAX package's
    asw_postaggregate_impl.  `aggr` is (D, H', W) with `crop` rows already
    shed relative to the weights' H rows.  The refinement weights come from
    the uncropped images and are cropped with the volume: computed on
    cropped images they would be wrong within radius of the cut."""
    R, kern = cfg.radius, cfg.kernels
    c_top, c_bot = crop
    H = weights.rv_l.shape[1]
    if aggr.shape[1] != H - c_top - c_bot:
        raise ValueError(f"aggr has {aggr.shape[1]} rows; weights of {H} rows "
                         f"cropped by {tuple(crop)} give {H - c_top - c_bot}")
    rv_l, rh_l, rv_r, rh_r = (w[:, c_top:H - c_bot] for w in (
        weights.rv_l, weights.rh_l, weights.rv_r, weights.rh_r))

    res = run("wta", partial(ops.wta_fast, big=cfg.big, kernels=kern), aggr)
    wta_left_img = _to_image(res.disp_ref, cfg)
    wta_right_img = _to_image(res.disp_target, cfg)
    # Consistency reads the images back * d_max (consist.cl:24-25).
    cons = run("consistency", ops.consistency, wta_left_img * cfg.d_max,
               wta_right_img * cfg.d_max, res.conf_ref, res.conf_target)
    red_post = red_pre = ops.red_diagnostic(wta_left_img, cons.consistent)

    filled_q, right_q = cons.filled, wta_right_img * cfg.d_max
    conf_ref, conf_tar = cons.conf_ref, cons.conf_target
    wta_refined = partial(ops.wta_refined_fast, big=cfg.big, kernels=kern)
    refine_v = partial(ops.refine_pass_v, kernels=kern)
    refine_h = partial(ops.refine_pass_h, kernels=kern)
    for _ in range(cfg.k_iters):
        # ops.refine_view's two passes, one stage each.
        vv_l, dv_l = run("v_ref_L", refine_v, rv_l, filled_q, conf_ref, R,
                         cfg.eps)
        val_l, den_l = run("h_ref_L", refine_h, rh_l, vv_l, dv_l, conf_ref,
                           R, cfg.eps)
        vv_r, dv_r = run("v_ref_R", refine_v, rv_r, right_q, conf_tar, R,
                         cfg.eps)
        val_r, den_r = run("h_ref_R", refine_h, rh_r, vv_r, dv_r, conf_tar,
                           R, cfg.eps)
        r = run("wta_ref", wta_refined, aggr, val_l, den_l, val_r, den_r,
                cfg.penalty)
        if cfg.wta_ref_conf_bug:
            # asw_wta_ref.cl:63-66: the reference confidence gets the TARGET
            # confidence; the target buffer keeps its previous value.
            new_conf_ref, new_conf_tar = r.conf_target, conf_tar
        else:
            new_conf_ref, new_conf_tar = r.conf_ref, r.conf_target
        left_img = _to_image(r.disp_ref, cfg)
        right_q = _to_image(r.disp_target, cfg) * cfg.d_max
        c = run("consistency_ref", ops.consistency, left_img * cfg.d_max,
                right_q, new_conf_ref, new_conf_tar)
        red_post = ops.red_diagnostic(left_img, c.consistent)
        filled_q, conf_ref, conf_tar = c.filled, c.conf_ref, c.conf_target

    filled_img = (ops.image_from_q(filled_q, cfg.d_max) if cfg.quantize_maps
                  else ops.to_unit(filled_q, cfg.d_max))
    return ASWResult(
        disparity=run("median", ops.median3x3, filled_img, kern),
        filled=filled_img,
        consistency_pre=red_pre,
        consistency_post=red_post,
        wta_left=wta_left_img,
        wta_right=wta_right_img,
        aggregated_cost=aggr,
    )


class ASWDebug(NamedTuple):
    """Per-stage captures mirroring the reference debug build's dumps
    under `stereo_matching/sukub/` (SURVEY.md §4.2): WTA maps after every
    aggregation round (`aggregation/{reference,target}/aggregation_i`),
    after every refinement round (`refinement/.../refinement_i`), the
    raw-cost WTA (`asw_raw_d.png`) and consistency diagnostics."""
    raw_wta_left: torch.Tensor       # (H, W) [0,1] WTA on the raw cost volume
    raw_wta_right: torch.Tensor
    aggr_wta_left: torch.Tensor      # (r, H, W) WTA after each v+h round
    aggr_wta_right: torch.Tensor
    refine_wta_left: torch.Tensor    # (k, H, W) WTA_REF after each round
    refine_wta_right: torch.Tensor
    consistency_red_pre: torch.Tensor  # (H, W, 3) after the initial WTA
    refine_reds: torch.Tensor          # (k, H, W, 3) per refinement round
    result: ASWResult


def _stack(maps: list, shape: tuple, like: torch.Tensor) -> torch.Tensor:
    """torch.stack, or an empty (0, *shape) stack for no rounds."""
    if maps:
        return torch.stack(maps)
    return like.new_empty((0,) + tuple(shape))


def asw_pipeline_debug_impl(left: torch.Tensor, right: torch.Tensor,
                            cfg: StereoConfig) -> ASWDebug:
    """asw_pipeline_impl with every round's WTA maps kept, as eager ops
    (the JAX package's asw_pipeline_debug_impl); `asw_pipeline_debug`
    replays it from a CUDA graph."""
    return asw_pipeline_debug_from_weights(left, right,
                                           asw_weights(left, right, cfg), cfg)


def asw_pipeline_debug(left: torch.Tensor, right: torch.Tensor,
                       cfg: StereoConfig) -> ASWDebug:
    """asw_pipeline_debug_impl(left, right, cfg), captured once per
    signature (shapes, dtype, device, cfg) as a CUDA graph and replayed on
    CUDA tensors (utils.graphs), as the JAX package jits it; called
    directly on CPU tensors.  Each call returns fresh tensors, the nested
    `result` included."""
    return graphs.replay(asw_pipeline_debug_impl, (left, right), (cfg,))


class _DebugRecorder:
    """Stage runner of asw_pipeline_debug: runs each stage and keeps what
    the debug captures need from its output -- a WTA of the raw cost
    ("aggr") and of each level ("h_aggr" after its denominator), and each
    refinement round's WTA_REF and consistency results."""

    def __init__(self, cfg: StereoConfig):
        self.wta = partial(ops.wta_fast, big=cfg.big, kernels=cfg.kernels)
        self.raw = None
        self.levels, self.refined, self.consistent = [], [], []
        self._den_h = False

    def run(self, name: str, fn, *args):
        out = fn(*args)
        if name == "aggr":
            self.raw = self.wta(out)
        elif name == "h_aggr" and not self._den_h:
            self._den_h = True
        elif name == "h_aggr":
            self.levels.append(self.wta(out))
        elif name == "wta_ref":
            self.refined.append(out)
        elif name == "consistency_ref":
            self.consistent.append(out.consistent)
        return out


def asw_pipeline_debug_from_weights(left: torch.Tensor, right: torch.Tensor,
                                    weights: ASWWeights,
                                    cfg: StereoConfig) -> ASWDebug:
    """The debug pipeline after the weights: asw_pipeline_from_weights
    with the volume as one chunk (cfg.aggr_d_chunks is ignored, as in the
    JAX package) and a stage runner that runs a WTA (K3/K4 on CUDA) on the
    raw cost and every level: 1 + r + 1 + k WTAs in all."""
    H, W = left.shape[:2]
    rec = _DebugRecorder(cfg)
    result = asw_pipeline_from_weights(left, right, weights,
                                       cfg.replace(aggr_d_chunks=0),
                                       run=rec.run)
    refine_l = [_to_image(r.disp_ref, cfg) for r in rec.refined]
    return ASWDebug(
        raw_wta_left=_to_image(rec.raw.disp_ref, cfg),
        raw_wta_right=_to_image(rec.raw.disp_target, cfg),
        aggr_wta_left=_stack([_to_image(r.disp_ref, cfg)
                              for r in rec.levels], (H, W), left),
        aggr_wta_right=_stack([_to_image(r.disp_target, cfg)
                               for r in rec.levels], (H, W), left),
        refine_wta_left=_stack(refine_l, (H, W), left),
        refine_wta_right=_stack([_to_image(r.disp_target, cfg)
                                 for r in rec.refined], (H, W), left),
        consistency_red_pre=result.consistency_pre,
        refine_reds=_stack([ops.red_diagnostic(img, c) for img, c in
                            zip(refine_l, rec.consistent)], (H, W, 3), left),
        result=result)


def asw_pipeline_batched(left: torch.Tensor, right: torch.Tensor,
                         cfg: StereoConfig) -> ASWResult:
    """(B, H, W, 3) pairs -> an ASWResult with a leading B on every field.
    Frames run in sequence, as the JAX package's lax.map runs them: on
    CUDA tensors each frame replays asw_pipeline's graph of one frame."""
    if left.shape != right.shape or left.dim() != 4:
        raise ValueError(f"need two (B, H, W, 3) batches, got "
                         f"{tuple(left.shape)} and {tuple(right.shape)}")
    frames = [asw_pipeline(l, r, cfg) for l, r in zip(left, right)]
    return ASWResult(*(torch.stack(f) for f in zip(*frames)))
