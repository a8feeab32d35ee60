"""Cross-based OII stereo pipeline (Zhang/Lu/Lafruit 2009), end to end;
PyTorch port of `stereo_matchin_tpu/models/cross_based.py`
(`cross_pipeline_impl`, the stage functions and `cross_pipeline_staged`).

Reference driver: main.cpp:219-411 -- Median(L, R) -> Cross(L, R) ->
Aggregation -> Integral_h -> Oii_hcross -> Integral_v -> Oii_vcross ->
Init_disparity -> Disparity (vote) -> Median.

Everything runs on the device of the input tensors.  cfg.oii_impl picks
the route (kernels.oii_route): on "kernels" the arms, the SAD volume, both
OII passes and the vote run as the CUDA kernels K5-K8;
"taps" runs their plain versions in the same sum order, so both give the
same bits; "prefix" sums through integral images like the reference.
cfg.kernels routes the three medians (K12 or the plain ops,
kernels.use_kernels).

The frame is a chain of stage functions (`_median_stage` ..
`_vote_stage`, the JAX package's names), each a plain function on tensors;
`cross_pipeline_staged` runs them through a `run(name, fn, *args)`
callable (bench.harness.StageTimer.run times each one) and
`cross_pipeline_impl` is that chain untimed, so the two cannot drift.
`cross_pipeline` replays `cross_pipeline_impl` from a CUDA graph captured
once per signature (utils.graphs), as the JAX package runs the whole
chain as one XLA program (`cross_pipeline_fused`).  Where the JAX package
jits each stage function, the port replays a graph per stage signature:
`cross_pipeline_staged(left, right, cfg, run=utils.replay_stage)`, as
bench.harness runs it on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import StereoConfig
from .. import ops
from ..kernels import oii_route
from ..utils import graphs
from ..utils.profiling import call_stage


class CrossResult(NamedTuple):
    initial: torch.Tensor       # (H, W) stored image value in [0,1] (cross_based_initial.png)
    final: torch.Tensor         # (H, W) stored image value in [0,1] (cross_based_disparity.png)
    median_left: torch.Tensor   # (H, W, 3) median-filtered left (median.png)


def _median_stage(img, kernels: str):
    return ops.median3x3(img, kernels)


def _trunc_stage(img):
    # The reference's truncated Median dispatch leaves the bottom H mod 3
    # rows and right W mod 3 columns of its uninitialised median images
    # unwritten, zero on the golden device (main.cpp:193,245-246,354).
    return ops.median_dispatch_truncate(img)


def _arms_stage(img, arm_len: int, tau: float, quirk: bool, route: str):
    if route == "kernels":
        from ..kernels.cross_oii import cross_arms

        return cross_arms(img, arm_len, tau, quirk)
    return ops.cross_arms(img, arm_len, tau, quirk)


def _sad_stage(ml, mr, num_disp: int, route: str):
    if route == "kernels":
        from ..kernels.sad_volume import sad_volume

        return sad_volume(ml, mr, num_disp)
    return ops.sad_cost_volume(ml, mr, num_disp)              # [0,1] scale


def _aggr_stage(cost, arms_l, arms_r, arm_len: int, impl: str):
    return ops.cross_aggregate(cost, arms_l, arms_r, arm_len, impl=impl)


def _init_stage(aggr, d_max: int, quantize: bool):
    return ops.disparity_to_image(ops.wta_argmin(aggr), d_max, quantize)


def _vote_stage(initial, arms_l, d_max: int, quantize: bool, arm_len: int,
                impl: str, kernels: str):
    voted = ops.histogram_vote(initial, arms_l, d_max, quantize=quantize,
                               arm_len=arm_len, impl=impl)
    return ops.median3x3(voted, kernels)


def cross_pipeline_staged(left: torch.Tensor, right: torch.Tensor,
                          cfg: StereoConfig, run=call_stage) -> CrossResult:
    """The frame as its stages, each through run(name, fn, *args) under
    the reference TSV's column names; the median-truncate quirk runs
    outside any column, as in the JAX harness.  run=utils.replay_stage
    replays each stage from its CUDA graph on the card, as the JAX
    package's stage jits run; the default, utils.call_stage, keeps the
    chain eager for cross_pipeline_impl, which cross_pipeline captures
    whole."""
    if left.shape != right.shape or left.dim() != 3 or left.shape[2] != 3:
        raise ValueError(f"need two (H, W, 3) images, got {tuple(left.shape)} "
                         f"and {tuple(right.shape)}")
    route = oii_route(cfg.oii_impl, left)
    ml = run("medL_solo", _median_stage, left, cfg.kernels)
    mr = run("medR_solo", _median_stage, right, cfg.kernels)
    if cfg.median_dispatch_quirk:
        ml, mr = _trunc_stage(ml), _trunc_stage(mr)
    arms_l = run("cross_h", _arms_stage, ml, cfg.arm_len, cfg.tau,
                 cfg.legacy_cross_arm_quirk, route)
    arms_r = run("cross_v", _arms_stage, mr, cfg.arm_len, cfg.tau,
                 cfg.legacy_cross_arm_quirk, route)
    cost = run("aggregation", _sad_stage, ml, mr, cfg.num_disp, route)
    aggr = run("aggr_h", _aggr_stage, cost, arms_l, arms_r, cfg.arm_len,
               cfg.oii_impl)
    initial = run("init_disp", _init_stage, aggr, cfg.d_max,
                  cfg.quantize_maps)
    final = run("final_disp", _vote_stage, initial, arms_l, cfg.d_max,
                cfg.quantize_maps, cfg.arm_len, cfg.oii_impl, cfg.kernels)
    if cfg.median_dispatch_quirk:
        final = _trunc_stage(final)
    return CrossResult(initial=initial, final=final, median_left=ml)


def cross_pipeline_impl(left: torch.Tensor, right: torch.Tensor,
                        cfg: StereoConfig) -> CrossResult:
    """The frame as a chain of eager ops: cross_pipeline_staged untimed.
    left/right: (H, W, 3) float32 in [0, 1] on the UNORM8 grid, on one
    device."""
    return cross_pipeline_staged(left, right, cfg)


def cross_pipeline(left: torch.Tensor, right: torch.Tensor,
                   cfg: StereoConfig) -> CrossResult:
    """cross_pipeline_impl(left, right, cfg), captured once per signature
    (shapes, dtype, device, cfg) as a CUDA graph and replayed on CUDA
    tensors (utils.graphs); called directly on CPU tensors.  Each call
    returns fresh tensors."""
    return graphs.replay(cross_pipeline_impl, (left, right), (cfg,))
