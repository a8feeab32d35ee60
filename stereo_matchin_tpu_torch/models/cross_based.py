"""Cross-based OII stereo pipeline (Zhang/Lu/Lafruit 2009), end to end;
PyTorch port of `stereo_matchin_tpu/models/cross_based.py`
`cross_pipeline_impl`.

Reference driver: main.cpp:219-411 -- Median(L, R) -> Cross(L, R) ->
Aggregation -> Integral_h -> Oii_hcross -> Integral_v -> Oii_vcross ->
Init_disparity -> Disparity (vote) -> Median.

Everything runs on the device of the input tensors.  cfg.oii_impl picks
the route (kernels.oii_route): on "kernels" the arms, the SAD volume, both
OII passes and the vote run as the CUDA kernels K5-K8; "taps" runs their
plain versions in the same sum order, so both give the same bits;
"prefix" sums through integral images like the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import StereoConfig
from .. import ops
from ..kernels import oii_route


class CrossResult(NamedTuple):
    initial: torch.Tensor       # (H, W) stored image value in [0,1] (cross_based_initial.png)
    final: torch.Tensor         # (H, W) stored image value in [0,1] (cross_based_disparity.png)
    median_left: torch.Tensor   # (H, W, 3) median-filtered left (median.png)


def cross_pipeline(left: torch.Tensor, right: torch.Tensor,
                   cfg: StereoConfig) -> CrossResult:
    """left/right: (H, W, 3) float32 in [0, 1] on the UNORM8 grid, on one
    device."""
    if left.shape != right.shape or left.dim() != 3 or left.shape[2] != 3:
        raise ValueError(f"need two (H, W, 3) images, got {tuple(left.shape)} "
                         f"and {tuple(right.shape)}")
    route = oii_route(cfg.oii_impl, left)
    ml = ops.median3x3(left)
    mr = ops.median3x3(right)
    if cfg.median_dispatch_quirk:
        # The reference's truncated Median dispatch leaves the bottom H mod 3
        # rows and right W mod 3 columns of its uninitialised median images
        # unwritten, zero on the golden device (main.cpp:193,245-246).
        ml = ops.median_dispatch_truncate(ml)
        mr = ops.median_dispatch_truncate(mr)
    if route == "kernels":
        from ..kernels.cross_oii import cross_arms
        from ..kernels.sad_volume import sad_volume
    else:
        cross_arms, sad_volume = ops.cross_arms, ops.sad_cost_volume
    arms_l = cross_arms(ml, cfg.arm_len, cfg.tau, cfg.legacy_cross_arm_quirk)
    arms_r = cross_arms(mr, cfg.arm_len, cfg.tau, cfg.legacy_cross_arm_quirk)
    cost = sad_volume(ml, mr, cfg.num_disp)                  # [0,1] scale
    aggr = ops.cross_aggregate(cost, arms_l, arms_r, cfg.arm_len,
                               impl=cfg.oii_impl)
    initial = ops.disparity_to_image(ops.wta_argmin(aggr), cfg.d_max,
                                     cfg.quantize_maps)
    voted = ops.histogram_vote(initial, arms_l, cfg.d_max,
                               quantize=cfg.quantize_maps, arm_len=cfg.arm_len,
                               impl=cfg.oii_impl)
    final = ops.median3x3(voted)
    if cfg.median_dispatch_quirk:
        # The final median (main.cpp:354) runs on the same truncated size.
        final = ops.median_dispatch_truncate(final)
    return CrossResult(initial=initial, final=final, median_left=ml)
