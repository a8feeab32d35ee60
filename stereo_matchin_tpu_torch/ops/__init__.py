"""Plain PyTorch ops of the ASW and cross paths, module for module beside
`stereo_matchin_tpu.ops`, with the same (D, H, W) / (T, H, W) layouts.

They run on any device.  The ASW aggregation, SAD cost (`sad_cost`), WTA,
support, refinement and median entry points also take `kernels` ("auto"
| "jnp" | "pallas"), and the cross aggregation and vote take `impl`
(StereoConfig.oii_impl); both route CUDA tensors through the hand-written
kernels of `stereo_matchin_tpu_torch.kernels`.
"""

from .aggregation import (asw_aggregate, asw_aggregate_pass, asw_den_plain,
                          asw_levels, asw_pass_plain, asw_pass_win_plain)
from .asw2d import asw_aggregate_2d
from .common import (disparity_to_image, edge_pad, image_from_q, shift_axis,
                     to_unit, unorm8_code, unorm8_level)
from .consistency import ConsistencyResult, consistency, red_diagnostic
from .cost import sad_cost, sad_cost_volume, shifted_columns
from .cross import cross_arms
from .median import median3x3, median3x3_plain, median_dispatch_truncate
from .oii import combined_arms, cross_aggregate, oii_pass_plain
from .refinement import (refine_pass_h, refine_pass_v, refine_pass_v_win,
                         refine_view, refinement_weights)
from .support import support_weights
from .vote import (histogram_vote, vote_counts_plain, vote_indices,
                   vote_mode_plain)
from .wta import WTAResult, epipolar_target_scan, two_min_scan, wta_argmin
from .wta_fast import wta_fast, wta_refined_fast

__all__ = [
    "ConsistencyResult",
    "WTAResult",
    "asw_aggregate",
    "asw_aggregate_2d",
    "asw_aggregate_pass",
    "asw_den_plain",
    "asw_levels",
    "asw_pass_plain",
    "asw_pass_win_plain",
    "combined_arms",
    "consistency",
    "cross_aggregate",
    "cross_arms",
    "disparity_to_image",
    "edge_pad",
    "epipolar_target_scan",
    "histogram_vote",
    "image_from_q",
    "median3x3",
    "median3x3_plain",
    "median_dispatch_truncate",
    "oii_pass_plain",
    "red_diagnostic",
    "refine_pass_h",
    "refine_pass_v",
    "refine_pass_v_win",
    "refine_view",
    "refinement_weights",
    "sad_cost",
    "sad_cost_volume",
    "shift_axis",
    "shifted_columns",
    "support_weights",
    "to_unit",
    "two_min_scan",
    "unorm8_code",
    "unorm8_level",
    "vote_counts_plain",
    "vote_indices",
    "vote_mode_plain",
    "wta_argmin",
    "wta_fast",
    "wta_refined_fast",
]
