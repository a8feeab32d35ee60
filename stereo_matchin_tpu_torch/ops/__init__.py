"""Plain PyTorch ops of the ASW path, module for module beside
`stereo_matchin_tpu.ops`, with the same (D, H, W) / (T, H, W) layouts.

They run on any device.  The aggregation and WTA entry points also take
`kernels` ("auto" | "jnp" | "pallas") and route CUDA tensors through the
hand-written kernels of `stereo_matchin_tpu_torch.kernels`.
"""

from .aggregation import (asw_aggregate, asw_aggregate_pass, asw_den_plain,
                          asw_pass_plain)
from .common import (disparity_to_image, edge_pad, image_from_q, shift_axis,
                     to_unit, unorm8_code, unorm8_level)
from .consistency import ConsistencyResult, consistency, red_diagnostic
from .cost import sad_cost_volume, shifted_columns
from .median import median3x3, median_dispatch_truncate
from .refinement import (refine_pass_h, refine_pass_v, refine_view,
                         refinement_weights)
from .support import support_weights
from .wta import WTAResult, epipolar_target_scan, two_min_scan
from .wta_fast import wta_fast, wta_refined_fast

__all__ = [
    "ConsistencyResult",
    "WTAResult",
    "asw_aggregate",
    "asw_aggregate_pass",
    "asw_den_plain",
    "asw_pass_plain",
    "consistency",
    "disparity_to_image",
    "edge_pad",
    "epipolar_target_scan",
    "image_from_q",
    "median3x3",
    "median_dispatch_truncate",
    "red_diagnostic",
    "refine_pass_h",
    "refine_pass_v",
    "refine_view",
    "refinement_weights",
    "sad_cost_volume",
    "shift_axis",
    "shifted_columns",
    "support_weights",
    "to_unit",
    "two_min_scan",
    "unorm8_code",
    "unorm8_level",
    "wta_fast",
    "wta_refined_fast",
]
