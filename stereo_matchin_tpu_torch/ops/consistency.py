"""Left/right consistency check with occlusion filling; PyTorch port of
`stereo_matchin_tpu/ops/consistency.py` (reference kernels/consist.cl).

A pixel is consistent when |d_ref - d_target| < 1.001 on the [0, d_max]
scale; inconsistent pixels get both confidences zeroed and the filled
map takes the target value there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ConsistencyResult(NamedTuple):
    filled: torch.Tensor       # (H, W) disparity in [0, d_max], occlusion-filled
    conf_ref: torch.Tensor     # (H, W) confidence, zeroed where inconsistent
    conf_target: torch.Tensor  # (H, W)
    consistent: torch.Tensor   # (H, W) bool — for the red diagnostic image


def consistency(d_ref, d_target, conf_ref, conf_target,
                threshold: float = 1.001) -> ConsistencyResult:
    """d_ref / d_target: (H, W) disparities on the [0, d_max] scale."""
    consistent = (d_target - d_ref).abs() < threshold
    filled = torch.where(consistent, d_ref, d_target)
    new_conf_ref = torch.where(consistent, conf_ref, 0.0)
    new_conf_target = torch.where(consistent, conf_target, 0.0)
    return ConsistencyResult(filled, new_conf_ref, new_conf_target, consistent)


def red_diagnostic(d_img, consistent):
    """(H, W, 3) image: the stored [0, 1] disparity value where consistent,
    pure red where not (consist.cl:567-569,577)."""
    r = torch.where(consistent, d_img, 1.0)
    g = torch.where(consistent, d_img, 0.0)
    return torch.stack([r, g, g], dim=-1)
