"""Disparity-map quality metrics and golden-image regression; the port's
own copy of `stereo_matchin_tpu/eval/metrics.py` (numpy only), held equal
to it by tests/test_torch_standalone.py.

The reference's verification was visual plus offline bad-pixel rates
against Middlebury ground truth (thesis PDF p.34; SURVEY.md §4).  This
module gives both: the bad-pixel percentage between any two maps, and
comparisons against the reference's stored artifacts
(`cross_based_initial.png`, `cross_based_disparity.png`,
`asw_disparity.png`), which lie in the reference checkout: a golden
resolves only through the pair registry, under $STEREO_REFERENCE_ROOT.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class MapComparison:
    exact_pct: float     # |d_got - d_ref| < 0.5  (on the disparity scale)
    bad1_pct: float      # |d_got - d_ref| > 1.0
    bad2_pct: float      # |d_got - d_ref| > 2.0
    mean_abs: float

    def __str__(self):
        return (f"exact={self.exact_pct:.2f}% bad1={self.bad1_pct:.2f}% "
                f"bad2={self.bad2_pct:.2f}% meanabs={self.mean_abs:.3f}")


def compare_maps(got, ref, d_max: int = 60, mask=None) -> MapComparison:
    """got/ref: (H, W) stored image values in [0,1] OR disparities when
    d_max=1.  Differences are evaluated on the [0, d_max] scale."""
    g = np.asarray(got, np.float64) * d_max
    r = np.asarray(ref, np.float64) * d_max
    diff = np.abs(g - r)
    if mask is not None:
        diff = diff[np.asarray(mask)]
    return MapComparison(
        exact_pct=float(np.mean(diff < 0.5) * 100.0),
        bad1_pct=float(np.mean(diff > 1.0) * 100.0),
        bad2_pct=float(np.mean(diff > 2.0) * 100.0),
        mean_abs=float(diff.mean()),
    )


def bad_pixel_pct(got_disp, gt_disp, threshold: float = 2.0, mask=None) -> float:
    """Classic Middlebury bad-pixel rate: % of pixels whose absolute
    disparity error exceeds `threshold` (both inputs on the same scale)."""
    diff = np.abs(np.asarray(got_disp, np.float64) - np.asarray(gt_disp, np.float64))
    if mask is not None:
        diff = diff[np.asarray(mask)]
    return float(np.mean(diff > threshold) * 100.0)


def golden_path(pair_name: str, artifact: str) -> str:
    """The stored artifact of a registered pair, under
    $STEREO_REFERENCE_ROOT/<pair>/; without the variable the registry
    raises a LookupError that names it."""
    from ..io.datasets import get_pair

    return os.path.join(get_pair(pair_name).golden_dir, artifact)


def compare_to_golden(got_img, pair_name: str, artifact: str,
                      d_max: int = 60) -> MapComparison:
    """Compare an (H, W) [0,1] map against a stored reference PNG."""
    from ..io import png

    gold = png.read_gray(golden_path(pair_name, artifact))
    return compare_maps(got_img, gold, d_max=d_max)
