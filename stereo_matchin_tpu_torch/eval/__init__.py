"""Quality metrics, golden-image regression and synthetic scenes with a
known disparity."""

from .metrics import (MapComparison, bad_pixel_pct, compare_maps,
                      compare_to_golden, golden_path)
from .synthetic import synthetic_scene

__all__ = ["MapComparison", "bad_pixel_pct", "compare_maps",
           "compare_to_golden", "golden_path", "synthetic_scene"]
