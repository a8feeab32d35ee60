"""End-to-end pipelines of the port: the ASW method (models.asw) and the
cross-based method (models.cross_based)."""

from .asw import (ASWResult, ASWWeights, asw_pipeline,
                  asw_pipeline_from_weights, asw_weights)
from .cross_based import CrossResult, cross_pipeline

__all__ = ["ASWResult", "ASWWeights", "CrossResult", "asw_pipeline",
           "asw_pipeline_from_weights", "asw_weights", "cross_pipeline"]
