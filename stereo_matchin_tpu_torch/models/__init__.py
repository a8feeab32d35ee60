"""End-to-end pipelines of the port (the ASW method so far)."""

from .asw import (ASWResult, ASWWeights, asw_pipeline,
                  asw_pipeline_from_weights, asw_weights)

__all__ = ["ASWResult", "ASWWeights", "asw_pipeline",
           "asw_pipeline_from_weights", "asw_weights"]
