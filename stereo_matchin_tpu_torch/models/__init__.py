"""End-to-end pipelines of the port: the ASW method (models.asw) and the
cross-based method (models.cross_based).  `asw_pipeline`, `cross_pipeline`,
`asw_pipeline_batched` and `asw_pipeline_debug` replay CUDA graphs on the
card (utils.graphs); `asw_pipeline_impl`, `cross_pipeline_impl` and
`asw_pipeline_debug_impl` are their eager chains.  The band drivers
(models.tiled `asw_pipeline_tiled`, `cross_pipeline_tiled`, and the
wavefront drivers they route to) replay each band step from a CUDA graph
on the card, the interior bands from one; `run=utils.call_stage` runs the
steps eagerly."""

from .asw import (ASWDebug, ASWResult, ASWWeights, asw_pipeline,
                  asw_pipeline_batched, asw_pipeline_debug,
                  asw_pipeline_debug_from_weights, asw_pipeline_debug_impl,
                  asw_pipeline_from_weights, asw_pipeline_impl, asw_weights)
from .cross_based import (CrossResult, cross_pipeline, cross_pipeline_impl,
                          cross_pipeline_staged)

__all__ = ["ASWDebug", "ASWResult", "ASWWeights", "CrossResult",
           "asw_pipeline", "asw_pipeline_batched", "asw_pipeline_debug",
           "asw_pipeline_debug_from_weights", "asw_pipeline_debug_impl",
           "asw_pipeline_from_weights", "asw_pipeline_impl", "asw_weights",
           "cross_pipeline", "cross_pipeline_impl", "cross_pipeline_staged"]
