"""Multi-device layer: the (batch, row, disp) mesh, halo exchange and the
sharded ASW and cross pipelines, on torch.distributed with one process
per shard; the port of `stereo_matchin_tpu/parallel/`."""

from .mesh import (AXIS_BATCH, AXIS_DISP, AXIS_ROW, build_mesh, gather_blocks,
                   rank_device)
from .halo import crop_halo, exchange_halo
from .asw_sharded import ShardedASWResult, make_asw_sharded
from .cross_sharded import ShardedCrossResult, make_cross_sharded
from .distributed import build_pod_mesh, initialize, scaling_report, spawn
from .wta_sharded import (TwoMin, two_min_combine, wta_refined_sharded,
                          wta_sharded)

__all__ = [
    "AXIS_BATCH",
    "AXIS_DISP",
    "AXIS_ROW",
    "ShardedASWResult",
    "ShardedCrossResult",
    "TwoMin",
    "build_mesh",
    "build_pod_mesh",
    "crop_halo",
    "exchange_halo",
    "gather_blocks",
    "initialize",
    "make_asw_sharded",
    "make_cross_sharded",
    "rank_device",
    "scaling_report",
    "spawn",
    "two_min_combine",
    "wta_refined_sharded",
    "wta_sharded",
]
