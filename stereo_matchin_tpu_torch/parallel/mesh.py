"""Device mesh of the sharded pipelines, on torch.distributed.

The JAX package arranges its devices as a (batch, row, disp) mesh
(`stereo_matchin_tpu/parallel/mesh.py`):

  batch — data parallelism over independent stereo pairs (frames);
  row   — image rows tiled over the shards, with halo exchange between
          row neighbours (parallel/halo.py);
  disp  — cost-volume planes sharded, with an exact two-min merge of the
          per-shard WTA summaries (parallel/wta_sharded.py).

The port runs one process per shard (torch.distributed's multi-controller
model): each rank runs the per-shard code that JAX runs inside
`shard_map`, on its own device, and the collectives go where JAX puts
them.  `build_mesh` returns a `DeviceMesh` of shape (batch, row, disp)
with disp innermost, as JAX lays it out; its `get_group("row")` and
`get_group("disp")` are the groups the halo exchange and the WTA merge
use.  `init_device_mesh("cuda", ...)` accepts a gloo default group
(checked on the card with torch 2.11): its groups take the default
group's backend, so several ranks may share one card over gloo.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..config import MeshConfig

AXIS_BATCH = "batch"
AXIS_ROW = "row"
AXIS_DISP = "disp"


def rank_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: cuda:(local rank % cards on the host), the local
    rank from torchrun's LOCAL_RANK or else the global rank; or the CPU
    where the caller asks for it."""
    if device_type == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def build_mesh(cfg: MeshConfig, device_type: str = "cuda") -> DeviceMesh:
    """The (batch, row, disp) mesh over every rank of the default group,
    which must hold exactly cfg.num_devices ranks.  Sets this rank's
    current CUDA device (rank_device) unless device_type is "cpu"."""
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs an initialised default process "
                           "group (parallel.distributed.initialize)")
    world = dist.get_world_size()
    if world != cfg.num_devices:
        raise ValueError(f"mesh {cfg} needs {cfg.num_devices} ranks, the "
                         f"default group has {world}")
    if device_type != "cpu":
        torch.cuda.set_device(rank_device(device_type))
    return init_device_mesh(device_type, (cfg.batch, cfg.row, cfg.disp),
                            mesh_dim_names=(AXIS_BATCH, AXIS_ROW, AXIS_DISP))


class Shard(NamedTuple):
    """Where this rank sits in a mesh, and the groups its collectives use."""
    batch: int              # coordinates along (batch, row, disp)
    row: int
    disp: int
    n_batch: int            # the mesh's sizes
    n_row: int
    n_disp: int
    row_group: object       # ProcessGroup of this rank's row neighbours
    disp_group: object      # ProcessGroup of this rank's disparity shards

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's (B / batch, H / row, ...) block of a global
        (B, H, ...) batch; raises unless B and H divide, as shard_map."""
        B, H = x.shape[:2]
        if B % self.n_batch or H % self.n_row:
            raise ValueError(f"a ({B}, {H}, ...) batch does not split over "
                             f"{self.n_batch} batch and {self.n_row} row "
                             f"shards")
        b, h = B // self.n_batch, H // self.n_row
        return x[self.batch * b:(self.batch + 1) * b,
                 self.row * h:(self.row + 1) * h].contiguous()

    def planes(self, num_disp: int):
        """(d0, d_local, d_pad): D padded up to a multiple of the disp
        shards, and this shard's first plane and plane count."""
        d_pad = -(-num_disp // self.n_disp) * self.n_disp
        d_local = d_pad // self.n_disp
        return self.disp * d_local, d_local, d_pad


def local_shard(mesh: DeviceMesh) -> Shard:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    b, r, d = mesh.get_coordinate()
    return Shard(b, r, d, sizes[AXIS_BATCH], sizes[AXIS_ROW], sizes[AXIS_DISP],
                 mesh.get_group(AXIS_ROW), mesh.get_group(AXIS_DISP))


def gather_blocks(result, mesh: DeviceMesh):
    """Every rank's blocks all-gathered into the full maps, on every rank:
    a result of the same type with (B, H, ...) fields.  The disp shards
    of one block must hold identical blocks; raises where they do not."""
    from .comm import all_gather

    sh = local_shard(mesh)
    ranks = mesh.mesh
    fields = []
    for x in result:
        g = all_gather(x)
        Bl, Hl = x.shape[:2]
        full = x.new_empty((sh.n_batch * Bl, sh.n_row * Hl) + x.shape[2:])
        for b in range(sh.n_batch):
            for r in range(sh.n_row):
                blocks = [g[int(ranks[b, r, d])] for d in range(sh.n_disp)]
                if not all(torch.equal(blocks[0], o) for o in blocks[1:]):
                    raise AssertionError(f"disp shards of block (batch {b}, "
                                         f"row {r}) differ")
                full[b * Bl:(b + 1) * Bl, r * Hl:(r + 1) * Hl] = blocks[0]
        fields.append(full)
    return type(result)(*fields)
