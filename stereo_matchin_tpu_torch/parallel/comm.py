"""The collectives of the sharded pipelines, with their transport.

The transport follows the group's backend, `dist.get_backend(group)`:
gloo moves host tensors only (its point-to-point path cannot read device
memory), so under gloo a device tensor goes through a host copy and
comes back to its device; NCCL moves device tensors directly.  This is
the rule of the backend, chosen per call from the group, not a fallback.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def host_staged(group) -> bool:
    """True where the group's backend moves host tensors only (gloo)."""
    return dist.get_backend(group) == "gloo"


def group_rank(group) -> int:
    return dist.get_group_rank(group, dist.get_rank())


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """(n, *x.shape): every rank's x in group-rank order, on x's device."""
    n = dist.get_world_size(group)
    dev = torch.device("cpu") if host_staged(group) else x.device
    src = x.to(dev).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=dev)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.view((n,) + tuple(x.shape)).to(x.device)


def exchange(sends: dict, recvs: dict, group, like: torch.Tensor) -> dict:
    """Point-to-point exchange in one batch: sends {group rank: tensor},
    recvs {group rank: (shape)}.  Returns {group rank: received tensor}
    on like's device."""
    dev = torch.device("cpu") if host_staged(group) else like.device
    bufs = {p: torch.empty(shape, dtype=like.dtype, device=dev)
            for p, shape in recvs.items()}
    ops = [dist.P2POp(dist.isend, t.to(dev).contiguous(),
                      dist.get_global_rank(group, p), group)
           for p, t in sends.items()]
    ops += [dist.P2POp(dist.irecv, b, dist.get_global_rank(group, p), group)
            for p, b in bufs.items()]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return {p: b.to(like.device) for p, b in bufs.items()}
