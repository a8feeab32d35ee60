"""Multi-rank dry run of the sharded pipelines; the port of the JAX
package's `__graft_entry__.dryrun_multichip`.

    python -m stereo_matchin_tpu_torch.parallel.dryrun [--ranks 4]
        [--backend gloo|nccl] [--device cuda|cpu]

spawns the ranks (parallel.distributed.spawn), runs the sharded ASW and
cross pipelines once over a (batch, row, disp) mesh of them (`mesh_shape`)
on 64x64 frames (d_max 23, radius 4, arm_len 6, r 3, k 2) and holds the
gathered maps against the unsharded pipelines on the same inputs: the
ASW disparity and filled maps and the cross final map bit-equal, and any
cross initial pixel that differs a proven argmin tie (the top two
aggregated costs within 2 ulp).  It prints one line like the JAX package's
MULTICHIP_r05.json tail.

`sharded_maps` is the rank function the dry run, the tests and
chip_smoke.py spawn: it runs a list of `Case`s (method, mesh, config,
halo mode, stage runner by name) and returns each one's per-rank
launches, time, peak memory and step graphs, and on rank 0 the gathered
maps; `halo_tiles` returns each rank's strip of an array after the halo
exchange.  The runner "replay" replays each step of a shard from a CUDA
graph on the card (utils.replay_stage), "eager" calls it
(utils.call_stage), and "record" calls it through a `StepLog`, which logs
each step's name and stage key while the collectives raise inside a step.
"""

from __future__ import annotations

import argparse
import functools
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .. import kernels, ops
from ..config import MeshConfig, StereoConfig
from ..utils import call_stage, clear_caches, graphs, replay_stage
from . import comm, halo
from .asw_sharded import make_asw_sharded
from .cross_sharded import make_cross_sharded
from .distributed import spawn
from .halo import exchange_halo
from .mesh import build_mesh, gather_blocks, local_shard, rank_device

DRYRUN_CFG = dict(d_max=23, radius=4, arm_len=6, r_iters=3, k_iters=2)
DRYRUN_HW = (64, 64)


class Case(NamedTuple):
    method: str                  # "asw" or "cross"
    mesh: tuple                  # (batch, row, disp)
    cfg: dict                    # StereoConfig keywords
    pair: str                    # key of the pairs passed to sharded_maps
    halo_mode: str = "exchange"  # ASW only (make_asw_sharded)
    run: str = "replay"          # the steps' runner: "replay", "eager", "record"


class StepLog:
    """A stage runner that calls each step and logs its name and stage key
    (utils/graphs.py stage_key, which refuses an argument that nests a
    tensor); `running` names the step it is in (guard_collectives)."""

    running = None

    def __init__(self):
        self.steps = []

    def __call__(self, name, fn, *args):
        self.steps.append((name, graphs.stage_key(name, fn, args)))
        StepLog.running = name
        try:
            return fn(*args)
        finally:
            StepLog.running = None


def _outside_steps(f):
    @functools.wraps(f)
    def guarded(*args, **kwargs):
        if StepLog.running is not None:
            raise RuntimeError(f"{f.__name__} called inside the step "
                               f"{StepLog.running}")
        return f(*args, **kwargs)

    guarded.outside_steps = True
    return guarded


def guard_collectives() -> None:
    """Make comm.all_gather and comm.exchange (and halo's name for it)
    raise while a StepLog runs a step, in this process."""
    for mod, name in ((comm, "all_gather"), (comm, "exchange"),
                      (halo, "exchange")):
        f = getattr(mod, name)
        if not getattr(f, "outside_steps", False):
            setattr(mod, name, _outside_steps(f))


RUNNERS = {"replay": replay_stage, "eager": call_stage}


def _pair(spec, dev):
    """(left, right) on dev: numpy arrays, or (fn, args) whose fn(dev,
    *args) makes them (a seeded pair made on the device)."""
    if callable(spec[0]):
        return spec[0](dev, *spec[1])
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in spec)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.barrier()


def sharded_maps(rank: int, cases: list, pairs: dict,
                 device_type: str = "cuda", runs: int = 1) -> list:
    """Rank function: every case on a mesh of all ranks, `runs` frames
    each, then the stage graphs cleared (utils.clear_caches).  Per case, a
    dict with this rank's `launches` (kernels.LAUNCHES over the last frame;
    `frame_launches` over each), `ms` (each frame, barrier to barrier),
    `peak` (max device memory allocated in the last frame, bytes),
    `reserved` (max reserved in each frame, the cached blocks of earlier
    cases released; 0s on the CPU), `stages`
    (utils/graphs.py STAGES.stats() after the frames: the step graphs,
    their warm-ups' and captures' seconds, pool and slot bytes), `coord`,
    for the "record" runner `steps` (each frame's (name, stage key) list)
    and `guarded` (a collective inside a step raised), and on rank 0
    `maps`: the gathered full maps of the last frame (field -> numpy
    array)."""
    torch.set_num_threads(1)
    out, meshes = [], {}
    dev = rank_device(device_type)
    for case in cases:
        if case.mesh not in meshes:
            meshes[case.mesh] = build_mesh(MeshConfig(*case.mesh),
                                           device_type)
        mesh = meshes[case.mesh]
        cfg = StereoConfig(**case.cfg)
        left, right = _pair(pairs[case.pair], dev)
        log = None
        if case.run == "record":
            guard_collectives()
            run = log = StepLog()
        else:
            run = RUNNERS[case.run]
        f = (make_asw_sharded(cfg, mesh, case.halo_mode, run)
             if case.method == "asw" else make_cross_sharded(cfg, mesh, run))
        rec = {"ms": [], "frame_launches": [], "reserved": [], "steps": []}
        if dev.type == "cuda":
            torch.cuda.empty_cache()       # no earlier case's cached blocks
        for _ in range(runs):
            res = None
            _sync(dev)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            kernels.reset_launches()
            if log is not None:
                log.steps = []
            t0 = time.perf_counter()
            res = f(left, right)
            _sync(dev)
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["frame_launches"].append(dict(kernels.LAUNCHES))
            rec["reserved"].append(torch.cuda.max_memory_reserved(dev)
                                   if dev.type == "cuda" else 0)
            if log is not None:
                rec["steps"].append(log.steps)
        rec.update(launches=rec["frame_launches"][-1],
                   peak=(torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else 0),
                   stages=graphs.STAGES.stats(),
                   coord=tuple(mesh.get_coordinate()))
        if log is not None:
            try:
                StepLog()("probe", comm.all_gather, left, None)
                rec["guarded"] = False
            except RuntimeError:
                rec["guarded"] = True
        full = gather_blocks(res, mesh)
        if rank == 0:
            rec["maps"] = {k: v.cpu().numpy()
                           for k, v in full._asdict().items()}
        del res, full, left, right
        clear_caches()
        out.append(rec)
    return out


def halo_tiles(rank: int, x: np.ndarray, mesh: tuple, halo: int, axis: int,
               device_type: str = "cuda"):
    """Rank function: this rank's strip of x (split along `axis` over the
    mesh's row shards) after exchange_halo with its row neighbours, on
    its device.  Returns (row coordinate, padded strip as numpy)."""
    torch.set_num_threads(1)
    sh = local_shard(build_mesh(MeshConfig(*mesh), device_type))
    t = torch.from_numpy(np.ascontiguousarray(x)).to(rank_device(device_type))
    n = t.shape[axis] // sh.n_row
    strip = t.narrow(axis, sh.row * n, n).contiguous()
    return sh.row, exchange_halo(strip, halo, sh.row_group, axis).cpu().numpy()


def mesh_shape(n: int) -> tuple:
    """Factor n ranks into (batch, row, disp), spreading evenly (the JAX
    dry run's `_mesh_shape`)."""
    disp = 2 if n % 2 == 0 else 1
    rem = n // disp
    row = 2 if rem % 2 == 0 else (rem if rem in (3, 5, 7) else 1)
    batch = rem // row
    assert batch * row * disp == n, (batch, row, disp, n)
    return batch, row, disp


def example_pair(batch: int, h: int = DRYRUN_HW[0], w: int = DRYRUN_HW[1],
                 seed: int = 3):
    """The JAX dry run's synthetic pair: UNORM8 noise, the right view the
    left one rolled 5 columns, repeated over the batch."""
    rng = np.random.default_rng(seed)
    left = (rng.integers(0, 256, (h, w, 3)) / np.float32(255.0)).astype(
        np.float32)
    right = np.roll(left, -5, axis=1)
    return tuple(np.repeat(a[None], batch, axis=0) for a in (left, right))


def _prove_ties(left, right, cfg: StereoConfig, bad) -> int:
    """Each differing initial pixel (b, y, x) must be an argmin tie: its
    two smallest aggregated costs within 2 ulp relative."""
    for b in sorted(set(bad[:, 0])):
        ml, mr = (ops.median3x3(x[b], cfg.kernels) for x in (left, right))
        quirk = cfg.legacy_cross_arm_quirk
        al = ops.cross_arms(ml, cfg.arm_len, cfg.tau, quirk)
        ar = ops.cross_arms(mr, cfg.arm_len, cfg.tau, quirk)
        aggr = ops.cross_aggregate(ops.sad_cost_volume(ml, mr, cfg.num_disp),
                                   al, ar, cfg.arm_len, impl="taps")
        for _, y, x in bad[bad[:, 0] == b]:
            v = np.sort(aggr[:, y, x].cpu().numpy())
            gap = (v[1] - v[0]) / max(float(v[0]), 1e-30)
            if gap > 2.4e-7:
                raise AssertionError(f"initial ({b}, {y}, {x}) differs and "
                                     f"is no tie (gap {gap})")
    return len(bad)


def dryrun_multichip(n: int, backend: str = "gloo",
                     device_type: str = "cuda") -> str:
    """Spawn n ranks, run both sharded pipelines once over mesh_shape(n)
    and hold them against the unsharded pipelines (see the module
    docstring).  Returns the printed line; raises on any mismatch."""
    from ..models import asw, cross_based

    batch, row, disp = mesh_shape(n)
    cross_kw = dict(DRYRUN_CFG, oii_impl="taps")
    left, right = example_pair(batch)
    cases = [Case("asw", (batch, row, disp), DRYRUN_CFG, "p"),
             Case("cross", (batch, row, disp), cross_kw, "p")]
    ranks = spawn(sharded_maps, n, backend,
                  (cases, {"p": (left, right)}, device_type))
    got_asw, got_cross = (r["maps"] for r in ranks[0])

    dev = torch.device("cuda" if device_type == "cuda" else "cpu")
    lt, rt = (torch.from_numpy(a).to(dev) for a in (left, right))
    cfg, ccfg = StereoConfig(**DRYRUN_CFG), StereoConfig(**cross_kw)
    h, w = DRYRUN_HW
    # The unsharded frames run eagerly: several gloo ranks share one card.
    for b in range(batch):
        ref = asw.asw_pipeline_impl(lt[b], rt[b], cfg)
        for f in ("disparity", "filled"):
            if not np.array_equal(got_asw[f][b], getattr(ref, f).cpu().numpy()):
                raise AssertionError(f"ASW {f} of frame {b} differs from the "
                                     f"unsharded pipeline")
    ci = got_cross["initial"]
    ri = np.stack([cross_based.cross_pipeline_impl(lt[b], rt[b], ccfg)
                   .initial.cpu().numpy() for b in range(batch)])
    for b in range(batch):
        rf = (cross_based.cross_pipeline_impl(lt[b], rt[b], ccfg).final.cpu()
              .numpy())
        if not np.array_equal(got_cross["final"][b], rf):
            raise AssertionError(f"cross final of frame {b} differs from the "
                                 f"unsharded pipeline")
    bad = np.argwhere(ci != ri)
    if len(bad) > 0.002 * ci.size:
        raise AssertionError(f"cross initial differs on {len(bad)} of "
                             f"{ci.size} pixels")
    n_tied = _prove_ties(lt, rt, ccfg, bad)
    line = (f"dryrun_multichip ok: mesh(batch={batch}, row={row}, "
            f"disp={disp}) over {n} {backend} ranks on {device_type}; asw "
            f"disparity {(batch, h, w)} BIT-EQUAL to unsharded "
            f"(disparity+filled); cross final BIT-EQUAL to unsharded; cross "
            f"initial equal at {ci.size - len(bad)}/{ci.size} px with "
            f"{n_tied} disagreements all PROVEN sub-2-ulp argmin cost ties")
    print(line)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun: no CUDA device; pass --device cpu")
    dryrun_multichip(a.ranks, a.backend, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
