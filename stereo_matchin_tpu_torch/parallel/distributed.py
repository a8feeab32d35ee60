"""Process-group initialisation, the pod mesh, rank spawning and the
scaling report; the port of `stereo_matchin_tpu/parallel/distributed.py`.

One process per shard.  Under torchrun every process calls

    from stereo_matchin_tpu_torch.parallel import distributed
    distributed.initialize("nccl")          # reads torchrun's environment
    mesh = distributed.build_pod_mesh(row=2, disp=2)
    step = make_asw_sharded(cfg, mesh)       # f(left, right) -> this rank's block

and `spawn` starts such ranks from one Python process (the tests, the dry
run and chip_smoke.py): each rank initialises against a localhost
address, runs a function and returns its result.  Every process group
has a timeout and every join a deadline, so a rank that raises fails the
run in bounded time instead of leaving its peers waiting.
"""

from __future__ import annotations

import datetime
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

from ..config import MeshConfig
from .mesh import build_mesh, rank_device

DEFAULT_TIMEOUT_S = 300.0


def initialize(backend: str, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """dist.init_process_group with the backend named by the caller.

    With no init_method it reads torchrun's environment (env://: RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT).  An NCCL rank first takes its
    card (mesh.rank_device, by LOCAL_RANK or the rank)."""
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl":
        torch.cuda.set_device(rank_device("cuda"))


def build_pod_mesh(row: int = 1, disp: int = 1, batch: int | None = None,
                   device_type: str = "cuda"):
    """The (batch, row, disp) mesh over every rank; batch defaults to
    world // (row * disp), and a world it does not divide raises."""
    n = dist.get_world_size()
    if batch is None:
        if n % (row * disp):
            raise ValueError(f"{n} ranks not divisible by row*disp="
                             f"{row * disp}")
        batch = n // (row * disp)
    return build_mesh(MeshConfig(batch=batch, row=row, disp=disp),
                      device_type)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, backend, address, timeout_s, tasks, results):
    try:
        fn, args = tasks.get(timeout=timeout_s)
        initialize(backend, address, world, rank, timeout_s)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:           # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world_size: int, backend: str = "gloo", args: tuple = (),
          timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run fn(rank, *args) in `world_size` fresh processes (the spawn start
    method: a forked child of a process that holds a CUDA context cannot
    use the card) joined in one process group over a localhost port.
    Returns the ranks' results in rank order.  Raises, with the failing
    ranks' tracebacks, if any rank raises or the run passes timeout_s;
    every process is gone when it returns or raises."""
    ctx = torch.multiprocessing.get_context("spawn")
    # fn and args go through a queue: a process's own arguments pass
    # through a pipe that blocks its start until the child has imported
    # its modules, which would start the ranks one after another.
    tasks, results = ctx.Queue(), ctx.Queue()
    address = f"tcp://localhost:{free_port()}"
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, backend, address, timeout_s,
                               tasks, results), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    for _ in procs:
        tasks.put((fn, args))
    deadline = time.monotonic() + timeout_s
    got, errors, ended = {}, [], {}
    try:
        while len(got) < world_size:
            left = deadline - time.monotonic()
            try:
                rank, ok, out = results.get(timeout=min(max(left, 0.1), 1.0))
            except queue.Empty:
                # A rank that ended 2 s ago has flushed any result it put.
                now = time.monotonic()
                for r, p in enumerate(procs):
                    if p.exitcode is not None:
                        ended.setdefault(r, now)
                dead = [r for r, t in ended.items()
                        if r not in got and now - t > 2.0]
                if dead or left <= 0:
                    missing = dead or sorted(set(range(world_size)) - set(got))
                    errors.append(f"ranks {missing} ended or ran past "
                                  f"{timeout_s} s without a result")
                    break
                continue
            if not ok:
                errors.append(f"rank {rank}:\n{out}")
                break                      # its peers may now wait forever
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0) if not errors
                   else 5.0)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
    if errors:
        raise RuntimeError("spawned ranks failed:\n" + "\n".join(errors))
    return [got[r] for r in range(world_size)]


def scaling_report(step_fn, left, right, mesh, runs: int = 5,
                   repeats: int = 3) -> dict:
    """Throughput of a sharded step on `mesh`, on every rank: wall ms per
    step as the MIN over timed blocks of `runs` steps (min-of-blocks:
    one block is easily poisoned by transient host load), blocks added
    until the two fastest agree within 10% (`stable`), up to twice
    `repeats`; repeats=1 times one block (stable None).  A block ends
    with torch.cuda.synchronize() on CUDA inputs and a barrier, so every
    rank's last step is done.  Returns ms, mpix_s, mpix_s_per_device,
    devices, stable."""
    def sync():
        if left.device.type == "cuda":
            torch.cuda.synchronize(left.device)
        dist.barrier()

    step_fn(left, right)                 # warm-up (kernel build, allocator)
    sync()

    def block():
        t0 = time.perf_counter()
        for _ in range(runs):
            step_fn(left, right)
        sync()
        return time.perf_counter() - t0

    stable = None
    if repeats == 1:
        times = [block()]
    else:
        times = [block() for _ in range(max(repeats, 2))]
        stable = False
        for _ in range(max(repeats, 2)):
            two = sorted(times)[:2]
            if two[1] - two[0] <= 0.10 * two[0]:
                stable = True
                break
            times.append(block())
    ms = min(times) / runs * 1000.0
    n_dev = mesh.size()
    B, H, W = left.shape[0], left.shape[1], left.shape[2]
    mpix_s = B * H * W / (ms / 1000.0) / 1e6
    return {"ms": ms, "mpix_s": mpix_s, "mpix_s_per_device": mpix_s / n_dev,
            "devices": n_dev, "stable": stable}
