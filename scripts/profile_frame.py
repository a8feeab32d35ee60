#!/usr/bin/env python3
"""Device time of one frame by kernel, under torch.profiler.

    python3 scripts/profile_frame.py [--method asw|cross] [--config3] [--stages]
    python3 scripts/profile_frame.py [--method asw|cross] [--config3]
        --bands N [--route wavefront|halo] [--eager]
    python3 scripts/profile_frame.py [--method asw|cross] --sharded [--eager]

Runs the ASW pipeline (`--method asw`, the default) or the cross-based
pipeline (`--method cross`) of the PyTorch port through the CUDA kernels
on a seeded pair, once to warm up and once under torch.profiler, and
prints the frame's host time, its device time and the kernels that took
it, largest first: REFERENCE_CONFIG at 288x384, or with --config3
BASELINE config 3 (1988x2880, d_max 279; ASW with aggr_d_chunks 4).
By default the frame is the captured entry (`asw_pipeline`,
`cross_pipeline`): the warm-up captures it as a CUDA graph, and the
profiled frame is a replay of that graph.  With --stages the frame runs
eagerly through its stage runner (the stages and names of the per-stage
harness, bench/harness.py), each stage inside a
torch.profiler.record_function range, and it also prints the device time
of the kernels each stage launched and what no stage launched (the UNORM8
round trips and other glue between stages).  With --bands N the frame is
the band driver in N bands (models/tiled.py; --route wavefront, the
default, or halo), its band steps replayed from CUDA graphs, or run
eagerly with --eager (utils.call_stage); it also prints per band its
device ms, kernel launches, host ms to dispatch it and its busy share
(device ms over the span from its first kernel's start to its last
kernel's end), beside one unprofiled frame's host ms.  With --sharded
the frame is the sharded pipeline at config 3 on a (1, 2, 2) mesh of 4
gloo ranks sharing the card (parallel/, the pairs of chip_smoke.py phase
19), its steps replayed from CUDA graphs or run eagerly with --eager; each
rank runs two frames, then profiles its third (the ranks at once), and it
prints every rank's numbers as above, with its (batch, row, disp)
coordinates, and its device time by step (the steps' names,
parallel/asw_sharded.py and cross_sharded.py), the device work outside
every step being the collectives' copies.  Needs
an NVIDIA GPU; prints the card's nvidia-smi name and power limit beside
the numbers.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    ap = argparse.ArgumentParser()
    ap.add_argument("--method", choices=("asw", "cross"), default="asw")
    ap.add_argument("--config3", action="store_true")
    ap.add_argument("--stages", action="store_true",
                    help="also the device time by pipeline stage")
    ap.add_argument("--bands", type=int, default=0,
                    help="run the band driver in this many bands")
    ap.add_argument("--route", choices=("wavefront", "halo"),
                    default="wavefront")
    ap.add_argument("--eager", action="store_true",
                    help="with --bands or --sharded: run the steps eagerly")
    ap.add_argument("--sharded", action="store_true",
                    help="rank 0 of the sharded pipeline at config 3 on "
                         "(1, 2, 2), 4 gloo ranks")
    args = ap.parse_args()
    if sum((bool(args.bands), args.stages, args.sharded)) > 1:
        ap.error("--bands, --stages and --sharded are exclusive")
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    if args.sharded:
        return sharded(args.method, args.eager, smi)

    from chip_smoke import CONFIG3_HW, random_pair
    from stereo_matchin_tpu_torch import REFERENCE_CONFIG
    from stereo_matchin_tpu_torch.models import asw, cross_based

    import numpy as np

    cfg = REFERENCE_CONFIG
    H, W = 288, 384
    if args.config3:
        cfg = cfg.replace(d_max=279)
        if args.method == "asw":
            cfg = cfg.replace(aggr_d_chunks=4)
        H, W = CONFIG3_HW
    stages = set()

    def run(name, fn, *a):
        stages.add(name)
        with record_function(name):
            return fn(*a)

    bands = BandRanges(stages, args.eager)
    if args.bands:
        from stereo_matchin_tpu_torch.models import tiled

        driver = (tiled.asw_pipeline_tiled if args.method == "asw"
                  else tiled.cross_pipeline_tiled)

        def pipeline(left, right, cfg):
            bands.start()
            return driver(left, right, cfg, args.bands,
                          wavefront=args.route == "wavefront", run=bands.run)
    elif args.method == "asw":
        def pipeline(left, right, cfg):
            if not args.stages:
                return asw.asw_pipeline(left, right, cfg)
            w = asw.asw_weights(left, right, cfg, run=run)
            return asw.asw_pipeline_from_weights(left, right, w, cfg, run=run)
    else:
        def pipeline(left, right, cfg):
            if not args.stages:
                return cross_based.cross_pipeline(left, right, cfg)
            return cross_based.cross_pipeline_staged(left, right, cfg, run=run)
    left, right = random_pair(np.random.default_rng(3), H, W)
    pipeline(left, right, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipeline(left, right, cfg)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipeline(left, right, cfg)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    # Device-side rows only (kernels, copies): an operator's row repeats
    # the time of the kernels it launched, and a stage's range on the
    # device timeline (--stages) spans its kernels.
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in stages]
    rows.sort(key=lambda e: e.device_time_total, reverse=True)
    device_ms = sum(e.device_time_total for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    what = (f"{args.route} bands ({args.bands}, "
            f"{'eager' if args.eager else 'replayed'})" if args.bands
            else "frame")
    print(f"{args.method} {what} {H}x{W}, d_max {cfg.d_max}, aggr_d_chunks "
          f"{cfg.aggr_d_chunks}: {plain_ms:.1f} ms host unprofiled, "
          f"{host_ms:.1f} ms host (profiled), "
          f"{device_ms:.1f} ms device ({device_ms / host_ms * 100:.1f}% busy) "
          f"in {launches} device launches; {smi}")
    # The 20 largest rows, and every other row of the port's own kernels
    # (csrc/*.cu, all in an anonymous namespace), however small.
    for i, e in enumerate(rows):
        if i < 20 or e.key.startswith(("(anonymous namespace)::",
                                       "void (anonymous namespace)::")):
            print(f"  {e.device_time_total / 1e3:10.3f} ms  {e.count:6d} x  "
                  f"{e.key[:90]}")
    if args.stages:
        print_stages(prof, stages, device_ms)
    if args.bands:
        bands.report(trace_events(prof))
    return 0


def sharded(method: str, eager: bool, smi: str) -> int:
    """--sharded: spawn the 4 ranks and print every rank's profile."""
    import dataclasses

    from chip_smoke import CONFIG3_HW, config3_batch, scene_batch
    from stereo_matchin_tpu_torch import REFERENCE_CONFIG
    from stereo_matchin_tpu_torch.kernels import _build
    from stereo_matchin_tpu_torch.parallel.distributed import spawn

    _build.build()                  # once, before the ranks load it
    cfg = REFERENCE_CONFIG.replace(d_max=279, median_dispatch_quirk=False)
    pair = ((config3_batch, (3,)) if method == "asw"
            else (scene_batch, (4, *CONFIG3_HW, 279)))
    out = spawn(sharded_rank, 4, "gloo",
                (method, eager, pair, dataclasses.asdict(cfg)), 900)
    for report in out:
        print(f"{report}; {smi}")
    return 0


def sharded_rank(rank, method, eager, pair, cfg_kw) -> str:
    """Rank function of --sharded: two frames, then a third one, profiled.
    Returns the rank's report."""
    import contextlib
    import io

    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from stereo_matchin_tpu_torch import kernels
    from stereo_matchin_tpu_torch.config import MeshConfig, StereoConfig
    from stereo_matchin_tpu_torch.parallel import (make_asw_sharded,
                                                   make_cross_sharded)
    from stereo_matchin_tpu_torch.parallel.dryrun import _pair
    from stereo_matchin_tpu_torch.parallel.mesh import build_mesh, rank_device
    from stereo_matchin_tpu_torch.utils import call_stage, replay_stage

    torch.set_num_threads(1)
    mesh = build_mesh(MeshConfig(1, 2, 2), "cuda")
    dev = rank_device("cuda")
    left, right = _pair(pair, dev)
    inner, steps = call_stage if eager else replay_stage, set()

    def run(name, fn, *args):
        steps.add(name)
        with record_function(name):
            return inner(name, fn, *args)

    cfg = StereoConfig(**cfg_kw)
    f = (make_asw_sharded(cfg, mesh, run=run) if method == "asw"
         else make_cross_sharded(cfg, mesh, run=run))

    def frame():
        torch.cuda.synchronize(dev)
        dist.barrier()
        t0 = time.perf_counter()
        f(left, right)
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3

    cold, warm = frame(), frame()
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        host_ms = frame()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in steps]
    rows.sort(key=lambda e: e.device_time_total, reverse=True)
    device_ms = sum(e.device_time_total for e in rows) / 1e3
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        print(f"sharded {method} rank {rank} at {mesh.get_coordinate()} of "
              f"(1, 2, 2), 4 gloo ranks on one "
              f"card, config 3, steps {'eager' if eager else 'replayed'}: "
              f"frames {cold:.1f} (cold), {warm:.1f} ms; profiled "
              f"{host_ms:.1f} ms host, {device_ms:.1f} ms device "
              f"({device_ms / host_ms * 100:.1f}% busy) in "
              f"{sum(e.count for e in rows)} device launches; kernels "
              f"{dict((k, v) for k, v in kernels.LAUNCHES.items() if v)}")
        for e in rows[:15]:
            print(f"  {e.device_time_total / 1e3:10.3f} ms  {e.count:6d} x  "
                  f"{e.key[:90]}")
        print_stages(prof, steps, device_ms)
    return text.getvalue().rstrip()


class BandRanges:
    """The stage runner of a profiled band frame: each band step inside a
    record_function range of its own ("band i <step name>"), through
    utils.replay_stage, or eagerly (utils.call_stage); keeps the host ms
    each band took to dispatch."""

    def __init__(self, stages: set, eager: bool):
        from stereo_matchin_tpu_torch.utils import call_stage, replay_stage

        self.stages, self.inner = stages, call_stage if eager else replay_stage
        self.host_ms = []

    def start(self):
        self.host_ms = []

    def run(self, name, fn, *args):
        from torch.profiler import record_function

        label = f"band {len(self.host_ms)} {name}"
        self.stages.add(label)
        t0 = time.perf_counter()
        with record_function(label):
            out = self.inner(name, fn, *args)
        self.host_ms.append((label, (time.perf_counter() - t0) * 1e3))
        return out

    def report(self, events):
        """Per band: device ms, launches, host ms to dispatch it, and its
        busy share over its device span."""
        from stereo_matchin_tpu_torch.utils.profiling import stage_device_ms

        by_band = stage_device_ms(events, self.stages)
        spans = band_spans(events, self.stages)
        for label, host in self.host_ms:
            ms, n = by_band.get(label, (0.0, 0))
            span = spans.get(label, 0.0)
            print(f"  {label}: {ms:.3f} ms device in {n} launches, "
                  f"{host:.1f} ms host to dispatch, busy "
                  f"{ms / span * 100 if span else 0.0:.1f}% of its "
                  f"{span:.3f} ms device span")


def trace_events(prof) -> list:
    import json
    import tempfile

    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text())["traceEvents"]


def band_spans(events, names) -> dict:
    """{range name: ms from the start of the first device event it launched
    to the end of the last} (launches matched as
    utils.profiling.stage_device_ms matches them)."""
    import bisect

    launched_at = {e["args"]["correlation"]: e["ts"] for e in events
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and "correlation" in e.get("args", {})}
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e.get("name") in names)
    starts = [r[0] for r in ranges]
    first, last = {}, {}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        t = launched_at.get(e.get("args", {}).get("correlation"))
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if i < 0 or t > ranges[i][1]:
            continue
        name = ranges[i][2]
        first[name] = min(first.get(name, e["ts"]), e["ts"])
        last[name] = max(last.get(name, 0.0), e["ts"] + e["dur"])
    return {k: (last[k] - first[k]) / 1e3 for k in first}


def print_stages(prof, stages, device_ms):
    """Device time by stage (utils.profiling.stage_device_ms over the
    profile's Chrome trace)."""
    from stereo_matchin_tpu_torch.utils.profiling import stage_device_ms

    events = trace_events(prof)
    by_stage = stage_device_ms(events, stages)
    spans = sum(e.get("cat") == "user_annotation" and e.get("name") in stages
                for e in events)
    outside = by_stage.pop(None, (0.0, 0))
    total = sum(ms for ms, _ in by_stage.values()) + outside[0]
    print(f"by stage ({spans} stage ranges): {total:.3f} ms of "
          f"kernels, copies and sets in the trace (operator table "
          f"{device_ms:.3f} ms), {outside[0]:.3f} ms of them in "
          f"{outside[1]} launches outside every stage")
    for name, (ms, n) in sorted(by_stage.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:10.3f} ms  {n:6d} x  {name}")


if __name__ == "__main__":
    sys.exit(main())
