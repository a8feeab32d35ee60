#!/usr/bin/env python3
"""Device time of one frame by kernel, under torch.profiler.

    python3 scripts/profile_frame.py [--method asw|cross] [--config3] [--stages]

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
round trips and other glue between stages).  Needs an NVIDIA GPU; prints
the card's nvidia-smi name and power limit beside the numbers.
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()

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

    if args.method == "asw":
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
    print(f"{args.method} frame {H}x{W}, d_max {cfg.d_max}, aggr_d_chunks "
          f"{cfg.aggr_d_chunks}: {host_ms:.1f} ms host (profiled), "
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
    return 0


def print_stages(prof, stages, device_ms):
    """Device time by stage (utils.profiling.stage_device_ms over the
    profile's Chrome trace)."""
    import json
    import tempfile

    from stereo_matchin_tpu_torch.utils.profiling import stage_device_ms

    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
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
