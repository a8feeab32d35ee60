#!/usr/bin/env python3
"""Device time of one frame by kernel, under torch.profiler.

    python3 scripts/profile_frame.py [--method asw|cross] [--config3]

Runs the ASW pipeline (`--method asw`, the default) or the cross-based
pipeline (`--method cross`) of the PyTorch port through the CUDA kernels
on a seeded pair, once to warm up and once under torch.profiler, and
prints the frame's host time, its device time and the kernels that took
it, largest first: REFERENCE_CONFIG at 288x384, or with --config3
BASELINE config 3 (1988x2880, d_max 279; ASW with aggr_d_chunks 4).
Needs an NVIDIA GPU; prints the card's nvidia-smi name and power limit
beside the numbers.
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
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--method", choices=("asw", "cross"), default="asw")
    ap.add_argument("--config3", action="store_true")
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
    pipeline = (asw.asw_pipeline if args.method == "asw"
                else cross_based.cross_pipeline)
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
    # the time of the kernels it launched.
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
