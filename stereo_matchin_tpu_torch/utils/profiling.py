"""Profiling and tracing utilities; PyTorch port of
`stereo_matchin_tpu/utils/profiling.py`.

The reference's observability is OpenCL event profiling feeding
`compute_time` (main.cpp:33-76) plus printf banners.  Here:

  * `device_sync` — completion barrier: torch.cuda.synchronize() on the
    devices of the CUDA tensors it is given; nothing on the CPU, whose
    ops finish before they return.
  * `Stopwatch` — accumulating wall-clock section timer built on
    device_sync.
  * `trace` — context manager around torch.profiler (CPU and, where a
    card is present, CUDA activities) writing a Chrome trace.
  * `call_stage` — the untimed stage runner: the pipelines take a
    `run(name, fn, *args)` callable (bench.harness.StageTimer.run times
    each stage; utils.graphs.replay_stage replays each from a CUDA graph);
    this one just calls fn.
  * `stage_device_ms` — the device time of a profiled frame by stage, from
    its Chrome trace (scripts/profile_frame.py --stages): each activity
    goes to its range's device-side extent.

The JAX package's `utils/compilation_cache.py` has no counterpart: the
port compiles only its CUDA sources, and `kernels/_build.py` keeps the
built library keyed by their contents.
"""

from __future__ import annotations

import bisect
import contextlib
import os
import time
from typing import Dict

import torch


def call_stage(name: str, fn, *args):
    """Run one named pipeline stage untimed: fn(*args)."""
    return fn(*args)


def _cuda_devices(out, found: set) -> set:
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (list, tuple)):     # NamedTuples included
        for v in out:
            _cuda_devices(v, found)
    return found


def device_sync(out) -> None:
    """Block until every CUDA tensor in `out` (a tensor, or nested
    lists, tuples and dicts of them) has been computed."""
    for device in _cuda_devices(out, set()):
        torch.cuda.synchronize(device)


class Stopwatch:
    """Accumulating wall-clock timer with device synchronisation."""

    def __init__(self):
        self.ms: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            device_sync(holder.get("out", sync_value))
            self.ms[name] = self.ms.get(name, 0.0) + (
                time.perf_counter() - t0) * 1000.0
            self.counts[name] = self.counts.get(name, 0) + 1

    def timed(self, name: str, fn, *args):
        with self.section(name) as h:
            h["out"] = fn(*args)
        return h["out"]

    def report(self) -> str:
        width = max((len(k) for k in self.ms), default=0)
        lines = [
            f"{k:<{width}}  {v:9.3f} ms  (x{self.counts[k]})"
            for k, v in sorted(self.ms.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block; writes <log_dir>/trace.json (Chrome
    trace format) when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _span_of(spans, starts, t):
    """The name of the latest-starting span of `spans` ((start, end, name),
    sorted by start) that holds time t (the innermost where they nest), or
    None."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        if t <= spans[i][1]:
            return spans[i][2]
        i -= 1
    return None


def stage_device_ms(events, stages) -> dict:
    """Device time by stage from a torch.profiler Chrome trace's
    `traceEvents`: each kernel, copy or set goes to the stage whose
    `record_function` range (a user annotation named in `stages`)
    launched it.  Returns {stage: (ms, launches)}, None for what no stage
    launched (the glue between stages).

    The profiler links each launch to the annotation open around it by
    CUPTI's correlation records, not by time, and writes each range's
    device-side extent (cat "gpu_user_annotation": from its first
    activity's start to its last one's end) on the device's clock.  An
    activity goes to the innermost such extent that holds its midpoint:
    the device runs one stream's activities in launch order, so a range's
    extent holds its own activities and nothing launched outside it.
    Where a trace has no device-side extents, an activity goes to the
    range whose host-side span holds the runtime call that launched it,
    matched by correlation id.  That fallback compares CUPTI's host
    timestamps with the profiler's own, two clocks that can disagree by
    more than a short stage lasts (a trace can show a kernel starting
    before the call that launched it), so a stage's launches can land
    outside it.  The operator tree would miss the kernels launched
    through ctypes (csrc/*.cu), which no torch operator owns."""
    device = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "gpu_user_annotation"
                    and e.get("name") in stages)
    if device:
        spans, when = device, None
    else:
        when = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
        spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                       for e in events if e.get("cat") == "user_annotation"
                       and e.get("name") in stages)
    starts = [sp[0] for sp in spans]
    by_stage = {}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        if when is None:
            # The midpoint stays clear of the rounding of the trace's
            # times at the extent's ends, which its own activities bound.
            t = e["ts"] + e["dur"] / 2
        else:
            t = when.get(e.get("args", {}).get("correlation"))
        name = None if t is None else _span_of(spans, starts, t)
        ms, n = by_stage.get(name, (0.0, 0))
        by_stage[name] = (ms + e["dur"] / 1e3, n + 1)
    return by_stage
