"""The traced stretch of a run: torch.profiler, CUDA activities only, over
a few frames of the window, read back from its Chrome trace.

The profiler records no host operations: recording them too nearly
doubled what the trace adds to a frame (PERF.md, section 3).  The stretch
is bounded on the device by the harness's own copies of the kept map to
the host (the only copies from the device into pinned memory): it runs
from the end of the copy of the first recorded frame, which is left out
(the first recorded step of a profiling session can lose launches), to
the end of the copy of the last traced frame, and so holds each traced
frame with the idle time before it.  It closes at a frame's end once
`seconds` have passed.  Device activities are the trace's kernels,
copies and sets; the host events are the CUDA runtime's calls.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
MAP_COPY = "Memcpy DtoH (Device -> Pinned)"


class Trace(NamedTuple):
    window: tuple        # (start, end) of the stretch, microseconds
    device: list         # (start, end, name) of each device activity in it
    host: list           # (start, end, name) of the runtime's calls, by start
    frames: list         # (H, W) of each frame in the stretch
    first: int = 0       # the window's index of the stretch's first frame


class Tracer:
    """Drives torch.profiler around the window's first frames: `start`
    before the window, then `before_frame` and `after_frame` around each
    frame, `read` once the window has closed."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.prof = None
        self.t0 = None
        self.first = 0
        self.frames = []
        self.skipped = self.done = False

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()

    def before_frame(self, index: int, size) -> None:
        """Frame `index` of the window, of `size`, is about to start."""
        if self.done:
            return
        if not self.skipped:
            self.skipped = True            # the first recorded frame
            return
        if self.t0 is None:
            self.t0 = time.perf_counter()
            self.first = index
        self.frames.append(tuple(size))

    def after_frame(self) -> None:
        if (self.t0 is not None and not self.done
                and time.perf_counter() - self.t0 >= self.seconds):
            self.close()

    def close(self) -> None:
        if self.done or self.prof is None:
            return
        self.prof.__exit__(None, None, None)
        self.done = True

    def read(self) -> Trace | None:
        """The stretch's Trace, or None where no frame was traced."""
        self.close()
        if not self.frames:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return from_events(events, self.frames, self.first)


def from_events(events, frames, first: int = 0) -> Trace | None:
    """A Trace from Chrome trace events: the stretch from the end of the
    first map copy to the end of the last, the device activities whose
    midpoint lies in it (clipped to it), the runtime's calls.  None where
    the map copies do not number the frames and the skipped one."""
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e)
             for e in events if "dur" in e and "ts" in e]
    copies = sorted(end for _, end, e in spans
                    if e.get("cat") == "gpu_memcpy"
                    and e.get("name") == MAP_COPY)
    if not frames or len(copies) != len(frames) + 1:
        return None
    t0, t1 = copies[0], copies[-1]
    device, host = [], []
    for s, end, e in spans:
        cat = e.get("cat")
        if cat in DEVICE_CATS and t0 <= (s + end) / 2 <= t1:
            device.append((max(s, t0), min(end, t1), e["name"]))
        elif cat in HOST_CATS:
            host.append((s, end, e["name"]))
    device.sort()
    host.sort()
    return Trace((t0, t1), device, host, list(frames), first)


def busy_intervals(trace: Trace) -> list:
    """The union of the device activities' intervals, sorted, disjoint."""
    out = []
    for s, e, _ in trace.device:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(trace: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(trace))


def window_us(trace: Trace) -> float:
    return trace.window[1] - trace.window[0]


def device_us(trace: Trace, names=None) -> float:
    """Summed duration of the device activities (those whose name holds one
    of `names`, where given)."""
    return sum(e - s for s, e, n in trace.device
               if names is None or any(k in n for k in names))


def top_ops(trace: Trace, n: int = 10) -> list:
    """[[name, seconds], ...]: the device operations that took most time."""
    by = {}
    for s, e, name in trace.device:
        by[name] = by.get(name, 0.0) + (e - s)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[short(name), us / 1e6] for name, us in top]


def idle_gaps(trace: Trace, n: int = 10) -> list:
    """[[name, seconds], ...]: the longest stretches with nothing on the
    device, each named by the runtime call the host was in at its
    midpoint ("host" between calls), and "after map copy/" where the gap
    opens a frame (the host returning from the copy and entering the
    next frame)."""
    t0, t1 = trace.window
    copy_ends = {e for _, e, name in trace.device if name == MAP_COPY}
    copy_ends.add(t0)
    gaps, last = [], t0
    for s, e in busy_intervals(trace):
        if s > last:
            gaps.append((s - last, last, s))
        last = max(last, e)
    if t1 > last:
        gaps.append((t1 - last, last, t1))
    gaps.sort(reverse=True)
    starts = [h[0] for h in trace.host]
    out = []
    for d, a, b in gaps[:n]:
        name = host_call(trace.host, starts, (a + b) / 2)
        if a in copy_ends:
            name = "after map copy/" + name
        out.append([short(name), d / 1e6])
    return out


def host_call(host, starts, t: float, depth: int = 4000) -> str:
    """The runtime call the host was in at time t, or "host"."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and depth > 0:
        s, e, name = host[i]
        if t <= e:
            return name
        i -= 1
        depth -= 1
    return "host"


def short(name: str, limit: int = 100) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."
