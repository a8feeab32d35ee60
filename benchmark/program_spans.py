"""The program's own spans and counters, as the per-layer metrics read them
(`stereo_matchin_tpu_torch/utils/profiling.py`: `SPANS`, the frame
entry's spans while a profiler records, and `COUNTERS`, the frame
cache's counters).

A reader finds the program through the modules the run has already
loaded (`sys.modules`), never by an import, and every function here
returns None where what it needs is missing: a checkout whose program has
no recorder or no counter gives no such metric, and the result line
leaves it out.

The spans are timed by `time.perf_counter_ns()`, the clock of the
harness's `Frame` times, which pick each traced frame's `entry` span.
The trace's `ts` is another clock (the Unix clock less the profiler's
base, which `tracing.Tracer` drops), and its device activities are
stamped apart from its runtime calls: on an H100 the device's stamps
stood up to 0.9 ms off the calls' and drifted from them by up to 3.5 ms
over a 3.4 s stretch.  So the spans are mapped in two steps, each by the
bounds that causality puts on it frame by frame:

  * onto the clock of the runtime's calls, by the graph launches: each
    `entry.launch` span holds exactly one `cudaGraphLaunch` call, and the
    stretch's frames, the profile's last, hold the profile's last such
    calls, one a frame (picked so, not by the window, whose bounds are on
    the device's clock), matched in order.  A frame's offset lies between
    the two that put the call at either end of its span.  Both clocks are
    the host's and keep one rate (on an H100 every stretch's bounds left
    one offset, to 2.6-15.5 us), so the offset is one number, the middle
    of what every frame's bounds leave, its error half their width
    (`steady`); where they leave none, it is read as the device's is;
  * from there onto the device's clock: the host leaves the synchronize
    after the previous frame's map copy has ended on the device, and each
    piece of work the host then enqueues, up to the graph's launch,
    starts on the device after the call that enqueued it began (the
    calls meet the device's next activities in order, one each).

The device's offset from the calls keeps its rate for a while, then may
turn (on an H100 it held for 136 ms, then drifted 1.4% for the rest of a
stretch), so it is read as a line in time over each run of frames that
one line passes through: `band` finds every line that passes between the
run's bounds.  A frame's offset is the middle of what those lines give
at its entry, and its error half their spread there; a frame's residual
is the sum of its two steps' errors.  One frame's device bounds are as wide as the wake-up
of its synchronize and the latency of its quickest enqueue (21-160 us on
an H100 under the profiler); the line shares what the frames' tightest
bounds know.  Where no line passes, the counts differ or a residual
passes RESIDUAL_US, nothing is mapped."""

from __future__ import annotations

import bisect
import statistics
import sys

from benchmark.tracing import MAP_COPY, busy_intervals, window_us

PROFILING = "stereo_matchin_tpu_torch.utils.profiling"
LAUNCH_CALL = "cudaGraphLaunch"
SYNC_CALL = "cudaStreamSynchronize"
# Runtime and driver calls that put work on the device.
ENQUEUE_CALLS = ("cudaMemcpy", "cudaMemset", "cudaLaunch", "cudaGraphLaunch",
                 "cuMemcpy", "cuMemset", "cuLaunch", "cuGraphLaunch")
RESIDUAL_US = 50.0
# What two bounds may cross by and still count as met: the trace's stamps
# are whole nanoseconds at best.
EPS_US = 1e-3


def program(name: str):
    """`name` of the program's profiling module, or None where the run has
    not loaded the module or it lacks the name."""
    return getattr(sys.modules.get(PROFILING), name, None)


def frame_counter(name: str):
    """Counter `name` of the frame cache (the "frames" family), or None."""
    get = getattr(program("COUNTERS"), "get", None)
    value = getattr(get("frames"), name, None) if callable(get) else None
    return value if isinstance(value, (int, float)) else None


def traced_entries(run):
    """[(entry, launch)] as (start_ns, end_ns) pairs, one of each for every
    frame of the traced stretch (the entry span inside the frame's call),
    or None."""
    tr = run.trace
    recorded = getattr(program("SPANS"), "spans", None)
    if tr is None or not tr.frames or not recorded:
        return None
    frames = run.frames[tr.first:tr.first + len(tr.frames)]
    if len(frames) != len(tr.frames):
        return None
    entries = [s for s in recorded if s.name == "entry"]
    launches = {s.entry: (s.start_ns, s.end_ns) for s in recorded
                if s.name == "entry.launch"}
    out = []
    for f in frames:
        lo, hi = f.t_call * 1e9, f.t_return * 1e9
        mine = [s for s in entries if lo <= s.start_ns and s.end_ns <= hi]
        if len(mine) != 1 or mine[0].id not in launches:
            return None
        out.append(((mine[0].start_ns, mine[0].end_ns), launches[mine[0].id]))
    return out


def steady(windows, n: int):
    """[(offset, error)] n times for [(t, low, high)] windows
    (microseconds): the one offset that keeps low <= offset <= high in
    every window, the middle of what they leave and half its width; None
    where they leave nothing."""
    if not windows:
        return None
    low = max(lo for _, lo, _ in windows)
    high = min(hi for _, _, hi in windows)
    if high < low - EPS_US:
        return None
    return [((low + high) / 2, max(0.0, high - low) / 2)] * n


def band(windows, at):
    """[(offset, error)] at each time of `at`, one a window, for [(t, low,
    high)] windows (microseconds) in time order: the lines offset = a + b t
    that keep low <= offset <= high in every window of a run of them, each
    run as long as one line passes, read at the window's `at`: the middle
    of what they give and half its spread (the module's docstring); None
    where a window's own bounds cross.  Lines are sought with |b| up to 10%
    and within 10 s of the windows' middle."""
    if not windows:
        return None
    mid = statistics.median((lo + hi) / 2 for _, lo, hi in windows)
    t0 = statistics.median(t for t, _, _ in windows)
    a_max, b_max = 1e7, 1e5          # us, and us a second
    box = [(-a_max, -b_max), (a_max, -b_max), (a_max, b_max),
           (-a_max, b_max)]
    runs, poly = [], box             # [(first window, polygon)]
    for k, (t, lo, hi) in enumerate(windows):
        u = (t - t0) / 1e6
        cut = _clip(_clip(poly, u, hi - mid + EPS_US, 1.0), u,
                    lo - mid - EPS_US, -1.0)
        if not cut:                  # no line passes: a new run begins
            cut = _clip(_clip(box, u, hi - mid + EPS_US, 1.0), u,
                        lo - mid - EPS_US, -1.0)
            if not cut:
                return None
            runs.append((k, cut))
        elif not runs:
            runs.append((k, cut))
        else:
            runs[-1] = (runs[-1][0], cut)
        poly = cut
    starts = [k for k, _ in runs]
    out = []
    for k, t in enumerate(at):
        poly = runs[bisect.bisect_right(starts, k) - 1][1]
        vals = [a + b * (t - t0) / 1e6 for a, b in poly]
        lo, hi = min(vals), max(vals)
        out.append((mid + (lo + hi) / 2, (hi - lo) / 2))
    return out


def _clip(poly, u, bound, sign):
    """The convex polygon `poly` of (a, b) cut to sign * (a + b u) <=
    sign * bound."""
    def f(p):
        return sign * (p[0] + p[1] * u - bound)
    out = []
    for k, p in enumerate(poly):
        q = poly[(k + 1) % len(poly)]
        fp, fq = f(p), f(q)
        if fp <= 0:
            out.append(p)
        if fp * fq < 0:
            w = fp / (fp - fq)
            out.append((p[0] + w * (q[0] - p[0]), p[1] + w * (q[1] - p[1])))
    return out


def device_windows(trace, calls):
    """[(t, low, high)] a frame: the bounds on the shift that maps the
    runtime calls' clock onto the device's (the module's docstring), for
    each frame whose graph launch is in `calls`, at the time its
    synchronize returned; None where a frame's synchronize or first
    activity is missing or its first enqueue does not match it."""
    ends = [trace.window[0]] + sorted(e for _, e, name in trace.device
                                      if name == MAP_COPY)
    syncs = [h for h in trace.host if h[2].startswith(SYNC_CALL)]
    enqueues = [h for h in trace.host if h[2].startswith(ENQUEUE_CALLS)]
    starts = [d[0] for d in trace.device]
    if len(ends) < len(calls):
        return None
    out = []
    for k, (cs, _) in enumerate(calls):
        before = [h for h in syncs if h[0] < cs]
        i = bisect.bisect_left(starts, ends[k])
        if not before:
            return None
        back = before[-1][1]
        highs = []
        # The frame's enqueues, up to its graph launch, meet the device's
        # next activities in order, one each, while their kinds agree.
        for h, d in zip((h for h in enqueues if back <= h[0] <= cs),
                        trace.device[i:]):
            if not _same_kind(h[2], d[2]):
                break
            highs.append(d[0] - h[0])
            if h[2].startswith(LAUNCH_CALL):
                break
        if not highs:
            return None
        out.append((back, ends[k] - back, min(highs)))
    return out


def _same_kind(call: str, activity: str) -> bool:
    """Whether runtime call `call` may have put `activity` on the device: a
    copy a copy, a set a set, a launch a kernel (a graph anything)."""
    if "GraphLaunch" in call:
        return True
    for kind in ("Memcpy", "Memset"):
        if kind in call:
            return activity.startswith(kind)
    return not activity.startswith(("Memcpy", "Memset"))


def alignment(run):
    """(offsets_us, residual_us, entries): for each of traced_entries(run)
    the offset that maps its perf_counter_ns / 1e3 onto the trace's
    device clock, and the largest residual of the frames; None where the
    spans, the launch calls or the device's anchors are missing, their
    counts differ or a frame's own bounds cross."""
    entries = traced_entries(run)
    if not entries:
        return None
    # The stretch's frames are the profile's last: it closes after them.
    calls = [(s, e) for s, e, name in run.trace.host
             if name.startswith(LAUNCH_CALL)][-len(entries):]
    if len(calls) != len(entries):
        return None
    # Each step's line is read at the entries' starts.  The call lies
    # inside its launch span.
    starts = [es / 1e3 for (es, _), _ in entries]
    launch = [(ls / 1e3, ce - le / 1e3, cs - ls / 1e3)
              for (cs, ce), (_, (ls, le)) in zip(calls, entries)]
    calls_of = steady(launch, len(starts)) or band(launch, starts)
    windows = device_windows(run.trace, calls)
    if calls_of is None or windows is None:
        return None
    device = band(windows, [t + o for t, (o, _) in zip(starts, calls_of)])
    if device is None:
        return None
    return ([o + s for (o, _), (s, _) in zip(calls_of, device)],
            max(e1 + e2 for (_, e1), (_, e2) in zip(calls_of, device)),
            entries)


def idle_intervals(trace) -> list:
    """The stretches of the trace's window with nothing on the device."""
    t0, t1 = trace.window
    out, last = [], t0
    for s, e in busy_intervals(trace):
        if s > last:
            out.append((last, s))
        last = max(last, e)
    if t1 > last:
        out.append((last, t1))
    return out


def overlap_us(a, b) -> float:
    """The time two sorted lists of disjoint intervals share."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share(run, span: str):
    """The share (%) of the traced stretch in which nothing runs on the
    device while the host is inside the traced frames' `span` ("entry" or
    "launch", the entry's `entry.launch` child), or None where the spans
    do not map onto the trace within RESIDUAL_US."""
    mapped = alignment(run)
    if mapped is None or mapped[1] > RESIDUAL_US or window_us(run.trace) <= 0:
        return None
    offsets, _, entries = mapped
    k = 0 if span == "entry" else 1
    host = sorted((p[k][0] / 1e3 + off, p[k][1] / 1e3 + off)
                  for p, off in zip(entries, offsets))
    inside = overlap_us(idle_intervals(run.trace), host)
    return 100.0 * inside / window_us(run.trace)
