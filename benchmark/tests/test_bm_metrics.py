"""The metrics' arithmetic on hand-made runs and traces."""

import types

import pytest

from benchmark import harness, tracing
from benchmark.tests.support import REPO

READ = {name: harness.load_reader(REPO, name) for name in (
    "throughput", "latency_p95", "submit_ms", "setup_s", "peak_reserved_gb",
    "frame_device_ms", "device_idle_pct")}


def frames(ms_each, size=(10, 20), d_max=9, submit_ms=0.5):
    """Back-to-back frames of the given host milliseconds from t = 0."""
    out, t = [], 0.0
    for i, ms in enumerate(ms_each):
        out.append(harness.Frame(i % 4, size, d_max, t, t + submit_ms / 1e3,
                                 t + ms / 1e3))
        t += ms / 1e3
    return out


def run_of(fr, trace=None, setup_s=5.0, peak=3 * 10 ** 9):
    window = fr[-1].t_host - fr[0].t_call
    return harness.Run(None, types.SimpleNamespace(d_max=9), fr, window,
                       setup_s, peak, trace)


def test_throughput_is_all_work_over_the_window():
    r = run_of(frames([10.0] * 10))
    assert READ["throughput"](r) == pytest.approx(10 * 20 * 10 * 10 / 0.1 / 1e6)


@pytest.mark.parametrize("at", [0, 4, 9])
def test_a_stalled_frame_moves_throughput_and_the_tail(at):
    steady = run_of(frames([10.0] * 10))
    ms = [10.0] * 10
    ms[at] = 250.0
    stalled = run_of(frames(ms))
    assert READ["throughput"](stalled) < 0.5 * READ["throughput"](steady)
    assert READ["latency_p95"](steady) == pytest.approx(10.0)
    assert READ["latency_p95"](stalled) == pytest.approx(250.0)


def test_p95_is_over_all_frames():
    ms = [10.0] * 100
    for i in range(0, 100, 10):      # 10 slow frames spread over the window
        ms[i] = 30.0
    assert READ["latency_p95"](run_of(frames(ms))) == pytest.approx(30.0)
    ms[0] = ms[10] = ms[20] = ms[30] = ms[40] = ms[50] = 10.0
    assert READ["latency_p95"](run_of(frames(ms))) == pytest.approx(10.0)


def test_submit_setup_and_peak():
    r = run_of(frames([10.0] * 5, submit_ms=0.25), setup_s=7.5,
               peak=2_500_000_000)
    assert READ["submit_ms"](r) == pytest.approx(0.25)
    assert READ["setup_s"](r) == 7.5
    assert READ["peak_reserved_gb"](r) == pytest.approx(2.5)
    assert READ["peak_reserved_gb"](run_of(frames([1.0]), peak=0)) is None


def trace_of(device, window=(0.0, 100.0), host=(), n_frames=2, first=0):
    return tracing.Trace(window, sorted(device), sorted(host),
                         [(10, 20)] * n_frames, first)


def test_idle_share_is_from_the_union_of_intervals():
    # [10, 40] and [20, 50] overlap: busy 40 + 10 of 100.
    tr = trace_of([(10.0, 40.0, "a"), (20.0, 50.0, "b"), (70.0, 80.0, "c")])
    assert tracing.busy_us(tr) == 50.0
    r = run_of(frames([10.0]), trace=tr)
    assert READ["device_idle_pct"](r) == pytest.approx(50.0)
    # Device time sums the activities (overlap counted twice), per frame.
    assert READ["frame_device_ms"](r) == pytest.approx((30 + 30 + 10) / 2 / 1e3)


@pytest.mark.parametrize("first,n_frames", [(1, 2), (1, 4), (3, 2)])
def test_submit_reads_the_frames_after_the_stretch(first, n_frames):
    # The traced frames' entry calls (2 ms) are left out; those after
    # the stretch take 0.25 ms.
    fr = frames([10.0] * 10, submit_ms=0.25)
    end = first + n_frames
    fr[first:end] = [f._replace(t_return=f.t_call + 2e-3) for f in fr[first:end]]
    tr = trace_of([(10.0, 40.0, "a")], n_frames=n_frames, first=first)
    assert READ["submit_ms"](run_of(fr, trace=tr)) == pytest.approx(0.25)
    assert READ["submit_ms"](run_of(fr)) == pytest.approx(0.25)
    assert READ["submit_ms"](run_of(fr[:end], trace=tr)) is None


def test_no_trace_reads_nothing():
    r = run_of(frames([10.0]))
    assert READ["device_idle_pct"](r) is None
    assert READ["frame_device_ms"](r) is None


def test_breakdown_names_ops_and_gaps():
    copy = tracing.MAP_COPY
    host = [(3.0, 12.0, "cudaGraphLaunch"), (55.0, 98.0, "cudaMemcpyAsync")]
    tr = trace_of([(20.0, 40.0, "void k1<1>(float)"), (60.0, 70.0, "k2"),
                   (72.0, 80.0, "void k1<1>(float)"), (90.0, 100.0, copy)],
                  host=host)
    ops = tracing.top_ops(tr)
    assert ops == [["void k1<1>(float)", 28e-6], ["k2", 10e-6],
                   [copy, 10e-6]]
    gaps = tracing.idle_gaps(tr)
    assert gaps == [["host", 20e-6],                            # 40 .. 60
                    ["after map copy/cudaGraphLaunch", 20e-6],  # 0 .. 20
                    ["cudaMemcpyAsync", 10e-6],                 # 80 .. 90
                    ["cudaMemcpyAsync", 2e-6]]                  # 70 .. 72
    assert sum(g[1] for g in gaps) == pytest.approx(
        (100 - tracing.busy_us(tr)) / 1e6)


def test_trace_from_chrome_events_keeps_the_stretch():
    copy = tracing.MAP_COPY
    events = [
        {"cat": "kernel", "name": "before", "ts": 10, "dur": 20},
        {"cat": "gpu_memcpy", "name": copy, "ts": 90, "dur": 10},   # skipped
        {"cat": "kernel", "name": "k", "ts": 110, "dur": 10},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)",
         "ts": 125, "dur": 5},
        {"cat": "gpu_memcpy", "name": copy, "ts": 140, "dur": 10},
        {"cat": "kernel", "name": "after", "ts": 160, "dur": 10},
        {"cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 101,
         "dur": 2},
    ]
    tr = tracing.from_events(events, [(1, 1)], first=3)
    assert tr.window == (100.0, 150.0) and tr.first == 3
    assert [d[2] for d in tr.device] == [
        "k", "Memcpy DtoD (Device -> Device)", copy]
    assert tracing.busy_us(tr) == 25.0
    assert tr.host == [(101.0, 103.0, "cudaGraphLaunch")]
    # The copies must number the traced frames and the skipped one.
    assert tracing.from_events(events, [(1, 1)] * 2) is None
    assert tracing.from_events(events[2:], [(1, 1)]) is None
