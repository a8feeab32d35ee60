"""The readers of the program's spans and counters
(benchmark/program_spans.py and the metrics `entry_idle_pct`,
`launch_idle_pct`, `first_call_s`, `cache_reserved_gb`) on hand-made
traces, spans and counters: the launch mapping and its residual, the idle
intersections, and None wherever the program's recorder or counters are
missing, empty or do not align."""

import sys
import types

import pytest

from benchmark import harness, program_spans, tracing
from benchmark.tests.support import REPO
from stereo_matchin_tpu_torch.utils import profiling

NEW = ("entry_idle_pct", "launch_idle_pct", "first_call_s",
       "cache_reserved_gb")
READ = {name: harness.load_reader(REPO, name)
        for name in NEW + ("device_idle_pct",)}
OFF = 5000.0          # the trace's clock less the spans', microseconds
CALLS = (1000.0, 2000.0, 3000.0)    # the traced frames' entry calls, us


def program(spans=None, counters=None):
    """A stand-in for the program's profiling module."""
    mod = types.SimpleNamespace()
    if spans is not None:
        mod.SPANS = spans
    if counters is not None:
        mod.COUNTERS = counters
    return mod


@pytest.fixture
def loaded(monkeypatch):
    """Puts a stand-in in sys.modules under the program's module name."""
    def put(mod):
        if mod is None:
            monkeypatch.delitem(sys.modules, program_spans.PROFILING,
                                raising=False)
        else:
            monkeypatch.setitem(sys.modules, program_spans.PROFILING, mod)
    return put


def recorded(calls=CALLS):
    """The program's recorder holding one entry a frame: the entry 10..60
    us after the call, its launch child 30..45, and a skipped frame's
    entry before them."""
    rec = profiling.SpanRecorder()
    for t in (calls[0] - 1000.0,) + tuple(calls):
        ns = [int((t + d) * 1e3) for d in (10, 30, 45, 60)]
        rec.add("entry", ns[0], ns[3], [("launch", ns[1], ns[2])])
    return rec


def frames(calls=CALLS):
    """The window's frames: the skipped one, then the traced ones; each
    call returns 70 us after it starts."""
    out = []
    for i, t in enumerate((calls[0] - 1000.0,) + tuple(calls)):
        out.append(harness.Frame(i, (10, 20), 9, t / 1e6, (t + 70) / 1e6,
                                 (t + 730) / 1e6))
    return out


def trace(calls=CALLS, shift=None, early=None, drop=None, skew=0.0,
          syncs=True, lat=None):
    """Chrome events of the stretch.  Per frame, us after its call on the
    host's clock: the static input's copy enqueued at 5 (it runs 15..20),
    the graph launched 33..42 (inside the launch span, 30..45), its kernel
    45..700, the map copy 710..720, the host in its synchronize 700..730;
    the skipped frame's copy ends the stretch's start.  Device events are
    stamped `skew` us off the host's: a number, or a function of the host's
    time.  `lat` gives each frame (the skipped one first) its
    synchronize's wake-up and its copy's launch latency, (10, 10) where
    not given.  `shift` moves one frame's launch call by (frame, us), or
    several by {frame: us},
    `early` one frame's copy (frame, us) sooner; `drop` leaves one frame's
    launch out, `syncs=False` every synchronize."""
    copy = tracing.MAP_COPY
    events = []

    def host(name, ts, dur):
        events.append({"cat": "cuda_runtime", "name": name, "ts": ts,
                       "dur": dur})

    off = skew if callable(skew) else (lambda t: skew)

    def device(name, ts, dur, cat="kernel"):
        events.append({"cat": cat, "name": name, "ts": ts + off(ts - OFF),
                       "dur": dur})

    lats = lat or [(10.0, 10.0)] * (len(calls) + 1)
    moved = dict([shift]) if isinstance(shift, tuple) else (shift or {})
    for k, t in enumerate((calls[0] - 1000.0,) + tuple(calls)):
        wake, launch = lats[k]
        k -= 1                           # -1: the skipped frame
        t += OFF
        host("cudaMemcpyAsync", t + 5, 4)
        device("Memcpy DtoD (Device -> Device)",
               t + 5 + launch - (early[1] if early and early[0] == k else 0),
               5, "gpu_memcpy")
        if drop != k:
            host("cudaGraphLaunch",
                 t + 33 + moved.get(k, 0.0), 9)
        device("k", t + 45, 655)
        host("cudaMemcpyAsync", t + 705, 3)
        device(copy, t + 710, 10, "gpu_memcpy")
        if syncs:
            host("cudaStreamSynchronize", t + 700, 20 + wake)
    return tracing.from_events(events, [(10, 20)] * len(calls), first=1)


def run_of(tr, fr=None):
    fr = frames() if fr is None else fr
    return harness.Run(None, types.SimpleNamespace(d_max=9), fr, 1.0, 5.0,
                       1, tr)


WINDOW = CALLS[-1] + 720 - (CALLS[0] - 1000 + 720)


# A frame's bounds on each step: its call 3 us from either end of its
# launch span, its synchronize's wake-up and its copy's latency 10 us each.
STEP1, STEP2 = 3.0, 10.0


@pytest.mark.parametrize("skew", [0.0, -500.0, 300.0, 5.0])
def test_the_launches_map_the_spans_onto_the_trace(loaded, skew):
    """Onto the calls' clock by the launches, then onto the device's by
    the frames' bounds, however far off the device's stamps stand; the
    residual is the two steps' half-widths."""
    loaded(program(recorded()))
    offsets, residual, entries = program_spans.alignment(run_of(trace(
        skew=skew)))
    assert offsets == pytest.approx([OFF + skew] * len(CALLS))
    # The last frame's line is read 280 us past its last bound, where the
    # lines between the bounds spread a little further.
    assert STEP1 + STEP2 <= residual <= STEP1 + STEP2 + 3
    assert len(entries) == len(CALLS)


def test_a_drifting_device_clock_is_followed_by_its_line(loaded):
    """Device stamps 85 us behind at the skipped frame's call, 15 us more
    every 1000 us: each frame's offset is the line's at its entry."""
    loaded(program(recorded()))
    def skew(t):
        return -85.0 - 0.015 * (t - CALLS[0] + 1000.0)
    offsets, residual, _ = program_spans.alignment(run_of(trace(
        skew=skew)))
    assert residual <= program_spans.RESIDUAL_US
    for offset, t in zip(offsets, CALLS):
        assert abs(offset - OFF - skew(t + 10)) <= residual


@pytest.mark.parametrize("us", [1.0, -2.0])
def test_a_call_off_the_middle_of_its_span_narrows_the_line(loaded, us):
    """One frame's call moved by `us`, still inside its span: the offset
    moves by at most that, and the residual stays within the bounds."""
    loaded(program(recorded()))
    offsets, residual, _ = program_spans.alignment(run_of(trace(
        shift=(1, us))))
    assert max(abs(o - OFF) for o in offsets) <= abs(us) + 1e-6
    assert residual <= STEP1 + STEP2 + 3


def test_launch_calls_that_drift_from_the_spans_are_read_as_a_line(loaded):
    """The launch calls 4 us later each frame: no one offset keeps every
    frame's launch inside its span, a line does."""
    loaded(program(recorded()))
    offsets, residual, _ = program_spans.alignment(run_of(trace(
        shift={1: 4.0, 2: 8.0})))
    assert offsets[0] < offsets[1] < offsets[2]
    assert residual <= program_spans.RESIDUAL_US


def test_wide_bounds_alike_on_every_frame_give_none(loaded):
    """Each frame's synchronize wakes 80 us late and its copy starts 30 us
    after its enqueue: the shift is known to 110 us, and nothing is
    mapped."""
    loaded(program(recorded()))
    r = run_of(trace(lat=[(80.0, 30.0)] * (len(CALLS) + 1)))
    assert program_spans.alignment(r)[1] > program_spans.RESIDUAL_US
    assert READ["entry_idle_pct"](r) is None
    assert READ["launch_idle_pct"](r) is None


def test_bounds_that_differ_from_frame_to_frame_narrow_the_line(loaded):
    """A frame whose synchronize woke at once bounds the shift from below,
    one whose copy started at once from above: together they pin the
    line that each frame's own bounds (110 us apart) leave open."""
    loaded(program(recorded()))
    lat = [(80.0, 30.0), (0.0, 30.0), (80.0, 30.0), (80.0, 0.0)]
    offsets, residual, _ = program_spans.alignment(run_of(trace(lat=lat)))
    assert residual <= program_spans.RESIDUAL_US
    assert max(abs(o - OFF) for o in offsets) <= residual


def test_steady_finds_the_one_offset_between_the_bounds():
    """The launch step's offset: what every frame's bounds leave, its
    middle and half its width, one a frame; crossing bounds give None."""
    windows = [(0.0, -3.0, 3.0), (1e6, -1.0, 5.0), (2e6, -2.0, 2.0)]
    assert program_spans.steady(windows, 2) == [(0.5, 1.5)] * 2
    assert program_spans.steady(windows + [(3e6, 2.5, 9.0)], 1) is None
    assert program_spans.steady([], 1) is None


def test_band_finds_the_lines_between_the_bounds():
    """Bounds around offset 100 + 0.001 t (a 1000 ppm drift): the line's
    middle and spread at each time; a window's crossing bounds give
    None."""
    windows = [(t, 100 + 0.001 * t - w, 100 + 0.001 * t + h)
               for t, w, h in [(0.0, 1.0, 60.0), (1e6, 60.0, 1.0),
                               (2e6, 2.0, 70.0), (3e6, 70.0, 2.0)]]
    got = program_spans.band(windows, [0.0, 1.5e6, 3e6])
    for (offset, error), t in zip(got, [0.0, 1.5e6, 3e6]):
        assert abs(offset - (100 + 0.001 * t)) <= error <= 5.0
    assert program_spans.band(windows[:1], [0.0]) == [
        pytest.approx((129.5, 30.5 + program_spans.EPS_US))]
    assert program_spans.band([(0.0, 2.0, 1.0)], [0.0]) is None
    assert program_spans.band([], [0.0]) is None


def test_band_starts_a_new_run_where_no_line_passes():
    """An offset steady for 1 s, then drifting 1.4% (as a profiler's device
    stamps did on an H100): each frame is read on its own run's lines, and
    its offset lies within the error given."""
    def truth(t):
        return 3.0 if t < 1e6 else 3.0 - 0.014 * (t - 1e6)
    times = [k * 50_000.0 for k in range(40)]
    windows = [(t, truth(t) - (5 + k % 7), truth(t) + (4 + k % 5))
               for k, t in enumerate(times)]
    got = program_spans.band(windows, times)
    for (offset, error), t in zip(got, times):
        assert abs(offset - truth(t)) <= error + 1e-6
    assert max(error for _, error in got) <= 10.0


@pytest.mark.parametrize("second,high", [
    ("cudaMemcpyAsync", 15.0),      # the second copy pins it closest
    ("cudaLaunchKernel", 50.0),     # a launch met by a copy: pairing stops
    (None, None)])                  # the first call met by a set: None
def test_each_enqueue_up_to_the_launch_bounds_the_device_shift(second,
                                                                 high):
    """The previous map copy ends at 0, the synchronize returns at 10;
    copies enqueued at 20 and 60 run at 70 and 75, the graph launched at
    90 starts at 150."""
    first = "cudaMemcpyAsync" if second else "cudaMemsetAsync"
    host = [(0.0, 10.0, "cudaStreamSynchronize"), (20.0, 25.0, first),
            (60.0, 65.0, second or first), (90.0, 100.0, "cudaGraphLaunch")]
    device = [(70.0, 74.0, "Memcpy DtoD (Device -> Device)"),
              (75.0, 79.0, "Memcpy DtoD (Device -> Device)"),
              (150.0, 900.0, "k")]
    tr = tracing.Trace((0.0, 1000.0), device, host, [(10, 20)])
    got = program_spans.device_windows(tr, [(90.0, 100.0)])
    assert got == (None if high is None else [(10.0, -10.0, high)])


@pytest.mark.parametrize("skew,in_entry,in_launch", [(0.0, 30, 15),
                                                    (-500.0, 30, 15)])
def test_idle_inside_the_entry_and_the_launch(loaded, skew, in_entry,
                                               in_launch):
    """Per frame the device idles from the last map copy's end to the
    static copy, 15 us after the call, and from the copy's end to the
    kernel at 45: 30 us of it in the entry (10..60), 15 in its launch
    (30..45), wherever the device's stamps stand.  launch <= entry <=
    device idle."""
    loaded(program(recorded()))
    r = run_of(trace(skew=skew))
    entry, launch = READ["entry_idle_pct"](r), READ["launch_idle_pct"](r)
    assert entry == pytest.approx(100 * 3 * in_entry / WINDOW)
    assert launch == pytest.approx(100 * 3 * in_launch / WINDOW)
    # Device idle a frame: 295 us before the copy, 25 before the kernel,
    # 10 between the kernel and the map copy.
    device = READ["device_idle_pct"](r)
    assert device == pytest.approx(100 * 3 * (295 + 25 + 10) / WINDOW)
    assert launch <= entry <= device


def test_overlap_of_interval_lists():
    a = [(0, 10), (20, 30), (40, 50)]
    b = [(5, 25), (28, 45)]
    assert program_spans.overlap_us(a, b) == 5 + 5 + 2 + 5
    assert program_spans.overlap_us(a, []) == 0


@pytest.mark.parametrize("case", ["no module", "no recorder", "empty",
                                  "no trace", "misaligned", "count",
                                  "two entries", "no launch", "early device",
                                  "no synchronize"])
def test_idle_reads_nothing_without_aligned_spans(loaded, case):
    tr, fr = trace(), frames()
    rec = recorded()
    if case == "no module":
        loaded(None)
    elif case == "no recorder":
        loaded(program(counters={}))
    elif case == "empty":
        loaded(program(profiling.SpanRecorder()))
    else:
        loaded(program(rec))
    if case == "no trace":
        tr = None
    elif case == "misaligned":
        tr = trace(shift=(2, 60.0))     # 57 us out of its span
    elif case == "count":
        tr = trace(drop=1)
    elif case == "early device":
        tr = trace(early=(1, 140.0))     # 60 us off either bound
    elif case == "no synchronize":
        tr = trace(syncs=False)
    elif case == "two entries":          # a frame called the entry twice
        ns = int((CALLS[1] + 62) * 1e3)
        rec.add("entry", ns, ns + 5000, [("launch", ns + 1, ns + 2)])
    elif case == "no launch":
        rec.spans = [s for s in rec.spans if not (
            s.name == "entry.launch" and s.start_ns > CALLS[1] * 1e3)]
    r = run_of(tr, fr)
    assert READ["entry_idle_pct"](r) is None
    assert READ["launch_idle_pct"](r) is None


def counters(first=(0.5, 0.25, 1.0), peak=2_500_000_000, calls=1):
    """A stand-in for the program's counters of the frame cache."""
    warm, room, capture = first
    return {"frames": types.SimpleNamespace(
        first_calls=calls, warmup_s=calls * warm, make_room_s=calls * room,
        capture_s=calls * capture, peak_bytes=peak)}


def test_first_calls_and_the_cache_high_water_mark(loaded):
    loaded(program(counters=counters(calls=2)))
    r = run_of(None)
    assert READ["first_call_s"](r) == pytest.approx(2 * 1.75)
    assert READ["cache_reserved_gb"](r) == pytest.approx(2.5)


@pytest.mark.parametrize("case", ["no module", "no counters", "no frames",
                                  "no first call", "not a table"])
def test_counters_read_nothing_where_absent(loaded, case):
    mod = {"no module": None, "no counters": program(),
           "no frames": program(counters={"stages": counters()["frames"]}),
           "no first call": program(counters=counters(calls=0, peak=0)),
           "not a table": program(counters=3)}[case]
    loaded(mod)
    r = run_of(None)
    assert READ["first_call_s"](r) is None
    assert READ["cache_reserved_gb"](r) is None
