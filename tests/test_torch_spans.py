"""The frame entry's spans and the frame cache's counters
(stereo_matchin_tpu_torch/utils/profiling.py, recorded by utils/graphs.py)
on the CPU: spans only inside a torch.profiler session, the launch linked
to its entry and inside it, a bounded store, none for CPU tensors; counters of
the frame cache's first calls, their seconds and its high-water mark,
which outlive `clear_caches()`; `GraphFamily.stats()` as it was.
The card's calls are faked (tests/torch_support.py FakeCard); the graph is
a stand-in whose replay does nothing.  One test on the card shows that a
CUDA-only profiler turns recording on."""

from __future__ import annotations

import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stereo_matchin_tpu_torch.utils import graphs, profiling

from .torch_support import FakeCard, cuda_device

ENTRY = ["entry", "entry.launch"]
STATS_FIELDS = {"graphs", "warmup_s", "capture_s", "pool_bytes",
                "input_bytes"}


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that the cache takes
    it through its CUDA path."""

    is_cuda = True


def _on_card(*shape):
    return torch.zeros(*shape).as_subclass(_OnCard)


class _Graph:
    """A torch.cuda.CUDAGraph as CapturedFrame uses it."""

    def replay(self):
        pass


class _Event:
    def record(self, stream=None):
        pass


def _frame_fn(left, right, k):
    return left + k * right


@pytest.fixture
def card(monkeypatch):
    """A fake card whose captures are CapturedFrames on a stand-in graph,
    fresh counters and a fresh span store."""
    monkeypatch.setattr(profiling, "COUNTERS",
                        {"frames": profiling.GraphCounters()})
    monkeypatch.setattr(profiling, "SPANS", profiling.SpanRecorder())
    fake = FakeCard(monkeypatch, total=10**6, peak=400, output=100)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.
                        SimpleNamespace(wait_event=lambda e: None))
    kept = []

    def capture(fn, inputs, statics, dev, warm, pool, stream):
        fake.events.append(("capture", pool, stream, fake.free()))
        kept.append(fn(*inputs, *statics))
        return graphs.CapturedFrame(_Graph(), inputs, kept[-1], {}, {
            "warmup_s": warm["warmup_s"], "capture_s": 0.25})

    monkeypatch.setattr(graphs, "capture", capture)
    return fake


def _call(w=5):
    return graphs.replay(_frame_fn, (_on_card(4, w), _on_card(4, w)), (2,))


def _names():
    return [s.name for s in profiling.SPANS.spans]


def test_spans_are_recorded_only_inside_a_profiler_session(card):
    _call()
    assert profiling.SPANS.spans == []
    with profile(activities=[ProfilerActivity.CPU]):
        _call(6)              # a first call
        _call(6)              # a replay
    assert _names() == ENTRY + ENTRY
    _call(6)
    _call(7)
    assert _names() == ENTRY + ENTRY
    assert profiling.SPANS.dropped == 0


def test_the_launch_links_to_its_entry_and_lies_inside_it(card):
    with profile(activities=[ProfilerActivity.CPU]):
        _call()
        _call()
    spans = profiling.SPANS.spans
    assert len({s.id for s in spans}) == len(spans)
    entries = [s for s in spans if s.name == "entry"]
    assert len(entries) == 2
    for entry in entries:
        assert entry.parent is None and entry.entry == entry.id
        (launch,) = [s for s in spans if s.entry == entry.id
                     and s is not entry]
        assert launch.name == "entry.launch" and launch.parent == entry.id
        assert entry.start_ns <= launch.start_ns <= launch.end_ns \
            <= entry.end_ns


def test_the_store_is_bounded_and_counts_what_it_drops(card, monkeypatch):
    """An entry that would pass the limit is turned away whole."""
    monkeypatch.setattr(profiling, "SPANS", profiling.SpanRecorder(limit=5))
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(4):
            _call()           # 2 spans an entry: the third would make 6
    assert _names() == ENTRY + ENTRY
    assert profiling.SPANS.dropped == 2 * len(ENTRY)
    profiling.SPANS.clear()
    assert profiling.SPANS.spans == [] and profiling.SPANS.dropped == 0
    with profile(activities=[ProfilerActivity.CPU]):
        _call()
    assert _names() == ENTRY


def test_cpu_entries_record_no_spans_and_count_nothing(card):
    left, right = torch.rand(3, 4), torch.rand(3, 4)
    with profile(activities=[ProfilerActivity.CPU]):
        out = graphs.replay(_frame_fn, (left, right), (2,))
    assert torch.equal(out, left + 2 * right)
    assert profiling.SPANS.spans == []
    assert vars(profiling.COUNTERS["frames"]) == _fresh()


def _fresh():
    return vars(profiling.GraphCounters())


def test_counters_count_first_calls_and_outlive_clear_caches(card):
    """Two signatures, three calls each; a drop by free_memory and
    clear_caches() leave the counts as they were."""
    frames = profiling.COUNTERS["frames"]
    for _ in range(3):
        for w in (5, 6):
            _call(w)
    assert frames.first_calls == 2
    assert frames.warmup_s == 2 * 0.5 and frames.capture_s == 2 * 0.25
    assert frames.make_room_s > 0
    # The pool (the warm-up's 400 bytes) and both signatures' inputs.
    assert frames.peak_bytes == 400 + 2 * 4 * 4 * (5 + 6)
    before = dict(vars(frames))
    assert graphs.free_memory()                   # the frames go
    assert not graphs.CACHE.graphs and vars(frames) == before
    _call(5)
    assert frames.first_calls == 3
    assert frames.peak_bytes == before["peak_bytes"]
    before = dict(vars(frames))
    graphs.clear_caches()
    assert vars(frames) == before


def test_the_high_water_mark_is_read_after_each_capture_only(card):
    """A pool that grew after its capture is seen at the next capture, not
    at a replay."""
    frames = profiling.COUNTERS["frames"]
    _call(5)
    assert frames.peak_bytes == 400 + 2 * 4 * 4 * 5
    pool = graphs.CACHE.pools[torch.device("cpu"), False]
    pool.reserved = 5000
    _call(5)
    assert frames.peak_bytes == 400 + 2 * 4 * 4 * 5
    _call(6)
    assert frames.peak_bytes == 5000 + 2 * 4 * 4 * (5 + 6)


def test_a_drop_reads_the_high_water_mark_before_it(card):
    """A warm-up that outgrows the frames' pool and runs out of memory: the
    pool it grew is counted before the frames go."""
    frames = profiling.COUNTERS["frames"]
    _call(5)
    pool = graphs.CACHE.pools[torch.device("cpu"), False]
    pool.reserved = 5000                          # a warm-up grew it
    card.oom = lambda: bool(graphs.CACHE.graphs)
    _call(6)
    assert frames.peak_bytes == 5000 + 2 * 4 * 4 * 5


def test_stats_and_the_dry_runs_fields_are_unchanged(card):
    """stats() keeps its fields (the dry run's `stages`, chip_smoke's reads)
    and their meaning: the seconds of the graphs held."""
    for family in (graphs.CACHE, graphs.STAGES):
        assert family.stats() == dict.fromkeys(STATS_FIELDS, 0)
    _call(5)
    _call(6)
    st = graphs.CACHE.stats()
    assert set(st) == STATS_FIELDS
    assert (st["graphs"], st["warmup_s"], st["capture_s"]) == (2, 1.0, 0.5)
    assert st["input_bytes"] == 2 * 4 * 4 * (5 + 6)
    graphs.CACHE.clear()
    _call(7)
    st = graphs.CACHE.stats()
    assert (st["graphs"], st["warmup_s"], st["capture_s"]) == (1, 0.5, 0.25)
    assert profiling.COUNTERS["frames"].first_calls == 3


@pytest.mark.cuda
def test_a_cuda_only_profiler_turns_recording_on():
    """The benchmark's trace records CUDA activities only; the profiler's
    flag, which the spans follow, flips all the same."""
    cuda_device()
    assert profiling.SPANS.open("entry") is None
    with profile(activities=[ProfilerActivity.CUDA]):
        timeline = profiling.SPANS.open("entry")
        assert timeline is not None
    assert profiling.SPANS.open("entry") is None
