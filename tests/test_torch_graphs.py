"""The frame-graph cache (stereo_matchin_tpu_torch/utils/graphs.py) on the
CPU: its signature key, its launch bookkeeping, least-recently-used order
and memory rules as plain functions (the card's memory calls faked), and the captured entries (`asw_pipeline`,
`cross_pipeline`, `asw_pipeline_batched`), which on CPU tensors call
their eager chains (`*_impl`) and touch no `torch.cuda`.  The captures
themselves run on the card (tests/test_torch_cuda.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from stereo_matchin_tpu_torch import models
from stereo_matchin_tpu_torch.config import TINY_CONFIG
from stereo_matchin_tpu_torch.models import asw, cross_based
from stereo_matchin_tpu_torch.utils import graphs

from .torch_support import unorm8_pair


def _pair(H=24, W=32, seed=0):
    return tuple(torch.from_numpy(a)
                 for a in unorm8_pair(np.random.default_rng(seed), H, W))


def test_signature_separates_entry_shape_dtype_device_cfg_and_crop():
    a = torch.zeros(4, 6, 3)
    base = graphs.signature(asw.asw_pipeline_impl, (a, a),
                            (TINY_CONFIG, (0, 0)))
    assert base == graphs.signature(asw.asw_pipeline_impl,
                                    (a.clone(), torch.ones(4, 6, 3)),
                                    (TINY_CONFIG.replace(), (0, 0)))
    others = [
        graphs.signature(cross_based.cross_pipeline_impl, (a, a),
                         (TINY_CONFIG, (0, 0))),
        graphs.signature(asw.asw_pipeline_impl, (a, torch.zeros(4, 7, 3)),
                         (TINY_CONFIG, (0, 0))),
        graphs.signature(asw.asw_pipeline_impl, (a, a.double()),
                         (TINY_CONFIG, (0, 0))),
        graphs.signature(asw.asw_pipeline_impl, (a, a.to("meta")),
                         (TINY_CONFIG, (0, 0))),
        graphs.signature(asw.asw_pipeline_impl, (a, a),
                         (TINY_CONFIG.replace(kernels="jnp"), (0, 0))),
        graphs.signature(asw.asw_pipeline_impl, (a, a),
                         (TINY_CONFIG, (1, 0))),
    ]
    assert len({base, *others}) == 1 + len(others)
    hash(base)


@pytest.fixture
def no_cuda(monkeypatch):
    """Every torch.cuda call the cache makes raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("torch.cuda touched on a CPU call")

    for name in ("CUDAGraph", "graph", "Stream", "stream", "device", "Event",
                 "synchronize", "empty_cache", "mem_get_info",
                 "reset_peak_memory_stats", "memory_allocated",
                 "max_memory_allocated", "memory_reserved", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)


@pytest.mark.parametrize("entry,impl,statics", [
    (asw.asw_pipeline, "asw_pipeline_impl", (TINY_CONFIG,)),
    (asw.asw_pipeline, "asw_pipeline_impl", (TINY_CONFIG, (2, 3))),
    (cross_based.cross_pipeline, "cross_pipeline_impl", (TINY_CONFIG,))])
def test_cpu_call_runs_the_eager_chain_once_and_no_cuda(entry, impl, statics,
                                                        no_cuda, monkeypatch):
    module = asw if impl.startswith("asw") else cross_based
    eager = getattr(module, impl)
    calls = []

    def counted(*args):
        calls.append(args)
        return eager(*args)

    monkeypatch.setattr(module, impl, counted)
    left, right = _pair()
    got = entry(left, right, *statics)
    assert len(calls) == 1
    assert calls[0][0] is left and calls[0][1] is right
    want = eager(left, right, *statics)
    assert type(got) is type(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not graphs.CACHE.frames


def test_captured_entries_equal_their_eager_chains_on_the_cpu():
    left, right = _pair(seed=1)
    for got, want in (
            (asw.asw_pipeline(left, right, TINY_CONFIG),
             asw.asw_pipeline_impl(left, right, TINY_CONFIG)),
            (asw.asw_pipeline(left, right, TINY_CONFIG, (3, 2)),
             asw.asw_pipeline_impl(left, right, TINY_CONFIG, (3, 2))),
            (cross_based.cross_pipeline(left, right, TINY_CONFIG),
             cross_based.cross_pipeline_impl(left, right, TINY_CONFIG))):
        assert got._fields == want._fields
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_batched_entry_stacks_the_eager_frames_on_the_cpu(no_cuda):
    pairs = [_pair(seed=s) for s in (2, 3, 4)]
    got = asw.asw_pipeline_batched(torch.stack([p[0] for p in pairs]),
                                   torch.stack([p[1] for p in pairs]),
                                   TINY_CONFIG)
    for b, (left, right) in enumerate(pairs):
        for g, w in zip(got, asw.asw_pipeline_impl(left, right, TINY_CONFIG)):
            assert torch.equal(g[b], w)


def test_launch_bookkeeping_counts_one_frame_a_replay():
    before = dict(two_min=3, wta_diag=3, vote_h=0)
    after = dict(two_min=10, wta_diag=10, vote_h=0)
    frame = graphs.launch_delta(before, after)
    assert frame == dict(two_min=7, wta_diag=7, vote_h=0)
    counts = dict(before)              # the capture's counts put back
    for _ in range(3):
        graphs.add_launches(counts, frame)
    assert counts == dict(two_min=24, wta_diag=24, vote_h=0)


def test_cache_evicts_the_least_recently_used(monkeypatch):
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    cache = graphs.GraphCache()
    for k in "abcd":
        cache.put(k, k.upper())
    assert cache.get("a") == "A"                  # a is now the newest
    assert cache.get("z") is None
    cache.evict_to(graphs.MAX_GRAPHS - 1)         # room for one capture
    assert list(cache.frames) == ["c", "d", "a"]
    cache.put("e", "E")
    cache.get("c")
    cache.evict_oldest()
    assert list(cache.frames) == ["a", "e", "c"]
    cache.clear()
    assert not cache.frames


class _Frame:
    """A captured frame as the cache's memory rules see it."""

    def __init__(self, footprint):
        self.footprint = footprint


class _Card:
    """mem_get_info of a card of `total` bytes holding the cache's
    frames' footprints and `other` bytes besides."""

    def __init__(self, cache, total, other=0):
        self.cache, self.total, self.other = cache, total, other

    def mem_get_info(self, device=None):
        held = sum(f.footprint for f in self.cache.frames.values())
        return self.total - held - self.other, self.total


def test_capture_need_counts_the_pool_margin_and_the_clones():
    warm = {"warmup_peak_bytes": 20_000, "output_bytes": 6_000}
    assert graphs.capture_need(warm) == (
        20_000 + int(20_000 * graphs.POOL_MARGIN) + 6_000)
    assert graphs.capture_need(warm) > 20_000 + 6_000
    assert graphs.nbytes((torch.zeros(3, 4), torch.zeros(5, dtype=torch.int8),
                          torch.zeros(0))) == 3 * 4 * 4 + 5


def test_make_room_evicts_the_oldest_until_the_need_fits(monkeypatch):
    cache = graphs.GraphCache()
    card = _Card(cache, total=100, other=10)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "mem_get_info", card.mem_get_info)
    for k, size in zip("abc", (30, 20, 25)):
        cache.put(k, _Frame(size))
    assert cache.largest_footprint() == 30
    cache.make_room(15, "cuda")                   # 15 free: nothing goes
    assert list(cache.frames) == ["a", "b", "c"]
    cache.make_room(40, "cuda")                   # a goes (45 free)
    assert list(cache.frames) == ["b", "c"]
    cache.make_room(1000, "cuda")                 # more than the card
    assert not cache.frames
    assert graphs.GraphCache().largest_footprint() == 0


def test_first_call_makes_room_before_the_warm_up_and_the_capture(
        monkeypatch):
    """Four held frames of 20 on a card of 100 with 25 in use besides (the
    caller's last result, say): for a new signature, a goes for the count
    and b for the largest footprint before the warm-up (peak 26, result
    6); c goes before the capture, which needs 26 + 6 + 6."""
    cache = graphs.GraphCache()
    card = _Card(cache, total=100, other=25)
    events = []
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "mem_get_info", card.mem_get_info)
    evict = cache.evict_oldest

    def evict_oldest():
        events.append(("evict", next(iter(cache.frames))))
        evict()

    def warm_up(fn, inputs, statics, dev):
        events.append(("warm_up", card.mem_get_info()[0]))
        return {"warmup_peak_bytes": 26, "output_bytes": 6, "launches": {}}

    def capture(fn, inputs, statics, dev, warm):
        events.append(("capture", card.mem_get_info()[0]))
        return _Frame(38)

    monkeypatch.setattr(graphs, "POOL_MARGIN", 0.25)
    monkeypatch.setattr(cache, "evict_oldest", evict_oldest)
    monkeypatch.setattr(graphs, "warm_up", warm_up)
    monkeypatch.setattr(graphs, "capture", capture)
    for k in "abcd":
        cache.put(k, _Frame(20))
    assert cache.first_call(None, (torch.zeros(2),), (), "cuda").footprint \
        == 38
    assert events == [("evict", "a"), ("evict", "b"), ("warm_up", 35),
                      ("evict", "c"), ("capture", 55)]
    assert list(cache.frames) == ["d"]


def test_warm_up_out_of_memory_evicts_and_runs_again(monkeypatch):
    """A warm-up that runs out of memory is run again with one graph fewer,
    while one is left; with none left the error stands."""
    cache = graphs.GraphCache()
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (
        10**12, 10**12))
    runs = []

    def warm_up(fn, inputs, statics, dev):
        runs.append(list(cache.frames))
        if len(cache.frames) > 1:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return {"warmup_peak_bytes": 1, "output_bytes": 1, "launches": {}}

    monkeypatch.setattr(graphs, "warm_up", warm_up)
    monkeypatch.setattr(graphs, "capture", lambda *args: "captured")
    for k in "abc":
        cache.put(k, _Frame(1))
    assert cache.first_call(None, (torch.zeros(1),), (), "cuda") == "captured"
    assert runs == [["a", "b", "c"], ["b", "c"], ["c"]]
    monkeypatch.setattr(graphs, "warm_up", lambda *args: (_ for _ in ()).throw(
        torch.cuda.OutOfMemoryError("out of memory")))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        cache.first_call(None, (torch.zeros(1),), (), "cuda")
    assert not cache.frames


def test_models_export_the_eager_chains():
    for name in ("asw_pipeline_impl", "cross_pipeline_impl", "asw_pipeline",
                 "cross_pipeline", "asw_pipeline_batched"):
        assert name in models.__all__
        assert getattr(models, name) is getattr(
            asw if name.startswith("asw") else cross_based, name)
