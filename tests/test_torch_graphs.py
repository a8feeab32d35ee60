"""The frame-graph cache (stereo_matchin_tpu_torch/utils/graphs.py) on the
CPU: its signature key, its launch bookkeeping and its memory rules (every
signature kept while the card has room, the frames' one pool, families
dropped as a whole; the card's calls faked, tests/torch_support.py
FakeCard), and the captured entries (`asw_pipeline`, `cross_pipeline`,
`asw_pipeline_batched`), which on CPU tensors call their eager chains
(`*_impl`) and touch no `torch.cuda`.  The captures themselves run on the
card (tests/test_torch_cuda.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from stereo_matchin_tpu_torch import models
from stereo_matchin_tpu_torch.config import TINY_CONFIG
from stereo_matchin_tpu_torch.models import asw, cross_based
from stereo_matchin_tpu_torch.utils import graphs

from .torch_support import FakeCard as graphs_card
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
    assert not graphs.CACHE.graphs


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


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that the cache takes
    it through its CUDA path (the card's calls faked)."""

    is_cuda = True


def _on_card(*shape):
    return torch.zeros(*shape).as_subclass(_OnCard)


def _frame_fn(left, right, cfg):
    return "eager frame"


@pytest.mark.parametrize("count", [2, 5, 9])
def test_cache_holds_every_signature_while_the_card_has_room(count,
                                                             monkeypatch):
    """`count` signatures, each called once and then twice more in a
    shuffled order: each is captured once, into the device's one frame
    pool, and every later call replays its own graph; nothing is
    dropped."""
    card = graphs_card(monkeypatch, total=10**6, peak=400, output=100)
    cache = graphs.CACHE
    pairs = {w: (_on_card(4, w, 3), _on_card(4, w, 3)) for w in
             range(8, 8 + count)}
    order = list(pairs) + [int(w) for w in np.random.default_rng(
        count).permutation(list(pairs) * 2)]
    for w in order:
        assert cache(_frame_fn, pairs[w], (TINY_CONFIG,)) == "output"
    assert len(cache.graphs) == count
    assert [g.calls for g in cache.graphs.values()] == [3] * count
    assert [e[0] for e in card.events] == ["warm_up", "capture"] * count
    assert len(cache.pools) == 1
    pool = cache.pools[torch.device("cpu"), False]
    assert all(e[1] is pool and e[2] == "stream" for e in card.events)
    assert pool.reserved == 400                   # the largest peak, once
    assert {key[1][0][0][1] for key in cache.graphs} == set(pairs)


# (the frames' pool, the card's other bytes, whether a hold holds a stage
# graph) -> what a new frame signature's first call drops.  On a card of
# 2500 the stage graphs hold a pool of 500; the new signature (peak 600,
# result 50, two inputs of 100 bytes) warms up in the frames' pool, which
# holds it, and its capture needs POOL_MARGIN of the peak above the pool's
# free bytes, the clones and the inputs.  Dropping the frames frees their
# pool and leaves the capture a new one: 750 + 250.
FIRST_CALL_DROPS = {
    (1000, 300, False): [],
    (1000, 900, False): [("drop", "frames")],
    (600, 1100, False): [("drop", "frames"), ("drop", "stages")],
    (600, 1100, True): [("drop", "frames")],
}


@pytest.mark.parametrize("frames_pool,other,held", list(FIRST_CALL_DROPS))
def test_first_call_that_does_not_fit_frees_frames_then_stage_graphs(
        frames_pool, other, held, monkeypatch):
    """Three frames share a pool, all of it free between calls; where the
    card has fewer free bytes than a new signature's capture needs, the
    frame family goes as a whole, and then, if the capture still does not
    fit, every stage graph, unless a hold holds one."""
    dev = torch.device("cpu")
    card = graphs_card(monkeypatch, total=2500, other=other, peak=600,
                       output=50)
    card.held("frames", 3, frames_pool, dev=dev)
    card.held("stages", 2, 500)
    stages = graphs.STAGES
    left, right = _on_card(5, 5), _on_card(5, 5)
    with stages.hold():
        if held:
            stages._held.add("stages 0")
        graph = graphs.CACHE.first_call(_frame_fn, (left, right),
                                        (TINY_CONFIG,), dev)
    drops = FIRST_CALL_DROPS[frames_pool, other, held]
    assert [e for e in card.events if e[0] == "drop"] == drops
    warm, cap = (e for e in card.events if e[0] != "drop")
    assert (warm[0], cap[0]) == ("warm_up", "capture")
    assert warm[1].reserved == frames_pool        # it fitted in the pool
    assert (cap[1] is warm[1]) == (not drops)
    assert len(graphs.CACHE.graphs) == (0 if drops else 3)
    assert len(stages.graphs) == (0 if ("drop", "stages") in drops else 2)
    if not held:
        pool_need = 0 if frames_pool > 750 else 750 - frames_pool
        assert cap[3] >= 250 + (750 if drops else pool_need)
    assert [t.shape for t in graph.inputs] == [left.shape, right.shape]
    assert graph.inputs[0] is not left and graph.done == "event"


@pytest.mark.parametrize("pool_free", [0, 300, 450, 2000])
def test_new_signature_needs_only_what_it_adds_above_the_pool(pool_free,
                                                              monkeypatch):
    """A first call's need (make_room's) is the capture's pool (the warm-up's
    peak of 400 and POOL_MARGIN of it) above the bytes free in the shared
    pool after the warm-up, the clones of its result (100) and its new
    static inputs (two of 64 bytes)."""
    dev = torch.device("cpu")
    graphs_card(monkeypatch, total=10**6, peak=400, output=100).held(
        "frames", 1, pool_free, dev=dev)
    needs = []
    make_room = graphs.make_room

    def recording(need, device):
        needs.append(need())
        make_room(need, device)

    monkeypatch.setattr(graphs, "make_room", recording)
    graphs.CACHE.first_call(_frame_fn, (_on_card(4, 4), _on_card(4, 4)),
                            (TINY_CONFIG,), dev)
    free = max(pool_free, 400)                    # the warm-up's blocks
    assert needs == [max(0, 400 + int(400 * graphs.POOL_MARGIN) - free)
                     + 100 + 2 * 64]
    assert len(graphs.CACHE.graphs) == 1          # the held one


def test_capture_need_counts_the_pool_margin_and_the_clones():
    warm = {"warmup_peak_bytes": 20_000, "output_bytes": 6_000}
    assert graphs.capture_need(warm) == (
        20_000 + int(20_000 * graphs.POOL_MARGIN) + 6_000)
    assert graphs.capture_need(warm) > 20_000 + 6_000
    assert graphs.nbytes((torch.zeros(3, 4), torch.zeros(5, dtype=torch.int8),
                          torch.zeros(0))) == 3 * 4 * 4 + 5


def test_make_room_evicts_the_oldest_until_the_need_fits(monkeypatch):
    """make_room frees families, never one graph: nothing while the need
    fits, then every frame at once, then every stage graph; the need is
    asked again after each drop."""
    card = graphs_card(monkeypatch, total=1000, other=100)
    card.held("frames", 3, 300)
    card.held("stages", 2, 200)
    asked = []

    def need(n):
        return lambda: asked.append(n) or n

    graphs.make_room(need(400), "cuda")           # 400 free: nothing goes
    assert len(graphs.CACHE.graphs) == 3 and asked == [400]
    graphs.make_room(need(600), "cuda")           # the frames go: 700 free
    assert not graphs.CACHE.graphs and not graphs.CACHE.pools
    assert len(graphs.STAGES.graphs) == 2 and asked == [400, 600, 600]
    graphs.make_room(need(10**6), "cuda")         # more than the card
    assert not graphs.STAGES.graphs and card.free() == 900
    assert card.events == [("drop", "frames"), ("drop", "stages")]
    assert not graphs.free_memory()


def test_first_call_makes_room_before_the_warm_up_and_the_capture(
        monkeypatch):
    """The warm-up runs on the caller's own tensors in the frames' pool on
    the family's stream (its memory is the pool's own: no room is made for
    it outside); room for the capture is made after it; the capture runs
    in the same pool, on the same stream, on this signature's own copies
    of the tensors; the outputs become borrowed views of what the capture
    wrote and the event is the family's."""
    card = graphs_card(monkeypatch, total=10**6, peak=26, output=6,
                       run=True)
    warmed, made, wrote = [], [], []
    warm_up, make_room = card.warm_up, graphs.make_room
    monkeypatch.setattr(graphs, "warm_up", lambda fn, inputs, *args: (
        warmed.append(inputs), warm_up(fn, inputs, *args))[1])
    monkeypatch.setattr(graphs, "make_room", lambda need, dev: (
        made.append(len(card.events)), make_room(need, dev)))

    def fn(left, right, k):
        wrote.append(left + k * right)
        return wrote[-1], (right,)

    left, right = torch.rand(4, 5), torch.rand(4, 5)
    dev = torch.device("cpu")
    graph = graphs.CACHE.first_call(fn, (left, right), (2,), dev)
    assert [e[0] for e in card.events] == ["warm_up", "capture"]
    assert made == [1]                            # between the two
    assert warmed[0][0] is left and warmed[0][1] is right
    pool = graphs.CACHE.pools[dev, False]
    assert card.events[0][1:3] == (pool, "stream") == card.events[1][1:3]
    assert graph.inputs[0] is not left and torch.equal(graph.inputs[0], left)
    assert graph.output[0].data_ptr() == wrote[0].data_ptr()
    assert graph.output[0] is not wrote[0]
    assert graph.done == "event" and graphs.CACHE.done[dev] == "event"
    graphs.CACHE.graphs["k"] = graph
    assert graphs.CACHE.stats() == {"graphs": 1, "warmup_s": 0.5,
                                    "capture_s": 0.25, "pool_bytes": 26,
                                    "input_bytes": 2 * 4 * 5 * 4}


def test_warm_up_out_of_memory_evicts_and_runs_again(monkeypatch):
    """A warm-up that runs out of memory drops the frame family and runs
    again, then the stage graphs and runs again; with nothing left to drop
    the error stands."""
    card = graphs_card(monkeypatch, total=10**6, peak=1, output=1)
    card.held("frames", 2, 10)
    card.held("stages", 1, 10)
    card.oom = lambda: bool(graphs.STAGES.graphs)
    dev = torch.device("cpu")
    graphs.CACHE.first_call(_frame_fn, (torch.zeros(1),), (), dev)
    assert [e[0] for e in card.events] == ["warm_up", "drop", "warm_up",
                                           "drop", "warm_up", "capture"]
    card.oom = lambda: True
    with pytest.raises(torch.cuda.OutOfMemoryError):
        graphs.CACHE.first_call(_frame_fn, (torch.ones(1),), (), dev)


def test_models_export_the_eager_chains():
    for name in ("asw_pipeline_impl", "cross_pipeline_impl", "asw_pipeline",
                 "cross_pipeline", "asw_pipeline_batched"):
        assert name in models.__all__
        assert getattr(models, name) is getattr(
            asw if name.startswith("asw") else cross_based, name)
