"""The stage graphs (stereo_matchin_tpu_torch/utils/graphs.py StageGraphs,
replay_stage) and the captured debug entry (models/asw.py
asw_pipeline_debug) on the CPU: the stage key, the nested clones, the
shared static inputs, the memory rules as plain functions (the card's
calls faked), the runner on CPU tensors calling fn with no `torch.cuda`,
the eager chains keeping the untimed runner, and the debug entry against
its eager chain and against the JAX package's asw_pipeline_debug on the
JAX weights.  The captures themselves run on the card
(tests/test_torch_cuda.py)."""

from __future__ import annotations

import inspect
import types
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_matchin_tpu.models import asw as jasw
from stereo_matchin_tpu_torch import models
from stereo_matchin_tpu_torch import ops
from stereo_matchin_tpu_torch.config import TINY_CONFIG
from stereo_matchin_tpu_torch.convert import weights_from_jax
from stereo_matchin_tpu_torch.models import asw, cross_based
from stereo_matchin_tpu_torch.ops.aggregation import (asw_den_plain,
                                                      asw_pass_plain)
from stereo_matchin_tpu_torch.utils import graphs, profiling, replay_stage

from .test_torch_asw_debug import REDS, STACKS, _scene, codes, red_mask
from .test_torch_pipeline_asw import jax_strips
from .torch_support import TINY, config_pair, t, unorm8_pair


def _pair(H=24, W=32, seed=0):
    return tuple(torch.from_numpy(a)
                 for a in unorm8_pair(np.random.default_rng(seed), H, W))


def _volume(D=5, H=6, W=7, dtype=torch.float32):
    return torch.zeros(D, H, W, dtype=dtype)


def _strips(T=3, H=6, W=7):
    return torch.zeros(T, H, W), torch.ones(T, H, W)


# --- the stage key ----------------------------------------------------------

def test_fresh_partials_of_one_function_share_a_key():
    """The pipelines build a new partial every call: equal functions,
    arguments and keywords, and tensors of equal shape, dtype and device,
    give one key whatever the tensors hold."""
    cost = _volume()
    a = graphs.stage_key("wta", partial(ops.wta_fast, big=1e5,
                                        kernels="auto"), (cost,))
    b = graphs.stage_key("wta", partial(ops.wta_fast, kernels="auto",
                                        big=1e5), (torch.ones(5, 6, 7),))
    assert a == b and hash(a) == hash(b)
    wl, wr = _strips()
    v = graphs.stage_key("v_aggr", asw_pass_plain,
                         (cost, wl, wr, cost, 1e-5, 1, 0))
    assert v == graphs.stage_key("v_aggr", asw_pass_plain,
                                 (cost.clone(), wr, wl, cost + 1, 1e-5, 1, 0))


def _keys():
    """(base, others): stage calls that differ from the base in one thing
    each, keyed."""
    cost, (wl, wr) = _volume(), _strips()
    img = torch.zeros(6, 7, 3)
    arms = cross_based._arms_stage
    return {
        "d0": (("v_aggr", asw_pass_plain, (cost, wl, wr, cost, 1e-5, 1, 0)),
               ("v_aggr", asw_pass_plain, (cost, wl, wr, cost, 1e-5, 1, 5))),
        "axis": (("h_aggr", asw_pass_plain, (cost, wl, wr, cost, 1e-5, 1, 0)),
                 ("h_aggr", asw_pass_plain, (cost, wl, wr, cost, 1e-5, 2, 0))),
        "route": (("cross_h", arms, (img, 6, 20.0, True, "kernels")),
                  ("cross_h", arms, (img, 6, 20.0, True, "taps"))),
        "shape": (("v_aggr", asw_den_plain, (wl, wr, 1e-5, 0, 5)),
                  ("v_aggr", asw_den_plain, (torch.zeros(3, 6, 8), wr, 1e-5,
                                             0, 5))),
        "dtype": (("median", ops.median3x3, (img,)),
                  ("median", ops.median3x3, (img.double(),))),
        "name": (("v_ref_L", ops.refine_pass_v, (wl, img[..., 0], img[..., 0],
                                                 1, 1e-5)),
                 ("v_ref_R", ops.refine_pass_v, (wl, img[..., 0], img[..., 0],
                                                 1, 1e-5))),
        "keyword": (("wta", partial(ops.wta_fast, big=1e5, kernels="auto"),
                     (cost,)),
                    ("wta", partial(ops.wta_fast, big=1e5, kernels="jnp"),
                     (cost,))),
        "function": (("wta", partial(ops.wta_fast, big=1e5), (cost,)),
                     ("wta", partial(ops.wta_refined_fast, big=1e5),
                      (cost,))),
        "static type": (("aggr", ops.sad_cost_volume, (img, img, 5, 255.0, 0)),
                        ("aggr", ops.sad_cost_volume,
                         (img, img, 5, 255.0, 0.0))),
    }


@pytest.mark.parametrize("change", list(_keys()))
def test_a_different_static_or_tensor_signature_is_another_key(change):
    base, other = _keys()[change]
    assert graphs.stage_key(*base) != graphs.stage_key(*other)


def test_a_partial_binding_a_tensor_is_refused():
    with pytest.raises(ValueError, match="binds a tensor"):
        graphs.stage_key("wta_ref", partial(ops.wta_refined_fast,
                                            ref_value=torch.zeros(2)),
                         (_volume(),))


# --- nested clones, borrowed views, slots ------------------------------------

def _assert_cloned(got, want):
    assert type(got) is type(want)
    if isinstance(want, torch.Tensor):
        assert torch.equal(got, want) and got.dtype == want.dtype
        assert got.numel() == 0 or got.data_ptr() != want.data_ptr()
    elif isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_cloned(g, w)
    else:
        assert got is want


def test_clone_result_keeps_every_nesting_and_type():
    """A tensor, a tuple (refine_pass_v), a NamedTuple (wta_fast) and the
    debug entry's ASWDebug, which nests an ASWResult, keep their types and
    values, and every tensor is a new one."""
    left, right = _pair(seed=3)
    cost = torch.rand(5, 24, 32)
    wta = ops.wta_fast(cost, kernels="jnp")
    debug = asw.asw_pipeline_debug_impl(left, right, TINY_CONFIG)
    for out in (cost, (cost, cost[0]), wta, debug, (cost, (wta, None, 3)),
                torch.zeros(0, 4)):
        _assert_cloned(graphs.clone_result(out), out)
    assert isinstance(graphs.clone_result(debug).result, asw.ASWResult)
    assert graphs.nbytes(debug) == sum(t.numel() * t.element_size()
                                       for t in graphs.leaves(debug))
    assert len(graphs.leaves(debug)) == len(debug) - 1 + len(debug.result)


def test_borrowed_view_reads_memory_it_does_not_own():
    base = torch.arange(60.0).reshape(3, 4, 5)
    view = base[:, 1:3]
    alias = graphs.borrowed(view)
    assert torch.equal(alias, view) and alias.data_ptr() == view.data_ptr()
    assert alias.stride() == view.stride()
    base.add_(1.0)
    assert torch.equal(alias, view)


def test_slots_are_per_kind_and_index_and_shared_between_calls():
    """The k-th tensor of one shape, dtype and device takes slot k of that
    kind: a call's two volumes take two slots, another stage's call of the
    same kinds the same ones."""
    cost, (wl, wr) = _volume(), _strips()
    pass_slots = graphs.slot_keys([cost, wl, wr, cost])
    kinds = [k[:3] for k in pass_slots]
    volume = ((5, 6, 7), torch.float32, cost.device)
    strip = ((3, 6, 7), torch.float32, cost.device)
    assert kinds == [volume, strip, strip, volume]
    assert [k[3] for k in pass_slots] == [0, 0, 1, 1]
    assert graphs.slot_keys([wl, wr]) == pass_slots[1:3]
    assert graphs.slot_keys([cost.double()])[0][3] == 0


# --- the runner on the CPU ---------------------------------------------------

@pytest.fixture
def no_cuda(monkeypatch):
    """Every torch.cuda call the runner makes raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("torch.cuda touched on a CPU call")

    for name in ("CUDAGraph", "graph", "graph_pool_handle", "Stream",
                 "stream", "device", "Event", "synchronize", "empty_cache",
                 "mem_get_info", "reset_peak_memory_stats",
                 "memory_allocated", "max_memory_allocated",
                 "memory_reserved", "current_stream",
                 "is_current_stream_capturing"):
        monkeypatch.setattr(torch.cuda, name, refuse)


def test_replaying_runner_on_cpu_calls_fn_once_and_no_cuda(no_cuda):
    calls = []
    cost = torch.rand(5, 6, 7)

    def stage(c, big):
        calls.append((c, big))
        return ops.wta_fast(c, big, kernels="jnp")

    got = replay_stage("wta", stage, cost, 1e5)
    assert len(calls) == 1 and calls[0][0] is cost
    want = ops.wta_fast(cost, 1e5, kernels="jnp")
    _assert_cloned(got, want)
    assert not graphs.STAGES.graphs and not graphs.STAGES.slots
    assert graphs.replay_stage is replay_stage


def test_pipelines_through_the_replaying_runner_on_cpu_equal_eager(no_cuda):
    left, right = _pair(seed=4)
    cfg = TINY_CONFIG
    got = cross_based.cross_pipeline_staged(left, right, cfg,
                                            run=replay_stage)
    for g, w in zip(got, cross_based.cross_pipeline_impl(left, right, cfg)):
        assert torch.equal(g, w)
    weights = asw.asw_weights(left, right, cfg, run=replay_stage)
    got = asw.asw_pipeline_from_weights(left, right, weights, cfg,
                                        run=replay_stage)
    for g, w in zip(got, asw.asw_pipeline_impl(left, right, cfg)):
        assert torch.equal(g, w)
    assert not graphs.STAGES.graphs


def test_eager_chains_keep_the_untimed_runner(monkeypatch):
    """The frame entries capture asw_pipeline_impl, cross_pipeline_impl and
    asw_pipeline_debug_impl whole, so no stage of theirs may go through the
    replaying runner: every runner argument defaults to call_stage, and
    with the stage graphs made to raise, the eager chains still run."""
    for fn in (asw.asw_weights, asw.ladder_levels, asw.aggregate,
               asw.asw_pipeline_from_weights, asw.asw_postaggregate,
               cross_based.cross_pipeline_staged):
        assert inspect.signature(fn).parameters["run"].default is \
            profiling.call_stage, fn.__name__

    def refuse(*args, **kwargs):
        raise AssertionError("an eager chain used the stage graphs")

    monkeypatch.setattr(graphs.StageGraphs, "call", refuse)
    left, right = _pair(seed=5)
    asw.asw_pipeline_impl(left, right, TINY_CONFIG)
    asw.asw_pipeline_debug_impl(left, right, TINY_CONFIG)
    cross_based.cross_pipeline_impl(left, right, TINY_CONFIG)
    asw.asw_pipeline(left, right, TINY_CONFIG)
    cross_based.cross_pipeline(left, right, TINY_CONFIG)


# --- first call and memory, the card's calls faked ---------------------------

class _Card:
    """mem_get_info of a card of `total` bytes with `used` in use."""

    def __init__(self, total, used):
        self.total, self.used = total, used

    def mem_get_info(self, device=None):
        return self.total - self.used, self.total


def _fake_card(monkeypatch, card, events):
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "mem_get_info", card.mem_get_info)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: ("pool",))
    monkeypatch.setattr(torch.cuda, "Event", lambda: "shared event")

    def warm_up(fn, inputs, statics, dev):
        events.append(("warm_up", inputs, statics))
        return {"warmup_peak_bytes": 400, "output_bytes": 100, "launches": {},
                "warmup_s": 0.5}

    def capture(fn, inputs, statics, dev, warm, pool=None):
        events.append(("capture", inputs, pool, card.mem_get_info()[0]))
        out = fn(*inputs)
        return types.SimpleNamespace(output=out, done=None, stats={
            "warmup_s": warm["warmup_s"], "capture_s": 0.25,
            "pool_bytes": 1000})

    monkeypatch.setattr(graphs, "warm_up", warm_up)
    monkeypatch.setattr(graphs, "capture", capture)


def test_first_call_warms_up_on_the_callers_tensors_then_captures_on_slots(
        monkeypatch):
    """The warm-up runs on the caller's own tensors; the capture runs on the
    slots, into the shared pool, after room is made for the capture's need
    and the new slots; the graph's outputs become borrowed views and its
    event the runner's."""
    events = []
    card = _Card(total=10**6, used=0)
    _fake_card(monkeypatch, card, events)
    stages = graphs.StageGraphs()
    make_room = stages.make_room
    monkeypatch.setattr(stages, "make_room", lambda need, dev: (
        events.append(("make_room", need)), make_room(need, dev)))
    a, b = torch.rand(4, 5), torch.rand(4, 5)
    graph = stages.first_call("aggr", lambda x, y, k: x + k * y, (a, b, 2),
                              [a, b], "dev")
    assert events[0][0] == "warm_up" and events[0][1][0] is a
    assert events[0][1][1] is b and events[0][2] == ()
    # The pool (peak 400 and POOL_MARGIN of it), the clones (100) and two
    # new slots of 80 bytes.
    assert events[1] == ("make_room", 400 + int(400 * graphs.POOL_MARGIN)
                         + 100 + 2 * 4 * 5 * 4)
    assert events[2][0] == "capture" and events[2][2] == ("pool",)
    inputs = events[2][1]
    assert [s for s in inputs] == [stages.slots[k] for k in
                                   graphs.slot_keys([a, b])]
    assert inputs[0] is not a and inputs[0].shape == a.shape
    assert graph.done == "shared event" and stages.done["dev"] is graph.done
    assert graph.output.data_ptr() != 0
    assert stages.stats() == {"graphs": 0, "warmup_s": 0, "capture_s": 0,
                              "pool_bytes": 0, "input_bytes": 2 * 4 * 5 * 4}
    stages.graphs["k"] = graph
    assert stages.stats()["graphs"] == 1
    assert stages.stats()["pool_bytes"] == 1000


def test_make_room_frees_the_oldest_frames_then_every_stage_graph(
        monkeypatch):
    """Before a capture that needs more than the card has free, the frames
    go oldest first, then all stage graphs at once (they share a pool)."""
    evicted = []
    card = _Card(total=1000, used=900)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "mem_get_info", card.mem_get_info)
    frames = graphs.GraphCache()
    monkeypatch.setattr(graphs, "CACHE", frames)
    for k in "ab":
        frames.put(k, k)

    def evict_oldest():
        evicted.append(next(iter(frames.frames)))
        frames.frames.popitem(last=False)
        card.used -= 100

    monkeypatch.setattr(frames, "evict_oldest", evict_oldest)
    stages = graphs.StageGraphs()
    stages.graphs = {"s1": 1, "s2": 2}
    stages.slots = {"slot": torch.zeros(1)}
    stages.make_room(250, "dev")                  # a and b go: 300 free
    assert evicted == ["a", "b"] and stages.graphs
    stages.make_room(350, "dev")                  # the stage graphs go
    assert not stages.graphs and not stages.slots and not stages.pools
    assert not stages.free_memory()


def test_warm_up_out_of_memory_frees_and_runs_again(monkeypatch):
    events = []
    card = _Card(total=10**6, used=0)
    _fake_card(monkeypatch, card, events)
    runs = []
    warm = graphs.warm_up

    def warm_up(fn, inputs, statics, dev):
        runs.append(len(stages.graphs))
        if stages.graphs:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return warm(fn, inputs, statics, dev)

    monkeypatch.setattr(graphs, "warm_up", warm_up)
    monkeypatch.setattr(graphs, "CACHE", graphs.GraphCache())
    stages = graphs.StageGraphs()
    stages.graphs = {"old": 1}
    a = torch.rand(3)
    stages.first_call("median", torch.neg, (a,), [a], "dev")
    assert runs == [1, 0]
    monkeypatch.setattr(graphs, "warm_up", lambda *args: (_ for _ in ()).throw(
        torch.cuda.OutOfMemoryError("out of memory")))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        stages.first_call("median", torch.neg, (a,), [a], "dev")


# --- device time by stage -----------------------------------------------------

def test_stage_device_ms_attributes_kernels_by_their_launch():
    """A kernel goes to the stage whose range holds its launch, wherever it
    runs on the device; a launch outside every range goes to None."""
    events = [
        {"cat": "user_annotation", "name": "wta", "ts": 10, "dur": 10},
        {"cat": "user_annotation", "name": "median", "ts": 30, "dur": 5},
        {"cat": "user_annotation", "name": "other", "ts": 40, "dur": 5},
        {"cat": "cuda_runtime", "ts": 12, "args": {"correlation": 1}},
        {"cat": "cuda_driver", "ts": 19, "args": {"correlation": 2}},
        {"cat": "cuda_runtime", "ts": 25, "args": {"correlation": 3}},
        {"cat": "cuda_runtime", "ts": 31, "args": {"correlation": 4}},
        {"cat": "cuda_runtime", "ts": 41, "args": {"correlation": 5}},
        {"cat": "kernel", "dur": 500, "args": {"correlation": 1}},
        {"cat": "gpu_memcpy", "dur": 250, "args": {"correlation": 2}},
        {"cat": "kernel", "dur": 1000, "args": {"correlation": 3}},
        {"cat": "gpu_memset", "dur": 125, "args": {"correlation": 4}},
        {"cat": "kernel", "dur": 2000, "args": {"correlation": 5}},
        {"cat": "kernel", "dur": 4000, "args": {}},
    ]
    got = profiling.stage_device_ms(events, {"wta", "median"})
    assert got == {"wta": (0.75, 2), "median": (0.125, 1), None: (7.0, 3)}


# --- the debug entry ----------------------------------------------------------

def test_models_export_the_debug_chain():
    assert "asw_pipeline_debug_impl" in models.__all__
    assert models.asw_pipeline_debug_impl is asw.asw_pipeline_debug_impl


@pytest.mark.parametrize("kw", [{}, dict(k_iters=0),
                                dict(r_iters=3, k_iters=1,
                                     wta_ref_conf_bug=False)],
                         ids=["tiny", "no_refinement", "r3_k1_conf_fixed"])
def test_debug_entry_on_cpu_is_its_eager_chain_and_jax_on_jax_weights(
        kw, no_cuda, monkeypatch):
    """asw_pipeline_debug on CPU tensors calls asw_pipeline_debug_impl once
    and returns its result bit for bit, nested `result` included; with the
    JAX weights carried across, its codes and red masks equal the JAX
    package's asw_pipeline_debug."""
    jcfg, cfg = config_pair(**{**TINY, **kw})
    left, right = _scene(5, 48, 64, cfg.d_max)
    tl, tr = t(left), t(right)
    jax_weights = weights_from_jax(jax_strips(left, right, jcfg), "cpu")
    monkeypatch.setattr(asw, "asw_weights", lambda *args: jax_weights)
    impl, calls = asw.asw_pipeline_debug_impl, []

    def counted(*args):
        calls.append(args)
        return impl(*args)

    monkeypatch.setattr(asw, "asw_pipeline_debug_impl", counted)
    got = asw.asw_pipeline_debug(tl, tr, cfg)
    assert len(calls) == 1 and calls[0][0] is tl and calls[0][1] is tr
    want = impl(tl, tr, cfg)
    assert type(got) is asw.ASWDebug and type(got.result) is asw.ASWResult
    for g, w in zip(graphs.leaves(got), graphs.leaves(want)):
        assert torch.equal(g, w)
    ref = jasw.asw_pipeline_debug(jnp.asarray(left), jnp.asarray(right), jcfg)
    for f in STACKS:
        np.testing.assert_array_equal(codes(getattr(got, f)),
                                      codes(np.asarray(getattr(ref, f))),
                                      err_msg=f)
    for f in REDS:
        np.testing.assert_array_equal(red_mask(getattr(got, f)),
                                      red_mask(np.asarray(getattr(ref, f))),
                                      err_msg=f)
    for f in ("disparity", "filled", "wta_left", "wta_right"):
        np.testing.assert_array_equal(codes(getattr(got.result, f)),
                                      codes(np.asarray(getattr(ref.result,
                                                               f))),
                                      err_msg=f)
    assert not graphs.CACHE.frames
