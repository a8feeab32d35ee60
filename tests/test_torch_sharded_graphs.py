"""The sharded pipelines' steps (stereo_matchin_tpu_torch/parallel/) through
their stage runners on the CPU, in one spawn of 4 gloo ranks at the dry
run's size (parallel/dryrun.py DRYRUN_CFG, 64x64) over the meshes
(1, 2, 2), (1, 1, 4) and (2, 2, 1), and (1, 1, 4) again with the disp
padding:

  * the maps of the default runner (utils.replay_stage, which calls each
    step on CPU tensors), of utils.call_stage and of a recording runner,
    bit-equal to each other and to the unsharded asw_pipeline /
    cross_pipeline;
  * the recording runner (dryrun.StepLog) logs each step's name and
    stage key: per frame the steps of the modules' docstrings, the r
    aggregation rounds on one key, the k refinement rounds on theirs, and
    every key the same on the second frame;
  * comm.all_gather and comm.exchange, patched on the ranks
    (dryrun.guard_collectives), raise inside a step: the frames ran, and a
    probe that calls one inside a step raised;
  * every step's arguments pass check_args (stage_key refuses a nested
    tensor), and its keys hold no tensor.

Beside the spawn: the WTA merges' gathered-tensor forms against their list
forms, and utils/graphs.py's resident steps with the card's calls faked.
The captures themselves run on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 19).
"""

from __future__ import annotations

import importlib
import types

import numpy as np
import pytest
import torch

from stereo_matchin_tpu_torch.config import StereoConfig
from stereo_matchin_tpu_torch.models import asw, cross_based
from stereo_matchin_tpu_torch.ops.wta_fast import _two_min_plain
from stereo_matchin_tpu_torch.parallel import distributed, dryrun
from stereo_matchin_tpu_torch.parallel.dryrun import Case, sharded_maps
from stereo_matchin_tpu_torch.utils import graphs

from .torch_support import FakeCard

# parallel/__init__ exports a function named wta_sharded: take the module.
twta = importlib.import_module("stereo_matchin_tpu_torch.parallel.wta_sharded")
MESHES = [(1, 2, 2), (1, 1, 4), (2, 2, 1)]
ASW_KW = dict(dryrun.DRYRUN_CFG)
CROSS_KW = dict(dryrun.DRYRUN_CFG, oii_impl="taps")
PADDED_KW = dict(dryrun.DRYRUN_CFG, d_max=21)    # 22 planes pad to 24 on 4
RUNNERS = ("replay", "eager", "record")
MAPS = {"asw": ("disparity", "filled", "consistency_pre", "consistency_post",
                "wta_left", "wta_right"),
        "cross": ("initial", "final", "median_left")}
WTA = ["wta_local", "wta_merge_reference", "wta_epipolar",
       "wta_merge_target"]
CROSS_STEPS = ["cross_local", "cross_merge", "cross_vote", "cross_median"]
TIMEOUT_S = 120.0


def _variants():
    """(method, mesh, cfg keywords, pair) of every sharded case."""
    out = []
    for mesh in MESHES:
        pair = "two" if mesh[0] > 1 else "one"
        out += [("asw", mesh, ASW_KW, pair), ("cross", mesh, CROSS_KW, pair)]
    return out + [("asw", (1, 1, 4), PADDED_KW, "one")]


VARIANTS = _variants()
IDS = ["{}-b{}r{}d{}".format(m, *mesh) + ("-padded" if kw is PADDED_KW
                                          else "")
       for m, mesh, kw, _ in VARIANTS]


def _cases():
    return [Case(m, mesh, kw, pair, run=run) for m, mesh, kw, pair in VARIANTS
            for run in RUNNERS]


def _pairs():
    return {"one": dryrun.example_pair(1), "two": dryrun.example_pair(2)}


@pytest.fixture(scope="module")
def ranks():
    """Every rank's records, per case: {(variant index, runner): [rank 0's
    record, rank 1's, ...]}, two frames a case."""
    cases = _cases()
    out = distributed.spawn(sharded_maps, 4, "gloo",
                            (cases, _pairs(), "cpu", 2), TIMEOUT_S)
    return {(k // len(RUNNERS), c.run): [r[k] for r in out]
            for k, c in enumerate(cases)}


@pytest.fixture(scope="module")
def unsharded():
    """The unsharded pipelines' maps of each variant, frame by frame."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    pairs, out = _pairs(), {}
    for i, (method, _, kw, pair) in enumerate(VARIANTS):
        cfg = StereoConfig(**kw)
        run = asw.asw_pipeline if method == "asw" else \
            cross_based.cross_pipeline
        left, right = (torch.from_numpy(a) for a in pairs[pair])
        frames = [run(l, r, cfg) for l, r in zip(left, right)]
        out[i] = {f: np.stack([getattr(fr, f).numpy() for fr in frames])
                  for f in MAPS[method]}
    torch.set_num_threads(before)
    return out


@pytest.mark.parametrize("i", range(len(VARIANTS)), ids=IDS)
def test_every_runner_equals_the_unsharded_pipeline(ranks, unsharded, i):
    """The default (replaying) runner, call_stage and the recording runner:
    every map bit-equal to the unsharded frames; no step graph on the
    CPU."""
    method = VARIANTS[i][0]
    for run in RUNNERS:
        got = ranks[(i, run)][0]["maps"]
        for f in MAPS[method]:
            assert got[f].shape == unsharded[i][f].shape, (run, f)
            assert np.array_equal(got[f], unsharded[i][f]), (run, f)
        assert all(r["stages"]["graphs"] == 0 for r in ranks[(i, run)])


def _asw_steps(cfg: StereoConfig, d0: int, d_local: int) -> list:
    """One frame's ASW steps (parallel/asw_sharded.py's docstring)."""
    pin = ["asw_pin"] if cfg.num_disp - d0 < d_local else []
    return (["asw_weights"] + ["asw_round"] * cfg.r_iters + pin + WTA
            + ["asw_consistency", "asw_refine_weights"]
            + (["asw_refine"] + WTA + ["asw_refine_consistency"])
            * cfg.k_iters + ["asw_filled", "asw_median"])


@pytest.mark.parametrize("i", range(len(VARIANTS)), ids=IDS)
def test_recorded_steps_follow_the_segments(ranks, i):
    """Per rank and frame, the steps in order (each frame of the rank's
    block); the aggregation rounds on one key, each refinement step on
    one key over the k rounds, and the second frame's keys the first's."""
    method, mesh, kw, pair = VARIANTS[i]
    cfg = StereoConfig(**kw)
    frames = {"one": 1, "two": 2}[pair] // mesh[0]
    d_local = -(-cfg.num_disp // mesh[2])
    recs = ranks[(i, "record")]
    assert len(recs) == 4
    for rec in recs:
        assert len(rec["steps"]) == 2
        first, second = rec["steps"]
        names = [name for name, _ in first]
        if method == "asw":
            d0 = rec["coord"][2] * d_local
            assert names == _asw_steps(cfg, d0, d_local) * frames
        else:
            assert names == CROSS_STEPS * frames
        assert [k for _, k in second] == [k for _, k in first]
        by_name = {}
        for name, key in first:
            by_name.setdefault(name, []).append(key)
        if method == "asw":
            assert len(set(by_name["asw_round"])) == 1
            assert len(by_name["asw_round"]) == cfg.r_iters * frames
            for name in ("asw_refine", "asw_refine_consistency"):
                assert len(set(by_name[name])) == 1
            # The penalty's tensors key the WTA_REF's local and epipolar
            # steps apart from the WTA's; the merges take the same shapes.
            for name in WTA:
                want = 2 if name in ("wta_local", "wta_epipolar") else 1
                assert len(set(by_name[name])) == want, name
        else:
            assert all(len(set(keys)) == 1 for keys in by_name.values())


def _nests_tensor(key) -> bool:
    if isinstance(key, torch.Tensor):
        return True
    if isinstance(key, (tuple, list)):
        return any(_nests_tensor(k) for k in key)
    return False


@pytest.mark.parametrize("method", ["asw", "cross"])
def test_no_collective_runs_inside_a_step(ranks, method):
    """The recorded frames ran with comm.all_gather and comm.exchange
    raising inside a step, and a probe step calling one raised; every
    step's key passed check_args and holds no tensor, only tensor
    signatures."""
    for i, variant in enumerate(VARIANTS):
        if variant[0] != method:
            continue
        for rec in ranks[(i, "record")]:
            assert rec["guarded"]
            for frame in rec["steps"]:
                assert frame and not any(_nests_tensor(k) for _, k in frame)


def test_a_step_that_calls_a_collective_raises():
    """The guard itself, in this process: all_gather inside a logged step
    raises before it reaches torch.distributed."""
    saved = {(m, n): getattr(m, n) for m, n in (
        (dryrun.comm, "all_gather"), (dryrun.comm, "exchange"),
        (dryrun.halo, "exchange"))}
    try:
        dryrun.guard_collectives()
        log = dryrun.StepLog()
        with pytest.raises(RuntimeError, match="inside the step probe"):
            log("probe", dryrun.comm.all_gather, torch.zeros(2), None)
        with pytest.raises(RuntimeError, match="inside the step probe"):
            log("probe", dryrun.halo.exchange, {}, {}, None, torch.zeros(1))
        assert [name for name, _ in log.steps] == ["probe", "probe"]
        assert dryrun.StepLog.running is None
    finally:
        for (m, n), f in saved.items():
            setattr(m, n, f)


# --- the WTA steps' tensor forms ---------------------------------------------

@pytest.mark.parametrize("with_penalty", [False, True])
@pytest.mark.parametrize("shards", [2, 3])
def test_wta_steps_equal_the_list_merges(shards, with_penalty):
    """local_two_min, merge_reference_gathered, epipolar_segment and
    merge_target_gathered over a stacked all-gather, against
    merge_reference / merge_target over the shards' TwoMin lists (the
    penalty formed inside the steps as penalty * den), bit for bit."""
    rng = np.random.default_rng(shards + 10 * with_penalty)
    D, H, W, big, penalty = 13, 6, 17, 1e5, 0.085
    d_pad = -(-D // shards) * shards
    dl = d_pad // shards
    cost = rng.random((D, H, W)).astype(np.float32) * 50
    padded = np.concatenate([cost, np.full((d_pad - D, H, W), big,
                                           np.float32)])
    vols = [torch.from_numpy(padded[k * dl:(k + 1) * dl]) for k in
            range(shards)]
    den, val = (torch.from_numpy(rng.random((H, W)).astype(np.float32) * s)
                for s in (3, D))
    pen = (den, val, penalty) if with_penalty else (None, None, None)
    scale = penalty * den if with_penalty else None
    stacks, parts = [], []
    for k, v in enumerate(vols):
        stacks.append(twta.local_two_min(v, *pen, k * dl, big, "jnp"))
        c1, c2, d = _two_min_plain(v, scale, pen[1], big, k * dl)
        parts.append(twta.TwoMin(c1, c2, d + k * dl))
    g = torch.stack(stacks)
    ref = twta.merge_reference_gathered(g, big)
    want = twta.merge_reference(parts, big)
    for a, b in zip(ref, want):
        assert torch.equal(a, b)
    segs = [twta.epipolar_segment(v, ref.d, k * dl, dl, d_pad, *pen, big)
            for k, v in enumerate(vols)]
    got = twta.merge_target_gathered(torch.stack(segs), ref.d, big)
    want = twta.merge_target(
        [twta.epipolar_partial(v, ref.d, k * dl, dl, d_pad, scale, pen[1],
                               big) for k, v in enumerate(vols)], ref.d, big)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    res = twta.wta_result(ref.c1, ref.c2, ref.d, *got)
    assert torch.equal(res.conf_ref, (ref.c2 - ref.c1) / ref.c2)
    assert res.disp_ref.dtype == res.disp_target.dtype == torch.float32


def test_stacked_summaries_round_trip():
    s = twta.TwoMin(torch.rand(3, 4), torch.rand(3, 4),
                    torch.arange(12, dtype=torch.int32).reshape(3, 4) - 5)
    (back,) = twta.unstack_two_min(twta.stack_two_min(s)[None])
    for a, b in zip(back, s):
        assert torch.equal(a, b) and a.dtype == b.dtype


# --- resident steps, the card's calls faked -----------------------------------

def _fake_card(monkeypatch, events):
    """The card's calls faked (FakeCard); each capture also appends
    ("capture", its inputs, fn's output, its pool) to events."""
    card = FakeCard(monkeypatch, total=10**9, peak=400, output=100, run=True)
    capture = card.capture

    def recording(fn, inputs, statics, dev, warm, pool, stream):
        graph = capture(fn, inputs, statics, dev, warm, pool, stream)
        events.append(("capture", list(inputs), graph.output, pool))
        return graph

    monkeypatch.setattr(graphs, "capture", recording)
    return card


@graphs.resident
def _weights_step(x, k):
    return x * k, x + k


def _round_step(tile, w, s):
    return tile + w * s


def test_resident_outputs_are_kept_and_read_in_place(monkeypatch):
    """A resident step's outputs stay the graph's own (no borrowed views)
    and are registered; a later step that takes one captures on it, not on
    a slot, and only its other tensors take slots."""
    events = []
    _fake_card(monkeypatch, events)
    stages = graphs.StageGraphs()
    x = torch.rand(4, 5)
    w = stages.first_call("weights", _weights_step, (x, 2.0), [x], "dev")
    assert graphs.is_resident(_weights_step)
    assert not graphs.is_resident(_round_step)
    assert w.output is events[-1][2]            # the graph's own tensors
    w_scaled, w_shifted = w.output
    assert stages.resident == {t.untyped_storage().data_ptr()
                               for t in w.output}
    tile = torch.rand(4, 5)
    assert stages.in_place([tile, w_scaled]) == [False, True]
    r = stages.first_call("round", _round_step, (tile, w_scaled, 3.0),
                          [tile, w_scaled], "dev", [False, True])
    captured = events[-1][1]
    assert captured[1] is w_scaled
    assert captured[0] is stages.slots[graphs.slot_keys([tile])[0]]
    assert len(stages.slots) == 1               # x's, the tile's too
    assert r.output is not events[-1][2]        # a borrowed view
    assert r.output.data_ptr() == events[-1][2].data_ptr()
    stages.clear()
    assert not stages.resident


def test_a_resident_step_returning_a_slot_is_refused(monkeypatch):
    _fake_card(monkeypatch, [])
    stages = graphs.StageGraphs()
    x = torch.rand(3)
    with pytest.raises(ValueError, match="resident step echo returns"):
        stages.first_call("echo", graphs.resident(lambda t: t), (x,), [x],
                          "dev")


def test_load_copies_only_what_the_graph_does_not_read_in_place(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.
                        SimpleNamespace(wait_event=lambda e: None))
    monkeypatch.setattr(torch.cuda, "Event", lambda: "event")
    slot, kept = torch.zeros(3), torch.rand(3)
    frame = graphs.CapturedFrame(None, [slot, kept], None, {}, {})
    new = torch.rand(3)
    kept_before = kept.clone()
    frame.load([new, kept])
    assert torch.equal(slot, new) and torch.equal(kept, kept_before)


def test_resident_steps_capture_into_a_pool_of_their_own(monkeypatch):
    """A resident step's outputs must lie where no other stage graph ever
    writes: it warms up and captures in the device's pool of resident
    steps, every other step in the shared pool, whichever is captured
    first."""
    events = []
    card = _fake_card(monkeypatch, events)
    stages = graphs.StageGraphs()
    x, tile = torch.rand(4, 5), torch.rand(4, 5)
    stages.first_call("round", _round_step, (tile, x, 3.0), [tile, x], "dev")
    w = stages.first_call("weights", _weights_step, (x, 2.0), [x], "dev")
    stages.first_call("round", _round_step, (tile, w.output[0], 3.0),
                      [tile, w.output[0]], "dev", [False, True])
    stages.first_call("weights", _weights_step, (x, 5.0), [x], "dev")
    pools = [e[3] for e in events]
    assert pools[0] is pools[2] and pools[1] is pools[3]
    assert pools[0] is not pools[1]
    warmed = [e[1] for e in card.events if e[0] == "warm_up"]
    assert warmed == pools
    assert stages.pools == {("dev", False): pools[0], ("dev", True): pools[1]}
    stages.clear()
    assert not stages.pools
