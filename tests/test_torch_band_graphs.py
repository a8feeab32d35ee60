"""The band steps of the port's band drivers (models/tiled.py,
models/wavefront.py, models/wavefront_cross.py) and the stage runner that
replays them from CUDA graphs on the card (utils/graphs.py), on the CPU.

A band step is keyed by its canonical geometry (`_canon`, `_canon_c`, the
JAX package's functions of the same names), so the interior bands of a
frame share one graph; that is sound only because a step at its canonical
geometry gives the same bits as at its absolute geometry, which is held
here bit for bit for both methods.  The drivers give the same maps through
the replaying runner (which calls the step itself on CPU tensors) and the
eager one; the interior bands of a 5-band frame share one step key per
driver (three keys in all, two for the cross halo bands); the runner
refuses a tensor nested in an argument; every step's result is cloned
whole; and a frame holds its graphs against the memory rules (the card's
calls faked).  The captures themselves run on the card
(tests/test_torch_cuda.py).
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from stereo_matchin_tpu.models import wavefront as jwf
from stereo_matchin_tpu.models import wavefront_cross as jwfc
from stereo_matchin_tpu_torch.models import tiled, wavefront, wavefront_cross
from stereo_matchin_tpu_torch.utils import call_stage, graphs, replay_stage

from .test_torch_bands_asw import CONFIG3_KW
from .test_torch_bands_asw import SMALL as ASW_SMALL
from .test_torch_bands_cross import SMALL as CROSS_SMALL
from .test_torch_stage_graphs import no_cuda  # noqa: F401
from .torch_support import FakeCard, config_pair, t

ASW_CFG = config_pair(**ASW_SMALL)[1]
CROSS_CFG = config_pair(**CROSS_SMALL)[1]
# 70 rows in 5 bands of 14: every interior band's halo (13 rows at both
# configs) and strip windows lie inside the frame, so the interior bands
# share one slice shape, crop and canonical geometry.
H, W = 70, 32


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(15)
    left = (rng.integers(0, 256, (H, W, 3)) / np.float32(255.0)).astype(
        np.float32)
    right = np.roll(left, -2, axis=1)
    noise = rng.integers(-12, 13, right.shape) / np.float32(255.0)
    right = np.clip(np.round((right + noise) * 255) / 255.0, 0, 1).astype(
        np.float32)
    return t(left), t(right)


# The four drivers: (config, call with a runner).
DRIVERS = {
    "asw_wavefront": (ASW_CFG, lambda l, r, cfg, run: tiled.asw_pipeline_tiled(
        l, r, cfg, 5, wavefront=True, run=run)),
    "asw_halo": (ASW_CFG, lambda l, r, cfg, run: tiled.asw_pipeline_tiled(
        l, r, cfg, 5, wavefront=False, run=run)),
    "cross_wavefront": (CROSS_CFG, lambda l, r, cfg, run:
                        tiled.cross_pipeline_tiled(l, r, cfg, 5,
                                                   wavefront=True, run=run)),
    "cross_halo": (CROSS_CFG, lambda l, r, cfg, run:
                   tiled.cross_pipeline_tiled(l, r, cfg, 5, wavefront=False,
                                              run=run)),
}


class Spy:
    """A stage runner that calls each step eagerly and records its name,
    function, arguments, stage key and result."""

    def __init__(self):
        self.calls = []

    def run(self, name, fn, *args):
        out = fn(*args)
        self.calls.append(types.SimpleNamespace(
            name=name, fn=fn, args=args, out=out,
            key=graphs.stage_key(name, fn, args)))
        return out


def _fields(g):
    return (g.s, g.e, g.g0, g.g1, g.H, g.first, g.last)


def _assert_same(got, want):
    g, w = graphs.leaves(got), graphs.leaves(want)
    assert len(g) == len(w) > 0
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


# --- canonical geometry --------------------------------------------------------

@pytest.mark.parametrize("kw", [ASW_SMALL, {}, CONFIG3_KW],
                         ids=["small", "reference", "config3"])
def test_canon_equals_jax(kw):
    """Every band of every plan, field by field: at 1988 rows (config 3's
    frame) and the small frames of the tests, 2 to 8 bands."""
    jcfg, cfg = config_pair(**kw)
    seen = 0
    for rows in (44, 48, 70, 96, 288, 400, 1988):
        for bands in range(2, 9):
            for align in (128, 8):
                got = wavefront.plan_bands(rows, bands, cfg, align)
                want = jwf.plan_bands(rows, bands, jcfg, align)
                assert (got is None) == (want is None)
                for g, w in zip(got or (), want or ()):
                    assert _fields(wavefront._canon(g)) == _fields(
                        jwf._canon(w)), (rows, bands, align)
                    seen += 1
    assert seen > 0


@pytest.mark.parametrize("kw", [CROSS_SMALL, {}, CONFIG3_KW],
                         ids=["small", "reference", "config3"])
def test_canon_c_equals_jax(kw):
    jcfg, cfg = config_pair(**kw)
    seen = 0
    for rows in (44, 70, 91, 96, 288, 400, 1988):
        for bands in range(2, 9):
            got = wavefront_cross.plan_bands_cross(rows, bands, cfg)
            want = jwfc.plan_bands_cross(rows, bands, jcfg)
            assert (got is None) == (want is None)
            for g, w in zip(got or (), want or ()):
                assert _fields(wavefront_cross._canon_c(g)) == _fields(
                    jwfc._canon_c(w)), (rows, bands)
                seen += 1
    assert seen > 0


def test_interior_bands_of_the_config3_plans_share_one_geometry():
    """With the lane-aligned plan, 5 bands of config 3 have three canonical
    geometries each: first, interior, last.  In 8 ASW bands of 256 rows
    the seventh band's slice (to e + keep + r*R = 2001) is clamped at the
    frame bottom, which makes a fourth."""
    cfg = config_pair(**CONFIG3_KW)[1]
    for bands, asw_count in ((5, 3), (8, 4)):
        geoms = wavefront.plan_bands(1988, bands, cfg)
        assert len({wavefront._canon(g) for g in geoms}) == asw_count
        geoms = wavefront_cross.plan_bands_cross(1988, bands, cfg)
        assert len({wavefront_cross._canon_c(g) for g in geoms}) == 3


@pytest.mark.parametrize("method", ["asw", "cross"])
def test_steps_at_canonical_geometry_equal_steps_at_absolute_geometry(
        pair, method):
    """Every band after the first, run again at its absolute geometry on
    the same slice and strips, gives its canonical run's bits: maps and
    strips."""
    left, right = pair
    spy = Spy()
    if method == "asw":
        geoms = wavefront.plan_bands(H, 5, ASW_CFG)
        wavefront.asw_pipeline_wavefront(left, right, ASW_CFG, 5, run=spy.run)
    else:
        cfg = tiled.translation_invariant(CROSS_CFG, left)
        geoms = wavefront_cross.plan_bands_cross(H, 5, cfg)
        wavefront_cross.cross_pipeline_wavefront(left, right, cfg, 5,
                                                 run=spy.run)
    assert len(spy.calls) == len(geoms) == 5
    for call, g in zip(spy.calls[1:], geoms[1:]):
        assert call.args[-1] != g                # a translated geometry
        _assert_same(call.fn(*call.args[:-1], g), call.out)


# --- the drivers through their runners -------------------------------------------

@pytest.mark.parametrize("driver", list(DRIVERS))
def test_replaying_runner_equals_eager_runner_and_touches_no_cuda(
        pair, driver, no_cuda):  # noqa: F811
    cfg, call = DRIVERS[driver]
    got = call(*pair, cfg, replay_stage)
    want = call(*pair, cfg, call_stage)
    _assert_same(got, want)
    assert not graphs.STAGES.graphs and not graphs.STAGES.slots


@pytest.mark.parametrize("driver,count", [
    ("asw_wavefront", 3), ("asw_halo", 3), ("cross_wavefront", 3),
    ("cross_halo", 2)])
def test_a_5_band_frame_has_three_step_keys(pair, driver, count):
    """First, interior and last: the three interior bands share a key (on
    the card, one graph).  A cross halo band has no crop, so the first and
    last bands, both 27 rows here, share one too."""
    cfg, call = DRIVERS[driver]
    spy = Spy()
    call(*pair, cfg, spy.run)
    keys = [c.key for c in spy.calls]
    assert len(keys) == 5 and len(set(keys)) == count
    assert keys[1] == keys[2] == keys[3] != keys[0]


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_band_steps_results_are_cloned_whole(pair, driver):
    """clone_result of every step's result: every tensor in it (maps and
    strips, the cross strips nested in a NamedTuple) a new one."""
    cfg, call = DRIVERS[driver]
    spy = Spy()
    call(*pair, cfg, spy.run)
    want = {"asw_wavefront": [4, 4, 4, 4, 2], "asw_halo": [2] * 5,
            "cross_wavefront": [5, 5, 5, 5, 2], "cross_halo": [2] * 5}
    assert [len(graphs.leaves(c.out)) for c in spy.calls] == want[driver]
    for c in spy.calls:
        clone = graphs.clone_result(c.out)
        assert type(clone) is type(c.out)
        _assert_same(clone, c.out)
        for a, b in zip(graphs.leaves(clone), graphs.leaves(c.out)):
            assert a.data_ptr() != b.data_ptr()


def test_cross_strips_are_top_level_tensor_arguments(pair):
    """The carried strips reach a cross step as three tensors, not a
    container (the runner would refuse one)."""
    spy = Spy()
    DRIVERS["cross_wavefront"][1](*pair, CROSS_CFG, spy.run)
    mid = spy.calls[1]
    assert mid.fn is wavefront_cross._mid_band_c
    assert [type(a) for a in mid.args[:5]] == [torch.Tensor] * 5
    strips = spy.calls[0].out[2]
    assert type(strips) is wavefront_cross.CrossStrips
    assert all(a is b for a, b in zip(mid.args[2:5], strips))


def test_clone_result_clones_tensors_in_dicts_and_lists():
    x = torch.rand(3, 4)
    out = {"a": x, "b": [x, (x, 1)], "c": None}
    clone = graphs.clone_result(out)
    assert type(clone) is dict and type(clone["b"]) is list
    assert len(graphs.leaves(clone)) == 3
    for a in graphs.leaves(clone):
        assert torch.equal(a, x) and a.data_ptr() != x.data_ptr()


# --- the runner's refusals -----------------------------------------------------------

@pytest.mark.parametrize("nested", [
    lambda x: (x, x), lambda x: {"temp": x}, lambda x: [1, (2, x)],
    lambda x: wavefront_cross.CrossStrips(x, x, x)],
    ids=["tuple", "dict", "list", "namedtuple"])
def test_runner_refuses_a_tensor_nested_in_an_argument(nested, no_cuda):  # noqa: F811
    x = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="nests a tensor"):
        replay_stage("mid_band_c", lambda a, b: a, x, nested(x))
    with pytest.raises(ValueError, match="nests a tensor"):
        graphs.stage_key("mid_band_c", lambda a, b: a, (x, nested(x)))
    assert graphs.stage_key("first_band", lambda a, b: a, (x, (1, 2)))


# --- the memory rule: a frame holds its graphs, the card's calls faked -------------

def test_a_held_frame_keeps_its_graphs_when_room_is_short(monkeypatch):
    """Inside a hold, making room drops the captured frames but never the
    stage graphs a held frame called; outside it, every stage graph can
    go."""
    card = FakeCard(monkeypatch, total=1000, other=700)
    card.held("frames", 1, 100)
    card.held("stages", 2, 100)
    stages = graphs.STAGES
    with stages.hold():
        stages._held.add("stages 0")
        graphs.make_room(lambda: 500, "dev")
        assert card.events == [("drop", "frames")]
        assert set(stages.graphs) == {"stages 0", "stages 1"}
        assert not graphs.free_memory()
    assert not stages._held
    assert graphs.free_memory() and not stages.graphs


def test_a_held_frames_first_call_raises_where_only_its_graphs_could_go(
        monkeypatch):
    """A warm-up out of memory inside a held frame drops the captured
    frames and then raises: it never drops the frame's graphs (which
    would capture every band again on every frame)."""
    card = FakeCard(monkeypatch, total=10**6)
    card.held("frames", 1, 100)
    card.oom = lambda: True
    stages = graphs.STAGES
    a = torch.rand(3)
    with stages.hold():
        stages.graphs = {"first_band": 1}
        stages._held.add("first_band")
        with pytest.raises(torch.cuda.OutOfMemoryError):
            stages.first_call("mid_band", torch.neg, (a,), [a], "dev")
        assert stages.graphs == {"first_band": 1}
    assert [e[0] for e in card.events] == ["warm_up", "drop", "warm_up"]


def test_every_driver_holds_its_frame(pair, monkeypatch):
    """Each of the four drivers runs its bands inside STAGES.hold(), and
    the hold ends with the frame."""
    for driver, (cfg, call) in DRIVERS.items():
        holds = []
        spy = Spy()

        def run(name, fn, *args):
            holds.append(graphs.STAGES._holds)
            return spy.run(name, fn, *args)

        call(*pair, cfg, run)
        assert holds == [1] * 5, driver
        assert graphs.STAGES._holds == 0 and not graphs.STAGES._held
