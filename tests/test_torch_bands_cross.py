"""The port's cross-method band drivers (models/tiled.py
cross_pipeline_tiled, models/wavefront_cross.py) and the row anchoring
(`row0`/`h_glob`) of its arms and OII vertical pass, on the CPU.

Everything here is compared bit for bit: the cross path multiplies
nothing, so neither side has a fused multiply-add to contract, and the
taps OII form sums in the order of the port's kernels.  Banded runs must
EQUAL the whole-frame run and the JAX package's band drivers; the
anchored plain arms and OII-v must equal the JAX package's anchored walks
(`parallel/cross_sharded.py`) and its Pallas kernels in interpret mode.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_matchin_tpu.eval import synthetic_scene
from stereo_matchin_tpu.kernels.cross_oii import (cross_arms_pallas,
                                                  oii_vpass_pallas)
from stereo_matchin_tpu.models import tiled as jtiled
from stereo_matchin_tpu.models import wavefront_cross as jwfc
from stereo_matchin_tpu.ops.oii import combined_arms
from stereo_matchin_tpu.parallel.cross_sharded import (_cross_arms_tiled,
                                                       _oii_vtaps_tiled)
from stereo_matchin_tpu_torch import REFERENCE_CONFIG, StereoConfig, kernels
from stereo_matchin_tpu_torch import ops as tops
from stereo_matchin_tpu_torch.kernels.cross_oii import cross_arms, oii_pass
from stereo_matchin_tpu_torch.models import cross_based as tcross
from stereo_matchin_tpu_torch.models import tiled, wavefront_cross

from .test_torch_pipeline_cross import gen
from .torch_support import config_pair, n, t

# The sizes of tests/test_wavefront.py's cross cases: bands of at least
# 2L + 2 = 8 rows.
SMALL = dict(d_max=7, radius=2, arm_len=3, r_iters=2, k_iters=2,
             oii_impl="taps")
JAX_CFG, CFG = config_pair(**SMALL)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(21)
    left = (rng.integers(0, 256, (96, 40, 3)) / np.float32(255.0)).astype(
        np.float32)
    right = np.roll(left, -2, axis=1)
    noise = rng.integers(-10, 11, right.shape) / np.float32(255.0)
    right = np.clip(np.round((right + noise) * 255) / 255.0, 0, 1).astype(
        np.float32)
    return left, right


def _whole(left, right, cfg):
    res = tcross.cross_pipeline(t(left), t(right), cfg)
    return res.initial, res.final


def _assert_maps_equal(got, want):
    for g, w, name in zip(got, want, ("initial", "final")):
        g, w = n(g), n(w)
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


# --- banded == whole frame --------------------------------------------------

@pytest.mark.parametrize("bands", [2, 3, 5])
@pytest.mark.parametrize("wf", [True, False], ids=["wavefront", "halo"])
def test_banded_equals_whole_frame(pair, bands, wf):
    got = tiled.cross_pipeline_tiled(t(pair[0]), t(pair[1]), CFG, bands,
                                     wavefront=wf)
    _assert_maps_equal(got, _whole(*pair, CFG))


@pytest.mark.parametrize("wf", [True, False], ids=["wavefront", "halo"])
def test_non_dividing_last_band(pair, wf):
    """H = 91 in 4 bands of 23, 23, 23 and 22 rows: the last band's windows
    run past the frame bottom."""
    left, right = pair[0][:91], pair[1][:91]
    geoms = wavefront_cross.plan_bands_cross(91, 4, CFG)
    assert [g.e - g.s for g in geoms] == [23, 23, 23, 22]
    got = tiled.cross_pipeline_tiled(t(left), t(right), CFG, 4, wavefront=wf)
    _assert_maps_equal(got, _whole(left, right, CFG))


def _c0_pair():
    """A synthetic scene with UNORM8 noise of +-24 codes: near-tau detail
    in the bottom rows, so the walks of rows past the frame bottom (over
    edge-replicated images) differ from row H - 1's own arms."""
    rng = np.random.default_rng(0)
    left, right, _, _ = synthetic_scene(rng, 112, 96, 15)
    codes = [np.clip(np.round(x * 255) + rng.integers(-24, 25, x.shape), 0,
                     255) for x in (left, right)]
    return [(c / np.float32(255)).astype(np.float32) for c in codes]


def test_bottom_rows_vote_with_the_last_rows_arms(monkeypatch):
    """The vote reads the arms with the same edge clamp as the map, so rows
    past the frame bottom must vote with row H - 1's arms (ROADMAP C0,
    without the tsukuba pair): equal with the fix, and 8 final pixels
    differ on this input when the vote arms are left unfixed."""
    left, right = _c0_pair()
    cfg = StereoConfig(d_max=15, oii_impl="taps")
    whole = _whole(left, right, cfg)
    got = wavefront_cross.cross_pipeline_wavefront(t(left), t(right), cfg, 2)
    _assert_maps_equal(got, whole)

    fix = wavefront_cross._fix_bottom
    monkeypatch.setattr(wavefront_cross, "_fix_bottom",
                        lambda x, first_virtual, axis=0:
                        x if axis == 1 else fix(x, first_virtual, axis))
    initial, final = wavefront_cross.cross_pipeline_wavefront(
        t(left), t(right), cfg, 2)
    assert torch.equal(initial, whole[0])
    assert int((final != whole[1]).sum()) == 8


# --- against the JAX package ------------------------------------------------

@pytest.mark.parametrize("bands", [2, 3])
def test_equals_jax_band_drivers(pair, bands):
    left, right = pair
    jl, jr = jnp.asarray(left), jnp.asarray(right)
    want = jwfc.cross_pipeline_wavefront(jl, jr, JAX_CFG, bands)
    got = wavefront_cross.cross_pipeline_wavefront(t(left), t(right), CFG,
                                                   bands)
    _assert_maps_equal(got, want)
    want = jtiled.cross_pipeline_tiled(jl, jr, JAX_CFG, bands,
                                       wavefront=False)
    got = tiled.cross_pipeline_tiled(t(left), t(right), CFG, bands,
                                     wavefront=False)
    _assert_maps_equal(got, want)


@pytest.mark.parametrize("wf", [True, False], ids=["wavefront", "halo"])
def test_reference_config_3_bands_equal_fixture(wf):
    """REFERENCE_CONFIG on the 288x384 fixture pair in 3 bands gives the
    committed JAX maps (tests/data/cross_torch_fixture.npz)."""
    with np.load(gen.asw_gen.FIXTURE) as f:
        left, right = (t(gen.asw_gen.from_codes(f[k])) for k in ("left",
                                                                 "right"))
    got = tiled.cross_pipeline_tiled(left, right, REFERENCE_CONFIG, 3,
                                     wavefront=wf)
    with np.load(gen.FIXTURE) as f:
        for g, name in zip(got, ("initial", "final")):
            np.testing.assert_array_equal(gen.asw_gen.to_codes(n(g)), f[name],
                                          err_msg=name)


@pytest.mark.parametrize("kw", [SMALL, {}, dict(d_max=279, arm_len=17)],
                         ids=["small", "reference", "arm17"])
def test_plan_bands_cross_equals_jax(kw):
    jcfg, cfg = config_pair(**kw)
    for H in list(range(8, 200, 3)) + [288, 375, 1988]:
        for bands in range(1, 9):
            got = wavefront_cross.plan_bands_cross(H, bands, cfg)
            want = jwfc.plan_bands_cross(H, bands, jcfg)
            if want is None:
                assert got is None, (H, bands)
                continue
            assert [tuple(vars(g).values()) for g in got] == [
                tuple(vars(g).values()) for g in want], (H, bands)


def test_config3_cross_plan():
    """1988 rows in 5 bands (BASELINE config 3) at the reference arms."""
    geoms = wavefront_cross.plan_bands_cross(1988, 5, REFERENCE_CONFIG)
    assert [g.e - g.s for g in geoms] == [398, 398, 398, 398, 396]


def test_routing_and_refusals(pair):
    left, right = t(pair[0]), t(pair[1])
    # 16 bands of 6 rows are shorter than the strips: "auto" takes the
    # halo bands, True refuses.
    assert not wavefront_cross.cross_wavefront_supported(left.shape, CFG, 16)
    _assert_maps_equal(tiled.cross_pipeline_tiled(left, right, CFG, 16),
                       _whole(*pair, CFG))
    with pytest.raises(ValueError, match="wavefront=True"):
        tiled.cross_pipeline_tiled(left, right, CFG, 16, wavefront=True)
    with pytest.raises(ValueError, match="unsupported"):
        wavefront_cross.cross_pipeline_wavefront(left, right, CFG, 1)
    with pytest.raises(ValueError, match="median_dispatch_quirk"):
        tiled.cross_pipeline_tiled(left, right,
                                   CFG.replace(median_dispatch_quirk=True), 2)
    with pytest.raises(ValueError, match="pallas"):
        tiled.cross_pipeline_tiled(left, right, CFG.replace(oii_impl="pallas"),
                                   2)
    # "auto" and "prefix" run as "taps" on the CPU, and launch nothing.
    kernels.reset_launches()
    for impl in ("auto", "prefix"):
        _assert_maps_equal(tiled.cross_pipeline_tiled(
            left, right, CFG.replace(oii_impl=impl), 3), _whole(*pair, CFG))
    assert all(v == 0 for v in kernels.LAUNCHES.values())


# --- row anchoring of the arms (K5) and the OII vertical pass (K7) ----------

H_FRAME, W_FRAME, L = 40, 33, 4
# (row0, rows): a window inside the frame, one that ends at the frame
# bottom and one that runs 6 rows past it.
WINDOWS = [(7, 20), (25, 15), (30, 16)]


@pytest.fixture(scope="module")
def frame():
    """A frame whose arms reach every length (tau 0.35 on noise in steps)."""
    rng = np.random.default_rng(40)
    img = (np.round(rng.random((H_FRAME, W_FRAME, 3)) * 4) / 4).astype(
        np.float32)
    return img


def _window(x, row0, rows, axis=0):
    """Frame rows row0 .. row0 + rows - 1 of x; rows past the frame bottom
    are copies of its last row."""
    real = np.take(x, range(row0, min(row0 + rows, x.shape[axis])), axis=axis)
    extra = row0 + rows - x.shape[axis]
    if extra > 0:
        last = np.take(x, [x.shape[axis] - 1], axis=axis)
        real = np.concatenate([real] + [last] * extra, axis=axis)
    return np.ascontiguousarray(real)


@pytest.mark.parametrize("row0,rows", WINDOWS)
@pytest.mark.parametrize("quirk", [True, False])
def test_anchored_arms_equal_jax(frame, row0, rows, quirk):
    win = _window(frame, row0, rows)
    want = np.asarray(_cross_arms_tiled(jnp.asarray(win), 0, row0, H_FRAME, L,
                                        0.35, quirk))
    pallas = np.asarray(cross_arms_pallas(jnp.asarray(win), L, 0.35, quirk,
                                          row0=row0, h_glob=H_FRAME,
                                          interpret=True))
    got = cross_arms(t(win), L, 0.35, quirk, row0=row0, h_glob=H_FRAME)
    np.testing.assert_array_equal(n(got), want)
    np.testing.assert_array_equal(n(got), pallas)
    np.testing.assert_array_equal(
        n(tops.cross_arms(t(win), L, 0.35, quirk, row0, H_FRAME)), want)
    # Rows with L + 1 window rows on each side (or the frame border there)
    # carry the whole frame's arms; rows past the bottom carry row H - 1's.
    full = n(tops.cross_arms(t(frame), L, 0.35, quirk))
    M = L + 1
    top = 0 if row0 == 0 else M
    bot = min(rows, H_FRAME - row0) if row0 + rows >= H_FRAME else rows - M
    np.testing.assert_array_equal(n(got)[:, top:bot],
                                  full[:, row0 + top:row0 + bot])
    assert np.abs(full).max() > 2


@pytest.mark.parametrize("row0,rows", WINDOWS)
def test_anchored_oii_vpass_equals_jax(frame, row0, rows):
    D = 6
    rng = np.random.default_rng(row0)
    arms = n(tops.cross_arms(t(frame), L, 0.35))
    arms_r = n(tops.cross_arms(t(np.roll(frame, 1, axis=1)), L, 0.35))
    vol = rng.random((D, H_FRAME, W_FRAME), dtype=np.float32)
    vw = _window(vol, row0, rows, axis=1)
    al, ar = (_window(a, row0, rows, axis=1) for a in (arms, arms_r))
    got = oii_pass(t(vw), t(al), t(ar), L, 1, row0=row0, h_glob=H_FRAME)
    np.testing.assert_array_equal(
        n(tops.oii_pass_plain(t(vw), t(al), t(ar), L, 1, 0, row0, H_FRAME)),
        n(got))
    want = oii_vpass_pallas(jnp.asarray(vw), jnp.asarray(al), jnp.asarray(ar),
                            L, interpret=True, row0=row0, h_glob=H_FRAME)
    np.testing.assert_array_equal(n(got), np.asarray(want))
    # The sharded taps form over the rows with L rows of margin.
    vm, vp = combined_arms(jnp.asarray(al[:, L:-L]), jnp.asarray(ar[:, L:-L]),
                           D, plane_minus=2, plane_plus=3)
    tiled_taps = _oii_vtaps_tiled(jnp.asarray(vw), vm, vp, L, L, row0 + L,
                                  H_FRAME)
    np.testing.assert_array_equal(n(got)[:, L:-L], np.asarray(tiled_taps))
    # Rows inside the frame with L rows of margin equal the whole frame's.
    full = n(oii_pass(t(vol), t(arms), t(arms_r), L, 1))
    hi = min(rows - L, H_FRAME - row0)
    np.testing.assert_array_equal(n(got)[:, L:hi], full[:, row0 + L:row0 + hi])


def test_anchoring_defaults_and_refusals(frame):
    img = t(frame)
    assert torch.equal(cross_arms(img, L, 0.35, row0=0, h_glob=H_FRAME),
                       cross_arms(img, L, 0.35))
    vol = torch.rand((3, H_FRAME, W_FRAME), generator=torch.Generator()
                     .manual_seed(0))
    arms = cross_arms(img, L, 0.35)
    assert torch.equal(oii_pass(vol, arms, arms, L, 1, row0=0, h_glob=H_FRAME),
                       oii_pass(vol, arms, arms, L, 1))
    with pytest.raises(ValueError, match="axis 1"):
        oii_pass(vol, arms, arms, L, 2, row0=3)
    with pytest.raises(ValueError, match="h_glob"):
        cross_arms(img, L, 0.35, row0=0, h_glob=0)
