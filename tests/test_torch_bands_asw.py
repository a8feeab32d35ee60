"""The port's ASW band drivers (models/tiled.py, models/wavefront.py), its
d-chunked aggregation and crop (models/asw.py) and the windowed pass
(ops.asw_pass_win_plain, the plain version of K2 `asw_pass_win`), on the
CPU.

Banded runs must EQUAL the whole-frame run bit for bit: every kept row is
the same expression over the same inputs either way.  Against the JAX
package the band drivers are bit-equal on the integer maps when each
band's weight strips are the JAX strips of the same image slice (carried
across with convert.weights_from_jax; `exp` rounds differently in XLA and
PyTorch, see tests/test_torch_pipeline_asw.py).  The windowed pass meets
the Pallas kernel in interpret mode within the repository's 1-ulp FMA rule
(tests/test_torch_kernels_asw_aggregation.py): rtol 3e-6, atol 1e-6.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_matchin_tpu.kernels.asw_aggregation_dres import asw_vpass_dres_win
from stereo_matchin_tpu.models import tiled as jtiled
from stereo_matchin_tpu.models import wavefront as jwf
from stereo_matchin_tpu_torch import kernels
from stereo_matchin_tpu_torch import ops as tops
from stereo_matchin_tpu_torch.convert import weights_from_jax
from stereo_matchin_tpu_torch.kernels.asw_aggregation import asw_pass_win
from stereo_matchin_tpu_torch.models import asw as tasw
from stereo_matchin_tpu_torch.models import tiled, wavefront

from .test_torch_pipeline_asw import jax_strips
from .torch_support import config_pair, max_ulp, n, t, unorm8_pair

# The sizes of tests/test_wavefront.py: keep = k*R + 1 = 5, so the strip
# windows need bands of at least 10 rows.
SMALL = dict(d_max=11, radius=2, arm_len=3, r_iters=3, k_iters=2,
             aggr_d_chunks=2)
CONFIG3_KW = dict(d_max=279, radius=16, r_iters=7, k_iters=6, aggr_d_chunks=4)
JAX_CFG, CFG = config_pair(**SMALL)
CONFIG3 = config_pair(**CONFIG3_KW)[1]
FMA = dict(rtol=3e-6, atol=1e-6)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(7)
    left = (rng.integers(0, 256, (48, 32, 3)) / np.float32(255.0)).astype(
        np.float32)
    right = np.roll(left, -2, axis=1)
    noise = rng.integers(-12, 13, right.shape) / np.float32(255.0)
    right = np.clip(np.round((right + noise) * 255) / 255.0, 0, 1).astype(
        np.float32)
    return left, right


def _whole(left, right, cfg):
    res = tasw.asw_pipeline(t(left), t(right), cfg)
    return res.disparity, res.filled


def _assert_maps_equal(got, want):
    for g, w, name in zip(got, want, ("disparity", "filled")):
        assert g.shape == w.shape, name
        assert torch.equal(g, w), f"{name}: {int((g != w).sum())} pixels differ"


# --- banded == whole frame --------------------------------------------------

@pytest.mark.parametrize("chunks", [0, 1, 2, 3])
@pytest.mark.parametrize("bands", [2, 3])
@pytest.mark.parametrize("wf", [True, False], ids=["wavefront", "halo"])
def test_banded_equals_whole_frame(pair, chunks, bands, wf):
    cfg = CFG.replace(aggr_d_chunks=chunks)
    got = tiled.asw_pipeline_tiled(t(pair[0]), t(pair[1]), cfg, bands,
                                   wavefront=wf)
    _assert_maps_equal(got, _whole(*pair, cfg))


@pytest.mark.parametrize("wf", [True, False], ids=["wavefront", "halo"])
def test_non_dividing_last_band(pair, wf):
    """H = 44 in 3 bands: the last band is shorter (14 rows) than the
    others and its windows run past the frame bottom."""
    left, right = pair[0][:44], pair[1][:44]
    assert [g.e - g.s for g in wavefront.plan_bands(44, 3, CFG)] == [15, 15, 14]
    got = tiled.asw_pipeline_tiled(t(left), t(right), CFG, 3, wavefront=wf)
    _assert_maps_equal(got, _whole(left, right, CFG))


def test_aligned_cuts_and_r1(pair):
    """Cuts snapped to multiples of 8 (16/16/12) move no value; r_iters = 1
    carries no level strip, only the aggregated one."""
    left, right = pair[0][:44], pair[1][:44]
    geoms = wavefront.plan_bands(44, 3, CFG, align=8)
    assert [(g.s, g.e) for g in geoms] == [(0, 16), (16, 32), (32, 44)]
    got = wavefront.asw_pipeline_wavefront(t(left), t(right), CFG, 3, align=8)
    _assert_maps_equal(got, _whole(left, right, CFG))
    cfg = CFG.replace(r_iters=1, aggr_d_chunks=0)
    got = wavefront.asw_pipeline_wavefront(t(pair[0]), t(pair[1]), cfg, 3)
    _assert_maps_equal(got, _whole(*pair, cfg))


def test_routing_and_refusals(pair):
    left, right = t(pair[0]), t(pair[1])
    # 8 bands of 6 rows are shorter than the strips: "auto" takes the halo
    # bands, True refuses.
    assert not wavefront.wavefront_supported(left.shape, CFG, 8)
    got = tiled.asw_pipeline_tiled(left, right, CFG, 8)
    _assert_maps_equal(got, _whole(*pair, CFG))
    with pytest.raises(ValueError, match="wavefront=True"):
        tiled.asw_pipeline_tiled(left, right, CFG, 8, wavefront=True)
    with pytest.raises(ValueError, match="unsupported"):
        wavefront.asw_pipeline_wavefront(left, right, CFG, 1)
    with pytest.raises(ValueError, match="pallas"):
        tiled.asw_pipeline_tiled(left, right, CFG.replace(kernels="pallas"), 2)
    kernels.reset_launches()
    tiled.asw_pipeline_tiled(left, right, CFG, 2)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


# --- against the JAX package ------------------------------------------------

@pytest.fixture
def jax_weights(monkeypatch):
    """Every band's asw_weights returns the JAX strips of its slice."""
    def from_jax(left, right, cfg):
        return weights_from_jax(jax_strips(n(left), n(right), cfg), "cpu")

    monkeypatch.setattr(tasw, "asw_weights", from_jax)


def test_wavefront_equals_jax_wavefront(pair, jax_weights):
    left, right = pair
    want = jwf.asw_pipeline_wavefront(jnp.asarray(left), jnp.asarray(right),
                                      JAX_CFG.replace(kernels="pallas"), 3,
                                      interpret=True)
    got = wavefront.asw_pipeline_wavefront(t(left), t(right), CFG, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), np.asarray(w))


def test_halo_bands_equal_jax_halo_bands(pair, jax_weights):
    left, right = pair
    want = jtiled.asw_pipeline_tiled(jnp.asarray(left), jnp.asarray(right),
                                     JAX_CFG, 2, wavefront=False)
    got = tiled.asw_pipeline_tiled(t(left), t(right), CFG, 2, wavefront=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), np.asarray(w))


@pytest.mark.parametrize("kw", [SMALL, dict(SMALL, r_iters=1), {},
                                CONFIG3_KW],
                         ids=["small", "r1", "reference", "config3"])
def test_plan_bands_equals_jax(kw):
    jcfg, cfg = config_pair(**kw)
    for H in list(range(8, 130, 3)) + [288, 375, 400, 450, 1988]:
        for bands in range(1, 8):
            for align in (128, 8):
                got = wavefront.plan_bands(H, bands, cfg, align)
                want = jwf.plan_bands(H, bands, jcfg, align)
                if want is None:
                    assert got is None, (H, bands, align)
                    continue
                assert [tuple(vars(g).values()) for g in got] == [
                    tuple(vars(g).values()) for g in want], (H, bands, align)


def test_plan_at_config3():
    """BASELINE config 3 (2880 x 1988, d_max 279): the cuts of the JAX
    package's band plan."""
    geoms = wavefront.plan_bands(1988, 5, CONFIG3)
    assert [g.e - g.s for g in geoms] == [384, 384, 384, 384, 452]


def test_auto_bands():
    """One band where the frame fits, more as the memory shrinks, each
    band (the largest of the wavefront's cuts) inside the budget; on the
    CPU without a budget, one band."""
    H, W = 1988, 2880
    volume = CONFIG3.num_disp * W * H * 4
    assert tiled.auto_bands((H, W, 3), CONFIG3, hbm_bytes=80e9) == 1
    assert tiled.auto_bands((H, W, 3), CONFIG3, hbm_bytes=100 * volume) == 1
    few = tiled.auto_bands((H, W, 3), CONFIG3, hbm_bytes=4 * volume)
    assert few > 1
    rows = max(g.e - g.s for g in wavefront.plan_bands(H, few, CONFIG3))
    assert tiled.asw_plan_bytes(rows, W, CONFIG3, True) <= 0.85 * 4 * volume
    many = tiled.auto_bands((H, W, 3), CONFIG3, hbm_bytes=2 * volume)
    assert many > few
    assert not wavefront.wavefront_supported((H, W, 3), CONFIG3, many)
    assert tiled.asw_plan_bytes(-(-H // many), W, CONFIG3,
                                True) <= 0.85 * 2 * volume
    with pytest.raises(ValueError, match="planned to fit"):
        tiled.auto_bands((H, W, 3), CONFIG3, hbm_bytes=volume)
    assert tiled.auto_bands((40, 56, 3), CFG, device="cpu") == 1


# --- models/asw.py: aggr_d_chunks and crop -------------------------------------

@pytest.mark.parametrize("chunks,geometry", [(1, (11, 1)), (2, (6, 2)),
                                             (4, (3, 4)), (5, (3, 4)),
                                             (11, (1, 11))])
def test_d_chunked_aggregation_equals_one_volume(pair, chunks, geometry):
    """D = 11 planes: 2 chunks of 6 and 5 planes, 4 chunks of 3, 3, 3 and 2;
    5 chunks asked for give 4 (planes past D are never made)."""
    cfg = CFG.replace(d_max=10)
    assert tasw._chunk_geometry(cfg.num_disp, chunks) == geometry
    left, right = t(pair[0]), t(pair[1])
    w = tasw.asw_weights(left, right, cfg)
    whole = tasw.aggregate(left, right, w, cfg.replace(aggr_d_chunks=0))
    got = tasw.aggregate(left, right, w, cfg.replace(aggr_d_chunks=chunks))
    assert max_ulp(got, whole) == 0


def test_crop(pair):
    """The crop sheds aggregated rows; the maps keep the whole frame's
    values beyond k*radius + 1 rows of a cut."""
    left, right = t(pair[0]), t(pair[1])
    w = tasw.asw_weights(left, right, CFG)
    H, keep = left.shape[0], CFG.k_iters * CFG.radius + 1
    crop = (9, 7)
    whole = tasw.asw_pipeline(left, right, CFG)
    assert max_ulp(tasw.aggregate(left, right, w, CFG, crop),
                   whole.aggregated_cost[:, 9:H - 7]) == 0
    got = tasw.asw_pipeline(left, right, CFG, crop)
    assert got.disparity.shape == (H - 16, left.shape[1])
    assert torch.equal(got.disparity[keep:-keep],
                       whole.disparity[9 + keep:H - 7 - keep])
    with pytest.raises(ValueError, match="crop"):
        tasw.asw_pipeline(left, right, CFG, (30, 18))
    with pytest.raises(ValueError, match="rows"):
        tasw.asw_postaggregate(whole.aggregated_cost, w, CFG, (1, 0))


# --- the windowed pass (K2 asw_pass_win's plain version) ----------------------

@pytest.mark.parametrize("D,d0", [(7, 0), (9, 5)])
def test_windowed_pass(D, d0):
    """On a window of real rows the windowed pass equals the clamped pass
    on the same rows bit for bit, and over the edge-padded frame the whole
    clamped pass; it meets the JAX windowed kernel within the FMA rule."""
    R, eps = 4, 1e-5
    left, right = unorm8_pair(np.random.default_rng(D), 40, 70)
    cost = tops.sad_cost_volume(t(left), t(right), D, 255.0, d0)
    wl, wr = (tops.support_weights(t(x), R, 30.91, 28.21, 0)
              for x in (left, right))
    den = tops.asw_den_plain(wl, wr, eps, d0, D)
    full = tops.asw_pass_plain(cost, wl, wr, den, eps, 1, d0)
    a, b = 11, 29
    win = asw_pass_win(cost[:, a - R:b + R].contiguous(),
                       wl[:, a:b].contiguous(), wr[:, a:b].contiguous(),
                       den[:, a:b].contiguous(), eps, d0)
    assert max_ulp(win, full[:, a:b]) == 0
    padded = tops.edge_pad(cost, R, R, 1)
    assert max_ulp(tops.asw_pass_win_plain(padded, wl, wr, den, eps, d0),
                   full) == 0
    tr = lambda x: jnp.swapaxes(jnp.asarray(n(x)), 1, 2)
    want = asw_vpass_dres_win(tr(cost[:, a - R:b + R]), tr(wl[:, a:b]),
                              tr(wr[:, a:b]), R, eps, interpret=True,
                              d0=d0, max_shift=d0 + D - 1)
    np.testing.assert_allclose(n(win), np.swapaxes(np.asarray(want), 1, 2),
                               **FMA)


def test_windowed_pass_refuses_bad_shapes():
    wl = torch.zeros((5, 6, 8))
    den = torch.zeros((3, 6, 8))
    with pytest.raises(ValueError, match="cost_win"):
        asw_pass_win(torch.zeros((3, 6, 8)), wl, wl, den, 1e-5)
    with pytest.raises(ValueError, match="d0"):
        asw_pass_win(torch.zeros((3, 10, 8)), wl, wl, den, 1e-5, -1)
    assert asw_pass_win(torch.zeros((3, 10, 8)), wl, wl, den + 1,
                        1e-5).shape == (3, 6, 8)
