"""The port's multi-device layer (stereo_matchin_tpu_torch.parallel) in one
process: its pure functions against the JAX package's
`stereo_matchin_tpu/parallel/` on the same numpy inputs, and the sharded
WTA's merges against the port's unsharded WTA, on the CPU.

Tolerances: bit-equal against eager JAX (op by op, so XLA fuses no
multiply-add; `jax.disable_jit()` for the loops), except the support
weights, whose `exp` differs between XLA and PyTorch: held to the bound
tests/test_torch_ops.py states (rtol 1e-5) against JAX, and bit-equal to
the port's own whole-frame weights.  The spawned ranks' tests are in
tests/test_torch_parallel_gloo.py.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_matchin_tpu import ops as jops
from stereo_matchin_tpu.parallel import ops_tiled as jtiled
from stereo_matchin_tpu_torch import ops as tops
from stereo_matchin_tpu_torch.config import StereoConfig
from stereo_matchin_tpu_torch.kernels.wta_gather import two_min
from stereo_matchin_tpu_torch.ops.wta_fast import _two_min_plain
from stereo_matchin_tpu_torch.parallel import halo, ops_tiled
from stereo_matchin_tpu_torch.parallel.cross_sharded import (
    _clamp_to_frame, make_cross_sharded)
from stereo_matchin_tpu_torch.parallel.mesh import Shard

from .torch_support import n, t, unorm8_pair

# The packages export functions named wta_sharded: take the modules.
jwta = importlib.import_module("stereo_matchin_tpu.parallel.wta_sharded")
twta = importlib.import_module("stereo_matchin_tpu_torch.parallel.wta_sharded")

BIG = 1e5


def _same(got, want):
    got, want = n(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _summary(rng, H, W, D):
    """A two-min summary with ties (small integer costs) and big."""
    c1 = rng.integers(0, 6, (H, W)).astype(np.float32)
    c2 = c1 + rng.integers(0, 3, (H, W)).astype(np.float32)
    c1[rng.random((H, W)) < 0.1] = BIG
    c2[c1 == BIG] = BIG
    return c1, c2, rng.integers(0, D, (H, W)).astype(np.int32)


def test_two_min_combine_equals_jax():
    rng = np.random.default_rng(0)
    for _ in range(4):
        a, b = _summary(rng, 9, 13, 20), _summary(rng, 9, 13, 20)
        got = twta.two_min_combine(twta.TwoMin(*map(t, a)),
                                   twta.TwoMin(*map(t, b)))
        want = jwta.two_min_combine(jwta.TwoMin(*map(jnp.asarray, a)),
                                    jwta.TwoMin(*map(jnp.asarray, b)))
        for g, w in zip(got, want):
            _same(g, w)


def _volume(rng, D, H, W):
    """Integer costs (exact ties) with a block at or above the big cap."""
    cost = rng.integers(0, 30, (D, H, W)).astype(np.float32)
    cost[:, :2, :3] = 2e5
    return cost


def _penalty(rng, D, H, W):
    return (rng.random((H, W)).astype(np.float32),
            (rng.random((H, W)) * D).astype(np.float32))


class _EagerLax:
    """jax.lax with fori_loop run op by op in Python (a traced step index,
    no jit), so that XLA contracts no multiply-add in the loop body."""

    def __getattr__(self, name):
        return getattr(jax.lax, name)

    @staticmethod
    def fori_loop(lo, hi, body, carry):
        for i in range(lo, hi):
            carry = body(jnp.int32(i), carry)
        return carry


@pytest.mark.parametrize("with_penalty", [False, True])
def test_epipolar_partial_equals_jax(with_penalty, monkeypatch):
    """One shard's segment (d0 = 6 of 20 planes) against JAX's, step by
    step."""
    monkeypatch.setattr(jwta, "lax", _EagerLax())
    rng = np.random.default_rng(1 + with_penalty)
    D, H, W, d0, Dl = 20, 7, 30, 6, 5
    cost = _volume(rng, Dl, H, W)
    d1 = rng.integers(0, D, (H, W)).astype(np.int32)
    pen = _penalty(rng, D, H, W) if with_penalty else (None, None)
    got = twta.epipolar_partial(t(cost), t(d1), d0, Dl, D,
                                *(None if p is None else t(p) for p in pen))
    want = jwta.epipolar_partial(
        jnp.asarray(cost), jnp.asarray(d1), d0, Dl, D,
        *(None if p is None else jnp.asarray(p) for p in pen))
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("with_penalty", [False, True])
@pytest.mark.parametrize("d0", [0, 7, 60])
def test_two_min_at_an_offset_equals_jax_penalty(d0, with_penalty):
    """K3's d0 (its plain version here): the penalty of plane k is
    sc * |ct - (d0 + k)|, as JAX wta_refined_sharded builds it; d1 stays
    the plane index."""
    rng = np.random.default_rng(d0 + with_penalty)
    Dl, H, W = 9, 6, 11
    cost = _volume(rng, Dl, H, W)
    sc, ct = _penalty(rng, d0 + Dl, H, W)
    pen = None
    if with_penalty:
        ds = (d0 + jnp.arange(Dl)).astype(jnp.float32)[:, None, None]
        pen = jnp.asarray(sc)[None] * jnp.abs(jnp.asarray(ct)[None] - ds)
    want = jops.two_min_scan(jnp.asarray(cost), penalty=pen, big=BIG)
    got = (two_min(t(cost), t(sc), t(ct), BIG, d0) if with_penalty
           else two_min(t(cost), big=BIG, d0=d0))
    for g, w in zip(got, want):
        _same(g, w)
    with pytest.raises(ValueError, match="d0"):
        two_min(t(cost), big=BIG, d0=-1)


@pytest.mark.parametrize("with_penalty", [False, True])
@pytest.mark.parametrize("shards", [2, 3, 5])
def test_sharded_wta_merges_equal_unsharded(shards, with_penalty):
    """The merges of reference_scan_sharded / target_scan_sharded over
    per-shard summaries computed here (D padded with big planes) against
    the port's unsharded wta_fast / wta_refined_fast, bit for bit."""
    rng = np.random.default_rng(10 * shards + with_penalty)
    D, H, W = 13, 8, 25
    cost = _volume(rng, D, H, W)
    d_pad = -(-D // shards) * shards
    dl = d_pad // shards
    padded = np.concatenate([cost, np.full((d_pad - D, H, W), BIG,
                                           np.float32)])
    if with_penalty:
        val, den, val_t, den_t = (t(rng.random((H, W)).astype(np.float32)
                                    * s) for s in (D, 3, D, 3))
        want = tops.wta_refined_fast(t(cost), val, den, val_t, den_t, 0.085,
                                     BIG)
        sc, ct, sc_t, ct_t = 0.085 * den, val, 0.085 * den_t, val_t
    else:
        want = tops.wta_fast(t(cost), BIG)
        sc = ct = sc_t = ct_t = None
    vols = [t(padded[k * dl:(k + 1) * dl]) for k in range(shards)]
    parts = []
    for k, v in enumerate(vols):
        c1, c2, d = _two_min_plain(v, sc, ct, BIG, k * dl)
        parts.append(twta.TwoMin(c1, c2, d + k * dl))
    ref = twta.merge_reference(parts, BIG)
    segs = [twta.epipolar_partial(v, ref.d, k * dl, dl, d_pad, sc_t, ct_t,
                                  BIG) for k, v in enumerate(vols)]
    d_t, conf_t = twta.merge_target(segs, ref.d, BIG)
    _same(ref.d.float(), n(want.disp_ref))
    _same((ref.c2 - ref.c1) / ref.c2, n(want.conf_ref))
    _same(d_t.float(), n(want.disp_target))
    _same(conf_t, n(want.conf_target))


def _tile(img, row0, h_loc, pad):
    """Rows row0 - pad .. row0 + h_loc + pad - 1 of img, clamped to the
    frame (an exchanged tile)."""
    idx = np.clip(np.arange(row0 - pad, row0 + h_loc + pad), 0,
                  img.shape[0] - 1)
    return np.ascontiguousarray(img[idx])


@pytest.mark.parametrize("row0", [0, 8, 20])
def test_support_weights_tiled(row0):
    """Centre rows of a halo-padded tile at row_start = row0: bit-equal to
    the port's whole-frame weights, and within the exp bound of JAX's
    support_weights_tiled."""
    left, _ = unorm8_pair(np.random.default_rng(4), 28, 33)
    R, h_loc, halo_rows = 4, 8, 5
    tile = _tile(left, row0, h_loc, halo_rows)
    for gc, gp in ((30.91, 28.21), (10.94, 118.78)):
        got = ops_tiled.support_weights_tiled(t(tile), R, gc, gp, row0, 28,
                                              halo_rows)
        whole = tops.support_weights(t(left), R, gc, gp, 0)
        _same(got, n(whole)[:, row0:row0 + h_loc])
        want = jtiled.support_weights_tiled(
            jnp.asarray(tile), R, gc, gp, axis=0, row_start=row0,
            h_global=28, halo=halo_rows)
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5,
                                   atol=0)
    # Horizontal taps: the whole rows' ops.support_weights.
    want = jtiled.support_weights_tiled(jnp.asarray(left), R, 30.91, 28.21,
                                        axis=1)
    np.testing.assert_allclose(
        n(tops.support_weights(t(left), R, 30.91, 28.21, 1)), np.asarray(want),
        rtol=1e-5, atol=0)
    with pytest.raises(ValueError, match="halo"):
        ops_tiled.support_weights_tiled(t(tile), 6, 30.91, 28.21, row0, 28,
                                        halo_rows)


@pytest.mark.parametrize("d0", [0, 5, 30])
def test_shifted_planes_and_cost_at_an_offset_equal_jax(d0):
    """ops.shifted_columns / ops.sad_cost_volume with d0 against
    stack_shift_x_offset / sad_cost_volume_shard (their JAX homes)."""
    left, right = unorm8_pair(np.random.default_rng(5), 9, 26)
    Dl, d_pad = 6, d0 + 12
    plane = left[..., 0]
    _same(tops.shifted_columns(t(plane), Dl, d0),
          jtiled.stack_shift_x_offset(jnp.asarray(plane), d0, Dl, d_pad))
    for scale in (1.0, 255.0):
        _same(tops.sad_cost_volume(t(left), t(right), Dl, scale, d0),
              jtiled.sad_cost_volume_shard(jnp.asarray(left),
                                           jnp.asarray(right), d0, Dl, d_pad,
                                           scale))


@pytest.mark.parametrize("d0", [0, 4])
def test_aggregation_passes_on_a_tile_equal_jax(d0):
    """asw_vpass_tiled = K1's plain version + the windowed K2's on the
    (Dl, H_loc + 2R, W) tile; asw_hpass = K2 h's plain version at d0."""
    rng = np.random.default_rng(6 + d0)
    R, Dl, h_loc, W = 3, 5, 7, 19
    T = 2 * R + 1
    cost_pad = rng.uniform(0, 700, (Dl, h_loc + 2 * R, W)).astype(np.float32)
    wl, wr = (rng.uniform(0.01, 1, (T, h_loc, W)).astype(np.float32)
              for _ in range(2))
    with jax.disable_jit():
        want_v, want_den = jtiled.asw_vpass_tiled(
            jnp.asarray(cost_pad), jnp.asarray(wl), jnp.asarray(wr), d0, Dl,
            d0 + Dl, R, 1e-5)
        want_h, want_hden = jtiled.asw_hpass(
            jnp.asarray(cost_pad[:, R:R + h_loc]), jnp.asarray(wl),
            jnp.asarray(wr), d0, Dl, d0 + Dl, R, 1e-5)
    den = tops.asw_den_plain(t(wl), t(wr), 1e-5, d0, Dl)
    _same(den, want_den)
    _same(tops.asw_pass_win_plain(t(cost_pad), t(wl), t(wr), den, 1e-5, d0),
          want_v)
    _same(tops.asw_pass_plain(t(cost_pad[:, R:R + h_loc]), t(wl), t(wr), den,
                              1e-5, 2, d0), want_h)
    _same(den, want_hden)


def test_refine_vpass_and_median_tiled_equal_jax():
    """refine_vpass_tiled = ops.refine_pass_v_win on the padded maps."""
    rng = np.random.default_rng(7)
    R, h_loc, W = 4, 6, 15
    w = rng.uniform(0.01, 1, (2 * R + 1, h_loc, W)).astype(np.float32)
    d_pad = rng.integers(0, 61, (h_loc + 2 * R, W)).astype(np.float32)
    c_pad = rng.random((h_loc + 2 * R, W)).astype(np.float32)
    got = tops.refine_pass_v_win(t(w), t(d_pad), t(c_pad), 1e-5)
    with jax.disable_jit():
        want = jtiled.refine_vpass_tiled(jnp.asarray(w), jnp.asarray(d_pad),
                                         jnp.asarray(c_pad), R, 1e-5)
    for g, x in zip(got, want):
        _same(g, x)
    for shape in ((h_loc + 2, W), (h_loc + 2, W, 3)):
        img = rng.random(shape).astype(np.float32)
        _same(ops_tiled.median3x3_tiled(t(img)),
              jtiled.median3x3_tiled(jnp.asarray(img)))


def test_frame_clamp_of_a_padded_tile():
    """_clamp_to_frame: tile rows past the frame take the border row."""
    x = torch.arange(10.0)[:, None].expand(10, 3).contiguous()
    np.testing.assert_array_equal(n(_clamp_to_frame(x, -3, 20))[:, 0],
                                  [3, 3, 3, 3, 4, 5, 6, 7, 8, 9])
    np.testing.assert_array_equal(n(_clamp_to_frame(x, 15, 20))[:, 0],
                                  [0, 1, 2, 3, 4, 4, 4, 4, 4, 4])
    np.testing.assert_array_equal(n(_clamp_to_frame(x, 5, 20)), n(x))


def test_refusals_without_a_group():
    """median_dispatch_quirk, H or B off the shards: each raises before
    any collective (a halo past the local rows: test_torch_parallel_gloo)."""
    with pytest.raises(ValueError, match="median_dispatch_quirk"):
        make_cross_sharded(StereoConfig(median_dispatch_quirk=True), None)
    sh = Shard(0, 0, 0, 1, 3, 1, None, None)
    with pytest.raises(ValueError, match="does not split"):
        sh.block(torch.zeros(1, 10, 4, 3))
    with pytest.raises(ValueError, match="does not split"):
        Shard(0, 0, 0, 2, 1, 1, None, None).block(torch.zeros(3, 4, 4, 3))
    assert Shard(0, 2, 1, 1, 3, 4, None, None).planes(11) == (3, 3, 12)
    assert halo.crop_halo(torch.arange(10.0), 3).tolist() == [3, 4, 5, 6]
