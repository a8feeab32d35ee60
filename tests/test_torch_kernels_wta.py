"""Kernels K3 (two_min) and K4 (wta_diag) of the port: their plain
versions against the JAX package's Pallas kernels (interpret mode) and
WTA ops.  The CUDA kernels are held to the plain versions on the card in
tests/test_torch_cuda.py.

All comparisons are bit-equal.  The penalty inputs use a dyadic scale
(k/64) and integer centres, so every product sc*|ct - i| is exact and an
FMA-contracted XLA program rounds exactly like the port's two roundings;
with general penalties XLA:CPU may contract cost + sc*|ct - i| and drift
by 1 ulp (tests/test_kernels_wta.py), which says nothing about the port.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_matchin_tpu import ops as jops
from stereo_matchin_tpu.kernels.wta_gather import (build_diag, two_min_pallas,
                                                   wta_diag_pallas)
from stereo_matchin_tpu_torch import kernels
from stereo_matchin_tpu_torch import ops as tops
from stereo_matchin_tpu_torch.kernels.wta_gather import two_min, wta_diag
from stereo_matchin_tpu_torch.ops.wta_fast import (_diag_two_min_plain,
                                                   _target_scan_fast,
                                                   _two_min_plain)

from .torch_support import n, t

BIG = 1e5


def _volume(rng, D, H, W, ties=True):
    """Costs with exact ties between planes and pixels above the big cap."""
    if ties:
        cost = rng.integers(0, 30, (D, H, W)).astype(np.float32)
    else:
        cost = (rng.random((D, H, W), dtype=np.float32) * 50).astype(np.float32)
    cost[:, :2, :3] = 2e5                      # nothing below big
    cost[: D // 2, 2, :4] = 3e5                # big only on some planes
    return cost


def _penalty(rng, D, H, W):
    sc = (rng.integers(0, 128, (H, W)) / np.float32(64)).astype(np.float32)
    ct = rng.integers(0, D, (H, W)).astype(np.float32)
    return sc, ct


def _assert_same(got, want):
    for g, w in zip(got, want):
        g, w = n(g), np.asarray(w)
        np.testing.assert_array_equal(g, w.astype(g.dtype))


SHAPES = [(8, 16, 24), (11, 24, 20), (5, 8, 40), (61, 12, 70)]


@pytest.mark.parametrize("D,H,W", SHAPES)
@pytest.mark.parametrize("with_penalty", [False, True])
def test_plain_two_min_equals_pallas_kernel(D, H, W, with_penalty):
    rng = np.random.default_rng(D * 100 + W)
    cost = _volume(rng, D, H, W)
    pen = _penalty(rng, D, H, W) if with_penalty else (None, None)
    want = two_min_pallas(jnp.asarray(cost),
                          *(None if p is None else jnp.asarray(p) for p in pen),
                          big=BIG, interpret=True)
    got = two_min(t(cost), *(None if p is None else t(p) for p in pen), big=BIG)
    _assert_same(got, want)
    assert got[2].dtype == torch.int32


@pytest.mark.parametrize("D,H,W", SHAPES)
@pytest.mark.parametrize("with_penalty", [False, True])
def test_plain_wta_diag_equals_pallas_kernel(D, H, W, with_penalty):
    rng = np.random.default_rng(D * 7 + H)
    cost = _volume(rng, D, H, W)
    d1 = rng.integers(0, D, (H, W)).astype(np.int32)
    pen = _penalty(rng, D, H, W) if with_penalty else (None, None)
    want = wta_diag_pallas(build_diag(jnp.asarray(cost)),
                           jnp.asarray(d1, jnp.float32),
                           *(None if p is None else jnp.asarray(p) for p in pen),
                           big=BIG, interpret=True)
    got = wta_diag(t(cost), t(d1), *(None if p is None else t(p) for p in pen),
                   big=BIG)
    _assert_same(got, want)
    assert got[2].dtype == torch.int32


@pytest.mark.parametrize("ties", [True, False])
def test_wta_fast_equals_jax_sequential_wta(ties):
    rng = np.random.default_rng(21)
    cost = _volume(rng, 13, 20, 33, ties)
    want = jops.wta(jnp.asarray(cost), big=BIG)
    _assert_same(tops.wta_fast(t(cost), big=BIG), want)


@pytest.mark.parametrize("ties", [True, False])
def test_wta_refined_fast_equals_jax_sequential_wta_refined(ties):
    rng = np.random.default_rng(22)
    D, H, W = 13, 20, 33
    cost = _volume(rng, D, H, W, ties)
    # penalty 0.125 and den = k/8 in place of 0.085 and refine_view's
    # outputs keep every penalty*den*|val - d| exact (see module docstring)
    val = rng.integers(0, D, (H, W)).astype(np.float32)
    val_t = rng.integers(0, D, (H, W)).astype(np.float32)
    penalty = 0.125
    den = (rng.integers(0, 64, (H, W)) / np.float32(8)).astype(np.float32)
    den_t = (rng.integers(0, 64, (H, W)) / np.float32(8)).astype(np.float32)
    want = jops.wta_refined(*map(jnp.asarray, (cost, val, den, val_t, den_t)),
                            penalty, big=BIG)
    got = tops.wta_refined_fast(*map(t, (cost, val, den, val_t, den_t)),
                                penalty, big=BIG)
    _assert_same(got, want)


@pytest.mark.parametrize("with_penalty", [False, True])
def test_vectorised_target_scan_equals_sequential_oracle(with_penalty):
    """ops/wta_fast's gather + closed-form tail against ops/wta's step-by-
    step scan, both in the port, with half-integer centres (the tail's
    tie case) and arbitrary scales."""
    rng = np.random.default_rng(23)
    D, H, W = 17, 9, 40
    cost = t(_volume(rng, D, H, W))
    d1 = two_min(cost)[2]
    sc = ct = None
    if with_penalty:
        sc = t(rng.random((H, W), dtype=np.float32))
        ct = t((rng.integers(0, 2 * D, (H, W)) / np.float32(2)).astype(
            np.float32))
    want = tops.epipolar_target_scan(cost, d1, sc, ct, big=BIG)
    d, conf = _target_scan_fast(cost, d1, sc, ct, big=BIG)
    np.testing.assert_array_equal(n(d).astype(np.float32), n(want[0]))
    np.testing.assert_array_equal(n(conf), n(want[1]))


def test_wrappers_validate_and_launch_nothing_on_cpu():
    rng = np.random.default_rng(24)
    cost = t(_volume(rng, 6, 5, 7))
    d1 = two_min(cost)[2]
    kernels.reset_launches()
    _assert_same(wta_diag(cost, d1), _diag_two_min_plain(cost, d1))
    _assert_same(two_min(cost), _two_min_plain(cost))
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    with pytest.raises(TypeError):
        wta_diag(cost, d1.long())
    with pytest.raises(ValueError):
        two_min(cost, cost[0])                          # scale without centre
    with pytest.raises(ValueError):
        two_min(cost[0])

