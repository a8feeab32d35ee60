"""The port's cross-method ops and the plain versions of its kernels K5-K8
against the JAX package, on the same numpy inputs, on the CPU.

On a CPU tensor each kernel wrapper takes its plain version, so these
tests hold the wrappers' CPU route to the JAX ops and to the Pallas
kernels in interpret mode; the CUDA kernels are held to the same plain
versions on the card in tests/test_torch_cuda.py.

Tolerances, and why:
  * K5 arms, K8 counts and modes: integers, equal.
  * K6 (scale 1) and K7: bit-equal.  Both sides subtract, add in tap
    order and divide once; with nothing multiplied there is no fused
    multiply-add for XLA:CPU to contract.
  * "prefix" aggregation: torch.cumsum and XLA's cumsum add in different
    orders, and each window is a difference of two prefix values of up to
    W (then H) costs, so a few ulp of the prefix magnitude (<= 3 * 40
    here) survive the cancellation: atol 2e-5, rtol 2e-5 (the bound the
    JAX package holds its own prefix and taps forms to).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_matchin_tpu import ops as jops
from stereo_matchin_tpu.kernels.cross_oii import (cross_arms_pallas,
                                                  histogram_vote_pallas,
                                                  oii_hpass_pallas,
                                                  oii_hpass_pallas_t,
                                                  oii_vpass_pallas)
from stereo_matchin_tpu.kernels.sad_volume import sad_volume_t_pallas
from stereo_matchin_tpu.ops import vote as jvote
from stereo_matchin_tpu_torch import kernels
from stereo_matchin_tpu_torch import ops as tops
from stereo_matchin_tpu_torch.kernels.cross_oii import (cross_arms, oii_pass,
                                                        vote_h, vote_v)
from stereo_matchin_tpu_torch.kernels.sad_volume import sad_volume

from .torch_support import n, t, unorm8_pair

PREFIX_TOL = dict(rtol=2e-5, atol=2e-5)


def _levels_image(rng, H, W, tau):
    """An image whose channel differences hit tau's f32 neighbourhood
    exactly (0, fl32(tau) and its two f32 neighbours) and coarse levels
    that make long arms."""
    t32 = np.float32(tau)
    vals = np.array([0.0, t32, np.nextafter(t32, np.float32(0)),
                     np.nextafter(t32, np.float32(1)), 0.5, 1.0], np.float32)
    img = vals[rng.integers(0, len(vals), (H, W, 3))]
    flat = rng.random((H, W)) < 0.5                    # runs of one colour
    img[flat] = img[0, 0]
    return img


def _case(rng, H, W, D, L):
    """Random pair, its JAX arms (tau 0.35: arms of every length) and SAD
    volume, as numpy."""
    left = rng.random((H, W, 3), dtype=np.float32)
    right = rng.random((H, W, 3), dtype=np.float32)
    arms_l = np.asarray(jops.cross_arms(jnp.asarray(left), L, 0.35))
    arms_r = np.asarray(jops.cross_arms(jnp.asarray(right), L, 0.35))
    cost = np.asarray(jops.sad_cost_volume(jnp.asarray(left),
                                           jnp.asarray(right), D))
    return left, right, cost, arms_l, arms_r


# --- K5: cross arms ---------------------------------------------------------

@pytest.mark.parametrize("H,W,L,tau", [(24, 20, 3, 0.35), (40, 33, 6, 0.10),
                                       (16, 40, 25, 0.2)])
@pytest.mark.parametrize("quirk", [True, False])
def test_cross_arms_bit_equal_to_jax(H, W, L, tau, quirk):
    rng = np.random.default_rng(H * W + L)
    for img in (rng.random((H, W, 3), dtype=np.float32),
                _levels_image(rng, H, W, tau)):
        want = np.asarray(jops.cross_arms(jnp.asarray(img), L, tau, quirk))
        pallas = np.asarray(cross_arms_pallas(jnp.asarray(img), L, tau, quirk,
                                              interpret=True))
        got = cross_arms(t(img), L, tau, quirk)
        assert got.dtype == torch.int32 and got.shape == (4, H, W)
        np.testing.assert_array_equal(n(got), want)
        np.testing.assert_array_equal(n(got), pallas)
    assert np.abs(want).max() > 1


# --- K6: SAD volume ---------------------------------------------------------

@pytest.mark.parametrize("H,W,D", [(41, 97, 11), (30, 50, 61)])
def test_sad_volume_bit_equal_to_pallas(H, W, D):
    rng = np.random.default_rng(W + D)
    left, right = (rng.random((H, W, 3), dtype=np.float32) for _ in range(2))
    want = sad_volume_t_pallas(jnp.swapaxes(jnp.asarray(left), 0, 1),
                               jnp.swapaxes(jnp.asarray(right), 0, 1), D,
                               interpret=True)
    got = sad_volume(t(left), t(right), D)
    np.testing.assert_array_equal(n(got), np.swapaxes(np.asarray(want), 1, 2))
    np.testing.assert_array_equal(n(got), np.asarray(jops.sad_cost_volume(
        jnp.asarray(left), jnp.asarray(right), D)))


def test_sad_volume_offset_and_scale():
    """A chunk at d0 equals the same planes of the whole volume; scale 255
    is the ASW path's eager-JAX cost."""
    left, right = unorm8_pair(np.random.default_rng(2), 24, 40)
    whole = sad_volume(t(left), t(right), 5 + 9)
    assert torch.equal(sad_volume(t(left), t(right), 9, 1.0, 5), whole[5:])
    np.testing.assert_array_equal(
        n(sad_volume(t(left), t(right), 9, 255.0)),
        np.asarray(jops.sad_cost_volume(jnp.asarray(left), jnp.asarray(right),
                                        9, 255.0)))


# --- K7: OII passes ---------------------------------------------------------

@pytest.mark.parametrize("H,W,D,L", [(24, 20, 8, 3), (40, 150, 7, 25),
                                     (33, 41, 5, 4)])
def test_oii_passes_bit_equal_to_pallas(H, W, D, L):
    rng = np.random.default_rng(H + W + D)
    _, _, cost, al, ar = _case(rng, H, W, D, L)
    jc, jl, jr = jnp.asarray(cost), jnp.asarray(al), jnp.asarray(ar)
    temp = oii_pass(t(cost), t(al), t(ar), L, 2)
    np.testing.assert_array_equal(
        n(temp), np.asarray(oii_hpass_pallas(jc, jl, jr, L, interpret=True)))
    np.testing.assert_array_equal(
        n(temp), np.asarray(oii_hpass_pallas_t(jc, jl, jr, L, interpret=True)))
    out = oii_pass(temp, t(al), t(ar), L, 1)
    np.testing.assert_array_equal(
        n(out), np.asarray(oii_vpass_pallas(jnp.asarray(n(temp)), jl, jr, L,
                                            interpret=True)))
    np.testing.assert_array_equal(n(out), np.asarray(jops.cross_aggregate(
        jc, jl, jr, arm_len=L, impl="taps")))


def test_oii_passes_with_d0_bit_equal_to_pallas():
    """D = 57 planes from d0 = 5 (an offset no multiple of 8)."""
    d0, D, L = 5, 57, 4
    rng = np.random.default_rng(57)
    _, _, whole, al, ar = _case(rng, 12, 70, d0 + D, L)
    cost = np.ascontiguousarray(whole[d0:])
    jl, jr = jnp.asarray(al), jnp.asarray(ar)
    kw = dict(interpret=True, d0=jnp.asarray(d0), max_shift=d0 + D - 1)
    for axis, pallas in ((2, oii_hpass_pallas), (2, oii_hpass_pallas_t),
                         (1, oii_vpass_pallas)):
        got = oii_pass(t(cost), t(al), t(ar), L, axis, d0)
        np.testing.assert_array_equal(
            n(got), np.asarray(pallas(jnp.asarray(cost), jl, jr, L, **kw)))
        full = oii_pass(t(whole), t(al), t(ar), L, axis)
        assert torch.equal(got, full[d0:])


def test_cross_aggregate_routes():
    """"auto" on the CPU is "taps"; "prefix" matches JAX's prefix within
    PREFIX_TOL and the taps form within the same bound."""
    L = 3
    _, _, cost, al, ar = _case(np.random.default_rng(4), 24, 40, 8, L)
    args = (t(cost), t(al), t(ar), L)
    taps = tops.cross_aggregate(*args, impl="taps")
    assert torch.equal(tops.cross_aggregate(*args), taps)
    prefix = tops.cross_aggregate(*args, impl="prefix")
    want = jops.cross_aggregate(jnp.asarray(cost), jnp.asarray(al),
                                jnp.asarray(ar), arm_len=L, impl="prefix")
    np.testing.assert_allclose(n(prefix), np.asarray(want), **PREFIX_TOL)
    np.testing.assert_allclose(n(prefix), n(taps), **PREFIX_TOL)
    with pytest.raises(ValueError, match="pallas"):
        tops.cross_aggregate(*args, impl="pallas")
    with pytest.raises(ValueError, match="oii_impl"):
        tops.cross_aggregate(*args, impl="cumsum")


# --- K8: histogram vote -----------------------------------------------------

def _vote_case(rng, H, W, d_max, L, lo=0):
    left = rng.random((H, W, 3), dtype=np.float32)
    arms = np.asarray(jops.cross_arms(jnp.asarray(left), L, 0.35))
    d = rng.integers(lo, d_max + 1, size=(H, W)).astype(np.float32)
    img = np.asarray(jops.unorm8(jnp.asarray(d / np.float32(d_max))))
    return img, arms


def _modes(img, d_max):
    return np.round(n(img) * d_max).astype(np.int32)


@pytest.mark.parametrize("H,W,d_max,L,lo", [
    (24, 20, 7, 3, 0), (16, 40, 4, 4, 0), (40, 33, 6, 2, 0),
    (24, 40, 300, 3, 250),          # bins above 256
    (16, 1300, 4, 3, 0)],           # the TPU kernel's column-chunked width
    ids=["24x20", "16x40", "40x33", "d_max300", "wide"])
def test_histogram_vote_equal_to_pallas(H, W, d_max, L, lo):
    img, arms = _vote_case(np.random.default_rng(W + d_max), H, W, d_max, L, lo)
    want = histogram_vote_pallas(jnp.asarray(img), jnp.asarray(arms), d_max,
                                 quantize=False, arm_len=L, interpret=True)
    for impl in ("taps", "prefix"):
        got = tops.histogram_vote(t(img), t(arms), d_max, quantize=False,
                                  arm_len=L, impl=impl)
        np.testing.assert_array_equal(_modes(got, d_max), _modes(want, d_max),
                                      err_msg=impl)
        got_q = tops.histogram_vote(t(img), t(arms), d_max, arm_len=L,
                                    impl=impl)
        np.testing.assert_array_equal(n(got_q), np.asarray(jops.histogram_vote(
            jnp.asarray(img), jnp.asarray(arms), d_max, arm_len=L, impl=impl)))


def test_vote_counts_and_mode_equal_jax_taps():
    """The two halves of K8 on their own: the uint8 row counts equal JAX's
    int32 counts, and the mode equals JAX's argmax with ties to the
    highest d (the indicator is sparse, so ties are common)."""
    d_max, L = 9, 4
    img, arms = _vote_case(np.random.default_rng(8), 20, 31, d_max, L)
    idx = tops.vote_indices(t(img), d_max)
    jidx = jvote.vote_indices(jnp.asarray(img), d_max)
    np.testing.assert_array_equal(n(idx), np.asarray(jidx))
    ind = (jidx[None] == jnp.arange(d_max + 1)[:, None, None]).astype(jnp.int32)
    ja = jnp.asarray(arms)
    want_rc = jvote._clamped_window_taps(ind, ja[0][None], ja[1][None], L, 2)
    rc = vote_h(idx, t(arms), d_max + 1, L)
    assert rc.dtype == torch.uint8
    np.testing.assert_array_equal(n(rc), np.asarray(want_rc))
    tab = jvote._clamped_window_taps(want_rc, ja[2][None], ja[3][None], L, 1)
    want_mode = d_max - jnp.argmax(tab[::-1], axis=0)
    np.testing.assert_array_equal(n(vote_v(rc, t(arms), L)), np.asarray(want_mode))


# --- WTA argmin -------------------------------------------------------------

def test_wta_argmin_ties_to_the_lowest_d():
    rng = np.random.default_rng(12)
    cost = rng.integers(0, 3, (9, 10, 21)).astype(np.float32)   # many ties
    got = tops.wta_argmin(t(cost))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(n(got),
                                  np.asarray(jops.wta_argmin(jnp.asarray(cost))))
    tie = torch.tensor([[[2.0]], [[1.0]], [[1.0]], [[3.0]]])
    assert float(tops.wta_argmin(tie)) == 1.0


# --- wrappers on the CPU ----------------------------------------------------

def test_cpu_wrappers_launch_nothing_and_refuse_bad_input():
    kernels.reset_launches()
    L = 3
    left, right, cost, al, ar = _case(np.random.default_rng(6), 12, 17, 5, L)
    cross_arms(t(left), L, 0.35)
    sad_volume(t(left), t(right), 5)
    temp = oii_pass(t(cost), t(al), t(ar), L, 2)
    idx = torch.zeros((12, 17), dtype=torch.int32)
    vote_v(vote_h(idx, t(al), 5, L), t(al), L)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    with pytest.raises(ValueError):
        oii_pass(temp, t(al), t(ar), L, 0)
    with pytest.raises(TypeError):
        oii_pass(temp, t(al).long(), t(ar), L, 1)
    with pytest.raises(ValueError):
        oii_pass(temp, t(al)[:, :-1], t(ar), L, 1)
    with pytest.raises(TypeError):
        cross_arms(t(left).double(), L, 0.35)
    with pytest.raises(ValueError):
        sad_volume(t(left), t(right)[:-1], 5)
    with pytest.raises(ValueError, match="arm_len"):
        vote_h(idx, t(al), 5, 128)
    with pytest.raises(TypeError):
        vote_v(torch.zeros((5, 12, 17), dtype=torch.int32), t(al), L)
