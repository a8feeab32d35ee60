"""Kernels K1 (asw_den) and K2 (asw_pass) of the port: their plain
versions, which the wrappers take for CPU tensors, against the JAX
package's aggregation (the Pallas kernels in interpret mode and the jnp
ops).  The CUDA kernels are held to the plain versions on the card in
tests/test_torch_cuda.py.

Tolerances: against eager `ops.asw_aggregate_pass` bit-equal (both round
every product and sum once, in tap order).  Against the Pallas kernels,
which run jitted, the repository's 1-ulp FMA rule
(tests/test_kernels_dres.py): XLA:CPU may contract num + w*c into one
fused multiply-add, so rtol 3e-6, atol 1e-6.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from stereo_matchin_tpu import ops as jops
from stereo_matchin_tpu.kernels.asw_aggregation import (asw_den_pallas,
                                                        asw_hpass_pallas,
                                                        asw_vpass_pallas)
from stereo_matchin_tpu.kernels.asw_aggregation_dres import (asw_den_dres,
                                                             asw_hpass_dres,
                                                             asw_vpass_dres)
from stereo_matchin_tpu_torch import kernels
from stereo_matchin_tpu_torch import ops as tops
from stereo_matchin_tpu_torch.kernels.asw_aggregation import asw_den, asw_pass
from stereo_matchin_tpu_torch.ops import asw_den_plain, asw_pass_plain

from .torch_support import max_ulp, n, t, unorm8_pair

H, W, R, EPS = 64, 90, 4, 1e-5      # W: no multiple of any block size
FMA = dict(rtol=3e-6, atol=1e-6)


def _tr(x):
    return jnp.swapaxes(jnp.asarray(x), 1, 2)


@pytest.fixture(scope="module")
def strips():
    left, right = unorm8_pair(np.random.default_rng(11), H, W)
    jl, jr = jnp.asarray(left), jnp.asarray(right)
    out = {"left": left, "right": right}
    for name, img, axis in (("wv_l", jl, 0), ("wv_r", jr, 0),
                            ("wh_l", jl, 1), ("wh_r", jr, 1)):
        out[name] = np.asarray(jops.support_weights(img, R, 30.91, 28.21, axis))
    return out


def _cost(s, D):
    return np.asarray(jops.sad_cost_volume(jnp.asarray(s["left"]),
                                           jnp.asarray(s["right"]), D, 255.0))


@pytest.mark.parametrize("D", [7, 9, 17])
@pytest.mark.parametrize("axis", [1, 2])
def test_plain_pass_bit_equal_to_eager_jax_ops(strips, D, axis):
    wl, wr = (strips["wv_l"], strips["wv_r"]) if axis == 1 else \
        (strips["wh_l"], strips["wh_r"])
    cost = _cost(strips, D)
    want_out, want_den = jops.asw_aggregate_pass(
        jnp.asarray(cost), jnp.asarray(wl), jnp.asarray(wr), axis=axis,
        radius=R)
    den = asw_den(t(wl), t(wr), EPS, 0, D)
    out = asw_pass(t(cost), t(wl), t(wr), den, EPS, axis)
    assert max_ulp(den, want_den) == 0
    assert max_ulp(out, want_out) == 0


@pytest.mark.parametrize("D", [7, 9, 17])
def test_plain_den_and_passes_match_dres_kernels(strips, D):
    """D = 9 and 17 are the D = 1 (mod 8) shapes whose tail group once read
    out of bounds in the TPU kernels."""
    cost = _cost(strips, D)
    for (wl, wr), pallas_pass, axis in (
            ((strips["wv_l"], strips["wv_r"]), asw_vpass_dres, 1),
            ((strips["wh_l"], strips["wh_r"]), asw_hpass_dres, 2)):
        den = asw_den(t(wl), t(wr), EPS, 0, D)
        want_den = asw_den_dres(_tr(wl), _tr(wr), R, interpret=True,
                                num_disp=D)
        np.testing.assert_allclose(n(den), np.asarray(_tr(want_den)), **FMA)
        got = asw_pass(t(cost), t(wl), t(wr), den, EPS, axis)
        want = pallas_pass(_tr(cost), _tr(wl), _tr(wr), R, interpret=True)
        np.testing.assert_allclose(n(got), np.asarray(_tr(want)), **FMA)


@pytest.mark.parametrize("d0", [3, 8])
def test_plain_versions_with_d0_match_grid_kernels(strips, d0):
    """A disparity chunk at offset d0 (not a multiple of 8 on the GPU)."""
    D = 9
    full = _cost(strips, d0 + D)
    cost = np.ascontiguousarray(full[d0:])
    wl, wr = strips["wv_l"], strips["wv_r"]
    den = asw_den(t(wl), t(wr), EPS, d0, D)
    want_den = asw_den_pallas(jnp.asarray(wl), jnp.asarray(wr), R, EPS,
                              interpret=True, d0=d0, num_disp=D,
                              max_shift=d0 + D - 1)
    np.testing.assert_allclose(n(den), np.asarray(want_den), **FMA)
    # the chunk's planes equal the same planes of the whole volume
    whole = asw_den_plain(t(wl), t(wr), EPS, 0, d0 + D)
    assert max_ulp(den, whole[d0:]) == 0
    got = asw_pass(t(cost), t(wl), t(wr), den, EPS, 1, d0)
    want = asw_vpass_pallas(jnp.asarray(cost), jnp.asarray(wl),
                            jnp.asarray(wr), R, EPS, interpret=True, d0=d0,
                            den=want_den, max_shift=d0 + D - 1)
    np.testing.assert_allclose(n(got), np.asarray(want), **FMA)
    hl, hr = strips["wh_l"], strips["wh_r"]
    den_h = asw_den(t(hl), t(hr), EPS, d0, D)
    got = asw_pass(t(cost), t(hl), t(hr), den_h, EPS, 2, d0)
    want = asw_hpass_pallas(jnp.asarray(cost), jnp.asarray(hl),
                            jnp.asarray(hr), R, EPS, interpret=True, d0=d0,
                            max_shift=d0 + D - 1)
    np.testing.assert_allclose(n(got), np.asarray(want), **FMA)


def test_cpu_tensors_take_the_plain_route_and_launch_nothing(strips):
    kernels.reset_launches()
    wl, wr = t(strips["wv_l"]), t(strips["wv_r"])
    den = asw_den(wl, wr, EPS, 0, 5)
    assert max_ulp(den, asw_den_plain(wl, wr, EPS, 0, 5)) == 0
    cost = t(_cost(strips, 5))
    out = asw_pass(cost, wl, wr, den, EPS, 2)
    assert max_ulp(out, asw_pass_plain(cost, wl, wr, den, EPS, 2)) == 0
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_wrappers_refuse_what_the_kernels_do_not_take(strips):
    wl, wr = t(strips["wv_l"]), t(strips["wv_r"])
    cost = t(_cost(strips, 5))
    den = asw_den(wl, wr, EPS, 0, 5)
    with pytest.raises(TypeError):
        asw_den(wl.double(), wr.double(), EPS, 0, 5)
    with pytest.raises(ValueError):
        asw_den(wl[:-1], wr[:-1], EPS, 0, 5)            # even tap count
    with pytest.raises(ValueError):
        asw_den(wl, wr, EPS, -1, 5)
    with pytest.raises(ValueError):
        asw_pass(cost, wl, wr, den, EPS, 0)
    with pytest.raises(ValueError):
        asw_pass(cost[:, :-1], wl, wr, den, EPS, 1)
    with pytest.raises(ValueError, match="pallas"):
        tops.asw_aggregate(cost, wl, wr, wl, wr, R, 1, EPS, kernels="pallas")


def test_aggregate_routes(strips):
    """asw_aggregate gives the same bits through every route a CPU tensor
    can take, and equals the JAX jnp path within the FMA drift of four
    passes (rtol 1e-5)."""
    D = 7
    cost = _cost(strips, D)
    ws = [strips[k] for k in ("wv_l", "wv_r", "wh_l", "wh_r")]
    auto = tops.asw_aggregate(t(cost), *map(t, ws), R, 2, EPS)
    plain = tops.asw_aggregate(t(cost), *map(t, ws), R, 2, EPS, kernels="jnp")
    assert max_ulp(auto, plain) == 0
    want = jops.asw_aggregate(jnp.asarray(cost), *map(jnp.asarray, ws), R, 2,
                              EPS)
    np.testing.assert_allclose(n(auto), np.asarray(want), rtol=1e-5, atol=1e-5)

