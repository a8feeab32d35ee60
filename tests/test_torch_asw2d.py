"""The port's non-separable 2-D ASW aggregation (ops/asw2d.py) against the
JAX package's on the CPU, on the same numpy inputs.

Tolerances, and why:
  * against eager JAX: bit-equal.  Both sides round every operation once,
    in the same order (num_v over i; num_h and den_h i-major, j-minor; the
    product (wwh * wwv) * c_2d; num_v / T + num_h / den_h), and eager JAX
    fuses nothing, so no multiply-add is contracted.
  * against the numpy oracle (tests/oracle.py, a per-pixel loop that sums
    in another order): rtol = atol = 1e-3, the JAX package's own test's
    bound (tests/test_ops_vs_oracle.py test_asw_aggregate_2d).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from stereo_matchin_tpu.ops.asw2d import asw_aggregate_2d as jax_asw2d
from stereo_matchin_tpu_torch import ops as tops

from . import oracle
from .torch_support import max_ulp, n, t, unorm8_pair

GAMMA_C, GAMMA_P = 30.91, 28.21


def _inputs(seed, H, W, D, radius):
    """(cost, wv_l, wv_r, wh_l, wh_r) as numpy arrays: the SAD volume and
    the support strips of a seeded UNORM8 pair, made by the port's ops."""
    left, right = unorm8_pair(np.random.default_rng(seed), H, W)
    cost = n(tops.sad_cost_volume(t(left), t(right), D, 255.0))
    strips = [n(tops.support_weights(t(img), radius, GAMMA_C, GAMMA_P, axis))
              for axis in (0, 1) for img in (left, right)]
    return (cost, *strips)


# (seed, H, W, D, radius): D >= W / 2, so the clamp max(x - d, 0) reads
# column 0 on most columns; a radius past half the rows (every tap of the
# middle rows clamps at one edge or the other); a wide frame with few
# planes.
CASES = [(0, 12, 16, 9, 3), (1, 9, 14, 10, 5), (2, 20, 24, 5, 4),
         (3, 7, 10, 6, 3)]


@pytest.mark.parametrize("seed,H,W,D,radius", CASES)
def test_bit_equal_to_eager_jax(seed, H, W, D, radius):
    args = _inputs(seed, H, W, D, radius)
    want = np.asarray(jax_asw2d(*(jnp.asarray(a) for a in args), radius))
    got = tops.asw_aggregate_2d(*(t(a) for a in args), radius)
    assert got.shape == (D, H, W) and got.dtype == t(args[0]).dtype
    assert max_ulp(got, want) == 0


def test_within_the_oracle_bound():
    rng = np.random.default_rng(11)
    left, right = unorm8_pair(rng, 11, 13)
    D, R = 6, 3
    cost = oracle.sad_cost_volume(left, right, D, 255.0)
    strips = [oracle.support_weights(img, R, GAMMA_C, GAMMA_P, axis)
              for axis in (0, 1) for img in (left, right)]
    want = oracle.asw_aggregate_2d(cost, *strips, R)
    got = n(tops.asw_aggregate_2d(t(cost), *(t(s) for s in strips), R))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
