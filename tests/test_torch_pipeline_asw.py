"""The port's ASW slice end to end against the JAX package's asw_pipeline,
on the CPU, and the committed reference fixture.

The JAX support weights are carried into the port (convert.weights_from_
jax) so that both sides start from the same state; the weights are the
one input the two sides cannot compute bit-equal (`exp`, see
tests/test_torch_ops.py).  Then every integer map — disparity, filled and
WTA codes, the two red masks — must be bit-equal.  Measured at
REFERENCE_CONFIG on the 288x384 fixture pair: bit-equal, and 100% of the
disparity codes also agree when the port computes its own weights.

The aggregated volume is held to a stated bound only: jitted, XLA:CPU
contracts |l*255 - r*255| and the aggregation sums into fused
multiply-adds (see test_torch_ops.py), leaving residuals up to 3e-5 where
the port's cost is exactly 0, which the 14 weighted-mean passes carry,
plus a few ulp of sum drift (measured: 2.8e-4 absolute, 1.6e-5 relative
above 1), so atol 1e-3, rtol 1e-4.
"""

from __future__ import annotations

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_matchin_tpu import REFERENCE_CONFIG, TINY_CONFIG
from stereo_matchin_tpu import ops as jops
from stereo_matchin_tpu.eval import synthetic_scene
from stereo_matchin_tpu.models import asw as jasw
from stereo_matchin_tpu_torch import ops as tops
from stereo_matchin_tpu_torch.convert import weights_from_jax
from stereo_matchin_tpu_torch.models import asw as tasw

from .torch_support import n, t

DATA = pathlib.Path(__file__).resolve().parent / "data"
MAPS = ("disparity", "filled", "wta_left", "wta_right")
VOLUME_TOL = dict(rtol=1e-4, atol=1e-3)


def _load_generator():
    spec = importlib.util.spec_from_file_location(
        "gen_asw_torch_fixture", DATA / "gen_asw_torch_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


gen = _load_generator()


def jax_strips(left: np.ndarray, right: np.ndarray, cfg) -> dict:
    """The eight weight strips from the JAX package, jitted as the
    pipeline computes them."""
    R = cfg.radius

    @jax.jit
    def strips(l, r):
        out = {}
        for side, img in (("l", l), ("r", r)):
            out["wv_" + side] = jops.support_weights(img, R, cfg.gamma_c,
                                                     cfg.gamma_p, axis=0)
            out["wh_" + side] = jops.support_weights(img, R, cfg.gamma_c,
                                                     cfg.gamma_p, axis=1)
            out["rv_" + side], out["rh_" + side] = jops.refinement_weights(
                img, R, cfg.ref_gamma_c, cfg.ref_gamma_p)
        return out

    return {k: np.asarray(v) for k, v in
            strips(jnp.asarray(left), jnp.asarray(right)).items()}


def red_mask(img) -> np.ndarray:
    return gen.red_mask(n(img))


def codes(img) -> np.ndarray:
    return n(tops.unorm8_code(img)).astype(np.uint8)


def assert_maps_equal(got, want: dict):
    """Integer maps of a port ASWResult against code/mask arrays."""
    for f in MAPS:
        diff = int((codes(getattr(got, f)) != want[f]).sum())
        assert diff == 0, f"{f}: {diff} pixels differ from JAX"
    for f, key in (("consistency_pre", "red_pre"),
                   ("consistency_post", "red_post")):
        diff = int((red_mask(getattr(got, f)) != want[key]).sum())
        assert diff == 0, f"{f}: {diff} red-mask pixels differ from JAX"


@pytest.fixture(scope="module")
def fixture():
    with np.load(gen.FIXTURE) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def jax_reference(fixture):
    """JAX asw_pipeline at REFERENCE_CONFIG on the fixture pair (one run,
    shared by the module) and its weight strips."""
    left, right = gen.from_codes(fixture["left"]), gen.from_codes(fixture["right"])
    return gen.run_jax(fixture["left"], fixture["right"]), jax_strips(
        left, right, REFERENCE_CONFIG)


def test_fixture_regenerates_bit_equal(fixture, jax_reference):
    """tests/data/gen_asw_torch_fixture.py reproduces the committed file."""
    lc, rc = gen.scene_codes()
    regen = gen.fixture_from_result(lc, rc, jax_reference[0])
    assert sorted(regen) == sorted(fixture)
    for k in fixture:
        np.testing.assert_array_equal(regen[k], fixture[k], err_msg=k)
    assert gen.FIXTURE.stat().st_size < 1 << 20


def test_reference_config_bit_equal_on_jax_weights(fixture, jax_reference):
    res, strips = jax_reference
    left = t(gen.from_codes(fixture["left"]))
    right = t(gen.from_codes(fixture["right"]))
    got = tasw.asw_pipeline_from_weights(left, right, weights_from_jax(strips),
                                         REFERENCE_CONFIG)
    assert_maps_equal(got, fixture)
    assert got.disparity.shape == (288, 384)
    assert got.aggregated_cost.shape == (61, 288, 384)
    np.testing.assert_allclose(n(got.aggregated_cost), res.aggregated_cost,
                               **VOLUME_TOL)


def test_reference_config_agreement_on_own_weights(fixture):
    """Without injection the weights differ by a few ulp; the bar here (and
    in chip_smoke.py) is 99.5% equal disparity codes."""
    left = t(gen.from_codes(fixture["left"]))
    right = t(gen.from_codes(fixture["right"]))
    got = tasw.asw_pipeline(left, right, REFERENCE_CONFIG)
    agree = {f: float((codes(getattr(got, f)) == fixture[f]).mean())
             for f in MAPS}
    print(f"own-weight agreement with JAX at REFERENCE_CONFIG: {agree}")
    assert agree["disparity"] >= 0.995, agree


@pytest.mark.parametrize("cfg", [
    TINY_CONFIG,
    TINY_CONFIG.replace(wta_ref_conf_bug=False),
    TINY_CONFIG.replace(quantize_maps=False),
    TINY_CONFIG.replace(k_iters=0),
], ids=["tiny", "conf_bug_fixed", "unquantized", "no_refinement"])
def test_tiny_config_bit_equal_on_jax_weights(cfg):
    left, right, _, _ = synthetic_scene(np.random.default_rng(5), 48, 64,
                                        cfg.d_max)
    left, right = left.astype(np.float32), right.astype(np.float32)
    want = jasw.asw_pipeline(jnp.asarray(left), jnp.asarray(right), cfg)
    got = tasw.asw_pipeline_from_weights(
        t(left), t(right), weights_from_jax(jax_strips(left, right, cfg)), cfg)
    for f in MAPS + ("consistency_pre", "consistency_post"):
        g, w = n(getattr(got, f)), np.asarray(getattr(want, f))
        if not cfg.quantize_maps:
            # Raw rescales d * fl(1/d_max): jitted XLA folds the following
            # `* d_max` into that constant (ops/common.py to_unit), so JAX
            # itself is only 1-ulp stable here; the maps are integer
            # disparities, compared as such.
            g, w = np.rint(g * cfg.d_max), np.rint(w * cfg.d_max)
        np.testing.assert_array_equal(g, w, err_msg=f)
    np.testing.assert_allclose(n(got.aggregated_cost),
                               np.asarray(want.aggregated_cost), **VOLUME_TOL)


def test_cpu_routes_agree_and_unported_options_raise():
    cfg = TINY_CONFIG
    left, right, _, _ = synthetic_scene(np.random.default_rng(6), 24, 32,
                                        cfg.d_max)
    left, right = t(left.astype(np.float32)), t(right.astype(np.float32))
    auto = tasw.asw_pipeline(left, right, cfg)
    plain = tasw.asw_pipeline(left, right, cfg.replace(kernels="jnp"))
    for a, b in zip(auto, plain):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="pallas"):
        tasw.asw_pipeline(left, right, cfg.replace(kernels="pallas"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tasw.asw_pipeline(left, right, cfg.replace(aggr_d_chunks=2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tasw.asw_pipeline(left, right, cfg, crop=(2, 2))


def test_weights_from_jax_validates():
    strips = {k: np.zeros((5, 4, 6), np.float32)
              for k in tasw.ASWWeights._fields}
    w = weights_from_jax(strips)
    assert w.wv_l.shape == (5, 4, 6) and w.rh_r.device.type == "cpu"
    with pytest.raises(KeyError):
        weights_from_jax({k: v for k, v in strips.items() if k != "rv_l"})
    with pytest.raises(ValueError):
        weights_from_jax({**strips, "wh_r": np.zeros((5, 4, 6), np.float64)})
    with pytest.raises(ValueError):
        weights_from_jax({**strips, "wh_r": np.zeros((3, 4, 6), np.float32)})
