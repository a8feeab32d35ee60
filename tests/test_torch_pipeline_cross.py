"""The port's cross-based slice end to end against the JAX package's
cross_pipeline, on the CPU, and the committed reference fixture.

The JAX side runs with oii_impl="taps", the sum order of the port's CPU
route and kernels (on the CPU JAX's own default is "prefix", another
float order).  No input crosses between the two sides but the numpy
images: the cross method has no weights, and its integer arm planes are
compared bit for bit in tests/test_torch_ops_cross.py.  The maps and the
median-filtered image must be bit-equal: nothing on this path is
multiplied, so XLA:CPU has no fused multiply-add to contract.
"""

from __future__ import annotations

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_matchin_tpu.eval import synthetic_scene
from stereo_matchin_tpu.models import cross_based as jcross
from stereo_matchin_tpu_torch import REFERENCE_CONFIG, TINY_CONFIG
from stereo_matchin_tpu_torch.models import cross_based as tcross

from .torch_support import TINY, config_pair, n, t

DATA = pathlib.Path(__file__).resolve().parent / "data"
TAPS = dict(oii_impl="taps")


def _load_generator():
    spec = importlib.util.spec_from_file_location(
        "gen_cross_torch_fixture", DATA / "gen_cross_torch_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


gen = _load_generator()


@pytest.fixture(scope="module")
def pair():
    with np.load(gen.asw_gen.FIXTURE) as f:
        return f["left"], f["right"]


@pytest.fixture(scope="module")
def jax_reference(pair):
    """JAX cross_pipeline at REFERENCE_CONFIG (taps) on the fixture pair,
    one run shared by the module."""
    return gen.run_jax(*pair)


def test_fixture_regenerates_bit_equal(jax_reference):
    """tests/data/gen_cross_torch_fixture.py reproduces the committed file."""
    with np.load(gen.FIXTURE) as f:
        committed = {k: f[k] for k in f.files}
    regen = gen.fixture_from_result(jax_reference)
    assert sorted(regen) == sorted(committed) == sorted(gen.FIELDS)
    for k in committed:
        np.testing.assert_array_equal(regen[k], committed[k], err_msg=k)
    assert gen.FIXTURE.stat().st_size < 1 << 20


def test_reference_config_bit_equal_to_jax(pair, jax_reference):
    left, right = (t(gen.asw_gen.from_codes(c)) for c in pair)
    got = tcross.cross_pipeline(left, right, REFERENCE_CONFIG.replace(**TAPS))
    assert got.initial.shape == got.final.shape == (288, 384)
    assert got.median_left.shape == (288, 384, 3)
    for f in gen.FIELDS:
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      getattr(jax_reference, f), err_msg=f)


@pytest.mark.parametrize("kw", [
    {}, dict(median_dispatch_quirk=True), dict(legacy_cross_arm_quirk=False),
    dict(quantize_maps=False),
], ids=["tiny", "median_quirk", "arm_quirk_off", "unquantized"])
def test_tiny_config_bit_equal_to_jax(kw):
    """40x70: neither side divides by 3, so the median quirk zeroes a row
    and a column."""
    jcfg, cfg = config_pair(**TINY, **kw, **TAPS)
    left, right, _, _ = synthetic_scene(np.random.default_rng(5), 40, 70,
                                        cfg.d_max)
    left, right = left.astype(np.float32), right.astype(np.float32)
    want = jcross.cross_pipeline(jnp.asarray(left), jnp.asarray(right), jcfg)
    got = tcross.cross_pipeline(t(left), t(right), cfg)
    for f in gen.FIELDS:
        g, w = n(getattr(got, f)), np.asarray(getattr(want, f))
        if not cfg.quantize_maps and f != "median_left":
            # Raw rescales d * fl(1/d_max): jitted XLA may fold constants
            # around them (see test_torch_pipeline_asw.py); the maps are
            # integer disparities, compared as such.
            g, w = np.rint(g * cfg.d_max), np.rint(w * cfg.d_max)
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_cpu_routes():
    """On the CPU "auto" is "taps"; "prefix" runs (another float order, so
    argmin ties may move: not compared bit for bit); "pallas" demands the
    CUDA kernels."""
    cfg = TINY_CONFIG
    left, right, _, _ = synthetic_scene(np.random.default_rng(6), 24, 32,
                                        cfg.d_max)
    left, right = t(left.astype(np.float32)), t(right.astype(np.float32))
    auto = tcross.cross_pipeline(left, right, cfg)
    taps = tcross.cross_pipeline(left, right, cfg.replace(**TAPS))
    for a, b in zip(auto, taps):
        assert torch.equal(a, b)
    prefix = tcross.cross_pipeline(left, right, cfg.replace(oii_impl="prefix"))
    assert float((prefix.initial == taps.initial).float().mean()) > 0.95
    with pytest.raises(ValueError, match="pallas"):
        tcross.cross_pipeline(left, right, cfg.replace(oii_impl="pallas"))
    with pytest.raises(ValueError):
        tcross.cross_pipeline(left, right[:, :-1], cfg)
