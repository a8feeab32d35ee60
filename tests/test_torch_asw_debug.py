"""The port's debug and batched ASW entries (models/asw.py
asw_pipeline_debug, asw_pipeline_batched) on the CPU: the debug captures
against the JAX package's asw_pipeline_debug with the JAX weights carried
across (convert.weights_from_jax), integer codes and red masks bit for bit;
the debug result and the batched frames against the port's own pipeline,
bit for bit."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_matchin_tpu.eval import synthetic_scene
from stereo_matchin_tpu.models import asw as jasw
from stereo_matchin_tpu_torch import ops as tops
from stereo_matchin_tpu_torch.convert import weights_from_jax
from stereo_matchin_tpu_torch.models import asw as tasw

from .test_torch_pipeline_asw import jax_strips
from .torch_support import TINY, config_pair, n, t

STACKS = ("raw_wta_left", "raw_wta_right", "aggr_wta_left", "aggr_wta_right",
          "refine_wta_left", "refine_wta_right")
REDS = ("consistency_red_pre", "refine_reds")


def codes(img) -> np.ndarray:
    return n(tops.unorm8_code(torch.as_tensor(np.array(img))))


def red_mask(img) -> np.ndarray:
    r = np.asarray(n(img))
    return (r[..., 0] == 1.0) & (r[..., 1] == 0.0) & (r[..., 2] == 0.0)


def _scene(seed, H, W, d_max):
    left, right, _, _ = synthetic_scene(np.random.default_rng(seed), H, W,
                                        d_max)
    return left.astype(np.float32), right.astype(np.float32)


@pytest.mark.parametrize("kw", [{}, dict(k_iters=0),
                                dict(r_iters=3, k_iters=1,
                                     wta_ref_conf_bug=False)],
                         ids=["tiny", "no_refinement", "r3_k1_conf_fixed"])
def test_debug_codes_equal_jax_on_jax_weights(kw):
    jcfg, cfg = config_pair(**{**TINY, **kw})
    left, right = _scene(5, 48, 64, cfg.d_max)
    want = jasw.asw_pipeline_debug(jnp.asarray(left), jnp.asarray(right),
                                   jcfg)
    got = tasw.asw_pipeline_debug_from_weights(
        t(left), t(right), weights_from_jax(jax_strips(left, right, jcfg)),
        cfg)
    H, W, r, k = 48, 64, cfg.r_iters, cfg.k_iters
    assert got.aggr_wta_left.shape == (r, H, W)
    assert got.refine_wta_right.shape == (k, H, W)
    assert got.refine_reds.shape == (k, H, W, 3)
    for f in STACKS:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.shape == w.shape, f
        np.testing.assert_array_equal(codes(g), codes(w), err_msg=f)
    for f in REDS:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.shape == w.shape, f
        np.testing.assert_array_equal(red_mask(g), red_mask(w), err_msg=f)
    for f in ("disparity", "filled", "wta_left", "wta_right"):
        np.testing.assert_array_equal(codes(getattr(got.result, f)),
                                      codes(getattr(want.result, f)),
                                      err_msg=f)
    for f in ("consistency_pre", "consistency_post"):
        np.testing.assert_array_equal(red_mask(getattr(got.result, f)),
                                      red_mask(getattr(want.result, f)),
                                      err_msg=f)


@pytest.mark.parametrize("kw", [{}, dict(k_iters=0, aggr_d_chunks=2),
                                dict(r_iters=0)],
                         ids=["tiny", "no_refinement_d_chunks", "no_rounds"])
def test_debug_result_is_the_pipeline(kw):
    """`result` is asw_pipeline's, bit for bit (aggr_d_chunks changes no
    value); the last round's WTA map is the pipeline's wta_left and the
    last refinement's red map its consistency_post."""
    _, cfg = config_pair(**{**TINY, **kw})
    left, right = (t(a) for a in _scene(7, 32, 48, cfg.d_max))
    dbg = tasw.asw_pipeline_debug(left, right, cfg)
    want = tasw.asw_pipeline(left, right, cfg)
    for f in want._fields:
        assert torch.equal(getattr(dbg.result, f), getattr(want, f)), f
    if cfg.r_iters:
        assert torch.equal(dbg.aggr_wta_left[-1], want.wta_left)
        assert torch.equal(dbg.aggr_wta_right[-1], want.wta_right)
    else:
        assert torch.equal(dbg.raw_wta_left, want.wta_left)
    assert torch.equal(dbg.consistency_red_pre, want.consistency_pre)
    if cfg.k_iters:
        assert torch.equal(dbg.refine_reds[-1], want.consistency_post)


def test_batched_equals_single_frames():
    _, cfg = config_pair(**TINY)
    frames = [_scene(s, 32, 40, cfg.d_max) for s in (1, 2)]
    left = torch.stack([t(f[0]) for f in frames])
    right = torch.stack([t(f[1]) for f in frames])
    got = tasw.asw_pipeline_batched(left, right, cfg)
    for b, (l, r) in enumerate(frames):
        want = tasw.asw_pipeline(t(l), t(r), cfg)
        for f in want._fields:
            g = getattr(got, f)
            assert g.shape[0] == 2, f
            assert torch.equal(g[b], getattr(want, f)), (b, f)
    with pytest.raises(ValueError, match="batches"):
        tasw.asw_pipeline_batched(left[0], right[0], cfg)
