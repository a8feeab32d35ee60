"""The routes of K6 on the ASW SAD cost, K11 (the WTA epilogue) and K12
(the median) on the CPU, and chip_smoke.py's launch tables for them.

`ops.sad_cost` (the ASW paths' SAD cost) stays the plain op on CPU tensors
at scale 255 and d0 > 0, equal to the JAX package's shard cost.  The
`counted` fixture routes "auto" to the kernel wrappers on CPU tensors
(which run their plain versions there) and counts each K6, K11 and K12
wrapper call where a card would launch it, so that the launch tables the
smoke asserts on the card (`expected_asw_launches`,
`expected_cross_launches`, `sharded_launches`) are held here against a
frame's calls on each route.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from stereo_matchin_tpu.parallel.ops_tiled import sad_cost_volume_shard
from stereo_matchin_tpu_torch import kernels
from stereo_matchin_tpu_torch import ops as tops
from stereo_matchin_tpu_torch.config import StereoConfig
from stereo_matchin_tpu_torch.kernels import median as km
from stereo_matchin_tpu_torch.kernels import sad_volume as ks
from stereo_matchin_tpu_torch.kernels import wta_gather as kw
from stereo_matchin_tpu_torch.models import asw, cross_based, tiled
from stereo_matchin_tpu_torch.parallel import (asw_sharded, cross_sharded,
                                               ops_tiled)
from stereo_matchin_tpu_torch.utils import call_stage

from .torch_support import n, t, unorm8_pair

CFG = StereoConfig(d_max=11, radius=2, arm_len=4, r_iters=2, k_iters=2)
KEYS = ("sad_volume", "wta_merge", "median3x3")


@pytest.mark.parametrize("D,d0", [(12, 0), (5, 7), (3, 40)])
def test_asw_sad_route_is_the_plain_op_on_the_cpu(D, d0):
    """Scale 255 and d0 > 0 (a disparity chunk, a disp shard, d0 past the
    width): "auto" and "jnp" give the plain op's values, which equal the
    JAX package's shard cost; "pallas" raises; nothing is counted."""
    rng = np.random.default_rng(D + d0)
    left, right = unorm8_pair(rng, 9, 30)
    want = tops.sad_cost_volume(t(left), t(right), D, 255.0, d0)
    jax = sad_cost_volume_shard(jnp.asarray(left), jnp.asarray(right), d0, D,
                                d0 + D, scale=255.0)
    np.testing.assert_array_equal(n(want), np.asarray(jax))
    before = dict(kernels.LAUNCHES)
    for mode in ("auto", "jnp"):
        got = tops.sad_cost(t(left), t(right), D, 255.0, d0, mode)
        assert torch.equal(got, want)
    assert torch.equal(ks.sad_volume(t(left), t(right), D, 255.0, d0), want)
    with pytest.raises(ValueError):
        tops.sad_cost(t(left), t(right), D, 255.0, d0, "pallas")
    assert kernels.LAUNCHES == before


@pytest.fixture
def counted(monkeypatch):
    """A card's routing on CPU tensors: "auto" takes the kernel wrappers,
    which run their plain versions on the CPU, and each K6, K11 and K12
    wrapper call is counted in kernels.LAUNCHES where the card would
    launch it."""
    monkeypatch.setattr(kernels, "use_kernels", lambda mode, x: mode != "jnp")

    def counting(module, name, key):
        fn = getattr(module, name)

        def call(*args, **kw):
            kernels.LAUNCHES[key] += 1
            return fn(*args, **kw)
        monkeypatch.setattr(module, name, call)

    counting(ks, "sad_volume", "sad_volume")
    counting(kw, "wta_merge", "wta_merge")
    counting(km, "median3x3", "median3x3")
    kernels.reset_launches()
    yield
    kernels.reset_launches()


def _counts(keys=KEYS):
    return {k: kernels.LAUNCHES[k] for k in keys}


def _want(table, keys=KEYS):
    return {k: table[k] for k in keys}


@pytest.mark.parametrize("route,bands,chunks", [
    ("whole", 1, 0), ("whole", 1, 3), ("wavefront", 2, 0),
    ("wavefront", 3, 2), ("halo", 2, 2), ("halo", 3, 0)])
def test_asw_launch_table(counted, route, bands, chunks):
    """expected_asw_launches' K6, K11 and K12 entries equal the wrapper
    calls of one frame on each route (K6 once per chunk and band), and the
    frame equals the plain ops' frame."""
    cfg = CFG.replace(aggr_d_chunks=chunks)
    left, right = (t(x) for x in unorm8_pair(np.random.default_rng(bands),
                                             48, 32))
    if route == "whole":
        got = asw.asw_pipeline(left, right, cfg)
        got = (got.disparity, got.filled)
    else:
        got = tiled.asw_pipeline_tiled(left, right, cfg, bands,
                                       wavefront=route == "wavefront")
    assert _counts() == _want(chip_smoke.expected_asw_launches(
        cfg, bands, route, kernels))
    plain = asw.asw_pipeline(left, right, cfg.replace(kernels="jnp"))
    assert torch.equal(got[0], plain.disparity)
    assert torch.equal(got[1], plain.filled)


def test_asw_debug_launches_k11_once_a_wta(counted):
    """The debug entry runs the WTA 1 + r + 1 + k times: K11 with each."""
    left, right = (t(x) for x in unorm8_pair(np.random.default_rng(7), 40,
                                             32))
    asw.asw_pipeline_debug(left, right, CFG)
    r, k = CFG.r_iters, CFG.k_iters
    assert _counts() == {"sad_volume": 1, "wta_merge": 1 + r + 1 + k,
                         "median3x3": 1}


@pytest.mark.parametrize("route,bands", [("whole", 1), ("wavefront", 3),
                                         ("halo", 2)])
def test_cross_launch_table(counted, route, bands):
    """expected_cross_launches' K12 entry: both views' medians and the
    voted map's, per band (K6 on the cross path follows oii_impl, which
    keeps the plain ops on the CPU)."""
    left, right = (t(x) for x in unorm8_pair(np.random.default_rng(bands),
                                             48, 32))
    if route == "whole":
        got = cross_based.cross_pipeline(left, right, CFG)
        got = (got.initial, got.final)
    else:
        got = tiled.cross_pipeline_tiled(left, right, CFG, bands,
                                         wavefront=route == "wavefront")
    keys = ("median3x3", "wta_merge")
    assert _counts(keys) == _want(chip_smoke.expected_cross_launches(
        bands, kernels), keys)
    plain = cross_based.cross_pipeline(left, right,
                                       CFG.replace(kernels="jnp"))
    assert torch.equal(got[0], plain.initial)
    assert torch.equal(got[1], plain.final)


def test_sharded_launch_table(counted):
    """sharded_launches' K6 and K12 entries for both methods, each step as
    a rank runs it (call_stage) on a shard of 8 of 24 rows at d0 > 0: the
    ASW weights step (the SAD cost), the median step; the cross local step
    (both views' medians) and its median step.  The sharded WTA merge is
    plain: no K11."""
    cfg = CFG
    rng = np.random.default_rng(3)
    R, W, h_loc, row0, h_glob = cfg.radius, 32, 8, 8, 24
    left, right = (t(x) for x in unorm8_pair(rng, h_glob, W))

    def pad(x, halo):
        return x[torch.arange(row0 - halo, row0 + h_loc + halo).clamp(
            0, h_glob - 1)].contiguous()

    mine = lambda x: x[row0:row0 + h_loc].contiguous()
    d0, d_local = 4, 8
    call_stage("asw_weights", asw_sharded._weights, pad(left, R),
               pad(right, R), mine(left), mine(right), cfg, row0, h_glob, d0,
               d_local)
    filled = t(rng.uniform(0, 1, (h_loc + 2, W)).astype(np.float32))
    call_stage("asw_median", ops_tiled.median3x3_tiled, filled, cfg.kernels)
    keys = ("sad_volume", "median3x3", "wta_merge")
    assert _counts(keys) == _want(chip_smoke.sharded_launches(
        "asw", cfg, kernels), keys)
    kernels.reset_launches()
    halo = cfg.arm_len + 1
    call_stage("cross_local", cross_sharded._cross_local,
               pad(left, halo + 1), pad(right, halo + 1), cfg, row0 - halo,
               h_glob, d0, d_local)
    call_stage("cross_median", ops_tiled.median3x3_tiled, filled, cfg.kernels)
    keys = ("median3x3", "wta_merge")
    assert _counts(keys) == _want(chip_smoke.sharded_launches(
        "cross", cfg, kernels), keys)
