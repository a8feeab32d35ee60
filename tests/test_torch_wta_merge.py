"""Kernel K11 (wta_merge, the WTA epilogue) of the port: its plain version
`_wta_epilogue_plain` against the JAX package's `_tail_and_merge` and the
two confidences of its wta_fast / wta_refined_fast
(stereo_matchin_tpu/ops/wta_fast.py), and the wrapper's CPU route.  The
CUDA kernel is held to the plain version on the card in
tests/test_torch_cuda.py and chip_smoke.py.

The inputs are K3's and K4's plain outputs on integer volumes of costs in
[1, 30] (so c2 > 0) with blocks at and above the big cap, d1 from K3 or
forced to 0, D - 1 or uniform; narrow frames put many pixels in the
clamped tail (d1 > x).  Integer maps must be bit-equal; the f32 maps may
differ by the 1-ulp penalty drift that ROADMAP's "Agree" allows (eager
JAX runs the same two roundings, so they are bit-equal here).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_matchin_tpu.ops.wta_fast import (_tail_and_merge, wta_fast,
                                             wta_refined_fast)
from stereo_matchin_tpu_torch import kernels
from stereo_matchin_tpu_torch import ops as tops
from stereo_matchin_tpu_torch.kernels.wta_gather import wta_merge
from stereo_matchin_tpu_torch.ops.wta_fast import (_diag_two_min_plain,
                                                   _two_min_plain,
                                                   _wta_epilogue_plain)

from .torch_support import max_ulp, n, t

BIG = 1e5
F32 = np.float32


def _inputs(seed, D, H, W, d1_kind, pen, capped):
    """(K3 outputs, K4 outputs, (sc, ct) or (None, None)) on one volume.
    pen: None, "general" (uniform scale and centre) or "half" (centres on
    half-integers, where the tail's two probes tie)."""
    rng = np.random.default_rng(seed)
    cost = rng.integers(1, 31, (D, H, W)).astype(F32)
    if capped:
        cost[:, :2, :3] = BIG                   # at the cap on every plane
        cost[: D // 2, 2:4, :] = 2 * BIG        # above it on some planes
    if pen is None:
        sc = ct = None
    else:
        sc = t(rng.uniform(0, 2, (H, W)).astype(F32))
        ct = rng.integers(0, D, (H, W)).astype(F32)
        ct = t(ct + F32(0.5) if pen == "half"
               else rng.uniform(-2, D + 2, (H, W)).astype(F32))
    cost = t(cost)
    c1, c2, d1 = _two_min_plain(cost, sc, ct, BIG)
    d1 = {"argmin": d1, "zero": torch.zeros_like(d1),
          "last": torch.full_like(d1, D - 1),
          "random": t(rng.integers(0, D, (H, W)).astype(np.int32))}[d1_kind]
    return (c1, c2, d1), _diag_two_min_plain(cost, d1, sc, ct, BIG), (sc, ct)


def _jax_epilogue(ref, diag, pen, D):
    """The JAX package's epilogue: d1 as f32, (c2 - c1) / c2, and
    _tail_and_merge with its disparity as f32."""
    c1, c2, d1 = (jnp.asarray(n(x)) for x in ref)
    mc1, mc2, md, base = (jnp.asarray(n(x)) for x in diag)
    sc, ct = (None if x is None else jnp.asarray(n(x)) for x in pen)
    H, W = d1.shape
    xs = jnp.arange(W, dtype=jnp.int32)[None, :]
    b0 = jnp.maximum(d1 - xs, 0)
    d, conf = _tail_and_merge(d1, xs, mc1, mc2, md, base, b0, sc, ct, BIG,
                              jnp.float32, D, H, W)
    return (d1.astype(jnp.float32), (c2 - c1) / c2, d.astype(jnp.float32),
            conf)


CASES = [
    # (seed, D, H, W, d1, penalty, capped)
    (0, 17, 12, 40, "argmin", None, False),
    (1, 17, 12, 40, "argmin", "general", False),
    (2, 17, 12, 40, "argmin", "half", True),
    (3, 17, 10, 24, "last", None, True),
    (4, 17, 10, 24, "last", "general", True),
    (5, 17, 10, 24, "last", "half", False),
    (6, 9, 8, 30, "zero", None, False),
    (7, 9, 8, 30, "zero", "general", True),
    (8, 33, 9, 50, "random", "general", True),
    (9, 33, 9, 50, "random", "half", True),
    (10, 1, 4, 6, "zero", "general", False),
    (11, 2, 5, 7, "random", "half", True),
]


@pytest.mark.parametrize("seed,D,H,W,d1_kind,pen,capped", CASES)
def test_epilogue_plain_equals_the_jax_tail_and_merge(seed, D, H, W, d1_kind,
                                                      pen, capped):
    ref, diag, maps = _inputs(seed, D, H, W, d1_kind, pen, capped)
    got = _wta_epilogue_plain(*ref, *diag, *maps, BIG, D)
    want = _jax_epilogue(ref, diag, maps, D)
    for name, g, w in zip(("disp_ref", "conf_ref", "disp_target",
                           "conf_target"), got, want):
        assert g.dtype == torch.float32 and g.shape == (H, W), name
        if name.startswith("disp"):
            np.testing.assert_array_equal(n(g), np.asarray(w), err_msg=name)
        else:
            assert max_ulp(g, w) <= 1, name
    xs = torch.arange(W)[None, :]
    if d1_kind != "zero" and D > 2:
        # The clamped tail (d1 > x) runs on these frames.
        assert bool((ref[2] > xs).any())


def test_tail_wins_and_ties_keep_the_main_scan():
    """On the half-integer penalty frame the tail's value takes some pixels
    (d = b0) and a tie with the main scan keeps the main scan's plane."""
    D, H, W = 17, 12, 40
    ref, diag, maps = _inputs(2, D, H, W, "argmin", "half", True)
    d_t = _wta_epilogue_plain(*ref, *diag, *maps, BIG, D)[2]
    xs = torch.arange(W)[None, :]
    b0 = (ref[2] - xs).clamp(min=0)
    tail = (ref[2] > xs) & (d_t == b0.float()) & (d_t != diag[2].float())
    assert bool(tail.any())
    # A tie: the main scan's c1 equal to the tail's capped c1 keeps md.
    mc1, mc2, md, base = diag
    tied = [mc1.clone(), mc2, md, base]
    tied[0] = torch.where(ref[2] > xs, base + maps[0] * (
        maps[1] - torch.clamp(torch.round(maps[1]), torch.clamp(
            xs.float() + 1, min=1.0), torch.clamp(ref[2].float() - 1,
                                                  max=float(D - 2)))).abs(),
        mc1)
    got = _wta_epilogue_plain(*ref, *tied, *maps, BIG, D)
    want = _jax_epilogue(ref, tied, maps, D)
    np.testing.assert_array_equal(n(got[2]), np.asarray(want[2]))
    assert max_ulp(got[3], want[3]) <= 1


@pytest.mark.parametrize("pen", [None, "general"])
def test_wrapper_takes_the_plain_version_on_the_cpu(pen):
    D, H, W = 17, 10, 24
    ref, diag, maps = _inputs(12, D, H, W, "argmin", pen, True)
    before = dict(kernels.LAUNCHES)
    got = wta_merge(*ref, *diag, *maps, BIG, D)
    want = _wta_epilogue_plain(*ref, *diag, *maps, BIG, D)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert kernels.LAUNCHES == before


def test_wrapper_refuses_bad_inputs():
    D, H, W = 9, 6, 8
    ref, diag, maps = _inputs(13, D, H, W, "argmin", "general", False)
    with pytest.raises(ValueError):
        wta_merge(*ref, *diag, maps[0], None, BIG, D)
    with pytest.raises(TypeError):
        wta_merge(ref[0], ref[1], ref[2].float(), *diag, *maps, BIG, D)
    with pytest.raises(ValueError):
        wta_merge(*ref, diag[0][:, 1:], *diag[1:], *maps, BIG, D)
    with pytest.raises(ValueError):
        wta_merge(*ref, *diag, *maps, BIG, 0)


@pytest.mark.parametrize("refined", [False, True])
def test_wta_routes_equal_the_jax_wta(refined):
    """ops.wta_fast / wta_refined_fast (K3 -> K4 -> K11 plain on the CPU,
    "auto" and "jnp") against the JAX package's; "pallas" raises on a CPU
    tensor and nothing is counted."""
    rng = np.random.default_rng(14)
    D, H, W = 13, 9, 30
    cost = rng.integers(1, 31, (D, H, W)).astype(F32)
    cost[:, :2, :3] = BIG
    args = ()
    if refined:
        rv, rvt = (rng.integers(0, D, (H, W)).astype(F32) for _ in range(2))
        rd, rdt = ((rng.integers(0, 128, (H, W)) / F32(64)).astype(F32)
                   for _ in range(2))
        args = (rv, rd, rvt, rdt, 0.5)
    before = dict(kernels.LAUNCHES)
    fn = tops.wta_refined_fast if refined else tops.wta_fast
    jfn = wta_refined_fast if refined else wta_fast
    targs = tuple(t(a) if isinstance(a, np.ndarray) else a for a in args)
    want = jfn(jnp.asarray(cost), *(jnp.asarray(a) if isinstance(
        a, np.ndarray) else a for a in args), big=BIG)
    for mode in ("auto", "jnp"):
        got = fn(t(cost), *targs, big=BIG, kernels=mode)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(n(g), np.asarray(w))
    with pytest.raises(ValueError):
        fn(t(cost), *targs, big=BIG, kernels="pallas")
    assert kernels.LAUNCHES == before
