"""Kernels K13 (epipolar_segment) and K14 (shard_merge) of the port's
sharded WTA (kernels/wta_shard.py, csrc/wta_shard.cu) on the CPU.

  * A numpy walk of K13 as the CUDA code indexes it (each pixel's interval
    of unclamped steps, K13_UNROLL loads at a time, then the clamped tail,
    the sequential tracker, the stacked output with d's int32 bits)
    against parallel/wta_sharded.py epipolar_partial + stack_two_min, bit
    for bit, on every shard of every SHARD_WTA_EDGES case, with and without
    the WTA_REF penalty; the walk visits exactly the steps the plain loop
    counts.
  * A numpy walk of K14's two modes (the folds as the CUDA code indexes the
    gathered (n, 3, H, W) stack, NaN-propagating minimum and maximum, IEEE
    division) against the plain merges, bit for bit, NaN confidences
    included.
  * The plain merges against the JAX package's (its wta_sharded and
    wta_refined_sharded, eager, the all-gathers handing both sides the same
    gathered summaries): the fold orders and the confidences of 0 / 0.
  * The `kernels` routes on CPU tensors ("auto" and "jnp" the plain
    versions, "pallas" raises, nothing counted), the wrappers' refusals,
    one shard's WTA against the unsharded one, and chip_smoke.py's
    sharded launch table for K13/K14 (the `counted` fixture routes "auto"
    to the wrappers on CPU tensors and counts them).

The CUDA kernels are held to the plain versions on the card in
tests/test_torch_cuda.py and chip_smoke.py phase 3d.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from stereo_matchin_tpu_torch import kernels
from stereo_matchin_tpu_torch import ops as tops
from stereo_matchin_tpu_torch.config import StereoConfig
from stereo_matchin_tpu_torch.kernels import wta_shard as ks

from .torch_support import SHARD_WTA_EDGES, n, shard_wta_inputs, t

# The packages export functions named wta_sharded: take the modules.
jwta = importlib.import_module("stereo_matchin_tpu.parallel.wta_sharded")
twta = importlib.import_module("stereo_matchin_tpu_torch.parallel.wta_sharded")

BIG = 1e5
PENALTY = 0.085
F32 = np.float32
K13_UNROLL = 8          # csrc/wta_shard.cu kUnrollK13
CASES = list(SHARD_WTA_EDGES)


def _frame(case, with_penalty, seed=0):
    """One SHARD_WTA_EDGES case: (shard volumes, their d0 and planes, the
    padded depth, the penalty arguments of the steps (ref_denom,
    ref_value, ref_denom_t, ref_value_t or Nones), the reference gather,
    the merged reference, the target scan's d1)."""
    D, shards, H, W, kind = SHARD_WTA_EDGES[case]
    rng = np.random.default_rng(seed + 7 * with_penalty
                                + sum(map(ord, case)))
    cost, (rv, rd, rvt, rdt), rand = shard_wta_inputs(rng, D, shards, H, W,
                                                      BIG)
    d_pad = cost.shape[0]
    dl = d_pad // shards
    vols = [t(cost[k * dl:(k + 1) * dl]) for k in range(shards)]
    ref_pen = (t(rd), t(rv), PENALTY) if with_penalty else (None,) * 3
    tgt_pen = (t(rdt), t(rvt), PENALTY) if with_penalty else (None,) * 3
    g = torch.stack([twta.local_two_min(v, *ref_pen, k * dl, BIG, "jnp")
                     for k, v in enumerate(vols)])
    ref = twta.merge_reference_gathered(g, BIG)
    d1 = {"argmin": ref.d, "zero": torch.zeros_like(ref.d),
          "last": torch.full_like(ref.d, D - 1), "random": t(rand)}[kind]
    return vols, dl, d_pad, tgt_pen, g, ref, d1


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(n(x)).view(np.int32)


# --- K13 ---------------------------------------------------------------------

def _torch_min(a, b):
    """torch.minimum on the card (and fminf) for one pair of floats."""
    if np.isnan(a):
        return a
    if np.isnan(b):
        return b
    return b if b < a else a


def _torch_max(a, b):
    if np.isnan(a):
        return a
    if np.isnan(b):
        return b
    return b if b > a else a


def k13_walk(cost, d1, d0, n_local, total_disp, sc, ct, big):
    """K13 as csrc/wta_shard.cu indexes it, one pixel p = y * W + x at a
    time: the unclamped steps i in [lo, hi] read flat[(d1 - i - d0) * HW +
    (p - x) + (x - i)], K13_UNROLL of them loaded before any is compared;
    then the tail's base at column 0, each step i in [x + 1, imax - 1] with
    its own penalty.  Returns ((3, H, W) f32 output as the kernel writes
    it, the steps walked per pixel, the floats loaded in all)."""
    Dl, H, W = cost.shape
    HW = H * W
    flat = np.ascontiguousarray(cost, F32).reshape(-1)
    d1f = np.ascontiguousarray(d1).reshape(-1)
    scf = None if sc is None else np.ascontiguousarray(sc, F32).reshape(-1)
    ctf = None if ct is None else np.ascontiguousarray(ct, F32).reshape(-1)
    out = np.empty(3 * HW, F32)
    steps = np.zeros(HW, np.int64)
    loads_in_all = 0

    def pen(v, p, i):
        if scf is None:
            return v
        return F32(v + F32(scf[p] * F32(abs(F32(ctf[p] - F32(i))))))

    for p in range(HW):
        x = p % W
        row = p - x
        dd = int(d1f[p])
        imax = min(dd, total_disp - 1)
        c1 = c2 = F32(big)
        best = dd

        def track(v, b):
            nonlocal c1, c2, best
            if v < c1:
                c2, c1, best = c1, v, b
            else:
                c2 = _torch_min(c2, v)

        lo = max(0, dd - d0 - n_local + 1)
        hi = min(x, dd - d0, imax - 1)
        i = lo
        while i <= hi:
            loads = []
            for u in range(K13_UNROLL):
                j = i + u
                if j <= hi:
                    plane = dd - j - d0
                    assert 0 <= plane < n_local and 0 <= x - j < W
                    loads.append(flat[plane * HW + row + (x - j)])
            loads_in_all += len(loads)
            for u, v in enumerate(loads):
                track(pen(v, p, i + u), dd - (i + u))
                steps[p] += 1
            i += K13_UNROLL
        bt = dd - x
        btl = bt - d0
        if x + 1 < imax and 0 <= btl < n_local:
            base = flat[btl * HW + row]
            loads_in_all += 1
            for i in range(x + 1, imax):
                track(pen(base, p, i), bt)
                steps[p] += 1
        out[p], out[HW + p] = c1, c2
        out[2 * HW + p] = np.array(best, np.int32).view(F32)
    return out.reshape(3, H, W), steps.reshape(H, W), loads_in_all


def _counted_steps(d1, d0, n_local, total_disp, W):
    """The steps epipolar_partial counts (its `valid` mask), per pixel."""
    xs = torch.arange(W, dtype=torch.int32)[None, :]
    total = torch.zeros(d1.shape, dtype=torch.int64)
    for i in range(total_disp - 1):
        bl = d1 + (xs - i).clamp(min=0) - xs - d0
        total += ((i < d1) & (bl >= 0) & (bl < n_local)).long()
    return total.numpy()


@pytest.mark.parametrize("with_penalty", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_segment_walk_equals_epipolar_partial(case, with_penalty):
    vols, dl, d_pad, pen, _, _, d1 = _frame(case, with_penalty)
    sc = None if pen[0] is None else pen[2] * pen[0]
    W = d1.shape[1]
    walked = 0
    for k, v in enumerate(vols):
        want = twta.stack_two_min(twta.epipolar_partial(
            v, d1, k * dl, dl, d_pad, sc, pen[1], BIG))
        got, steps, loads = k13_walk(n(v), n(d1), k * dl, dl, d_pad,
                                     None if sc is None else n(sc),
                                     None if pen[1] is None else n(pen[1]),
                                     BIG)
        np.testing.assert_array_equal(got.view(np.int32), _bits(want),
                                      err_msg=f"shard {k}")
        np.testing.assert_array_equal(
            steps, _counted_steps(d1, k * dl, dl, d_pad, W))
        # The smoke's bound counts these loads and steps.
        assert chip_smoke.segment_walk(d1, k * dl, dl, d_pad) == (
            loads, int(steps.sum()))
        walked += int(steps.sum())
        # The step's route on the CPU is the same plain version.
        step = twta.epipolar_segment(v, d1, k * dl, dl, d_pad, *pen, BIG)
        assert torch.equal(step.view(torch.int32), want.view(torch.int32))
    if SHARD_WTA_EDGES[case][4] != "zero":
        assert walked > 0


def test_segment_edges_reach_the_cases_they_name():
    """The edge frames hold what SHARD_WTA_EDGES says: long clamped tails
    (x < d1), pixels whose diagonal misses a shard, pad planes at big,
    one plane a shard, and both NaN confidences of 0 / 0."""
    vols, dl, d_pad, _, _, _, d1 = _frame("d1_last_narrow", False)
    xs = torch.arange(d1.shape[1])[None, :]
    assert bool((d1 > xs).all()) and dl > 1
    assert int(_counted_steps(d1, 0, dl, d_pad, d1.shape[1]).min()) == 0
    vols, dl, d_pad, _, _, _, _ = _frame("Dl1_pad_shard", False)
    assert dl == 1 and bool((vols[-1] == BIG).all())
    res = _merged("d1_last_narrow", False, seed_with_ref=False)[2]
    assert bool(res.conf_target.isnan().any())
    assert bool(_merged("one_shard", False)[2].conf_ref.isnan().any())


# --- K14 ---------------------------------------------------------------------

def _np_min(a, b):
    return np.where(np.isnan(a), a, np.where(np.isnan(b), b,
                                             np.where(b < a, b, a)))


def _np_max(a, b):
    return np.where(np.isnan(a), a, np.where(np.isnan(b), b,
                                             np.where(b > a, b, a)))


def _combine(c1, c2, d, b1, b2, bd):
    take = b1 < c1
    m2 = _np_min(_np_min(c2, b2), _np_max(c1, b1))
    return np.where(take, b1, c1), m2, np.where(take, bd, d)


def k14_walk(g, big, ref=None):
    """K14 as csrc/wta_shard.cu indexes the gathered stack: shard s's
    planes at 3 * HW * s (+ HW, + 2 HW as int32 bits).  Reference mode
    (ref None): (c1, c2, d int32); target mode: (d_ref, conf_ref, d_t,
    conf_t) f32 from ref = (c1, c2, d_ref)."""
    n_, _, H, W = g.shape
    HW = H * W
    gf = np.ascontiguousarray(n(g), F32).reshape(-1)
    gi = gf.view(np.int32)
    at = lambda s, plane: gf[3 * HW * s + plane * HW:][:HW]
    bits = lambda s: gi[3 * HW * s + 2 * HW:][:HW]
    big = F32(big)
    if ref is None:
        c1, c2, d = at(0, 0), at(0, 1), bits(0)
        for s in range(1, n_):
            c1, c2, d = _combine(c1, c2, d, at(s, 0), at(s, 1), bits(s))
        return (c1.reshape(H, W), c2.reshape(H, W),
                np.where(c1 < big, d, 0).astype(np.int32).reshape(H, W))
    r1, r2, rd = (np.ascontiguousarray(n(x)).reshape(-1) for x in ref)
    c1 = np.full(HW, big, F32)
    c2, d = c1.copy(), rd.copy()
    for s in range(n_ - 1, -1, -1):
        c1, c2, d = _combine(c1, c2, d, at(s, 0), at(s, 1), bits(s))
    with np.errstate(divide="ignore", invalid="ignore"):
        maps = (rd.astype(F32), (r2 - r1) / r2, d.astype(F32),
                (c2 - c1) / c2)
    return tuple(np.asarray(m, F32).reshape(H, W) for m in maps)


def _merged(case, with_penalty, seed_with_ref=True):
    """(the frame, the target gather, the plain WTAResult) of one case:
    the target scan from the merged reference's d (as the pipeline runs
    it), or from the case's d1."""
    frame = _frame(case, with_penalty)
    vols, dl, d_pad, pen, _, ref, d1 = frame
    d1 = ref.d if seed_with_ref else d1
    g_t = torch.stack([twta.epipolar_segment(v, d1, k * dl, dl, d_pad,
                                             *pen, BIG)
                       for k, v in enumerate(vols)])
    return frame, g_t, twta.wta_result(
        ref.c1, ref.c2, d1, *twta.merge_target_gathered(g_t, d1, BIG))


@pytest.mark.parametrize("with_penalty", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_merge_walk_equals_the_plain_merges(case, with_penalty):
    vols, dl, d_pad, pen, g, ref, d1 = _frame(case, with_penalty)
    for got, want in zip(k14_walk(g, BIG), ref):
        np.testing.assert_array_equal(np.ascontiguousarray(got).view(np.int32),
                                      _bits(want))
    g_t = torch.stack([twta.epipolar_segment(v, d1, k * dl, dl, d_pad, *pen,
                                             BIG)
                       for k, v in enumerate(vols)])
    want = twta.wta_result(ref.c1, ref.c2, d1,
                           *twta.merge_target_gathered(g_t, d1, BIG))
    got = k14_walk(g_t, BIG, (ref.c1, ref.c2, d1))
    for name, a, b in zip(want._fields, got, want):
        np.testing.assert_array_equal(a.view(np.int32), _bits(b),
                                      err_msg=name)
    for a, b in zip(twta.merge_target_step(g_t, ref.c1, ref.c2, d1, BIG),
                    want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


class _GatheredLax:
    """jax.lax whose all_gather hands out the given gathered summaries in
    turn (the shards' (n, H, W) fields), and whose fori_loop runs op by op
    (no jit, so XLA contracts no multiply-add)."""

    def __init__(self, gathers):
        self.gathers = list(gathers)

    def __getattr__(self, name):
        return getattr(jax.lax, name)

    def all_gather(self, x, axis_name):
        return self.gathers.pop(0)

    @staticmethod
    def fori_loop(lo, hi, body, carry):
        for i in range(lo, hi):
            carry = body(jnp.int32(i), carry)
        return carry


def _jax_gather(g):
    parts = twta.unstack_two_min(g)
    return jwta.TwoMin(*(jnp.asarray(np.stack([n(getattr(p, f)) for p in
                                               parts]))
                         for f in ("c1", "c2", "d")))


@pytest.mark.parametrize("with_penalty", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_merges_equal_the_jax_sharded_wta(case, with_penalty, monkeypatch):
    """The merge steps' plain versions (K14's) against JAX's wta_sharded /
    wta_refined_sharded, both merging the same gathered summaries: the
    reference folded in ascending shard order, the target in descending
    order from (big, big, d1), the same maps, NaN where c2 = c1 = 0."""
    (vols, dl, d_pad, pen, g, _, _), g_t, want = _merged(case, with_penalty)
    got = twta.merge_target_step(
        g_t, *twta.merge_reference_step(g, BIG, "jnp"), BIG, "jnp")
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    monkeypatch.setattr(jwta, "lax", _GatheredLax([_jax_gather(g),
                                                   _jax_gather(g_t)]))
    # JAX's own segment of shard 0 goes to the all-gather, which drops it
    # (tests/test_torch_parallel.py holds epipolar_partial to JAX's).
    monkeypatch.setattr(jwta, "epipolar_partial", lambda *a, **k: None)
    cost0 = jnp.asarray(n(vols[0]))
    if with_penalty:
        # The maps reach only JAX's own local scans, whose results the
        # all-gathers replace.
        den, val = (jnp.asarray(n(x)) for x in pen[:2])
        jres = jwta.wta_refined_sharded(cost0, 0, dl, d_pad, "disp", val,
                                        den, val, den, PENALTY, BIG)
    else:
        jres = jwta.wta_sharded(cost0, 0, dl, d_pad, "disp", BIG)
    for name, a, b in zip(want._fields, got, jres):
        np.testing.assert_array_equal(n(a), np.asarray(b), err_msg=name)


# --- routes, refusals, one shard, the launch table ----------------------------

def test_routes_on_cpu_tensors_are_the_plain_versions():
    vols, dl, d_pad, pen, g, ref, d1 = _frame("three_shards_random", True)
    before = dict(kernels.LAUNCHES)
    seg = twta.epipolar_segment(vols[1], d1, dl, dl, d_pad, *pen, BIG, "jnp")
    g_t = torch.stack([seg] * 3)
    for mode in ("auto", "jnp"):
        assert torch.equal(twta.epipolar_segment(vols[1], d1, dl, dl, d_pad,
                                                 *pen, BIG, mode), seg)
        assert torch.equal(ks.epipolar_segment(vols[1], d1, dl, dl, d_pad,
                                               PENALTY * pen[0], pen[1],
                                               BIG), seg)
        for a, b in zip(twta.merge_reference_step(g, BIG, mode), ref):
            assert torch.equal(a, b)
        for a, b in zip(ks.shard_merge_reference(g, BIG), ref):
            assert torch.equal(a, b)
        want = twta.wta_result(ref.c1, ref.c2, ref.d,
                               *twta.merge_target_gathered(g_t, ref.d, BIG))
        for got in (twta.merge_target_step(g_t, ref.c1, ref.c2, ref.d, BIG,
                                           mode),
                    ks.shard_merge_target(g_t, ref.c1, ref.c2, ref.d, BIG)):
            for a, b in zip(got, want):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    with pytest.raises(ValueError, match="pallas"):
        twta.epipolar_segment(vols[1], d1, dl, dl, d_pad, *pen, BIG, "pallas")
    with pytest.raises(ValueError, match="pallas"):
        twta.merge_reference_step(g, BIG, "pallas")
    with pytest.raises(ValueError, match="pallas"):
        twta.merge_target_step(g_t, ref.c1, ref.c2, ref.d, BIG, "pallas")
    assert kernels.LAUNCHES == before


def test_wrappers_refuse_bad_inputs():
    vols, dl, d_pad, pen, g, ref, d1 = _frame("two_shards_padded", True)
    v = vols[0]
    with pytest.raises(ValueError, match="n_local"):
        ks.epipolar_segment(v, d1, 0, dl + 1, d_pad)
    with pytest.raises(ValueError, match="n_local"):
        ks.epipolar_segment(v, d1, 0, 0, d_pad)
    with pytest.raises(ValueError, match="d0"):
        ks.epipolar_segment(v, d1, -1, dl, d_pad)
    with pytest.raises(TypeError):
        ks.epipolar_segment(v, d1.float(), 0, dl, d_pad)
    with pytest.raises(ValueError, match="together"):
        ks.epipolar_segment(v, d1, 0, dl, d_pad, pen[0], None)
    with pytest.raises(ValueError):
        ks.epipolar_segment(v, d1[:, 1:], 0, dl, d_pad)
    with pytest.raises(ValueError, match="gathered"):
        ks.shard_merge_reference(g[:, :2])
    with pytest.raises(ValueError, match="gathered"):
        ks.shard_merge_reference(g[0])
    with pytest.raises(TypeError):
        ks.shard_merge_target(g, ref.c1, ref.c2, ref.d.float())
    with pytest.raises(ValueError):
        ks.shard_merge_target(g, ref.c1[1:], ref.c2, ref.d)


class _OneShard:
    """parallel/comm.py for a disp group of one shard: the all-gather of x
    is x itself."""

    @staticmethod
    def all_gather(x, group=None):
        return x[None]


@pytest.mark.parametrize("refined", [False, True])
def test_one_shard_wta_equals_the_unsharded_wta(refined, monkeypatch):
    """wta_sharded / wta_refined_sharded over one shard (its all-gather
    the shard's own summary) on each route: bit-equal to the unsharded
    ops.wta_fast / wta_refined_fast."""
    monkeypatch.setattr(twta, "comm", _OneShard)
    rng = np.random.default_rng(21 + refined)
    cost, maps, _ = shard_wta_inputs(rng, 17, 1, 7, 29, BIG)
    D = cost.shape[0]
    rv, rd, rvt, rdt = (t(m) for m in maps)
    for mode in ("auto", "jnp"):
        if refined:
            got = twta.wta_refined_sharded(t(cost), 0, D, D, None, rv, rd,
                                           rvt, rdt, PENALTY, BIG, mode)
            want = tops.wta_refined_fast(t(cost), rv, rd, rvt, rdt, PENALTY,
                                         BIG, "jnp")
        else:
            got = twta.wta_sharded(t(cost), 0, D, D, None, BIG, mode)
            want = tops.wta_fast(t(cost), BIG, "jnp")
        for name, a, b in zip(want._fields, got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name


@pytest.fixture
def counted(monkeypatch):
    """A card's routing on CPU tensors: "auto" takes the kernel wrappers,
    which run their plain versions on the CPU, and each K3, K13 and K14
    wrapper call is counted in kernels.LAUNCHES where the card would
    launch it."""
    from stereo_matchin_tpu_torch.kernels import wta_gather as kw

    monkeypatch.setattr(kernels, "use_kernels", lambda mode, x: mode != "jnp")

    def counting(module, name, key):
        fn = getattr(module, name)

        def call(*args, **kw_):
            kernels.LAUNCHES[key] += 1
            return fn(*args, **kw_)
        monkeypatch.setattr(module, name, call)

    counting(kw, "two_min", "two_min")
    counting(ks, "epipolar_segment", "epipolar_segment")
    counting(ks, "shard_merge_reference", "shard_merge")
    counting(ks, "shard_merge_target", "shard_merge")
    kernels.reset_launches()
    yield
    kernels.reset_launches()


@pytest.mark.parametrize("k_iters", [2, 0])
def test_sharded_launch_table(counted, k_iters, monkeypatch):
    """sharded_launches' K3, K13 and K14 entries equal the wrapper calls of
    one rank's WTA and k WTA_REFs: K13 once and K14 twice a WTA."""
    monkeypatch.setattr(twta, "comm", _OneShard)
    cfg = StereoConfig(d_max=11, radius=2, arm_len=4, r_iters=2,
                       k_iters=k_iters)
    rng = np.random.default_rng(30 + k_iters)
    cost, maps, _ = shard_wta_inputs(rng, cfg.num_disp, 1, 6, 20, BIG)
    D = cost.shape[0]
    want = twta.wta_sharded(t(cost), 0, D, D, None, BIG, "auto")
    for _ in range(cfg.k_iters):
        twta.wta_refined_sharded(t(cost), 0, D, D, None,
                                 *(t(m) for m in maps), PENALTY, BIG, "auto")
    keys = ("two_min", "epipolar_segment", "shard_merge")
    table = chip_smoke.sharded_launches("asw", cfg, kernels)
    assert {k: kernels.LAUNCHES[k] for k in keys} == {k: table[k]
                                                      for k in keys}
    assert table["epipolar_segment"] == k_iters + 1
    assert table["shard_merge"] == 2 * (k_iters + 1)
    plain = tops.wta_fast(t(cost), BIG, "jnp")
    for a, b in zip(want, plain):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
