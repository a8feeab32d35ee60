"""Kernels K13 (epipolar_segment) and K14 (shard_merge) of the port's
sharded WTA (kernels/wta_shard.py, csrc/wta_shard.cu) on the CPU.

  * A numpy walk of K13 as the CUDA code schedules it (blocks of a row
    segment, each pixel's interval of unclamped steps as planes, the
    block's staged range and windows, then per pixel the planes above it
    by direct loads, the staged planes, those below, and the clamped tail;
    the sequential tracker, the stacked output with d's int32 bits)
    against parallel/wta_sharded.py epipolar_partial + stack_two_min, bit
    for bit, on every shard of every SHARD_WTA_EDGES case, with and without
    the WTA_REF penalty; the walk visits exactly the steps the plain loop
    counts, every staged read falls in its window and every window in its
    ring slot, and chip_smoke.py's counts of its loads, staged and direct
    floats equal the walk's.
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

from .torch_support import (SHARD_WTA_EDGES, k13_plan, n, shard_wta_d1,
                            shard_wta_inputs, t)

# The packages export functions named wta_sharded: take the modules.
jwta = importlib.import_module("stereo_matchin_tpu.parallel.wta_sharded")
twta = importlib.import_module("stereo_matchin_tpu_torch.parallel.wta_sharded")

BIG = 1e5
PENALTY = 0.085
F32 = np.float32
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
    d1 = shard_wta_d1(kind, D, rand)(ref.d)
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


def k13_walk(cost, d1, d0, n_local, total_disp, sc, ct, big,
             walk="segment"):
    """K13 as csrc/wta_shard.cu schedules it (tests/torch_support.py
    k13_plan, the kernel's plan).  The segment walk: block (y, s) owns
    columns [x0, x1) of row y; each pixel's unclamped steps are the planes
    [klo, khi] (step i = d1 - d0 - kl reads column x - i of plane kl); the
    block stages the planes [ka, kb] whose coverage reaches 1 / share of
    its columns, each in the window [max(lowc, umin + kl), min(x1 - 1,
    umax + kl)] of the row (umin, umax: the column offsets x - d1 + d0 of
    the pixels that walk a staged plane), and each pixel walks the planes
    above kb through the kernel's queue (by direct loads, `unroll` planes
    a chunk from the queue's top plane down; where no plane is staged and
    at most 32 pixels are active, each from its own top plane, buffered in
    the free ring while the walkers' planes fit it), kb .. ka
    from the staged windows (every read inside its window), those below ka
    by direct loads (the queue again), then its clamped tail (the base at
    column 0, each step i in [x + 1, imax - 1] with its own penalty).  The
    pixel walk: each pixel its planes khi .. klo by direct loads,
    `unroll_pixel` a chunk, then its tail.  Returns ((3, H, W) f32 output
    as the kernel writes it, the steps walked per pixel, and the counts:
    "loads" (a float per unclamped step and per tail, the bound's),
    "steps", "staged" (floats copied into windows), "direct" (floats
    loaded directly: the planes outside [ka, kb] and the tails' bases),
    "buffered" (of those, copied into a free ring first), "above" and
    "below" (pixels that walk planes above kb, below ka), "past_ring"
    (pixels of a block with no staged plane whose planes no longer fit its
    free ring))."""
    Dl, H, W = cost.shape
    HW = H * W
    flat = np.ascontiguousarray(cost, F32).reshape(-1)
    d1 = np.ascontiguousarray(d1)
    scf = None if sc is None else np.ascontiguousarray(sc, F32)
    ctf = None if ct is None else np.ascontiguousarray(ct, F32)
    out = np.empty((3, H, W), F32)
    steps = np.zeros((H, W), np.int64)
    counts = dict.fromkeys(("loads", "steps", "staged", "direct",
                            "buffered", "above", "below", "past_ring"), 0)
    if HW == 0:
        return out, steps, counts
    plan = k13_plan(W, n_local, total_disp)
    seg, n_seg = plan["seg"], plan["n_seg"]
    if walk == "pixel":                 # one block: the whole row
        seg, n_seg = W, 1
    for y, s in np.ndindex(H, n_seg):
        x0, x1 = s * seg, min(W, (s + 1) * seg)
        assert x1 > x0
        cov = np.zeros(n_local + 1, np.int64)
        pix = []
        for x in range(x0, x1):
            d = int(d1[y, x])
            imax = min(d, total_disp - 1)
            lo = max(0, d - d0 - n_local + 1)
            hi = min(x, d - d0, imax - 1)
            klo, khi = (d - d0 - hi, d - d0 - lo) if hi >= lo else (0, -1)
            if hi >= lo:
                cov[klo] += 1
                cov[khi + 1] -= 1
                counts["loads"] += khi - klo + 1
            pix.append({"x": x, "d": d, "klo": klo, "khi": khi, "c1": F32(big),
                        "c2": F32(big), "best": d})

        def track(p, kl, v, i):
            """Step i of pixel p at local plane kl."""
            if scf is not None:
                v = F32(v + F32(scf[y, p["x"]] * F32(abs(F32(
                    ctf[y, p["x"]] - F32(i))))))
            if v < p["c1"]:
                p["c2"], p["c1"], p["best"] = p["c1"], v, kl + d0
            else:
                p["c2"] = _torch_min(p["c2"], v)
            steps[y, p["x"]] += 1

        def direct(p, khigh, klow, top, unroll):
            """Planes khigh .. klow by direct loads, `unroll` a chunk from
            top down: every plane loaded once, tracked in descending
            order."""
            loaded = []
            for k in range(top, klow - 1, -unroll):
                loaded += [kl for kl in range(k, k - unroll, -1)
                           if klow <= kl <= khigh]
            assert loaded == list(range(khigh, klow - 1, -1))
            for kl in loaded:
                col = p["x"] - p["d"] + d0 + kl
                assert 0 <= col < W and 0 <= kl < n_local
                counts["direct"] += 1
                track(p, kl, flat[kl * HW + y * W + col],
                      p["d"] - d0 - kl)

        if walk == "pixel":
            ka, kb = 0, -1
            for p in pix:
                if p["khi"] >= p["klo"]:
                    direct(p, p["khi"], p["klo"], p["khi"],
                           plan["unroll_pixel"])
        else:
            run = np.cumsum(cov[:n_local])
            ok = np.flatnonzero((run > 0)
                                & (run * plan["share"] >= x1 - x0))
            ka, kb = (int(ok[0]), int(ok[-1])) if ok.size else (0, -1)
            us = [p["x"] - p["d"] + d0 for p in pix
                  if p["khi"] >= ka and p["klo"] <= kb]
            lowc, highc = max(0, x0 - max(total_disp - 2, 0)), x1 - 1
            windows = {}
            for kl in range(kb, ka - 1, -1):
                ws, we = max(lowc, min(us) + kl), min(highc, max(us) + kl)
                # The window and its 16-byte phase fit a ring slot.
                assert we - ws + 1 + 3 <= plan["slot"]
                windows[kl] = (ws, we, flat[kl * HW + y * W + max(ws, 0):]
                               [:max(we - ws + 1, 0)])
                counts["staged"] += max(we - ws + 1, 0)
            above = [p for p in pix if p["khi"] > kb]
            top = max((p["khi"] for p in above), default=-1)
            # A sparse block (no plane staged, a warp of active pixels or
            # fewer) walks each from its free ring while their planes fit.
            free = (plan["ring"] * plan["slot"] if kb < ka and len(above)
                    <= 32 else 0)
            for p in above:             # 1. above the staged range
                counts["above"] += 1
                klow = max(p["klo"], kb + 1)
                n_planes = p["khi"] - klow + 1
                if n_planes <= free:    # buffered
                    free -= n_planes
                    counts["buffered"] += n_planes
                    direct(p, p["khi"], klow, p["khi"], n_planes)
                elif kb < ka and len(above) <= 32:
                    counts["past_ring"] += 1
                    direct(p, p["khi"], klow, p["khi"], plan["unroll"])
                else:
                    direct(p, p["khi"], klow, top, plan["unroll"])
            for kl in range(kb, ka - 1, -1):    # 2. staged, in lockstep
                ws, we, win = windows[kl]
                for p in pix:
                    if p["klo"] <= kl <= p["khi"]:
                        col = p["x"] - p["d"] + d0 + kl
                        assert ws <= col <= we
                        track(p, kl, win[col - ws], p["d"] - d0 - kl)
            below = [p for p in pix
                     if p["klo"] < ka and p["khi"] >= p["klo"]]
            top = max((min(p["khi"], ka - 1) for p in below), default=-1)
            for p in below:             # 3. below the staged range
                counts["below"] += 1
                direct(p, min(p["khi"], ka - 1), p["klo"], top,
                       plan["unroll"])
        for p in pix:                   # 4. the clamped tail
            x, d = p["x"], p["d"]
            imax = min(d, total_disp - 1)
            bt = d - x
            if x + 1 < imax and 0 <= bt - d0 < n_local:
                base = flat[(bt - d0) * HW + y * W]
                counts["loads"] += 1
                counts["direct"] += 1
                for i in range(x + 1, imax):
                    track(p, bt - d0, base, i)
            out[0, y, x], out[1, y, x] = p["c1"], p["c2"]
            out[2, y, x] = np.array(p["best"], np.int32).view(F32)
    counts["steps"] = int(steps.sum())
    return out, steps, counts


def _counted_steps(d1, d0, n_local, total_disp, W):
    """The steps epipolar_partial counts (its `valid` mask), per pixel."""
    xs = torch.arange(W, dtype=torch.int32)[None, :]
    total = torch.zeros(d1.shape, dtype=torch.int64)
    for i in range(total_disp - 1):
        bl = d1 + (xs - i).clamp(min=0) - xs - d0
        total += ((i < d1) & (bl >= 0) & (bl < n_local)).long()
    return total.numpy()


@pytest.mark.parametrize("walk", ["segment", "pixel"])
@pytest.mark.parametrize("with_penalty", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_segment_walk_equals_epipolar_partial(case, with_penalty, walk):
    vols, dl, d_pad, pen, _, _, d1 = _frame(case, with_penalty)
    sc = None if pen[0] is None else pen[2] * pen[0]
    W = d1.shape[1]
    walked = 0
    for k, v in enumerate(vols):
        want = twta.stack_two_min(twta.epipolar_partial(
            v, d1, k * dl, dl, d_pad, sc, pen[1], BIG))
        got, steps, counts = k13_walk(n(v), n(d1), k * dl, dl, d_pad,
                                      None if sc is None else n(sc),
                                      None if pen[1] is None else n(pen[1]),
                                      BIG, walk)
        np.testing.assert_array_equal(got.view(np.int32), _bits(want),
                                      err_msg=f"shard {k}")
        np.testing.assert_array_equal(
            steps, _counted_steps(d1, k * dl, dl, d_pad, W))
        # The smoke's bound counts these loads and steps, and the floats
        # the segment walk stages and loads directly.
        if walk == "segment":
            assert chip_smoke.segment_walk(
                    d1, k * dl, dl, d_pad, k13_plan(W, dl, d_pad)) == {
                key: counts[key] for key in ("loads", "steps", "staged",
                                             "direct")}
        else:
            assert counts["direct"] == counts["loads"]
        walked += int(steps.sum())
        # The step's route on the CPU is the same plain version.
        step = twta.epipolar_segment(v, d1, k * dl, dl, d_pad, *pen, BIG)
        assert torch.equal(step.view(torch.int32), want.view(torch.int32))
    if SHARD_WTA_EDGES[case][4] != "zero":
        assert walked > 0


def test_segment_edges_reach_the_cases_they_name():
    """The edge frames hold what SHARD_WTA_EDGES says: long clamped tails
    (x < d1), pixels whose diagonal misses a shard, pad planes at big,
    one plane a shard, both NaN confidences of 0 / 0, and the cases of
    K13's schedule."""
    vols, dl, d_pad, _, _, _, d1 = _frame("d1_last_narrow", False)
    xs = torch.arange(d1.shape[1])[None, :]
    assert bool((d1 > xs).all()) and dl > 1
    assert int(_counted_steps(d1, 0, dl, d_pad, d1.shape[1]).min()) == 0
    vols, dl, d_pad, _, _, _, _ = _frame("Dl1_pad_shard", False)
    assert dl == 1 and bool((vols[-1] == BIG).all())
    res = _merged("d1_last_narrow", False, seed_with_ref=False)[2]
    assert bool(res.conf_target.isnan().any())
    assert bool(_merged("one_shard", False)[2].conf_ref.isnan().any())
    # K13's schedule: segments of a row, the last one ragged; every
    # pixel walking a tail; outliers above and below the staged range.
    W = SHARD_WTA_EDGES["row_past_a_segment"][3]
    plan = k13_plan(W, 5, 10)
    assert plan["n_seg"] >= 2 and W % plan["seg"] != 0
    vols, dl, d_pad, _, _, _, d1 = _frame("all_tail", False)
    xs = torch.arange(d1.shape[1])[None, :]
    imax = d1.clamp(max=d_pad - 1)
    assert bool((xs + 1 < imax).all())
    vols, dl, d_pad, _, _, _, d1 = _frame("outliers_above_and_below", False)
    counts = k13_walk(n(vols[0]), n(d1), 0, dl, d_pad, None, None, BIG)[2]
    assert counts["above"] > 0 and counts["below"] > 0 and counts["staged"]
    # A block with no staged plane buffers its queue in the free ring.
    vols, dl, d_pad, _, _, _, d1 = _frame("sparse_second_shard", False)
    counts = k13_walk(n(vols[1]), n(d1), dl, dl, d_pad, None, None, BIG)[2]
    assert counts["buffered"] > 0 and counts["staged"] == 0
    assert counts["past_ring"] > 0


@pytest.mark.parametrize("W,n_local,total_disp,want", [
    (2880, 140, 280, (2, 1440, 1724)),      # a config-3 shard
    (384, 31, 62, (1, 384, 388)),           # a 288x384 shard
    (3101, 5, 10, (3, 1034, 1048)),         # a ragged last segment
    (1, 1, 1, (1, 1, 4)),
])
def test_segment_plan_sizes_the_ring(W, n_local, total_disp, want):
    """The walk's plan (csrc/wta_shard.cu's; tests/test_torch_cuda.py holds
    it to the built kernel's): equal segments of at most threads * pix
    columns, a slot for the widest window (the segment and the total_disp
    - 2 columns before it, within the row) and its 16-byte phase, rounded
    to 16 bytes; the ring, the queue and the coverage counts."""
    plan = k13_plan(W, n_local, total_disp)
    assert (plan["n_seg"], plan["seg"], plan["slot"]) == want
    assert plan["smem"] == (plan["ring"] * want[2] + 4 * want[1] + n_local
                            + 11) * 4
    assert plan["seg"] <= plan["threads"] * plan["pix"]
    assert plan["slot"] % 4 == 0


@pytest.mark.parametrize("W,n_local,total_disp", [(8000, 4, 6000),
                                                  (100, 60000, 10)])
def test_segment_plan_refuses_a_ring_that_does_not_fit(W, n_local,
                                                       total_disp):
    """Windows of 8000 columns, or 60000 planes' counts, are more than a
    block's shared memory: refused (the wrapper raises on the card)."""
    with pytest.raises(ValueError, match="does not fit"):
        k13_plan(W, n_local, total_disp)


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
    with pytest.raises(ValueError, match="walk"):
        ks.epipolar_segment(v, d1, 0, dl, d_pad, walk="diagonal")
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
