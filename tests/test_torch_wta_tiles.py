"""The WTA kernels K3/K4 (csrc/wta_gather.cu) walked in numpy exactly as
the CUDA code indexes:

  - K3: one thread per pixel walks every plane, ascending;
  - K4: one thread per pixel walks the first `head` planes of its diagonal
    (kernels/wta_gather.py `diag_head`), `unroll` planes per load batch; a
    longer diagonal in a warp with at most `sparse` such lanes leaves its
    tracker in the outputs and its pixel in the queue, whose entries a
    second pass walks to the end from that tracker; the other longer ones
    walk to the end at once.

Each walk must equal the plain versions (ops/wta_fast.py `_two_min_plain`
/ `_diag_two_min_plain`) bit for bit: the passes move where a compare
runs, never which compares run or their order.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from stereo_matchin_tpu_torch.kernels import wta_gather as kw
from stereo_matchin_tpu_torch.ops.wta_fast import (_diag_two_min_plain,
                                                   _two_min_plain)

from .torch_support import k4_queued, n, outlier_d1, t

BIG = np.float32(1e5)
F32 = np.float32
K4_THREADS, K4_UNROLL = 128, 8      # csrc/wta_gather.cu kThreadsK4, kUnrollK4


def _take_first(v, d, c1, c2, best):
    """K3's tracker, elementwise: strict '<' keeps the lowest d."""
    take = v < c1
    second = ~take & (v < c2)
    c2[...] = np.where(take, c1, np.where(second, v, c2))
    best[...] = np.where(take, d, best)
    c1[...] = np.where(take, v, c1)


def walk_two_min(cost, sc=None, ct=None, big=BIG, d0=0):
    """K3's outputs, in numpy f32: each pixel's planes in ascending order,
    plane d's penalty at disparity d0 + d."""
    D, H, W = cost.shape
    flat = cost.reshape(D, H * W)
    c1 = np.full(H * W, np.inf, F32)
    c2 = c1.copy()
    best = np.zeros(H * W, np.int32)
    for d in range(D):
        v = flat[d]
        if sc is not None:
            v = v + sc.reshape(-1) * np.abs(ct.reshape(-1) - F32(d0 + d))
        _take_first(v, d, c1, c2, best)
    anyv = c1 < big
    out = (np.minimum(c1, big), np.where(anyv, np.minimum(c2, big), big),
           np.where(anyv, best, 0).astype(np.int32))
    return tuple(o.reshape(H, W) for o in out)


def _take_last(v, b, big, c1, c2, bw):
    """K4's tracker, elementwise: skips !(v < big), '<=' keeps the largest
    b."""
    keep = v < big
    take = keep & (v <= c1)
    second = keep & ~take & (v < c2)
    return (np.where(take, v, c1), np.where(take, c1, np.where(second, v, c2)),
            np.where(take, b, bw))


def walk_diag(head, sparse, cost, d1, sc=None, ct=None, big=BIG,
              threads=K4_THREADS):
    """K4's outputs for one launch (both passes) with the first pass cut at
    `head` planes and warps of at most `sparse` longer lanes queued, in
    numpy f32, and the queue of pixels the first pass leaves to the
    second."""
    D, H, W = cost.shape
    HW = H * W
    assert threads % 32 == 0 and head >= 1
    p = np.arange(-(-HW // threads) * threads)
    inside = p < HW
    pc = np.minimum(p, HW - 1)
    x, y = pc % W, pc // W
    dd = np.where(inside, d1.reshape(HW)[pc], 0)
    lo, hi = np.maximum(1, dd - x), np.minimum(dd, D - 1)
    head_hi = np.where(hi - lo < head, hi, lo + head - 1)
    s = sc.reshape(HW)[pc] if sc is not None else None
    cen = ct.reshape(HW)[pc] if ct is not None else None

    def walk(first, last, c1, c2, bw):
        # Ascending planes, K4_UNROLL loads per batch: the order of compares
        # is the plane order whatever the batch.
        for b0 in range(1, D, K4_UNROLL):
            for b in range(b0, min(b0 + K4_UNROLL, D)):
                use = inside & (b >= first) & (b <= last)
                if not use.any():
                    continue
                col = np.clip(x - dd + b, 0, W - 1)
                v = cost[np.minimum(b, D - 1), y, col]
                if s is not None:
                    v = v + s * np.abs(cen - (dd - b).astype(F32))
                n1, n2, nb = _take_last(v, b, big, c1, c2, bw)
                c1, c2, bw = (np.where(use, n1, c1), np.where(use, n2, c2),
                              np.where(use, nb, bw))
        return c1, c2, bw

    inf = np.full(p.shape, np.inf, F32)
    c1, c2, bw = walk(lo, head_hi, inf, inf.copy(), np.zeros(p.shape, np.int32))
    longer = inside & (head_hi < hi)
    lanes = np.repeat(longer.reshape(-1, 32).sum(1), 32)    # per warp
    more = longer & (lanes <= sparse)
    never = np.iinfo(np.int32).max
    c1, c2, bw = walk(np.where(longer & ~more, head_hi + 1, never), hi, c1,
                      c2, bw)
    queue = np.flatnonzero(more)
    # The second pass: the queued pixels continue from their trackers.
    c1, c2, bw = walk(np.where(more, lo + head, never), hi, c1, c2, bw)
    anyv = c1 < big
    b0 = np.clip(dd - x, 0, D - 1)
    out = (np.minimum(c1, big), np.where(anyv, np.minimum(c2, big), big),
           np.where(anyv, bw, dd).astype(np.int32),
           cost[b0, y, np.clip(x - dd + b0, 0, W - 1)])
    return tuple(o[:HW].reshape(H, W) for o in out), queue


def _volume(rng, D, H, W):
    """Small integers (exact ties) with planes at or above the big cap over
    a corner, as chip_smoke.py's WTA checks."""
    cost = rng.integers(0, 30, (D, H, W)).astype(F32)
    cost[:, :3, :5] = 2e5
    return cost


def _d1(kind, rng, D, H, W, argmin):
    return {"argmin": argmin, "zero": np.zeros((H, W), np.int32),
            "last": np.full((H, W), D - 1, np.int32),
            "random": rng.integers(0, D, (H, W)).astype(np.int32),
            "outliers": outlier_d1(rng, D, H, W, kw.diag_head(D))}[kind]


def _same(got, want):
    for g, w in zip(got, want):
        w = n(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


# (D, H, W, K4's d1): one plane; three planes; H*W odd; W under a warp and
# W off a block; d1 = 0; d1 = D - 1 with every pixel of a narrow frame in
# the left band x < d1; uniform random d1; short d1 with a few outliers per
# warp at config 3's depth (the second pass walks them from the queue).
CASES = {
    "D1": (1, 6, 40, "argmin"),
    "D3": (3, 6, 40, "argmin"),
    "HW_odd": (9, 5, 43, "random"),
    "HW_even": (9, 4, 40, "argmin"),
    "W_under_warp_left_band": (7, 4, 20, "last"),
    "W_off_block": (12, 3, 150, "random"),
    "d1_zero": (9, 4, 64, "zero"),
    "d1_last_left_band": (40, 3, 50, "last"),
    "d1_uniform": (30, 4, 140, "random"),
    "d1_outliers_D280": (280, 2, 330, "outliers"),
}


# K4's (head, sparse): the wrapper's; one plane, every longer lane queued;
# three planes, up to 4 lanes of a warp queued; three planes, none queued.
HEADS = {"plan": None, "head1_all": (1, 32), "head3_sparse4": (3, 4),
         "head3_none": (3, 0)}


@pytest.mark.parametrize("head", list(HEADS))
@pytest.mark.parametrize("with_penalty", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_plan_walks_equal_plain(case, with_penalty, head):
    D, H, W, kind = CASES[case]
    rng = np.random.default_rng(D * H + W)
    cost = _volume(rng, D, H, W)
    sc = rng.uniform(0, 2, (H, W)).astype(F32) if with_penalty else None
    ct = rng.integers(0, D, (H, W)).astype(F32) if with_penalty else None
    pen = (None, None) if sc is None else (t(sc), t(ct))
    want = _two_min_plain(t(cost), *pen, big=float(BIG))
    _same(walk_two_min(cost, sc, ct), want)
    d1 = _d1(kind, rng, D, H, W, n(want[2]))
    hd, sparse = HEADS[head] or (kw.diag_head(D), kw.K4_SPARSE)
    got, queue = walk_diag(hd, sparse, cost, d1, sc, ct)
    _same(got, _diag_two_min_plain(t(cost), t(d1), *pen, big=float(BIG)))
    assert np.array_equal(queue, k4_queued(d1, D, hd, sparse))
    if head == "head1_all":
        assert np.array_equal(queue, k4_queued(d1, D, 1, 32))
    if kind == "outliers" and head == "plan":
        assert len(queue) > 0          # the second pass has work


@pytest.mark.parametrize("with_penalty", [False, True])
@pytest.mark.parametrize("D", [1, 2, 5, 64, 65, 280])
def test_two_min_walk_any_depth(D, with_penalty):
    """K3's walk at depths from one plane to config 3's, on integer
    volumes (exact ties) with a block of planes at the big cap."""
    H, W = 3, 37
    rng = np.random.default_rng(D)
    cost = _volume(rng, D, H, W)
    sc = rng.uniform(0, 2, (H, W)).astype(F32) if with_penalty else None
    ct = rng.integers(0, D, (H, W)).astype(F32) if with_penalty else None
    pen = (None, None) if sc is None else (t(sc), t(ct))
    _same(walk_two_min(cost, sc, ct),
          _two_min_plain(t(cost), *pen, big=float(BIG)))


@pytest.mark.parametrize("with_penalty", [False, True])
@pytest.mark.parametrize("d0", [1, 70, 279])
def test_two_min_walk_at_a_disparity_offset(d0, with_penalty):
    """K3 over a disparity shard: plane d holds disparity d0 + d, which
    only the penalty sees; d1 stays the plane index."""
    D, H, W = 9, 4, 29
    rng = np.random.default_rng(d0)
    cost = _volume(rng, D, H, W)
    sc = rng.uniform(0, 2, (H, W)).astype(F32) if with_penalty else None
    ct = (rng.integers(0, d0 + D, (H, W)).astype(F32) if with_penalty
          else None)
    pen = (None, None) if sc is None else (t(sc), t(ct))
    _same(walk_two_min(cost, sc, ct, d0=d0),
          _two_min_plain(t(cost), *pen, big=float(BIG), d0=d0))


@pytest.mark.parametrize("sparse", [0, 6, 32])
@pytest.mark.parametrize("threads", [32, 96])
def test_diag_walk_any_block(sparse, threads):
    """Blocks of one and of three warps (the last one ragged) on uniform
    random d1, queueing none, some or all of the longer diagonals, with
    and without the penalty."""
    D, H, W = 23, 3, 70
    rng = np.random.default_rng(sparse + threads)
    cost = _volume(rng, D, H, W)
    sc = rng.uniform(0, 2, (H, W)).astype(F32)
    ct = rng.integers(0, D, (H, W)).astype(F32)
    d1 = rng.integers(0, D, (H, W)).astype(np.int32)
    for pen in ((None, None), (sc, ct)):
        tp = (None, None) if pen[0] is None else (t(sc), t(ct))
        _same(walk_diag(5, sparse, cost, d1, *pen, threads=threads)[0],
              _diag_two_min_plain(t(cost), t(d1), *tp, big=float(BIG)))


def test_diag_walk_d1_outside_the_volume():
    """A d1 outside [0, D - 1] (no caller passes one) gives the plain
    version's results: its reads clamp into the volume."""
    D, H, W = 9, 3, 40
    rng = np.random.default_rng(8)
    cost = _volume(rng, D, H, W)
    d1 = rng.integers(0, D, (H, W)).astype(np.int32)
    d1[0, 10], d1[1, 3], d1[2, 30] = D + 4, -3, D
    for head, sparse in ((2, 32), (2, 0), (kw.diag_head(D), kw.K4_SPARSE)):
        _same(walk_diag(head, sparse, cost, d1)[0],
              _diag_two_min_plain(t(cost), t(d1), big=float(BIG)))


# The launches of REFERENCE_CONFIG at 288x384 (one pass: every diagonal
# fits the first), and of BASELINE config 3 (1988x2880, 280 planes): phase
# 14's band tail of chip_smoke.py and the whole frame (two passes).
@pytest.mark.parametrize("D,H,W,two_passes", [(61, 288, 384, False),
                                              (280, 578, 2880, True),
                                              (280, 1988, 2880, True)])
def test_plans_at_the_main_path_shapes(D, H, W, two_passes):
    head = kw.diag_head(D)
    assert head == min(kw.K4_HEAD, D)
    assert (head < D - 1) == two_passes
    assert H * W < 2 ** 31 - 1


def test_plans_that_do_not_fit_raise_and_wrappers_never_fall_back(
        monkeypatch):
    """A first pass of no plane raises ValueError; a wrapper given a tensor
    that is not on the CPU launches (here: refuses the meta device) and
    never takes the plain version."""
    monkeypatch.setattr(kw, "K4_HEAD", 0)
    with pytest.raises(ValueError, match="K4 is not compiled"):
        kw.diag_head(8)
    monkeypatch.undo()
    cost = torch.empty((8, 4, 64), device="meta")
    d1 = torch.empty((4, 64), dtype=torch.int32, device="meta")

    def plain(*a, **k):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(kw, "_two_min_plain", plain)
    monkeypatch.setattr(kw, "_diag_two_min_plain", plain)
    with pytest.raises(ValueError, match="CUDA kernel"):
        kw.two_min(cost)
    with pytest.raises(ValueError, match="CUDA kernel"):
        kw.wta_diag(cost, d1)
