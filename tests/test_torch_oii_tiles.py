"""The OII passes K7 (csrc/cross_oii.cu oii_v_kernel / oii_h_kernel) walked
in numpy exactly as the CUDA code indexes, under their plan
(kernels/cross_oii.py `oii_tiles`):

  - both axes: a block owns a tile of pixels and a chunk of dc planes; it
    stages the chunk's right arms of its rows at columns ca .. ca + aw - 1
    (clipped to the frame), each thread keeps its pixels' left arms in
    registers, and per plane the block stages the volume the tile's
    windows reach: axis 1 the rows rb .. rb + ty + 2L - 1 of its 32
    columns (only rows whose frame row lies in 1 .. h_glob - 1), axis 2
    the row segments sb .. sb + tx + 2 * halo - 1 (only columns 0 .. W - 1),
    in 16-byte copies where W % 4 == 0 and the volume is aligned;
  - each thread owns OII_ROWS rows (axis 1) or OII_COLS consecutive columns
    (axis 2) of outputs, walks the union of their windows once, ascending,
    reading each staged value once (axis 2: OII_COLS columns a load) and
    adding it to every output whose window holds it (skipping the others),
    unconditionally over the positions that every window holds (axis 2:
    before those, testing each window's start only, after them its end);
    then one IEEE division.

Unstaged shared words hold NaN, so a read of one into a sum shows as a
mismatch.  Each walk must equal the plain version (ops/oii.py
`oii_pass_plain`) bit for bit: the tiles move where a tap is read, never
the order of an output's adds.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from stereo_matchin_tpu_torch.kernels import cross_oii as kc
from stereo_matchin_tpu_torch.ops.oii import combined_arms, oii_pass_plain

from .torch_support import OII_EDGES, n, oii_inputs, t

FAR = 1 << 30                   # csrc/cross_oii.cu kOiiFar


def check_plan(plan, D, H, W, L, axis):
    tx, ty, dc = plan.tx, plan.ty, plan.dc
    if axis == 1:
        assert (tx, ty, plan.halo) == (32, kc.OII_WARPS * kc.OII_ROWS, L)
        assert plan.stage_bytes == 4 * 32 * (ty + 2 * L)
    else:
        assert (tx, ty) == (32 * kc.OII_COLS, kc.OII_WARPS)
        assert plan.halo % 4 == 0 and L <= plan.halo < L + 4
        assert plan.stage_bytes == 4 * ty * (tx + 2 * plan.halo)
    assert plan.arm_bytes == 8 * ty * (tx + dc - 1)
    assert plan.stage_bytes % 16 == 0
    assert plan.shared_bytes == 2 * plan.stage_bytes + plan.arm_bytes
    assert plan.shared_bytes <= kc.SHARED_LIMIT
    assert plan.grid == (-(-W // tx), -(-H // ty), plan.chunks)
    assert dc * (plan.chunks - 1) < D <= dc * plan.chunks


def windows(i, m, p, L, first, last):
    """csrc window(): first position, count and divisor of each output."""
    lo = np.maximum(i + np.minimum(np.maximum(m, -L), L + 1), first)
    hi = np.minimum(i + np.maximum(np.minimum(p, L), -L - 1), last)
    return lo, np.maximum(hi - lo + 1, 0), (p - m).astype(np.float32)


def union_and_core(lo, cnt):
    """csrc union_and_core() over the last axis (a thread's outputs)."""
    live = cnt > 0
    a = np.where(live, lo, FAR).min(-1)
    b = np.where(live, lo + cnt - 1, -FAR).max(-1)
    c0 = np.where(live, lo, -FAR).max(-1)
    c1 = np.where(live, lo + cnt - 1, FAR).min(-1)
    none = ~live.all(-1) | (c0 > c1)
    return a, b, np.where(none, b + 1, c0), np.where(none, b, c1)


def add_masked(acc, lo, cnt, r, v, act, core=False, start=True, end=True):
    """csrc add_masked() (or, in the core, the unconditional adds; with
    end=False add_from(), with start=False add_until()) at position r [...]
    of every thread where act, value v [...]: added where the bounds tested
    hold r, skipped elsewhere."""
    r = r[..., None]
    inw = core | (((r >= lo) | ~start) & ((r < lo + cnt) | ~end))
    return np.where(act[..., None] & inw, acc + v[..., None], acc)


def staged_arms(arms_r, planes, rows, x, d, d0, ca, aw, H, W):
    """The right arms a thread reads at max(x - d0 - d, 0) from the chunk's
    staged [ty][aw] columns ca .. : the index lies in the staging and the
    entry was staged (row and column inside the frame)."""
    k = np.maximum(x - d0 - d, 0) - ca
    assert (k >= 0).all() and (k < aw).all()
    col = ca + k
    assert (rows < H).all() and (col < W).all()
    return arms_r[planes[0]][rows, col], arms_r[planes[1]][rows, col]


def walk_v(vol, al, ar, L, d0=0, row0=0, h_glob=None, aligned=True,
           plan=None):
    """oii_v_kernel's output: block by block, plane by plane."""
    D, H, W = vol.shape
    h_glob = H if h_glob is None else h_glob
    plan = plan or kc.oii_tiles(D, H, W, L, 1)
    check_plan(plan, D, H, W, L, 1)
    R, TY, dc = kc.OII_ROWS, plan.ty, plan.dc
    gx, gy, chunks = plan.grid
    Rs, aw = TY + 2 * L, 32 + dc - 1
    vec = W % 4 == 0 and aligned
    r_first, r_last = max(0, 1 - row0), min(H - 1, h_glob - 1 - row0)
    out = np.full((D, H, W), np.nan, np.float32)
    written = np.zeros((D, H, W), np.int32)
    lane = np.arange(32)
    i_row = (np.arange(kc.OII_WARPS)[:, None, None] * R
             + np.arange(R)[None, None, :])                    # [8, 1, R]
    for by in range(gy):
        yb = TY * by
        rb = yb - L
        y = yb + i_row + 0 * lane[None, :, None]               # [8, 32, R]
        for bx in range(gx):
            x0 = 32 * bx
            x = x0 + lane[None, :, None] + 0 * y
            valid = (x < W) & (y < H)
            yc, xc = np.minimum(y, H - 1), np.minimum(x, W - 1)
            ml = np.where(valid, al[2][yc, xc], 0)
            pl = np.where(valid, al[3][yc, xc], 0)
            for z in range(chunks):
                d_lo = dc * z
                ca = max(x0 - d0 - d_lo - dc + 1, 0)
                for d in range(d_lo, min(d_lo + dc, D)):
                    stage = np.full((Rs, 32), np.nan, np.float32)
                    for k in range(Rs):
                        r = rb + k
                        if not r_first <= r <= r_last:
                            continue
                        for c in range(0, 32, 4 if vec else 1):
                            if x0 + c < W:
                                w = 4 if vec else 1
                                assert x0 + c + w <= W
                                stage[k, c:c + w] = vol[d, r, x0 + c:x0 + c + w]
                    mr, pr = staged_arms(ar, (2, 3), yc[valid], x[valid], d,
                                         d0, ca, aw, H, W)
                    m, p = ml.copy(), pl.copy()
                    m[valid] = np.maximum(m[valid], mr)
                    p[valid] = np.minimum(p[valid], pr)
                    lo, cnt, div = windows(y, m, p, L, r_first, r_last)
                    cnt = np.where(valid, cnt, 0)
                    a, b, c0, c1 = union_and_core(lo, cnt)
                    acc = np.zeros(y.shape, np.float32)
                    for s in range(int(np.maximum(b - a + 1, 0).max())):
                        r = a + s                                # [8, 32]
                        act = r <= b
                        k = np.where(act, r - rb, 0)
                        assert ((k >= 0) & (k < Rs))[act].all()
                        v = stage[k, lane[None, :]]
                        acc = add_masked(acc, lo, cnt, r, v, act,
                                         ((r >= c0) & (r <= c1))[..., None])
                    with np.errstate(divide="ignore", invalid="ignore"):
                        res = acc / div
                    out[d, y[valid], x[valid]] = res[valid]
                    written[d, y[valid], x[valid]] += 1
    assert (written == 1).all()
    return out


def walk_h(vol, al, ar, L, d0=0, aligned=True, plan=None):
    """oii_h_kernel's output: block by block, plane by plane."""
    D, H, W = vol.shape
    plan = plan or kc.oii_tiles(D, H, W, L, 2)
    check_plan(plan, D, H, W, L, 2)
    C, TX, TY, dc, LA = kc.OII_COLS, plan.tx, plan.ty, plan.dc, plan.halo
    gx, gy, chunks = plan.grid
    SW, aw = TX + 2 * LA, TX + dc - 1
    w = 4 if W % 4 == 0 and aligned else 1        # copy width, floats
    out = np.full((D, H, W), np.nan, np.float32)
    written = np.zeros((D, H, W), np.int32)
    lane = np.arange(32)
    warp = np.arange(TY)
    for by in range(gy):
        y = (TY * by + warp)[:, None, None] + np.zeros((1, 32, C), int)
        rows = TY * by + warp
        for bx in range(gx):
            x0 = TX * bx
            sb = x0 - LA
            x = x0 + C * lane[None, :, None] + np.arange(C) + 0 * y
            valid = (x < W) & (y < H)
            yc, xc = np.minimum(y, H - 1), np.minimum(x, W - 1)
            ml = np.where(valid, al[0][yc, xc], 0)
            pl = np.where(valid, al[1][yc, xc], 0)
            for z in range(chunks):
                d_lo = dc * z
                ca = max(x0 - d0 - d_lo - dc + 1, 0)
                for d in range(d_lo, min(d_lo + dc, D)):
                    stage = np.full((TY, SW), np.nan, np.float32)
                    for q in range(0, SW, w):
                        if 0 <= sb + q < W:
                            assert sb + q + w <= W
                            live = rows < H
                            stage[live, q:q + w] = vol[d, rows[live],
                                                       sb + q:sb + q + w]
                    mr, pr = staged_arms(ar, (0, 1), yc[valid], x[valid], d,
                                         d0, ca, aw, H, W)
                    m, p = ml.copy(), pl.copy()
                    m[valid] = np.maximum(m[valid], mr)
                    p[valid] = np.minimum(p[valid], pr)
                    lo, cnt, div = windows(x, m, p, L, 1, W - 1)
                    cnt = np.where(valid, cnt, 0)
                    a, b, c0, c1 = union_and_core(lo, cnt)
                    some = a <= b
                    assert (a[some] >= 1).all()
                    ga, gb = a // C, b // C
                    g0, g1 = (c0 + C - 1) // C, (c1 + 1) // C - 1
                    cored = (c0 <= c1) & (g0 <= g1)
                    acc = np.zeros(x.shape, np.float32)
                    for s in range(int(np.where(some, gb - ga + 1, 0).max())):
                        g = ga + s                               # [TY, 32]
                        act = some & (g <= gb)
                        k = np.where(act, g * C - sb, 0)
                        assert (k % C == 0).all()                # C-wide loads
                        assert ((k >= 0) & (k + C <= SW))[act].all()
                        core = (cored & (g >= g0) & (g <= g1))[..., None]
                        start = (~cored | (g < g0))[..., None]
                        end = (~cored | (g > g1))[..., None]
                        for e in range(C):
                            v = stage[warp[:, None], k + e]
                            acc = add_masked(acc, lo, cnt, g * C + e, v, act,
                                             core, start, end)
                    with np.errstate(divide="ignore", invalid="ignore"):
                        res = acc / div
                    out[d, y[valid], x[valid]] = res[valid]
                    written[d, y[valid], x[valid]] += 1
    assert (written == 1).all()
    return out


def plain(vol, al, ar, L, axis, d0=0, row0=0, h_glob=None):
    return n(oii_pass_plain(t(vol), t(al), t(ar), L, axis, d0, row0, h_glob))


def bits_equal(got, want):
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("case", list(OII_EDGES))
def test_oii_walks_equal_plain(case, axis, monkeypatch):
    D, H, W, L, d0, row0, h_glob, full = OII_EDGES[case]
    if case == "D45_chunks":
        monkeypatch.setattr(kc, "OII_BLOCKS", 1)
        plan = kc.oii_tiles(D, H, W, L, axis)
        assert (plan.dc, plan.chunks) == (23, 2)
    rng = np.random.default_rng(D * 31 + H * W + L)
    vol, al, ar = oii_inputs(rng, D, H, W, L, full)
    if axis == 1:
        got = walk_v(vol, al, ar, L, d0, row0, h_glob)
        want = plain(vol, al, ar, L, 1, d0, row0, h_glob)
    else:
        got = walk_h(vol, al, ar, L, d0)
        want = plain(vol, al, ar, L, 2, d0)
    bits_equal(got, want)
    # The windows of these inputs: some of 2L + 1 taps with `full`, else
    # some of one tap where a window starts at column 0 or frame row 0.
    planes = (2, 3) if axis == 1 else (0, 1)
    m, p = (n(a) for a in combined_arms(t(al), t(ar), D, *planes, d0))
    if axis == 1:
        i = np.arange(H)[None, :, None]
        first, last = max(0, 1 - row0), min(H - 1, (h_glob or H) - 1 - row0)
    else:
        i, first, last = np.arange(W)[None, None, :], 1, W - 1
    cnt = windows(i, m, p, L, first, last)[1]
    if full:
        assert (cnt == 2 * L + 1).any()
        assert np.isfinite(want).all() and (want > 0).all()
    elif axis == 2 or row0 == 0:
        assert (cnt == 1).any()


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("axis", [1, 2])
def test_oii_walks_on_and_off_16_byte_alignment(axis, aligned, monkeypatch):
    """A volume on a 16-byte boundary (16-byte copies) and one off it
    (4-byte copies), W % 4 == 0, with chunks of several planes."""
    monkeypatch.setattr(kc, "OII_BLOCKS", 1)
    D, H, W, L = 5, 67, 72, 5
    assert kc.oii_tiles(D, H, W, L, axis).dc == D
    vol, al, ar = oii_inputs(np.random.default_rng(axis), D, H, W, L)
    want = plain(vol, al, ar, L, axis, 2)
    walk = walk_v if axis == 1 else walk_h
    bits_equal(walk(vol, al, ar, L, 2, aligned=aligned), want)


def test_oii_plans_at_the_main_path_shapes():
    """288x384 at REFERENCE_CONFIG (D = 61) and config 3's band and whole
    frame (D = 280): rows of 4 (axis 1) and columns of 2 (axis 2) a thread;
    32-plane chunks at most, more where the grid is small; the shared bytes
    each block takes."""
    v = kc.oii_tiles(61, 288, 384, 25, 1)
    assert (v.tx, v.ty, v.dc, v.chunks) == (32, 32, 7, 9)
    assert v.grid == (12, 9, 9) and v.shared_bytes == 2 * 10496 + 9728
    h = kc.oii_tiles(61, 288, 384, 25, 2)
    assert (h.tx, h.ty, h.halo, h.dc, h.chunks) == (64, 8, 28, 13, 5)
    assert h.grid == (6, 36, 5) and h.shared_bytes == 2 * 3840 + 4864
    for H in (526, 1988):
        v, h = kc.oii_tiles(280, H, 2880, 25, 1), kc.oii_tiles(280, H, 2880, 25, 2)
        assert (v.dc, v.chunks, v.shared_bytes) == (32, 9, 37120)
        assert (h.dc, h.chunks, h.shared_bytes) == (32, 9, 13760)
        assert v.grid[:2] == (90, -(-H // 32)) and h.grid[:2] == (45, -(-H // 8))


def test_oii_plans_that_do_not_fit_raise_and_the_wrapper_never_falls_back(
        monkeypatch):
    """No plan where one plane's stages pass SHARED_LIMIT (a long L), the
    grid is too tall, a plane passes 2^31 - 1 pixels, D < 1 or the axis is
    neither; chunks are halved until the arms fit.  The wrapper given a
    tensor that is not on the CPU launches (here: refuses the meta device)
    and never takes the plain version."""
    with pytest.raises(ValueError, match="no K7 plan for L=423 on axis 1"):
        kc.oii_tiles(5, 64, 64, 423, 1)
    edge = kc.oii_tiles(5, 64, 64, 422, 1)
    assert edge.dc == 1 and edge.shared_bytes == kc.SHARED_LIMIT
    with pytest.raises(ValueError, match="no K7 plan for L=1753 on axis 2"):
        kc.oii_tiles(5, 64, 64, 1753, 2)
    assert kc.oii_tiles(5, 64, 64, 1752, 2).shared_bytes == kc.SHARED_LIMIT
    with pytest.raises(ValueError, match="no K7 plan for 600000 rows"):
        kc.oii_tiles(5, 600_000, 8, 3, 2)
    with pytest.raises(ValueError, match="passes 2"):
        kc.oii_tiles(5, 65_536, 32_768, 3, 1)
    with pytest.raises(ValueError, match="no K7 plan for D=0"):
        kc.oii_tiles(0, 8, 8, 3, 1)
    with pytest.raises(ValueError, match="axis must be"):
        kc.oii_tiles(5, 8, 8, 3, 0)
    halved = kc.oii_tiles(64, 1024, 1024, 410, 1)
    assert (halved.dc, halved.chunks) == (16, 4)
    assert halved.shared_bytes <= kc.SHARED_LIMIT
    assert 2 * halved.stage_bytes + 8 * 32 * (32 + 32 - 1) > kc.SHARED_LIMIT

    def plain_route(*a, **k):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(kc, "oii_pass_plain", plain_route)
    vol = torch.empty((4, 8, 64), dtype=torch.float32, device="meta")
    arms = torch.empty((4, 8, 64), dtype=torch.int32, device="meta")
    for axis in (1, 2):
        with pytest.raises(ValueError, match="CUDA kernel"):
            kc.oii_pass(vol, arms, arms, 25, axis)
