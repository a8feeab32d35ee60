"""The histogram-vote kernels K8 (csrc/cross_oii.cu) walked in numpy exactly
as the CUDA code indexes, under their plans (kernels/cross_oii.py
`vote_h_tiles` / `vote_v_tiles`):

  - vote_h: a block owns VOTE_H_TX pixels of one row and one chunk of dc
    planes; it stages the row's bins at clamped columns, zeroes a
    [dc][VOTE_H_PITCH] uint8 tile, and each thread adds its pixel's runs of
    equal bins to its own column, skipping bins outside the chunk, before
    the tile goes out;
  - vote_v: a block owns 32 columns and g * TY rows; its warps are g row
    warps times p plane groups, each group over a contiguous range of
    planes, two per step; a group stages both planes' rows clamp(y0 - L +
    r), each row warp forms the column prefix of its own rows with plane d
    in the low and plane d + 1 in the high 16 bits of a uint32, and reads
    each pixel's window of both planes as one difference of two prefix
    entries, '>=' over ascending d; the groups' results meet in ascending
    order with '>=' again.

Each walk must equal the plain versions (ops/vote.py `vote_counts_plain` /
`vote_mode_plain`) exactly: the plans move where a count is taken, never
what is counted.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from stereo_matchin_tpu_torch.kernels import cross_oii as kc
from stereo_matchin_tpu_torch.ops.vote import vote_counts_plain, vote_mode_plain

from .torch_support import VOTE_EDGES, n, t, vote_inputs

GARBAGE = 0xA5          # what an unwritten shared or output byte holds here


def walk_vote_h(idx, arms, D, L, plan=None):
    """vote_h's output, block by block (the rows of a block column at once):
    staged bins, per-thread runs into the tile, the tile written out."""
    H, W = idx.shape
    plan = plan or kc.vote_h_tiles(D, H, W, L)
    TX, PITCH = kc.VOTE_H_TX, kc.VOTE_H_PITCH
    assert plan.grid == (-(-W // TX), H, plan.chunks)
    assert plan.dc * PITCH + 4 * (TX + 2 * L) == plan.shared_bytes
    assert plan.shared_bytes <= kc.VOTE_H_SHARED
    assert plan.dc * (plan.chunks - 1) < D <= plan.dc * plan.chunks
    rc = np.full((D, H, W), GARBAGE, np.uint8)
    written = np.zeros((D, H, W), bool)
    lane = np.arange(TX)
    for bx in range(plan.grid[0]):
        x0 = bx * TX
        bins = idx[:, np.clip(x0 - L + np.arange(TX + 2 * L), 0, W - 1)]
        inside = np.broadcast_to(x0 + lane < W, (H, TX))
        xc = np.minimum(x0 + lane, W - 1)
        lo = np.maximum(arms[0][:, xc], -L)
        hi = np.minimum(arms[1][:, xc], L)
        rows = np.arange(H)[:, None].repeat(TX, 1)
        cols = lane[None].repeat(H, 0)
        for z in range(plan.chunks):
            d_lo = z * plan.dc
            nd = min(plan.dc, D - d_lo)
            tile = np.full((H, plan.dc, PITCH), GARBAGE, np.int64)
            tile[:, :nd] = 0
            cur = np.zeros((H, TX), np.int64)
            run = np.zeros((H, TX), np.int64)

            def flush(mask):
                m = mask & inside & (run > 0) & (cur < nd)
                assert (cur[m] < plan.dc).all()      # never outside the tile
                r, c, k = rows[m], cols[m], cur[m]
                tile[r, k, c] = (tile[r, k, c] + run[m]) & 0xFF

            for j in range(-L, L + 1):
                act = inside & (j >= lo) & (j <= hi)
                k = (bins[:, lane + L + j].astype(np.int64) - d_lo) & 0xFFFFFFFF
                new = act & (k != cur)
                flush(new)
                cur = np.where(new, k, cur)
                run = np.where(new, 0, run) + act
            flush(np.ones((H, TX), bool))
            w = min(TX, W - x0)
            if W % 16 == 0:
                assert w % 16 == 0                   # 16-byte stores only
            rc[d_lo:d_lo + nd, :, x0:x0 + w] = tile[:, :nd, :w].transpose(1, 0, 2)
            written[d_lo:d_lo + nd, :, x0:x0 + w] = True
    assert written.all()
    return rc


def walk_vote_v(rc, arms, L, plan=None, garbage_rng=None):
    """vote_v's output: every block at once, plane group by plane group,
    two planes a step; a group's staged rows clamped, columns past W and a
    missing second plane garbage; each row warp's packed prefix over its
    own rows, one 32-bit difference per pixel; the groups' results met in
    ascending order."""
    D, H, W = rc.shape
    plan = plan or kc.vote_v_tiles(D, H, W, L)
    TY, G, P, Rw = plan.ty, plan.g, plan.p, plan.rows
    Rs = G * TY + 2 * L                             # a group's staged rows
    assert Rw == TY + 2 * L <= kc.VOTE_V_ROWS
    assert 1 <= G <= kc.VOTE_V_ROW_WARPS and 1 <= P <= max(1, min(
        kc.VOTE_V_GROUPS, D))
    assert plan.stage_bytes == 128 * Rs and plan.stage_bytes % 16 == 0
    assert plan.region >= 128 * (Rw + 1) and plan.region >= 256 * TY
    assert plan.region % 16 == 0
    assert plan.shared_bytes == P * plan.stage_bytes + G * P * plan.region
    assert plan.shared_bytes <= kc.SHARED_LIMIT
    gx, gy = plan.grid
    assert (gx, gy) == (-(-W // 32), -(-H // (G * TY)))
    Wp = 32 * gx
    rng = garbage_rng or np.random.default_rng(0)
    srow = np.clip(G * TY * np.arange(gy)[:, None] - L + np.arange(Rs), 0,
                   H - 1)                                     # [gy, Rs]
    # Pixel (block row b, row warp g, i, column x): frame row b*G*TY + g*TY
    # + i; its window's prefix rows ra, rb in the warp's prefix.
    yy = (G * TY * np.arange(gy)[:, None, None] + TY * np.arange(G)[:, None]
          + np.arange(TY))                                    # [gy, G, TY]
    yc = np.minimum(yy, H - 1)
    valid = (yy[..., None] < H) & (np.arange(Wp) < W)         # [gy, G, TY, Wp]
    xc = np.minimum(np.arange(Wp), W - 1)
    vm = arms[2][yc][..., xc]
    vp = arms[3][yc][..., xc]
    lo = np.where(valid, np.minimum(np.maximum(vm, -L), L + 1), 0)
    hi = np.where(valid, np.maximum(np.minimum(vp, L), lo - 1), -1)
    i = np.arange(TY)[:, None]
    ra, rb = i + L + hi + 1, i + L + lo
    assert (rb >= 0).all() and (ra >= rb).all() and (ra <= Rw).all()
    b = np.arange(gy)[:, None, None, None]
    g = np.arange(G)[None, :, None, None]
    x = np.arange(Wp)
    rows_of_warp = TY * np.arange(G)[:, None] + np.arange(Rw)  # [G, Rw]
    assert rows_of_warp.max() < Rs

    def staged(d):
        st = rng.integers(0, 256, (gy, Rs, Wp)).astype(np.int64)
        if d is not None:
            st[..., :W] = rc[d][srow]
        return st[:, rows_of_warp]                    # [gy, G, Rw, Wp]

    results = []
    for pg in range(P):
        best = np.full(yy.shape + (Wp,), -1, np.int64)
        best_d = np.zeros(yy.shape + (Wp,), np.int64)
        d_begin, d_end = pg * D // P, (pg + 1) * D // P
        for d in range(d_begin, d_end, 2):
            second = d + 1 < d_end
            lo16, hi16 = staged(d), staged(d + 1 if second else None)
            pre = np.zeros((gy, G, Rw + 1, Wp), np.int64)
            pre[:, :, 1:] = np.cumsum(lo16 | hi16 << 16, axis=2) & 0xFFFFFFFF
            # Neither half carries: each is at most 255 * Rw <= 65535.
            assert np.cumsum(lo16, axis=2).max() <= 0xFFFF
            assert np.cumsum(hi16, axis=2).max() <= 0xFFFF
            diff = (pre[b, g, ra, x] - pre[b, g, rb, x]) & 0xFFFFFFFF
            for plane, tab, use in ((d, diff & 0xFFFF, True),
                                    (d + 1, diff >> 16, second)):
                take = use & (tab >= best)
                best = np.where(take, tab, best)
                best_d = np.where(take, plane, best_d)
        results.append((best, best_d))
    bv = np.full(yy.shape + (Wp,), -1, np.int64)
    bd = np.zeros(yy.shape + (Wp,), np.int64)
    for best, best_d in results:                  # ascending plane groups
        take = best >= bv
        bv, bd = np.where(take, best, bv), np.where(take, best_d, bd)
    return bd.reshape(gy * G * TY, Wp)[:H, :W].astype(np.int32)


def plan_with(D, H, W, L, g, p):
    """vote_v's plan with its row warps and plane groups forced."""
    plan = kc.vote_v_tiles(D, H, W, L)
    stage = 128 * (g * plan.ty + 2 * L)
    return plan._replace(g=g, p=p, stage_bytes=stage,
                         grid=(plan.grid[0], -(-H // (g * plan.ty))),
                         shared_bytes=p * stage + g * p * plan.region)


@pytest.mark.parametrize("case", list(VOTE_EDGES))
def test_vote_walks_equal_plain(case):
    H, W, D, L = VOTE_EDGES[case]
    rng = np.random.default_rng(D * 7 + H * W + L)
    idx, arms = vote_inputs(rng, D, H, W, L)
    want = n(vote_counts_plain(t(idx), t(arms), D, L))
    rc = walk_vote_h(idx, arms, D, L)
    np.testing.assert_array_equal(rc, want)
    np.testing.assert_array_equal(walk_vote_v(rc, arms, L),
                                  n(vote_mode_plain(t(want), t(arms), L)))
    if case == "D_chunks_700":
        assert kc.vote_h_tiles(D, H, W, L).chunks == 3
    if case == "L127_groups_cut":
        assert kc.vote_v_tiles(D, H, W, L)[:3] == (2, 2, 2)


@pytest.mark.parametrize("L", [1, 2, 8, 25, 120, 121, 127, 128])
def test_vote_v_walk_every_row_count(L):
    """TY = 16 down to 1 as L grows (TY + 2L <= 257), on counts as large as
    uint8 holds, so the prefix reaches its uint16 limit at TY = 1, L = 128:
    255 * 257 = 65535."""
    D, H, W = 3, 19, 37
    rng = np.random.default_rng(L)
    rc = rng.integers(200, 256, (D, H, W)).astype(np.uint8)
    if L == 128:
        rc[:] = 255
    _, arms = vote_inputs(rng, D, H, W, L)
    plan = kc.vote_v_tiles(D, H, W, L)
    assert plan.ty == max(ty for ty in kc.VOTE_V_TY if ty + 2 * L <= 257)
    np.testing.assert_array_equal(walk_vote_v(rc, arms, L),
                                  n(vote_mode_plain(t(rc), t(arms), L)))


@pytest.mark.parametrize("g,p", [(1, 1), (1, 3), (1, 4), (2, 1), (2, 3),
                                 (2, 4)])
def test_vote_v_walk_any_row_warps_and_plane_groups(g, p):
    """The same mode whatever the row warps and plane groups, on counts
    full of ties (ties go to the highest d across a plane pair and a group
    boundary too; D = 11 leaves some group an odd plane), with a ragged
    last block row."""
    D, H, W, L = 11, 37, 40, 4
    rng = np.random.default_rng(8 * g + p)
    rc = rng.integers(0, 3, (D, H, W)).astype(np.uint8)
    _, arms = vote_inputs(rng, D, H, W, L)
    np.testing.assert_array_equal(
        walk_vote_v(rc, arms, L, plan_with(D, H, W, L, g, p)),
        n(vote_mode_plain(t(rc), t(arms), L)))


def test_vote_v_plan_cuts_to_the_frame_and_shared_memory():
    """Two row warps and four plane groups, fewer where the frame has one
    TY-row tile or fewer planes; at L = 127 (TY = 2) plane groups are cut
    until the block fits 227 KB."""
    assert kc.vote_v_tiles(61, 288, 384, 25)[:3] == (16, 2, 4)
    assert kc.vote_v_tiles(280, 525, 2880, 25)[:3] == (16, 2, 4)
    assert kc.vote_v_tiles(3, 288, 384, 25)[:3] == (16, 2, 3)
    assert kc.vote_v_tiles(61, 16, 384, 25)[:3] == (16, 1, 4)
    assert kc.vote_v_tiles(61, 17, 384, 25)[:3] == (16, 2, 4)
    cut = kc.vote_v_tiles(61, 40, 384, 127)
    assert cut[:3] == (2, 2, 2) and cut.shared_bytes <= kc.SHARED_LIMIT
    assert 3 * cut.stage_bytes + 6 * cut.region > kc.SHARED_LIMIT


@pytest.mark.parametrize("D", [1, 2, 5, 302, 303, 604, 605])
def test_vote_h_chunk_edges(D):
    """At L = 25 a chunk holds 302 planes: one chunk up to D = 302, two
    equal chunks from 303, three from 605."""
    H, W, L = 2, 50, 25
    plan = kc.vote_h_tiles(D, H, W, L)
    assert plan.chunks == -(-D // 302) and plan.dc == -(-D // plan.chunks)
    rng = np.random.default_rng(D)
    idx, arms = vote_inputs(rng, D, H, W, L)
    np.testing.assert_array_equal(walk_vote_h(idx, arms, D, L, plan),
                                  n(vote_counts_plain(t(idx), t(arms), D, L)))


# The launches of REFERENCE_CONFIG at 288x384 and of BASELINE config 3's
# cross band in chip_smoke.py phase 16 (rows 1541..2066, d_max 279) and
# whole frame.
@pytest.mark.parametrize("D,H,W", [(61, 288, 384), (280, 525, 2880),
                                   (280, 1988, 2880)])
def test_plans_at_the_main_path_shapes(D, H, W):
    h = kc.vote_h_tiles(D, H, W, 25)
    assert (h.dc, h.chunks, h.grid) == (D, 1, (-(-W // 128), H, 1))
    v = kc.vote_v_tiles(D, H, W, 25)
    assert (v.ty, v.g, v.p, v.rows, v.region) == (16, 2, 4, 66, 8576)
    assert v.grid == (W // 32, -(-H // 32))
    assert v.shared_bytes == 4 * 128 * 82 + 8 * 8576 == 110592


def test_plans_that_do_not_fit_raise_and_wrappers_never_fall_back(
        monkeypatch):
    """vote_v has no plan past L = 128 (the uint16 prefix), vote_h none
    where a plane's tile row and the bins pass VOTE_H_SHARED, neither for a
    grid too tall; a wrapper given a tensor that is not on the CPU launches
    (here: refuses the meta device) and never takes the plain version."""
    with pytest.raises(ValueError, match="no vote_v plan for L=129"):
        kc.vote_v_tiles(5, 8, 32, 129)
    with pytest.raises(ValueError, match="no vote_v plan for 16777216 rows"):
        kc.vote_v_tiles(5, 1 << 24, 32, 25)
    with pytest.raises(ValueError, match="no vote_h plan for D=5, L=6100"):
        kc.vote_h_tiles(5, 8, 32, 6100)
    with pytest.raises(ValueError, match="no vote_h plan for 70000 rows"):
        kc.vote_h_tiles(5, 70000, 32, 25)
    monkeypatch.setattr(kc, "VOTE_H_SHARED", 512)
    with pytest.raises(ValueError, match="no vote_h plan"):
        kc.vote_h_tiles(5, 8, 32, 1)
    monkeypatch.undo()

    def plain(*a, **k):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(kc, "vote_counts_plain", plain)
    monkeypatch.setattr(kc, "vote_mode_plain", plain)
    idx = torch.empty((4, 64), dtype=torch.int32, device="meta")
    arms = torch.empty((4, 4, 64), dtype=torch.int32, device="meta")
    rc = torch.empty((8, 4, 64), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA kernel"):
        kc.vote_h(idx, arms, 8, 25)
    with pytest.raises(ValueError, match="CUDA kernel"):
        kc.vote_v(rc, arms, 25)
