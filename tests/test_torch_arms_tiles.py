"""The cross-arms kernel K5 (csrc/cross_oii.cu cross_arms_kernel) walked in
numpy exactly as the CUDA code indexes, under its plan
(kernels/cross_oii.py `arms_tiles`):

  - one launch: v tiles first (32 columns x ty_v rows; the rows y0 - R ..
    y0 + ty_v + R - 1, clamped to the image, are copied, only the tile's
    columns that lie in the frame, in 16-byte copies where W % 4 == 0),
    then an h tile for each row and ARMS_HX columns (the row segment x0 - R
    .. x0 + ARMS_HX + R - 1, where it lies in the frame, is staged), R =
    first + L - 2;
  - each thread walks its pixel's minus and plus arms of its tile's axis in
    the staged colours, distances first .. lim, lim cut to the frame before
    the walk (columns 0 .. W - 1; frame rows 0 .. h_glob - 1 from
    clamp(row0 + y, 0, h_glob - 1)), the first failed colour test ending it.

Unstaged shared words hold NaN, so a read of one ends an arm early and shows
as a mismatch.  Each walk must equal the plain version (ops/cross.py
`cross_arms`) exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from stereo_matchin_tpu_torch.kernels import cross_oii as kc
from stereo_matchin_tpu_torch.ops.cross import cross_arms

from .torch_support import ARMS_EDGES, arms_image, n, t

TAU = np.float32(0.10)


def check_plan(plan, H, W, L, first):
    R = first + L - 2
    assert plan.halo == R and plan.ty_v in kc.ARMS_V_ROWS
    assert plan.ty_v % kc.ARMS_WARPS == 0
    assert kc.ARMS_HX == 32 * kc.ARMS_WARPS       # an h tile: a pixel a thread
    assert plan.blocks_v == -(-W // kc.ARMS_VX) * -(-H // plan.ty_v)
    assert plan.blocks_h == -(-W // kc.ARMS_HX) * H
    assert plan.shared_bytes == max(12 * kc.ARMS_VX * (plan.ty_v + 2 * R),
                                    16 * (kc.ARMS_HX + 2 * R))
    assert plan.shared_bytes <= kc.SHARED_LIMIT


def arm_walk(tile, idx, step, p, first, lim, act):
    """csrc arm_walk() for every thread at once: tile [positions, 3] staged
    colours, idx [threads] the centres, p [threads, 3] their colours."""
    arm = np.ones(idx.shape, np.int32)
    alive = act.copy()
    for dist in range(first, int(lim.max(initial=first - 1)) + 1):
        alive &= dist <= lim
        k = np.where(alive, idx + dist * step, 0)
        assert ((k >= 0) & (k < len(tile)))[alive].all()
        nb = tile[k]
        alive &= (np.abs(nb - p) < TAU).all(-1)
        arm += alive
    return arm


def walk(img, L, quirk, row0=0, h_glob=None, plan=None):
    """cross_arms_kernel's output, block by block: the v tiles, then the h
    tiles."""
    H, W = img.shape[:2]
    h_glob = H if h_glob is None else h_glob
    first = 3 if quirk else 2
    plan = plan or kc.arms_tiles(H, W, L, first)
    check_plan(plan, H, W, L, first)
    R, ty, last = plan.halo, plan.ty_v, first + L - 2
    gx_v, gx_h = -(-W // kc.ARMS_VX), -(-W // kc.ARMS_HX)
    out = np.zeros((4, H, W), np.int32)
    written = np.zeros((4, H, W), np.int32)
    lane = np.arange(32)
    sw = kc.ARMS_HX + 2 * R
    for b in range(plan.blocks_v + plan.blocks_h):
        if b < plan.blocks_v:                       # a v tile
            band, bx = divmod(b, gx_v)
            x0, y0 = bx * kc.ARMS_VX, band * ty
            x = x0 + lane
            rows = np.clip(y0 - R + np.arange(ty + 2 * R), 0, H - 1)
            nf = 3 * min(kc.ARMS_VX, W - x0)        # floats of a tile row
            assert W % 4 or nf % 4 == 0             # whole 16-byte copies
            tile = np.full((ty + 2 * R, kc.ARMS_VX, 3), np.nan, np.float32)
            tile[:, :nf // 3] = img[rows][:, x0:x0 + nf // 3]
            tile = tile.reshape(-1, 3)              # [rows][32]
            i = np.arange(ty)[:, None] + 0 * lane   # [ty, 32]
            y = y0 + i
            act = (y < H) & (x < W)
            gy = np.clip(row0 + y, 0, h_glob - 1)
            idx = (R + i) * kc.ARMS_VX + lane
            p = tile[np.where(act, idx, 0)]
            up = arm_walk(tile, idx, -kc.ARMS_VX, p, first,
                          np.minimum(last, gy), act)
            dn = arm_walk(tile, idx, kc.ARMS_VX, p, first,
                          np.minimum(last, h_glob - 1 - gy), act)
            ya, xa = y[act], (x + 0 * i)[act]
            out[2][ya, xa], out[3][ya, xa] = -up[act], dn[act]
            written[2:, ya, xa] += 1
            continue
        y, bx = divmod(b - plan.blocks_v, gx_h)     # an h tile: row y
        x0 = bx * kc.ARMS_HX
        tile = np.full((sw, 3), np.nan, np.float32)
        cols = x0 - R + np.arange(sw)
        inside = (cols >= 0) & (cols < W)
        tile[inside] = img[y, cols[inside]]
        c = np.arange(kc.ARMS_HX)
        x = x0 + c
        act = x < W
        idx = R + c
        p = tile[idx]
        lf = arm_walk(tile, idx, -1, p, first, np.minimum(last, x), act)
        rt = arm_walk(tile, idx, 1, p, first, np.minimum(last, W - 1 - x), act)
        out[0][y, x[act]], out[1][y, x[act]] = -lf[act], rt[act]
        written[:2, y, x[act]] += 1
    assert (written == 1).all()
    return out


def plain(img, L, quirk, row0=0, h_glob=None):
    return n(cross_arms(t(img), L, float(TAU), quirk, row0, h_glob))


@pytest.mark.parametrize("v_rows", ["plan", "tallest"])
@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("case", list(ARMS_EDGES))
def test_arms_walks_equal_plain(case, quirk, v_rows, monkeypatch):
    H, W, L, row0, h_glob, kind = ARMS_EDGES[case]
    if v_rows == "tallest":
        monkeypatch.setattr(kc, "ARMS_V_BLOCKS", 1)
        assert kc.arms_tiles(H, W, L, 3 if quirk else 2).ty_v == 32
    img = arms_image(np.random.default_rng(H * W + L), H, W, kind)
    got = walk(img, L, quirk, row0, h_glob)
    want = plain(img, L, quirk, row0, h_glob)
    np.testing.assert_array_equal(got, want)
    arm = np.abs(want)
    if kind == "noise" or L == 1:
        assert (arm == 1).all()
    elif kind == "flat":                  # every arm as long as the frame allows
        reach = np.stack([np.arange(W)[None, :] + 0 * np.arange(H)[:, None]] * 2)
        reach[1] = W - 1 - reach[1]
        assert (arm[:2] == np.clip(reach - (3 if quirk else 2) + 2, 1, L)).all()
        assert (arm == L).any()
    else:
        assert (arm == 1).any() and (arm > 2).any()


def test_arms_plans_at_the_main_path_shapes():
    """288x384 at REFERENCE_CONFIG (L = 25, the legacy quirk: R = 26), and
    config 3's band and whole frame: v tiles of 8 and 32 rows, the tallest
    that still gives ARMS_V_BLOCKS v tiles; 22.5-31.5 KB of shared memory a
    block."""
    p = kc.arms_tiles(288, 384, 25, 3)
    assert (p.halo, p.ty_v, p.blocks_v, p.blocks_h) == (26, 8, 432, 576)
    assert p.shared_bytes == 12 * 32 * (8 + 52)
    p = kc.arms_tiles(526, 2880, 25, 3)
    assert (p.ty_v, p.blocks_v, p.blocks_h) == (32, 1530, 6312)
    assert p.shared_bytes == 12 * 32 * (32 + 52)
    p = kc.arms_tiles(1988, 2880, 25, 2)
    assert (p.halo, p.ty_v, p.blocks_v, p.blocks_h) == (25, 32, 5670, 23856)
    assert p.shared_bytes == 12 * 32 * (32 + 50)


def test_arms_plans_that_do_not_fit_raise_and_the_wrapper_never_falls_back(
        monkeypatch):
    """No plan where a v tile of 8 rows and its halo pass SHARED_LIMIT (a
    long L), a plane passes 2^31 - 1 pixels or a size is 0; a longer L
    takes shorter v tiles.  The wrapper given a tensor that is not on the
    CPU launches (here: refuses the meta device) and never takes the plain
    version."""
    # 12 * 32 * (8 + 2R) <= 232448 holds up to R = 298: L = 297 with the quirk.
    assert kc.arms_tiles(64, 64, 297, 3).shared_bytes == 12 * 32 * 604
    with pytest.raises(ValueError, match="no K5 plan for L=298"):
        kc.arms_tiles(64, 64, 298, 3)
    monkeypatch.setattr(kc, "ARMS_V_BLOCKS", 1)
    assert kc.arms_tiles(64, 64, 290, 3).ty_v == 16
    assert kc.arms_tiles(64, 64, 280, 3).ty_v == 32
    with pytest.raises(ValueError, match="passes 2"):
        kc.arms_tiles(65_536, 32_768, 25, 3)
    with pytest.raises(ValueError, match="no K5 plan for 0x8"):
        kc.arms_tiles(0, 8, 25, 3)

    def plain_route(*a, **k):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(kc, "cross_arms_plain", plain_route)
    img = torch.empty((8, 64, 3), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA kernel"):
        kc.cross_arms(img, 25)
