"""The tile plan of the aggregation kernels K1/K2 (kernels/asw_aggregation.py
`aggregation_tiles`), walked block by block in numpy exactly as
csrc/asw_aggregation.cu indexes: the left weights staged once per tile,
the right-weight segment of each span of planes staged with its clamp at
column 0, the cost taps of each group of planes staged with their halo,
G sums per thread.  The walk must equal the plain versions
(ops/aggregation.py asw_den_plain / asw_pass_plain / asw_pass_win_plain)
bit for bit: tiling moves where an output is computed, never the order of
its operations.  Unstaged shared words hold NaN, so a read outside what
the kernel stages shows as a mismatch.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from stereo_matchin_tpu_torch import REFERENCE_CONFIG
from stereo_matchin_tpu_torch import ops as tops
from stereo_matchin_tpu_torch.kernels import asw_aggregation as ka

from .torch_support import max_ulp, t

EPS = 1e-5


def emulate(plan, wl, wr, eps, d0, D, cost=None, den=None):
    """The kernel's outputs for one launch with `plan`, in numpy f32."""
    T, H, W = wl.shape
    mode, bx, by, span, G = plan.mode, plan.bx, plan.by, plan.span, plan.group
    R = (T - 1) // 2
    lay = ka.layout(mode, T, bx, by, span, G, plan.baked)
    sw, crow, crows = lay.sw, lay.crow, lay.crows
    assert plan.shared_bytes == 4 * lay.total <= ka.SHARED_LIMIT
    assert lay.sl % 4 == lay.sr % 4 == sw % 4 == crow % 4 == 0
    assert bx % 4 == 0 and bx * by <= 1024
    assert plan.baked == (T == ka.BAKED_TAPS)
    gx, gy = plan.grid
    assert gx * bx >= W and gy * by >= H
    eps = np.float32(eps)
    out = np.zeros((D, H, W), np.float32)
    written = np.zeros((D, H, W), np.int32)
    ty, tx = np.mgrid[0:by, 0:bx]
    for bxi in range(gx):
        for byi in range(gy):
            x0, y0 = bxi * bx, byi * by
            rows = np.minimum(y0 + np.arange(by), H - 1)
            sl = wl[:, rows][:, :, np.minimum(x0 + np.arange(bx), W - 1)]
            valid = (x0 + tx < W) & (y0 + ty < H)
            for s0 in range(0, D, span):
                sn = min(span, D - s0)
                # The segment from the aligned column xa at or below xbase.
                xbase = x0 - d0 - (s0 + sn - 1)
                xa = xbase // 4 * 4
                jo = xbase - xa
                n = -(-(jo + bx + sn - 1) // 4) * 4
                assert n <= sw
                sr = np.full((T, by, sw), np.nan, np.float32)
                sr[:, :, :n] = wr[:, rows][:, :, np.clip(
                    xa + np.arange(n), 0, W - 1)]
                for g0 in range(s0, s0 + sn, G):
                    gn = min(G, s0 + sn - g0)
                    sc = np.full((G, crows, crow), np.nan, np.float32)
                    r, c = np.arange(crows), np.arange(crow)
                    for g in range(gn if mode else 0):
                        if mode == 1:
                            yy, xx = np.clip(y0 - R + r, 0, H - 1), np.minimum(
                                x0 + c, W - 1)
                        elif mode == 2:
                            yy, xx = np.minimum(y0 + r, H - 1), np.clip(
                                x0 - R + c, 0, W - 1)
                        else:
                            yy, xx = np.minimum(y0 + r, H + T - 2), np.minimum(
                                x0 + c, W - 1)
                        sc[g] = cost[g0 + g][yy][:, xx]
                    acc = np.full((G, by, bx), eps, np.float32)
                    jr = jo + tx + (s0 + sn - 1 - g0)
                    for tap in range(T):
                        left = sl[tap, ty, tx]
                        for g in range(gn):
                            assert 0 <= (jr - g).min() and (jr - g).max() < n
                            ww = left * sr[tap, ty, jr - g]
                            if mode == 0:
                                acc[g] = acc[g] + ww
                            else:
                                c = (sc[g, ty, tx + tap] if mode == 2
                                     else sc[g, ty + tap, tx])
                                acc[g] = acc[g] + ww * c
                    ys, xs = y0 + ty[valid], x0 + tx[valid]
                    for g in range(gn):
                        d = g0 + g
                        res = acc[g][valid]
                        if mode:
                            res = res / den[d, ys, xs]
                        out[d, ys, xs] = res
                        written[d, ys, xs] += 1
    assert (written == 1).all()
    return out


def _inputs(T, H, W, D, d0, seed, rows=None):
    rng = np.random.default_rng(seed)
    wl, wr = (rng.uniform(0.01, 1.0, (T, H, W)).astype(np.float32)
              for _ in range(2))
    cost = rng.uniform(0, 765, (D, rows or H, W)).astype(np.float32)
    den = tops.asw_den_plain(t(wl), t(wr), EPS, d0, D).numpy()
    return wl, wr, cost, den


def _span_target(mode, T, span):
    """A shared budget that cuts the planes into spans of at least `span`
    (the segment rows are padded to 4 floats, so a few more may fit)."""
    m = ka.MODES[mode]
    bx, by, group = ka.TILE_SHAPES[m]
    return 4 * ka.layout(m, T, bx, by, span, group, T == ka.BAKED_TAPS).total


# (T, H, W, D, d0, shape, span): W off the tile width, D off the group,
# W under one tile, d0 >= W (every read clamps to column 0), several spans
# with a short last one, T = 33 (REFERENCE_CONFIG), T = 61 (radius 30:
# the vertical tiles' rows halved), other tile shapes (set in TILE_SHAPES).
CASES = {
    "T3_ragged": (3, 13, 150, 11, 0, None, None),
    "T3_spans": (3, 13, 150, 11, 4, None, 4),
    "T5_under_one_tile": (5, 9, 20, 7, 3, None, None),
    "T5_d0_past_W": (5, 17, 40, 9, 45, None, 3),
    "T33_spans": (33, 20, 70, 13, 2, None, 5),
    "T61_rows_halved": (61, 13, 40, 5, 2, None, None),
    "T5_tile_16x4_g2": (5, 11, 37, 7, 6, (16, 4, 2), 3),
    "T3_tile_64x2_g2": (3, 7, 70, 5, 1, (64, 2, 2), None),
    "T5_tile_32x4_g4": (5, 11, 37, 9, 6, (32, 4, 4), 3),
    "T33_tile_32x8_g8_d0_past_W": (33, 20, 45, 11, 50, (32, 8, 8), None),
}


@pytest.mark.parametrize("mode", ["den", "v", "h", "win"])
@pytest.mark.parametrize("case", list(CASES))
def test_tile_walk_equals_plain(mode, case, monkeypatch):
    T, H, W, D, d0, shape, span = CASES[case]
    if shape is not None:
        monkeypatch.setitem(ka.TILE_SHAPES, ka.MODES[mode], shape)
    if span is not None:
        monkeypatch.setattr(ka, "SHARED_TARGET", _span_target(mode, T, span))
    plan = ka.aggregation_tiles(T, H, W, D, mode)
    if span is not None:            # several spans
        assert span <= plan.span < D, plan
    rows = H + T - 1 if mode == "win" else H
    wl, wr, cost, den = _inputs(T, H, W, D, d0, seed=T * H + W + D, rows=rows)
    got = emulate(plan, wl, wr, EPS, d0, D, cost, den)
    if mode == "den":
        want = tops.asw_den_plain(t(wl), t(wr), EPS, d0, D)
    elif mode == "win":
        want = tops.asw_pass_win_plain(t(cost), t(wl), t(wr), t(den), EPS, d0)
    else:
        want = tops.asw_pass_plain(t(cost), t(wl), t(wr), t(den), EPS,
                                   1 if mode == "v" else 2, d0)
    assert max_ulp(got, want) == 0


# The launches of REFERENCE_CONFIG at 288x384 and of BASELINE config 3
# (1988x2880, d_max 279): a 70-plane chunk, the whole volume, and an
# interior wavefront band's 384-row window.
SHAPES = [(33, 288, 384, 61), (33, 1988, 2880, 70), (33, 1988, 2880, 280),
          (33, 384, 2880, 70)]


@pytest.mark.parametrize("T,H,W,D", SHAPES)
def test_plans_fit_a_block(T, H, W, D):
    for mode in ka.MODES:
        plan = ka.aggregation_tiles(T, H, W, D, mode)
        assert plan.shared_bytes <= ka.SHARED_LIMIT, (mode, plan)
        assert 1 <= plan.span <= D and plan.grid[1] <= 65535
        assert -(-D // plan.span) * plan.span - D < -(-D // plan.span)


@pytest.mark.parametrize("radius", [29, 30, 50])
def test_rows_halve_where_one_plane_does_not_fit(radius):
    """From radius 29 the vertical passes' 32x12 tile does not fit one
    plane in a block: the plan halves its rows until it does, and takes the
    tallest tile that fits; the row tiles keep theirs."""
    T = 2 * radius + 1
    for mode in ka.MODES:
        plan = ka.aggregation_tiles(T, 1988, 2880, 70, mode)
        bx, by, group = ka.TILE_SHAPES[plan.mode]
        assert plan.shared_bytes <= ka.SHARED_LIMIT, (mode, plan)
        assert plan.grid == (-(-2880 // bx), -(-1988 // plan.by))
        if mode in ("den", "h"):
            assert plan.by == by == 1
            continue
        assert plan.by < by
        taller = ka.layout(plan.mode, T, bx, 2 * plan.by, 1, group, False)
        assert 4 * taller.total > ka.SHARED_LIMIT


def test_no_plan_raises_and_the_wrapper_never_falls_back(monkeypatch):
    """Radius 200 (T = 401) fits no block: the planner raises, and so does
    a wrapper given a tensor that is not on the CPU, instead of taking the
    plain version; at radius 2 the same wrapper reaches the launch route
    (which refuses a tensor that is not on the card)."""
    assert REFERENCE_CONFIG.window == 33
    for mode in ka.MODES:
        with pytest.raises(ValueError, match="no tile plan"):
            ka.aggregation_tiles(401, 64, 64, 8, mode)
        for shape in ((30, 4, 2), (64, 32, 2), (32, 4, 1)):
            monkeypatch.setitem(ka.TILE_SHAPES, ka.MODES[mode], shape)
            with pytest.raises(ValueError, match="block"):
                ka.aggregation_tiles(5, 64, 64, 8, mode)
        monkeypatch.undo()
    for T, match in ((401, "no tile plan"), (5, "CUDA kernel")):
        wl = torch.empty((T, 16, 24), device="meta")
        cost = torch.empty((3, 16, 24), device="meta")
        win = torch.empty((3, 16 + T - 1, 24), device="meta")
        with pytest.raises(ValueError, match=match):
            ka.asw_den(wl, wl, EPS, 0, 3)
        for axis in (1, 2):
            with pytest.raises(ValueError, match=match):
                ka.asw_pass(cost, wl, wl, cost, EPS, axis)
        with pytest.raises(ValueError, match=match):
            ka.asw_pass_win(win, wl, wl, cost, EPS)
