"""The port's CUDA kernels on the card: each against its plain PyTorch
version, bit for bit (the kernels are built with --fmad=false), the
ASW and cross slices through the kernels against the plain ops, and the
frames captured as CUDA graphs (utils/graphs.py) against the eager ones.

Every test here needs an NVIDIA GPU and skips elsewhere.  This file
imports no JAX, so it also runs where JAX is not installed; the
repository's conftest.py does, so on such a machine run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from stereo_matchin_tpu_torch import kernels
from stereo_matchin_tpu_torch import ops as tops
from stereo_matchin_tpu_torch.config import TINY_CONFIG, StereoConfig
from stereo_matchin_tpu_torch.eval import synthetic_scene
from stereo_matchin_tpu_torch.kernels.asw_aggregation import (asw_den, asw_pass,
                                                              asw_pass_win)
from stereo_matchin_tpu_torch.kernels.cross_oii import (cross_arms, oii_pass,
                                                        vote_h, vote_v)
from stereo_matchin_tpu_torch.kernels.sad_volume import sad_volume
from stereo_matchin_tpu_torch.kernels import cross_oii as kc
from stereo_matchin_tpu_torch.kernels import wta_gather as kw
from stereo_matchin_tpu_torch.kernels.wta_gather import two_min, wta_diag
from stereo_matchin_tpu_torch.models import asw, cross_based, tiled
from stereo_matchin_tpu_torch.utils import graphs
from stereo_matchin_tpu_torch.ops.wta_fast import (_diag_two_min_plain,
                                                   _two_min_plain)

from stereo_matchin_tpu_torch.kernels import sad_volume as ks
from .torch_support import (ARMS_EDGES, OII_EDGES, SAD_EDGES,
                            SHARD_WTA_EDGES, VOTE_EDGES, arms_image,
                            cuda_device, k4_queued, k12_tiles, k13_plan,
                            max_ulp, n, oii_inputs, outlier_d1, sad_inputs,
                            shard_wta_d1, shard_wta_inputs, shifted_d1,
                            structured_d1, unorm8_pair, vote_inputs)

pytestmark = pytest.mark.cuda
EPS, BIG = 1e-5, 1e5


def _pair(dev, H, W, seed=0):
    left, right = unorm8_pair(np.random.default_rng(seed), H, W)
    return torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev)


@pytest.mark.parametrize("H,W,R,D,d0", [(40, 70, 4, 7, 0), (40, 70, 4, 9, 5),
                                        (288, 384, 16, 61, 0),
                                        (375, 450, 16, 17, 3)])
def test_aggregation_kernels_bit_equal_to_plain(H, W, R, D, d0):
    dev = cuda_device()
    left, right = _pair(dev, H, W)
    cost = tops.sad_cost_volume(left, right, d0 + D, 255.0)[d0:].contiguous()
    for axis in (1, 2):
        wl = tops.support_weights(left, R, 30.91, 28.21, axis - 1)
        wr = tops.support_weights(right, R, 30.91, 28.21, axis - 1)
        before = dict(kernels.LAUNCHES)
        den = asw_den(wl, wr, EPS, d0, D)
        out = asw_pass(cost, wl, wr, den, EPS, axis, d0)
        torch.cuda.synchronize()
        key = "asw_pass_v" if axis == 1 else "asw_pass_h"
        assert kernels.LAUNCHES["asw_den"] == before["asw_den"] + 1
        assert kernels.LAUNCHES[key] == before[key] + 1
        assert max_ulp(den, tops.asw_den_plain(wl, wr, EPS, d0, D)) == 0
        assert max_ulp(out, tops.asw_pass_plain(cost, wl, wr, den, EPS, axis,
                                                d0)) == 0


# The tile plans' edge shapes (kernels/asw_aggregation.py aggregation_tiles),
# (T, H, W, D, d0): W off the tile width and D off the group, W under one
# tile, d0 >= W (every read clamps to column 0), the compiled-in T = 33 with
# a short group, a 150-wide frame at T = 33 past its last tile, and T = 61
# (radius 30), whose vertical tiles have their rows halved.
EDGES = [(3, 13, 150, 11, 0), (5, 9, 20, 7, 3), (5, 17, 40, 9, 45),
         (33, 20, 70, 13, 2), (33, 29, 150, 21, 160), (61, 26, 70, 9, 4)]


@pytest.mark.parametrize("T,H,W,D,d0", EDGES)
def test_aggregation_kernels_bit_equal_at_tile_edges(T, H, W, D, d0):
    dev = cuda_device()
    rng = np.random.default_rng(T * W + D)

    def card(*shape, hi=1.0):
        return torch.from_numpy(rng.uniform(0.01, hi, shape).astype(
            np.float32)).to(dev)

    wl, wr = card(T, H, W), card(T, H, W)
    cost, win = card(D, H, W, hi=765.0), card(D, H + T - 1, W, hi=765.0)
    den = _launched("asw_den", asw_den, wl, wr, EPS, d0, D)
    assert max_ulp(den, tops.asw_den_plain(wl, wr, EPS, d0, D)) == 0
    for axis, key in ((1, "asw_pass_v"), (2, "asw_pass_h")):
        got = _launched(key, asw_pass, cost, wl, wr, den, EPS, axis, d0)
        assert max_ulp(got, tops.asw_pass_plain(cost, wl, wr, den, EPS, axis,
                                                d0)) == 0
    got = _launched("asw_pass_win", asw_pass_win, win, wl, wr, den, EPS, d0)
    assert max_ulp(got, tops.asw_pass_win_plain(win, wl, wr, den, EPS,
                                                d0)) == 0


# (D, H, W, d1 of K4, offset in floats of the volume's first element): the
# first three as before; then edge shapes, as chip_smoke.py's WTA_EDGES:
# one plane; three planes; H*W odd; a volume 4 bytes off a 16-byte
# boundary; W under a block of K4 and W off it; d1 = 0 and d1 = D - 1 (a
# narrow frame all in the left band); uniform random d1, also at config 3's
# depth (dense warps: the first pass walks them to the end); short d1 with
# a few outliers per warp at config 3's depth (K4's second pass walks the
# outliers from its queue).
WTA_SHAPES = [(8, 16, 24, "argmin", 0), (11, 24, 20, "argmin", 0),
              (61, 288, 384, "argmin", 0),
              (1, 48, 64, "argmin", 0), (3, 40, 64, "argmin", 0),
              (61, 37, 53, "random", 0), (61, 32, 96, "argmin", 1),
              (17, 30, 20, "last", 0), (33, 24, 300, "random", 0),
              (61, 32, 200, "zero", 0), (61, 32, 200, "last", 0),
              (280, 12, 700, "random", 0), (280, 8, 700, "outliers", 0)]


@pytest.mark.parametrize("D,H,W,kind,offset", WTA_SHAPES)
@pytest.mark.parametrize("with_penalty", [False, True])
def test_wta_kernels_bit_equal_to_plain(D, H, W, kind, offset, with_penalty):
    _wta_bit_equal(D, H, W, kind, offset, with_penalty)


# K4's first pass cut to 1 and to 5 planes: on the outlier map the longer
# diagonals continue in the second pass from the queue; on argmin and
# uniform d1 most warps are dense and walk theirs to the end at once.
@pytest.mark.parametrize("head", [1, 5])
@pytest.mark.parametrize("kind", ["argmin", "random", "outliers"])
def test_wta_diag_second_pass_bit_equal_to_plain(kind, head, monkeypatch):
    monkeypatch.setattr(kw, "K4_HEAD", head)
    _wta_bit_equal(61, 40, 300, kind, 0, True)


def _wta_bit_equal(D, H, W, kind, offset, with_penalty):
    dev = cuda_device()
    rng = np.random.default_rng(D + H + W)
    flat = rng.integers(0, 30, offset + D * H * W).astype(np.float32)  # ties
    cost = torch.from_numpy(flat).to(dev)[offset:].view(D, H, W)
    cost[:, :2, :3] = 2e5
    pen = (None, None)
    if with_penalty:
        pen = tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in
                    (rng.random((H, W)), rng.random((H, W)) * D))
    before = dict(kernels.LAUNCHES)
    got = two_min(cost, *pen, big=BIG)
    want = _two_min_plain(cost, *pen, big=BIG)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))
    d1 = {"argmin": want[2], "zero": torch.zeros_like(want[2]),
          "last": torch.full_like(want[2], D - 1),
          "random": torch.from_numpy(rng.integers(0, D, (H, W)).astype(
              np.int32)).to(dev),
          "outliers": torch.from_numpy(outlier_d1(
              rng, D, H, W, kw.diag_head(D))).to(dev)}[kind]
    if kind == "outliers":
        assert len(k4_queued(d1, D, kw.diag_head(D), kw.K4_SPARSE)) > 0
    got = wta_diag(cost, d1, *pen, big=BIG)
    for g, w in zip(got, _diag_two_min_plain(cost, d1, *pen, big=BIG)):
        np.testing.assert_array_equal(n(g), n(w))
    assert kernels.LAUNCHES["two_min"] == before["two_min"] + 1
    assert kernels.LAUNCHES["wta_diag"] == before["wta_diag"] + 1


def test_slice_through_kernels_equals_plain_ops_and_counts_launches():
    dev = cuda_device()
    cfg = TINY_CONFIG
    left, right = _pair(dev, 48, 64, seed=1)
    kernels.reset_launches()
    got = asw.asw_pipeline(left, right, cfg)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] for k in kernels.ASW_KERNELS} == {
        "asw_den": 2, "asw_pass_v": cfg.r_iters, "asw_pass_h": cfg.r_iters,
        "asw_pass_win": 0, "two_min": cfg.k_iters + 1,
        "wta_diag": cfg.k_iters + 1, "support_w": 8,
        "refine_v": 2 * cfg.k_iters, "refine_win": 0,
        "refine_h": 2 * cfg.k_iters, "sad_volume": 1,
        "wta_merge": cfg.k_iters + 1, "median3x3": 1,
        "epipolar_segment": 0, "shard_merge": 0}
    assert all(kernels.LAUNCHES[k] == 0 for k in kernels.CROSS_KERNELS
               if k not in kernels.ASW_KERNELS)
    want = asw.asw_pipeline(left, right, cfg.replace(kernels="jnp"))
    assert kernels.LAUNCHES["two_min"] == cfg.k_iters + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("H,W,R,D,d0", [(40, 70, 4, 7, 0), (288, 384, 16, 61, 0),
                                        (375, 450, 16, 57, 5)])
def test_windowed_pass_kernel_bit_equal_to_plain(H, W, R, D, d0):
    """The windowed vertical pass over rows [a, b) with R real margin rows
    on each side: the kernel equals its plain version and the clamped pass
    on the same rows."""
    dev = cuda_device()
    left, right = _pair(dev, H, W, seed=D)
    cost = tops.sad_cost_volume(left, right, D, 255.0, d0)
    wl, wr = (tops.support_weights(x, R, 30.91, 28.21, 0) for x in (left, right))
    den = tops.asw_den_plain(wl, wr, EPS, d0, D)
    a, b = R + 3, H - R - 5
    win = cost[:, a - R:b + R].contiguous()
    strips = [x[:, a:b].contiguous() for x in (wl, wr, den)]
    got = _launched("asw_pass_win", asw_pass_win, win, *strips, EPS, d0)
    assert max_ulp(got, tops.asw_pass_win_plain(win, *strips, EPS, d0)) == 0
    full = tops.asw_pass_plain(cost, wl, wr, den, EPS, 1, d0)
    assert max_ulp(got, full[:, a:b]) == 0


# --- K9 support_w and K10 refine_pass ---------------------------------------

def _maps(dev, rng, rows, W, d_max=60):
    d = rng.integers(0, d_max + 1, (rows, W)).astype(np.float32)
    conf = rng.uniform(0.001, 1.0, (rows, W)).astype(np.float32)
    return torch.from_numpy(d).to(dev), torch.from_numpy(conf).to(dev)


@pytest.mark.parametrize("R,H,W", [(16, 288, 384), (16, 375, 450), (0, 7, 9),
                                   (16, 10, 20), (16, 40, 13), (5, 3, 130)])
def test_strip_and_refine_kernels_bit_equal_to_plain(R, H, W):
    """K9 on both axes with both pairs of gammas, K10 v and h (h on v's
    outputs, and v on a strip cropped to a view of its rows) against the
    plain ops, each launch counted once."""
    dev = cuda_device()
    rng = np.random.default_rng(H + W)
    img = _pair(dev, H, W, seed=R)[0]
    d, conf = _maps(dev, rng, H, W)
    for gammas in ((30.91, 28.21), (10.94, 118.78)):
        for axis in (0, 1):
            got = _launched("support_w", tops.support_weights, img, R,
                            *gammas, axis)
            want = tops.support_weights(img, R, *gammas, axis, kernels="jnp")
            assert max_ulp(got, want) == 0
        wv, wh = tops.refinement_weights(img, R, *gammas, kernels="jnp")
        v = _launched("refine_v", tops.refine_pass_v, wv, d, conf, R, EPS)
        for g, w in zip(v, tops.refine_pass_v(wv, d, conf, R, EPS,
                                              kernels="jnp")):
            assert max_ulp(g, w) == 0
        h = _launched("refine_h", tops.refine_pass_h, wh, *v, conf, R, EPS)
        for g, w in zip(h, tops.refine_pass_h(wh, *v, conf, R, EPS,
                                              kernels="jnp")):
            assert max_ulp(g, w) == 0
        if H > 2:
            crop, dc, cc = wv[:, 1:-1], d[1:-1], conf[1:-1]
            got = _launched("refine_v", tops.refine_pass_v, crop, dc, cc, R,
                            EPS)
            for g, w in zip(got, tops.refine_pass_v(crop.contiguous(), dc, cc,
                                                    R, EPS, kernels="jnp")):
                assert max_ulp(g, w) == 0


@pytest.mark.parametrize("R,h_loc,W,row0,h_glob", [
    (16, 144, 384, 0, 288), (16, 144, 384, 144, 288), (2, 5, 30, 7, 12),
    (16, 10, 40, 10, 20)])
def test_shard_strip_and_window_kernels_bit_equal_to_plain(R, h_loc, W, row0,
                                                           h_glob):
    """A row shard: K9 on the centre rows of its halo-padded tile and K10
    win on its exchanged maps against the plain ops and against the whole
    frame's strip and vertical pass on those rows."""
    from stereo_matchin_tpu_torch.parallel import ops_tiled

    dev = cuda_device()
    rng = np.random.default_rng(row0 + h_glob)
    frame = _pair(dev, h_glob, W, seed=h_loc)[0]
    d, conf = _maps(dev, rng, h_glob, W)
    rows = lambda a, b: torch.arange(a, b, device=dev).clamp(0, h_glob - 1)
    halo, gam = max(R, 1), (10.94, 118.78)
    tile = frame[rows(row0 - halo, row0 + h_loc + halo)].contiguous()
    w = _launched("support_w", ops_tiled.support_weights_tiled, tile, R,
                  *gam, row0, h_glob, halo)
    whole = tops.support_weights(frame, R, *gam, 0, kernels="jnp")
    assert max_ulp(w, ops_tiled.support_weights_tiled(
        tile, R, *gam, row0, h_glob, halo, kernels="jnp")) == 0
    assert max_ulp(w, whole[:, row0:row0 + h_loc]) == 0
    win = rows(row0 - R, row0 + h_loc + R)
    dw, cw = d[win].contiguous(), conf[win].contiguous()
    got = _launched("refine_win", tops.refine_pass_v_win, w, dw, cw, EPS)
    for g, p, f in zip(got, tops.refine_pass_v_win(w, dw, cw, EPS,
                                                   kernels="jnp"),
                       tops.refine_pass_v(whole, d, conf, R, EPS,
                                          kernels="jnp")):
        assert max_ulp(g, p) == 0
        assert max_ulp(g, f[row0:row0 + h_loc]) == 0


def test_refine_kernels_take_any_layout_and_refuse_bad_arguments():
    """A strip whose rows are not contiguous, a transposed map and a
    non-contiguous image launch the kernels on a copy and equal the plain
    ops; a missing dv and taps that do not match the radius raise."""
    from stereo_matchin_tpu_torch.kernels import asw_refine as kr

    dev = cuda_device()
    rng = np.random.default_rng(41)
    img = _pair(dev, 12, 20, seed=5)[0]
    wide = tops.support_weights(img, 2, 10.94, 118.78, 0, kernels="jnp")
    w = wide[:, :, 2:]                       # rows 18 floats of 20 apart
    d, conf = _maps(dev, rng, 12, 18)
    d_t = d.t().contiguous().t()             # the same values, transposed
    got = _launched("refine_v", kr.refine_pass, w, d_t, conf, EPS, "v")
    for g, p in zip(got, tops.refine_pass_v(w, d, conf, 2, EPS,
                                            kernels="jnp")):
        assert max_ulp(g, p) == 0
    img_t = img.transpose(0, 1).contiguous().transpose(0, 1)
    assert not img_t.is_contiguous()
    got = _launched("support_w", tops.support_weights, img_t, 2, 10.94,
                    118.78, 1)
    assert max_ulp(got, tops.support_weights(img, 2, 10.94, 118.78, 1,
                                             kernels="jnp")) == 0
    with pytest.raises(ValueError):
        kr.refine_pass(w, d, conf, EPS, "h")
    with pytest.raises(ValueError):
        tops.refine_pass_v(w, d, conf, 3, EPS)
    with pytest.raises(ValueError):
        kr.refine_pass(w.cpu(), d, conf, EPS, "v")


@pytest.mark.parametrize("chunks", [0, 3])
@pytest.mark.parametrize("wf", [True, False], ids=["wavefront", "halo"])
def test_asw_band_drivers_through_kernels_equal_whole_frame(chunks, wf):
    dev = cuda_device()
    cfg = TINY_CONFIG.replace(aggr_d_chunks=chunks)
    left, right = _pair(dev, 72, 64, seed=4)
    whole = asw.asw_pipeline(left, right, cfg)
    kernels.reset_launches()
    got = tiled.asw_pipeline_tiled(left, right, cfg, 3, wavefront=wf)
    torch.cuda.synchronize()
    assert torch.equal(got[0], whole.disparity)
    assert torch.equal(got[1], whole.filled)
    assert (kernels.LAUNCHES["asw_pass_win"] > 0) == wf
    bands = kernels.LAUNCHES["two_min"] // (cfg.k_iters + 1)
    assert [kernels.LAUNCHES[k] for k in ("support_w", "refine_v",
                                          "refine_h", "refine_win")] == [
        8 * bands, 2 * cfg.k_iters * bands, 2 * cfg.k_iters * bands, 0]
    c = -(-cfg.num_disp // -(-cfg.num_disp // max(chunks, 1)))
    assert [kernels.LAUNCHES[k] for k in ("sad_volume", "wta_merge",
                                          "median3x3")] == [
        c * bands, (cfg.k_iters + 1) * bands, bands]
    plain = tiled.asw_pipeline_tiled(left, right, cfg.replace(kernels="jnp"),
                                     3, wavefront=wf)
    assert torch.equal(plain[0], got[0]) and torch.equal(plain[1], got[1])


# --- the cross method: K5-K8 ------------------------------------------------

CROSS_SHAPES = [(288, 384, 61, 25), (375, 450, 61, 25), (23, 37, 9, 4)]


def _scene(dev, H, W, d_max, seed=3):
    """Median-filtered synthetic pair (the cross path's kernel inputs)."""
    left, right, _, _ = synthetic_scene(np.random.default_rng(seed), H, W,
                                        d_max)
    return tuple(tops.median3x3(torch.from_numpy(a.astype(np.float32)).to(dev))
                 for a in (left, right))


def _launched(name, fn, *args):
    before = kernels.LAUNCHES[name]
    out = fn(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    return out


@pytest.mark.parametrize("H,W,D,L", CROSS_SHAPES)
@pytest.mark.parametrize("quirk", [True, False])
def test_cross_arms_kernel_equals_plain(H, W, D, L, quirk):
    dev = cuda_device()
    for img in _scene(dev, H, W, D - 1):
        got = _launched("cross_arms", cross_arms, img, L, 0.10, quirk)
        assert torch.equal(got, tops.cross_arms(img, L, 0.10, quirk))


@pytest.mark.parametrize("H,W,D,L", CROSS_SHAPES)
@pytest.mark.parametrize("scale,d0", [(1.0, 0), (255.0, 5)])
def test_sad_volume_kernel_bit_equal_to_plain(H, W, D, L, scale, d0):
    dev = cuda_device()
    ml, mr = _scene(dev, H, W, D - 1)
    got = _launched("sad_volume", sad_volume, ml, mr, D, scale, d0)
    assert max_ulp(got, tops.sad_cost_volume(ml, mr, D, scale, d0)) == 0


def _off16(x):
    """A copy of x whose first element lies 4 bytes past a 16-byte boundary."""
    off = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    off = off.view(x.shape).copy_(x)
    assert off.data_ptr() % 16 == 4
    return off


@pytest.mark.parametrize("chunking", ["plan", "largest_chunks"])
@pytest.mark.parametrize("case", list(SAD_EDGES))
def test_sad_volume_kernel_bit_equal_to_plain_at_plan_edges(case, chunking,
                                                            monkeypatch):
    """K6 at its plan's edge shapes (torch_support.SAD_EDGES), with the
    plan's chunks and with the largest (SAD_DC planes), on the pair as made
    and on copies 4 bytes off a 16-byte boundary."""
    dev = cuda_device()
    H, W, D, d0, scale = SAD_EDGES[case]
    if chunking == "largest_chunks":
        monkeypatch.setattr(ks, "SAD_BLOCKS", 1)
    left, right = (torch.from_numpy(a).to(dev) for a in sad_inputs(
        np.random.default_rng(H * W + D), H, W))
    want = tops.sad_cost_volume(left, right, D, scale, d0)
    for l, r in ((left, right), (_off16(left), _off16(right))):
        got = _launched("sad_volume", sad_volume, l, r, D, scale, d0)
        assert max_ulp(got, want) == 0


def test_sad_library_refuses_a_plan_off_its_layout():
    """The entry point takes the wrapper's plan (kernels/sad_volume.py
    sad_tiles) and refuses one that does not cover the planes or match its
    compiled layout, launching nothing."""
    dev = cuda_device()
    D, H, W = 40, 4, 64
    img = torch.zeros((H, W, 3), device=dev)
    out = torch.zeros((D, H, W), device=dev)
    plan = ks.sad_tiles(D, H, W)
    s = torch.cuda.current_stream(dev).cuda_stream
    lib, invalid = ks._lib(), 1                 # cudaErrorInvalidValue

    def call(dc, chunks, shared):
        return lib.sad_volume_f32(img.data_ptr(), img.data_ptr(),
                                  out.data_ptr(), D, H, W, 0, 1.0, dc, chunks,
                                  shared, s)

    assert call(plan.dc, plan.chunks, plan.shared_bytes + 12) == invalid
    assert call(plan.dc, plan.chunks + 1, plan.shared_bytes) == invalid
    assert call(plan.dc - 1, plan.chunks, plan.shared_bytes - 12) == invalid
    n = ks.SAD_TX + ks.SAD_DC                   # a chunk past SAD_DC planes
    assert call(ks.SAD_DC + 1, 2, 12 * (n + (n >> 5) + 1)) == invalid
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("v_rows", ["plan", "tallest"])
@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("case", list(ARMS_EDGES))
def test_cross_arms_kernel_equals_plain_at_plan_edges(case, quirk, v_rows,
                                                      monkeypatch):
    """K5 at its plan's edge shapes (torch_support.ARMS_EDGES), with the
    plan's v tiles and with the tallest (64 rows), on the image as made and
    on a copy 4 bytes off a 16-byte boundary."""
    dev = cuda_device()
    H, W, L, row0, h_glob, kind = ARMS_EDGES[case]
    if v_rows == "tallest":
        monkeypatch.setattr(kc, "ARMS_V_BLOCKS", 1)
    img = torch.from_numpy(arms_image(np.random.default_rng(H * W + L), H, W,
                                      kind)).to(dev)
    want = tops.cross_arms(img, L, 0.10, quirk, row0, h_glob)
    for im in (img, _off16(img)):
        got = _launched("cross_arms", cross_arms, im, L, 0.10, quirk, row0,
                        h_glob)
        assert torch.equal(got, want)


def test_arms_library_refuses_a_plan_off_its_layout():
    """The entry point takes the wrapper's plan (kernels/cross_oii.py
    arms_tiles) and refuses one that does not match the frame or its
    compiled layout, launching nothing."""
    dev = cuda_device()
    H, W, L, first = 40, 70, 5, 3
    img = torch.zeros((H, W, 3), device=dev)
    arms = torch.zeros((4, H, W), dtype=torch.int32, device=dev)
    p = kc.arms_tiles(H, W, L, first)
    s = torch.cuda.current_stream(dev).cuda_stream
    lib, invalid = kc._lib(), 1                 # cudaErrorInvalidValue

    def call(**kw):
        f = p._replace(**kw)
        return lib.cross_arms_f32(img.data_ptr(), arms.data_ptr(), H, W, L,
                                  first, 0.1, 0, H, f.halo, f.ty_v,
                                  f.blocks_v, f.blocks_h, f.shared_bytes, s)

    assert call(halo=p.halo - 1) == invalid
    assert call(shared_bytes=p.shared_bytes + 16) == invalid
    assert call(blocks_v=p.blocks_v + 1) == invalid
    assert call(blocks_h=p.blocks_h - 1) == invalid
    assert call(ty_v=12) == invalid             # not a multiple of 8 rows
    # A taller v tile with its own blocks but the shorter tile's bytes.
    taller = 2 * p.ty_v
    assert call(ty_v=taller, blocks_v=-(-W // 32) * -(-H // taller)) == invalid
    torch.cuda.synchronize()
    assert torch.equal(arms, torch.zeros_like(arms))


@pytest.mark.parametrize("H,W,D,L", CROSS_SHAPES + [(288, 384, 57, 25)])
def test_oii_pass_kernel_bit_equal_to_plain(H, W, D, L):
    dev = cuda_device()
    d0 = 5 if D == 57 else 0
    ml, mr = _scene(dev, H, W, D - 1)
    al, ar = (tops.cross_arms(m, L) for m in (ml, mr))
    cost = tops.sad_cost_volume(ml, mr, D, 1.0, d0)
    temp = _launched("oii_pass_h", oii_pass, cost, al, ar, L, 2, d0)
    assert max_ulp(temp, tops.oii_pass_plain(cost, al, ar, L, 2, d0)) == 0
    out = _launched("oii_pass_v", oii_pass, temp, al, ar, L, 1, d0)
    assert max_ulp(out, tops.oii_pass_plain(temp, al, ar, L, 1, d0)) == 0


@pytest.mark.parametrize("case", list(OII_EDGES))
def test_oii_pass_kernel_bit_equal_at_plan_edges(case, monkeypatch):
    """K7 at its plans' edge shapes (torch_support.OII_EDGES), both axes
    (the vertical one anchored by the case's row0/h_glob), on the volume as
    made and on a copy one float off a 16-byte boundary (4-byte copies);
    windows of one tap, inverted and, in `full_windows`, of 2L + 1."""
    dev = cuda_device()
    D, H, W, L, d0, row0, h_glob, full = OII_EDGES[case]
    if case == "D45_chunks":
        monkeypatch.setattr(kc, "OII_BLOCKS", 1)
    vol, al, ar = (torch.from_numpy(a).to(dev) for a in oii_inputs(
        np.random.default_rng(D * 31 + H * W + L), D, H, W, L, full))
    for axis, anchor in ((1, (row0, h_glob)), (2, (0, None))):
        key = "oii_pass_v" if axis == 1 else "oii_pass_h"
        want = tops.oii_pass_plain(vol, al, ar, L, axis, d0, *anchor)
        for v in (vol, _off16(vol)):
            got = _launched(key, oii_pass, v, al, ar, L, axis, d0, *anchor)
            assert max_ulp(got, want) == 0


def test_oii_library_refuses_a_plan_off_its_layout():
    """The entry point takes the wrapper's plan (kernels/cross_oii.py
    oii_tiles) and refuses one that does not cover the planes or match its
    shared layout, launching nothing."""
    dev = cuda_device()
    D, H, W, L = 5, 8, 32, 4
    vol = torch.zeros((D, H, W), device=dev)
    out = torch.zeros((D, H, W), device=dev)
    al = torch.zeros((4, H, W), dtype=torch.int32, device=dev)
    s = torch.cuda.current_stream(dev).cuda_stream
    lib, invalid = kc._lib(), 1                 # cudaErrorInvalidValue
    for axis in (1, 2):
        plan = kc.oii_tiles(D, H, W, L, axis)

        def call(**kw):
            f = plan._replace(**kw)
            return lib.oii_pass_f32(vol.data_ptr(), al.data_ptr(),
                                    al.data_ptr(), out.data_ptr(), D, H, W, L,
                                    0, axis, 0, H, f.dc, f.chunks,
                                    f.stage_bytes, f.arm_bytes,
                                    f.shared_bytes, s)

        assert call(shared_bytes=plan.shared_bytes + 16) == invalid
        assert call(stage_bytes=plan.stage_bytes - 16,
                    shared_bytes=plan.shared_bytes - 32) == invalid
        assert call(chunks=plan.chunks + 1) == invalid
        assert call(dc=plan.dc + 1, arm_bytes=plan.arm_bytes + 8 * plan.ty,
                    shared_bytes=plan.shared_bytes + 8 * plan.ty) == invalid
        other = kc.oii_tiles(D, H, W, L, 3 - axis)  # the other axis's tile
        assert call(**{f: getattr(other, f) for f in (
            "dc", "chunks", "stage_bytes", "arm_bytes", "shared_bytes")}) == invalid
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("H,W,D,L", CROSS_SHAPES + [(288, 384, 301, 25)]
                         + list(VOTE_EDGES.values()))
def test_vote_kernels_equal_plain(H, W, D, L):
    """Bins from a random map, and at D = 301 (d_max 300) bins above 256;
    at the plans' edge shapes (torch_support.VOTE_EDGES) runs of bins with
    ties and bins outside [0, D), odd arms, and vote_v also on an rc one
    byte off a 16-byte boundary (no 16-byte copies)."""
    dev = cuda_device()
    rng = np.random.default_rng(H + D)
    if (H, W, D, L) in VOTE_EDGES.values():
        idx, al = (torch.from_numpy(a).to(dev)
                   for a in vote_inputs(rng, D, H, W, L))
    else:
        ml, _ = _scene(dev, H, W, 60)
        al = tops.cross_arms(ml, L)
        idx = torch.from_numpy(rng.integers(max(0, D - 60), D, (H, W)).astype(
            np.int32)).to(dev)
    rc = _launched("vote_h", vote_h, idx, al, D, L)
    want = tops.vote_counts_plain(idx, al, D, L)
    assert rc.dtype == want.dtype and torch.equal(rc, want)
    mode = _launched("vote_v", vote_v, rc, al, L)
    want_mode = tops.vote_mode_plain(want, al, L)
    assert torch.equal(mode, want_mode)
    off = torch.empty(rc.numel() + 1, dtype=torch.uint8, device=dev)[1:]
    off = off.view(rc.shape).copy_(rc)
    assert off.data_ptr() % 16 == 1
    assert torch.equal(_launched("vote_v", vote_v, off, al, L), want_mode)


def test_vote_library_refuses_a_plan_off_its_layout():
    """The entry points take the wrappers' plans (kernels/cross_oii.py
    vote_h_tiles / vote_v_tiles) and refuse one that does not cover the
    planes or match their shared layout, launching nothing."""
    dev = cuda_device()
    D, H, W, L = 5, 8, 32, 4
    idx = torch.zeros((H, W), dtype=torch.int32, device=dev)
    al = torch.zeros((4, H, W), dtype=torch.int32, device=dev)
    rc = torch.zeros((D, H, W), dtype=torch.uint8, device=dev)
    mode = torch.zeros((H, W), dtype=torch.int32, device=dev)
    h, v = kc.vote_h_tiles(D, H, W, L), kc.vote_v_tiles(D, H, W, L)
    s = torch.cuda.current_stream(dev).cuda_stream
    lib, invalid = kc._lib(), 1                 # cudaErrorInvalidValue

    def vote_h(dc, chunks, shared):
        return lib.vote_h_u8(idx.data_ptr(), al.data_ptr(), rc.data_ptr(), D,
                             H, W, L, dc, chunks, shared, s)

    def vote_v(ty, g, p, stage, region, shared):
        return lib.vote_v_i32(rc.data_ptr(), al.data_ptr(), mode.data_ptr(),
                              D, H, W, L, ty, g, p, stage, region, shared, s)

    assert vote_h(h.dc - 1, h.chunks, h.shared_bytes) == invalid
    assert vote_h(h.dc, h.chunks, h.shared_bytes + 1) == invalid
    assert vote_v(v.ty, v.g, v.p, v.stage_bytes, v.region,
                  v.shared_bytes - 16) == invalid
    assert vote_v(v.ty, v.g, v.p + 4, v.stage_bytes, v.region,
                  v.shared_bytes) == invalid
    torch.cuda.synchronize()
    assert torch.equal(mode, torch.zeros_like(mode))


def test_cross_slice_through_kernels_equals_plain_ops_and_counts_launches():
    dev = cuda_device()
    cfg = TINY_CONFIG
    left, right = _pair(dev, 48, 64, seed=2)
    kernels.reset_launches()
    got = cross_based.cross_pipeline(left, right, cfg)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] for k in kernels.CROSS_KERNELS} == {
        "cross_arms": 2, "sad_volume": 1, "oii_pass_h": 1, "oii_pass_v": 1,
        "vote_h": 1, "vote_v": 1, "median3x3": 3}
    assert all(kernels.LAUNCHES[k] == 0 for k in kernels.ASW_KERNELS
               if k not in kernels.CROSS_KERNELS)
    launched = dict(kernels.LAUNCHES)
    want = cross_based.cross_pipeline(left, right, cfg.replace(
        oii_impl="taps", kernels="jnp"))
    assert kernels.LAUNCHES == launched
    for g, w in zip(got, want):
        assert torch.equal(g, w)



# (row0, rows) windows of a 375-row frame: inside it, 9 rows past its
# bottom (edge-replicated rows), and a 2L-row strip (L = 25) as the cross
# wavefront carries.
ANCHORED = [(100, 140), (250, 134), (300, 50)]


@pytest.mark.parametrize("row0,rows", ANCHORED)
@pytest.mark.parametrize("quirk", [True, False])
def test_anchored_cross_kernels_equal_plain(row0, rows, quirk):
    """K5 and K7's vertical pass on a window of frame rows (row0, h_glob)."""
    dev = cuda_device()
    H, W, D, L = 375, 450, 57, 25
    ml, mr = _scene(dev, H, W, 60)
    idx = torch.arange(row0, row0 + rows, device=dev).clamp_(max=H - 1)
    wl, wr = ml[idx].contiguous(), mr[idx].contiguous()
    al = _launched("cross_arms", cross_arms, wl, L, 0.10, quirk, row0, H)
    assert torch.equal(al, tops.cross_arms(wl, L, 0.10, quirk, row0, H))
    ar = tops.cross_arms(wr, L, 0.10, quirk, row0, H)
    temp = tops.oii_pass_plain(tops.sad_cost_volume(wl, wr, D, 1.0, 5), al,
                               ar, L, 2, 5)
    out = _launched("oii_pass_v", oii_pass, temp, al, ar, L, 1, 5, row0, H)
    assert max_ulp(out, tops.oii_pass_plain(temp, al, ar, L, 1, 5, row0,
                                            H)) == 0


@pytest.mark.parametrize("wf", [True, False], ids=["wavefront", "halo"])
def test_cross_band_drivers_through_kernels_equal_whole_frame(wf):
    dev = cuda_device()
    cfg = TINY_CONFIG.replace(arm_len=4)
    left, right = _scene(dev, 96, 80, cfg.d_max)
    whole = cross_based.cross_pipeline(left, right, cfg)
    got = tiled.cross_pipeline_tiled(left, right, cfg, 3, wavefront=wf)
    assert torch.equal(got[0], whole.initial)
    assert torch.equal(got[1], whole.final)
    taps = tiled.cross_pipeline_tiled(left, right,
                                      cfg.replace(oii_impl="taps"), 3,
                                      wavefront=wf)
    assert torch.equal(taps[0], got[0]) and torch.equal(taps[1], got[1])


# --- the harness, the staged cross pipeline, the debug and batched ASW -----

def _one_frame_launches(run):
    kernels.reset_launches()
    out = run()
    torch.cuda.synchronize()
    return dict(kernels.LAUNCHES), out


@pytest.mark.parametrize("chunks", [0, 2])
def test_harness_launches_one_frame_of_each_method(chunks):
    """One time_asw_method / time_cross_method launches what one frame of
    its pipeline launches, and times every column from CUDA events."""
    from stereo_matchin_tpu_torch.bench import harness

    dev = cuda_device()
    cfg = TINY_CONFIG.replace(aggr_d_chunks=chunks)
    left, right = _pair(dev, 48, 64, seed=6)
    for timed, frame, columns in (
            (harness.time_asw_method, asw.asw_pipeline, harness.ASW_COLUMNS),
            (harness.time_cross_method, cross_based.cross_pipeline,
             harness.CROSS_COLUMNS)):
        want, _ = _one_frame_launches(lambda: frame(left, right, cfg))
        got, times = _one_frame_launches(lambda: timed(left, right, cfg))
        assert got == want and sum(got.values()) > 0
        assert all(times[c] >= 0.0 for c in columns)


def test_staged_cross_pipeline_through_kernels_equals_taps():
    dev = cuda_device()
    cfg = TINY_CONFIG.replace(median_dispatch_quirk=True)
    left, right = _pair(dev, 50, 70, seed=8)
    got = cross_based.cross_pipeline_staged(left, right, cfg)
    want = cross_based.cross_pipeline_staged(left, right,
                                             cfg.replace(oii_impl="taps"))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("k_iters", [2, 0])
def test_asw_debug_through_kernels_equals_the_pipeline(k_iters):
    """The debug result is asw_pipeline's and its captures the plain ops';
    K3/K4 run 1 + r + 1 + k times."""
    dev = cuda_device()
    cfg = TINY_CONFIG.replace(k_iters=k_iters)
    left, right = _pair(dev, 48, 64, seed=9)
    r, k = cfg.r_iters, cfg.k_iters
    launches, dbg = _one_frame_launches(
        lambda: asw.asw_pipeline_debug(left, right, cfg))
    assert {n_: launches[n_] for n_ in kernels.ASW_KERNELS} == {
        "asw_den": 2, "asw_pass_v": r, "asw_pass_h": r, "asw_pass_win": 0,
        "two_min": 1 + r + 1 + k, "wta_diag": 1 + r + 1 + k,
        "support_w": 8, "refine_v": 2 * k, "refine_win": 0,
        "refine_h": 2 * k, "sad_volume": 1, "wta_merge": 1 + r + 1 + k,
        "median3x3": 1, "epipolar_segment": 0, "shard_merge": 0}
    want = asw.asw_pipeline(left, right, cfg)
    for g, w in zip(dbg.result, want):
        assert torch.equal(g, w)
    assert torch.equal(dbg.aggr_wta_left[-1], want.wta_left)
    plain = asw.asw_pipeline_debug(left, right, cfg.replace(kernels="jnp"))
    for f in dbg._fields[:-1]:
        assert torch.equal(getattr(dbg, f), getattr(plain, f)), f


def test_asw_batched_through_kernels_equals_single_frames():
    dev = cuda_device()
    cfg = TINY_CONFIG
    pairs = [_pair(dev, 40, 56, seed=s) for s in (10, 11)]
    got = asw.asw_pipeline_batched(torch.stack([p[0] for p in pairs]),
                                   torch.stack([p[1] for p in pairs]), cfg)
    for b, (left, right) in enumerate(pairs):
        for g, w in zip(got, asw.asw_pipeline(left, right, cfg)):
            assert torch.equal(g[b], w)


@pytest.mark.parametrize("with_penalty", [False, True])
@pytest.mark.parametrize("D,H,W,d0", [(9, 24, 40, 3), (15, 37, 53, 60),
                                      (140, 12, 300, 140)])
def test_two_min_at_a_disparity_offset_bit_equal_to_plain(D, H, W, d0,
                                                         with_penalty):
    """K3 over a disparity shard (plane d holds d0 + d, as the sharded WTA
    runs it): the penalty sc * |ct - (d0 + d)|, d1 the plane index."""
    dev = cuda_device()
    rng = np.random.default_rng(D + d0)
    cost = torch.from_numpy(rng.integers(0, 30, (D, H, W)).astype(
        np.float32)).to(dev)
    cost[:, :2, :3] = 2e5
    pen = (None, None)
    if with_penalty:
        pen = tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in
                    (rng.random((H, W)), rng.random((H, W)) * (d0 + D)))
    got = _launched("two_min", two_min, cost, *pen, BIG, d0)
    for g, w in zip(got, _two_min_plain(cost, *pen, BIG, d0)):
        np.testing.assert_array_equal(n(g), n(w))


@pytest.mark.parametrize("mesh", [(1, 2, 1), (1, 1, 2), (2, 1, 1)])
def test_sharded_pipelines_on_the_card_equal_unsharded(mesh):
    """Two gloo ranks sharing the card (CUDA tensors staged through the
    host): both methods' maps bit-equal to the unsharded frames, and the
    kernels launched per rank and frame (K3 at d0, K13 and K14 on the disp
    shards)."""
    from stereo_matchin_tpu_torch.parallel.distributed import spawn
    from stereo_matchin_tpu_torch.parallel.dryrun import Case, sharded_maps

    dev = cuda_device()
    pairs = [unorm8_pair(np.random.default_rng(s), 48, 64) for s in (1, 2)]
    left, right = (np.stack([p[k] for p in pairs]) for k in (0, 1))
    kw = dict(d_max=15, radius=4, arm_len=6, r_iters=2, k_iters=2)
    cases = [Case("asw", mesh, kw, "p"), Case("cross", mesh, kw, "p")]
    ranks = spawn(sharded_maps, 2, "gloo", (cases, {"p": (left, right)},
                                            "cuda"), 300)
    cfg = TINY_CONFIG.replace(**kw)
    frames = len(pairs) // mesh[0]
    for k, model in ((0, asw.asw_pipeline), (1, cross_based.cross_pipeline)):
        got = ranks[0][k]["maps"]
        for b in range(len(pairs)):
            want = model(*(torch.from_numpy(a[b]).to(dev)
                           for a in (left, right)), cfg)
            for f, w in want._asdict().items():
                if f in got:
                    np.testing.assert_array_equal(got[f][b], n(w), err_msg=f)
        want = dict.fromkeys(kernels.LAUNCHES, 0)
        if k == 0:
            want.update(asw_den=2 * frames, asw_pass_win=cfg.r_iters * frames,
                        asw_pass_h=cfg.r_iters * frames,
                        two_min=(cfg.k_iters + 1) * frames,
                        support_w=8 * frames,
                        refine_win=2 * cfg.k_iters * frames,
                        refine_h=2 * cfg.k_iters * frames,
                        sad_volume=frames, median3x3=frames,
                        epipolar_segment=(cfg.k_iters + 1) * frames,
                        shard_merge=2 * (cfg.k_iters + 1) * frames)
        else:
            want.update(cross_arms=2 * frames, sad_volume=frames,
                        oii_pass_h=frames, oii_pass_v=frames, vote_h=frames,
                        vote_v=frames, median3x3=3 * frames)
        assert all(r[k]["launches"] == want for r in ranks)


SHARDED_KW = dict(d_max=15, radius=4, arm_len=6, r_iters=2, k_iters=2)


@pytest.fixture(scope="module", params=["gloo", "nccl"])
def one_rank(request):
    """One rank of each backend on the card, both methods on the (1, 1, 1)
    mesh, the steps replayed and eager, two frames each: (backend, the
    cases, the rank's records, the pair)."""
    from stereo_matchin_tpu_torch.parallel.distributed import spawn
    from stereo_matchin_tpu_torch.parallel.dryrun import Case, sharded_maps

    cuda_device()
    pairs = [unorm8_pair(np.random.default_rng(s), 48, 64) for s in (3, 4)]
    pair = tuple(np.stack([p[k] for p in pairs]) for k in (0, 1))
    cases = [Case(m, (1, 1, 1), SHARDED_KW, "p", run=run)
             for m in ("asw", "cross") for run in ("replay", "eager")]
    (recs,) = spawn(sharded_maps, 1, request.param,
                    (cases, {"p": pair}, "cuda", 2), 300)
    return request.param, cases, recs, pair


@pytest.mark.parametrize("method", ["asw", "cross"])
def test_replayed_shard_steps_equal_eager_on_one_rank(one_rank, method):
    """A world-size-1 gloo rank and an NCCL rank: the shard's steps replayed
    from CUDA graphs (the default runner) give the eager steps' maps
    (utils.call_stage) and the unsharded frames bit for bit, every frame
    (the first, which captures, included) launches one frame's kernels,
    and the replayed case held step graphs."""
    backend, cases, recs, (left, right) = one_rank
    dev = cuda_device()
    got = {c.run: r for c, r in zip(cases, recs) if c.method == method}
    cfg = TINY_CONFIG.replace(**SHARDED_KW)
    model = asw.asw_pipeline if method == "asw" else cross_based.cross_pipeline
    for b in range(left.shape[0]):
        want = model(*(torch.from_numpy(a[b]).to(dev) for a in (left, right)),
                     cfg)
        for f, w in want._asdict().items():
            if f in got["replay"]["maps"]:
                for run in ("replay", "eager"):
                    np.testing.assert_array_equal(
                        got[run]["maps"][f][b], n(w), err_msg=f"{run} {f}")
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    frames = left.shape[0]
    if method == "asw":
        want.update(asw_den=2 * frames, asw_pass_win=cfg.r_iters * frames,
                    asw_pass_h=cfg.r_iters * frames,
                    two_min=(cfg.k_iters + 1) * frames, support_w=8 * frames,
                    refine_win=2 * cfg.k_iters * frames,
                    refine_h=2 * cfg.k_iters * frames, sad_volume=frames,
                    median3x3=frames,
                    epipolar_segment=(cfg.k_iters + 1) * frames,
                    shard_merge=2 * (cfg.k_iters + 1) * frames)
    else:
        want.update(cross_arms=2 * frames, sad_volume=frames,
                    oii_pass_h=frames, oii_pass_v=frames, vote_h=frames,
                    vote_v=frames, median3x3=3 * frames)
    for run in ("replay", "eager"):
        assert got[run]["frame_launches"] == [want, want], (backend, run)
    assert got["replay"]["stages"]["graphs"] > 0
    assert got["eager"]["stages"]["graphs"] == 0


@pytest.mark.parametrize("method", ["asw", "cross"])
def test_first_sharded_frame_peaks_no_higher_than_a_replay(one_rank, method):
    """A rank's first frame captures its steps, each warmed up inside the
    pool it captures into (resident steps in theirs): its peak reserved
    memory is no more than the replayed frame's plus POOL_MARGIN of the
    step graphs' pools."""
    backend, cases, recs, _ = one_rank
    rec = next(r for c, r in zip(cases, recs)
               if c.method == method and c.run == "replay")
    first, replay = rec["reserved"]
    pool = rec["stages"]["pool_bytes"]
    assert pool > 0
    assert first <= replay + graphs.POOL_MARGIN * pool, (backend, first,
                                                         replay, pool)


def _png_pairs(root, count, H, W):
    """`count` seeded UNORM8 PNG pairs under root/pair<k>/, as StereoPairs."""
    from stereo_matchin_tpu_torch.io import StereoPair, png

    pairs = []
    for k in range(count):
        left, right = unorm8_pair(np.random.default_rng(100 + k), H, W)
        d = root / f"pair{k}"
        d.mkdir()
        png.write_rgb(d / "l.png", left)
        png.write_rgb(d / "r.png", right)
        pairs.append(StereoPair(f"pair{k}", str(d / "l.png"),
                                str(d / "r.png")))
    return pairs


def test_run_decode_path_on_the_card_equals_inline_decode(tmp_path):
    """24 pairs through `run`'s decode path (the loader's host arrays,
    copied to the card as `cmd_run` copies them) while the card is busy
    with a ~ms spin a pair: every tensor equals the pair decoded inline
    (`_load`)."""
    from stereo_matchin_tpu_torch.__main__ import _load, _to_device
    from stereo_matchin_tpu_torch.io import PairLoader

    dev = cuda_device()
    pairs = _png_pairs(tmp_path, 24, 96, 128)
    got = []
    for images in PairLoader([(p.left, p.right) for p in pairs]):
        left, right = _to_device(images, dev)
        assert left.device == right.device == dev
        got.append((left, right))
        torch.cuda._sleep(2_000_000)
    torch.cuda.synchronize()
    assert len(got) == len(pairs)
    for pair, (left, right) in zip(pairs, got):
        want = _load(pair, dev)
        assert torch.equal(left, want[0]) and torch.equal(right, want[1]), \
            pair.name


def test_run_on_the_card_writes_the_pipelines_maps(tmp_path):
    """`run --method both` on the card over three pairs (decoded ahead):
    the maps of the pipelines on the pairs decoded inline."""
    from stereo_matchin_tpu_torch.__main__ import _load, main
    from stereo_matchin_tpu_torch.io import png

    dev = cuda_device()
    pairs = _png_pairs(tmp_path, 3, 48, 64)
    pics = tmp_path / "pics.txt"
    pics.write_text("".join(f"{p.left}\n{p.right}\n" for p in pairs))
    kw = dict(d_max=15, radius=4, arm_len=6, r_iters=2, k_iters=2)
    flags = [a for f, v in kw.items() for a in (f"--{f}", str(v))]
    out = tmp_path / "out"
    assert main(["run", "--pics", str(pics), "--out", str(out),
                 "--device", "cuda"] + flags) == 0
    cfg = StereoConfig(**kw)
    for pair in pairs:
        left, right = _load(pair, dev)
        cross = cross_based.cross_pipeline(left, right, cfg)
        res = asw.asw_pipeline(left, right, cfg)
        d = out / pair.name
        for name, img in (("cross_based_initial.png", cross.initial),
                          ("cross_based_disparity.png", cross.final),
                          ("asw_disparity.png", res.disparity)):
            got = torch.from_numpy(png.read_gray(str(d / name)))
            assert torch.equal(tops.unorm8_code(got),
                               tops.unorm8_code(img).cpu()), name
        np.testing.assert_array_equal(png.read_rgb(str(d / "median.png")),
                                      n(cross.median_left))


@pytest.mark.parametrize("H,W,D,radius", [(12, 16, 9, 3), (40, 64, 16, 16)])
def test_asw_aggregate_2d_on_the_card_equals_the_cpu(H, W, D, radius):
    """Plain torch ops on the card round each operation as the CPU does
    (the division by T included: a divisor tensor, not a Python number)."""
    dev = cuda_device()
    left, right = (torch.from_numpy(a) for a in
                   unorm8_pair(np.random.default_rng(H + D), H, W))
    args = [tops.sad_cost_volume(left, right, D, 255.0)]
    args += [tops.support_weights(img, radius, 30.91, 28.21, axis)
             for axis in (0, 1) for img in (left, right)]
    want = tops.asw_aggregate_2d(*args, radius)
    got = tops.asw_aggregate_2d(*(a.to(dev) for a in args), radius)
    assert got.device == dev
    assert max_ulp(got, want) == 0


# --- the captured frames (utils/graphs.py) ----------------------------------

@pytest.fixture
def fresh_graphs():
    graphs.clear_caches()
    yield graphs.CACHE
    graphs.clear_caches()


def _frame_entry(method, route):
    """(captured entry, eager chain, config) of a method on a route."""
    if method == "asw":
        return (asw.asw_pipeline, asw.asw_pipeline_impl,
                TINY_CONFIG.replace(kernels=route))
    return (cross_based.cross_pipeline, cross_based.cross_pipeline_impl,
            TINY_CONFIG.replace(oii_impl=route))


@pytest.mark.parametrize("method,route", [("asw", "auto"), ("asw", "jnp"),
                                          ("cross", "auto"),
                                          ("cross", "taps")])
def test_captured_frame_equals_eager_on_pairs_it_was_not_captured_on(
        method, route, fresh_graphs):
    """Captured on pair 0, replayed on pairs 1 and 2: every field bit-equal
    to the eager chain, and each call, the first included, counts exactly
    one eager frame's launches."""
    dev = cuda_device()
    entry, impl, cfg = _frame_entry(method, route)
    for seed in (20, 21, 22):
        left, right = _pair(dev, 48, 64, seed=seed)
        launches, got = _one_frame_launches(lambda: entry(left, right, cfg))
        want_launches, want = _one_frame_launches(
            lambda: impl(left, right, cfg))
        assert launches == want_launches
        assert type(got) is type(want)
        for f in want._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert len(fresh_graphs.graphs) == 1
    stats = next(iter(fresh_graphs.graphs.values())).stats
    assert fresh_graphs.stats()["pool_bytes"] > 0 and stats["capture_s"] > 0


def test_batched_replays_one_captured_frame(fresh_graphs):
    dev = cuda_device()
    cfg = TINY_CONFIG
    pairs = [_pair(dev, 40, 56, seed=s) for s in (23, 24, 25)]
    launches, got = _one_frame_launches(lambda: asw.asw_pipeline_batched(
        torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs]),
        cfg))
    one, _ = _one_frame_launches(lambda: asw.asw_pipeline_impl(*pairs[0],
                                                               cfg))
    assert launches == {k: 3 * v for k, v in one.items()}
    for b, (left, right) in enumerate(pairs):
        for g, w in zip(got, asw.asw_pipeline_impl(left, right, cfg)):
            assert torch.equal(g[b], w)
    assert len(fresh_graphs.graphs) == 1


@pytest.mark.parametrize("method", ["asw", "cross"])
def test_held_result_is_not_overwritten_by_the_next_call(method,
                                                         fresh_graphs):
    dev = cuda_device()
    entry, _, cfg = _frame_entry(method, "auto")
    first = entry(*_pair(dev, 48, 64, seed=26), cfg)
    kept = [t.clone() for t in first]
    second = entry(*_pair(dev, 48, 64, seed=27), cfg)
    torch.cuda.synchronize()
    for f, k in zip(first, kept):
        assert torch.equal(f, k)
    assert not torch.equal(first[0], second[0])
    assert all(f.data_ptr() != s.data_ptr() for f, s in zip(first, second))


def test_calls_from_two_streams_each_get_their_own_pair(fresh_graphs):
    """A call on a second stream waits for the first stream's replay and
    clones before it overwrites the static inputs."""
    dev = cuda_device()
    cfg = TINY_CONFIG
    pairs = [_pair(dev, 48, 64, seed=s) for s in (30, 31, 32)]
    asw.asw_pipeline(*pairs[0], cfg)               # the capture
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
    got = []
    for s, pair in zip(streams, pairs[1:]):
        with torch.cuda.stream(s):
            got.append(asw.asw_pipeline(*pair, cfg))
    torch.cuda.synchronize(dev)
    for res, pair in zip(got, pairs[1:]):
        for g, w in zip(res, asw.asw_pipeline_impl(*pair, cfg)):
            assert torch.equal(g, w)
    frame = next(iter(fresh_graphs.graphs.values()))
    assert frame.stats["output_bytes"] == sum(
        t.numel() * t.element_size() for t in got[0])
    assert frame.done is fresh_graphs.done[dev]


def test_new_signature_captures_another_graph(fresh_graphs):
    dev = cuda_device()
    cfg = TINY_CONFIG
    left, right = _pair(dev, 48, 64, seed=28)
    asw.asw_pipeline(left, right, cfg)
    asw.asw_pipeline(left, right, cfg)
    assert len(fresh_graphs.graphs) == 1
    small = _pair(dev, 40, 64, seed=28)
    got = asw.asw_pipeline(*small, cfg)
    assert len(fresh_graphs.graphs) == 2
    cropped = asw.asw_pipeline(left, right, cfg, (3, 5))
    assert len(fresh_graphs.graphs) == 3 and len(fresh_graphs.pools) == 1
    for g, w in zip(got, asw.asw_pipeline_impl(*small, cfg)):
        assert torch.equal(g, w)
    for g, w in zip(cropped, asw.asw_pipeline_impl(left, right, cfg, (3, 5))):
        assert torch.equal(g, w)


def test_every_signature_stays_held_and_held_results_survive_replays(
        fresh_graphs):
    """Five widths captured into the frames' one pool, then replayed in a
    shuffled order: all five graphs stay held, every result equals
    cross_pipeline_impl's bit for bit, and every result held from an
    earlier call is unchanged after each later replay of any signature,
    the shared pool's hazard."""
    dev = cuda_device()
    cfg = TINY_CONFIG
    widths = (40, 48, 56, 64, 72)
    pairs = {w: _pair(dev, 32, w, seed=w) for w in widths}
    want = {w: cross_based.cross_pipeline_impl(*pairs[w], cfg) for w in widths}
    order = list(widths) + [int(w) for w in np.random.default_rng(
        5).permutation(widths * 3)]
    held = []
    for w in order:
        got = cross_based.cross_pipeline(*pairs[w], cfg)
        held.append((w, got))
        for hw, res in held:
            for g, x in zip(res, want[hw]):
                assert torch.equal(g, x), hw
    assert len(fresh_graphs.graphs) == len(widths)
    assert len(fresh_graphs.pools) == 1
    assert sorted(key[1][0][0][1] for key in fresh_graphs.graphs) == list(
        widths)


def _reserved_peaks(call):
    """(first call's, replay's) peak reserved bytes above the card's state
    before the first call, cached blocks released before each."""
    graphs.clear_caches()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    peaks = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = call()
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_reserved() - base)
        del out
    return peaks


@pytest.mark.parametrize("family", ["frame", "band stage"])
def test_first_call_peaks_no_higher_than_a_replay(family, fresh_graphs):
    """A first call warms up inside the pool it captures into: its peak
    reserved memory is no more than a replay's plus POOL_MARGIN of the
    family's pool (the captured frame at 288x384 REFERENCE_CONFIG; the
    400x450 scene in 3 ASW halo bands, whose bands each warm up beside the
    graphs already captured)."""
    dev = cuda_device()
    if family == "frame":
        left, right = _pair(dev, 288, 384, seed=50)
        first, replay = _reserved_peaks(
            lambda: asw.asw_pipeline(left, right, REF_CFG))
        pool = graphs.CACHE.stats()["pool_bytes"]
    else:
        cfg = REF_CFG.replace(aggr_d_chunks=3)
        left, right = _scene_pair(dev, 400, 450, cfg.d_max, 51)
        first, replay = _reserved_peaks(lambda: tiled.asw_pipeline_tiled(
            left, right, cfg, 3, wavefront=False))
        pool = graphs.STAGES.stats()["pool_bytes"]
    assert pool > 0
    assert first <= replay + graphs.POOL_MARGIN * pool, (first, replay, pool)


def test_host_copy_during_capture_raises_and_does_not_fall_back(
        fresh_graphs, monkeypatch):
    """A copy from the host is legal in the warm-up and not in the capture:
    the call raises, counts no launch and keeps no graph; the eager frame
    never stands in."""
    dev = cuda_device()
    cfg = TINY_CONFIG
    left, right = _pair(dev, 48, 64, seed=29)
    median = cross_based._median_stage
    monkeypatch.setattr(cross_based, "_median_stage", lambda img, kern: median(
        img, kern) + torch.tensor([0.0], device=img.device))
    before = dict(kernels.LAUNCHES)
    with pytest.raises(RuntimeError):
        cross_based.cross_pipeline(left, right, cfg)
    assert kernels.LAUNCHES == before
    assert not fresh_graphs.graphs
    monkeypatch.undo()
    got = cross_based.cross_pipeline(left, right, cfg)
    for g, w in zip(got, cross_based.cross_pipeline_impl(left, right, cfg)):
        assert torch.equal(g, w)


# --- the stage graphs (utils/graphs.py StageGraphs, replay_stage) ----------

def _staged(method, cfg, run):
    """A frame of `method` with every stage through `run`."""
    if method == "asw":
        return lambda left, right: asw.asw_pipeline_from_weights(
            left, right, asw.asw_weights(left, right, cfg, run=run), cfg,
            run=run)
    return lambda left, right: cross_based.cross_pipeline_staged(
        left, right, cfg, run=run)


class _Twin:
    """A stage runner that replays each stage from its graph, runs it
    eagerly as well, and holds the two bit-equal, container types
    included."""

    def __init__(self):
        self.names = []

    def run(self, name, fn, *args):
        got = graphs.replay_stage(name, fn, *args)
        want = fn(*args)
        assert type(got) is type(want), name
        g, w = graphs.leaves(got), graphs.leaves(want)
        assert len(g) == len(w) > 0, name
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        self.names.append(name)
        return got


@pytest.mark.parametrize("method,chunks", [("asw", 0), ("asw", 2),
                                           ("cross", 0)])
def test_every_replayed_stage_equals_its_eager_call(method, chunks,
                                                    fresh_graphs):
    """Captured on one pair, every stage of a frame on another pair replays
    (no new graph) bit-equal to its eager call, and the frame equals the
    eager chain's."""
    dev = cuda_device()
    cfg = TINY_CONFIG.replace(aggr_d_chunks=chunks)
    _staged(method, cfg, graphs.replay_stage)(*_pair(dev, 48, 64, seed=40))
    held = graphs.STAGES.stats()
    assert held["graphs"] > 0 and held["pool_bytes"] > 0
    pair = _pair(dev, 48, 64, seed=41)
    twin = _Twin()
    got = _staged(method, cfg, twin.run)(*pair)
    assert graphs.STAGES.stats()["graphs"] == held["graphs"]
    impl = (asw.asw_pipeline_impl if method == "asw"
            else cross_based.cross_pipeline_impl)
    for g, w in zip(got, impl(*pair, cfg)):
        assert torch.equal(g, w)
    if method == "asw":
        r, k = cfg.r_iters, cfg.k_iters
        chunk_count = 2 if chunks else 1
        assert twin.names.count("v_aggr") == chunk_count * (1 + r)
        assert twin.names.count("wta_ref") == k
    else:
        assert len(twin.names) == 8


def test_timed_runs_replay_and_launch_one_frame_each(fresh_graphs):
    """The harness's first run captures its stages; every run, the first
    included, launches exactly one frame's kernels, and later runs capture
    nothing."""
    from stereo_matchin_tpu_torch.bench import harness

    dev = cuda_device()
    cfg = TINY_CONFIG
    left, right = _pair(dev, 48, 64, seed=44)
    for timed, frame in ((harness.time_asw_method, asw.asw_pipeline_impl),
                         (harness.time_cross_method,
                          cross_based.cross_pipeline_impl)):
        want, _ = _one_frame_launches(lambda: frame(left, right, cfg))
        counts = []
        for _ in range(3):
            got, times = _one_frame_launches(lambda: timed(left, right, cfg))
            assert got == want
            assert all(v >= 0.0 for v in times.values())
            counts.append(graphs.STAGES.stats()["graphs"])
        assert counts[0] > 0 and counts[0] == counts[1] == counts[2]


def test_held_stage_results_survive_later_replays(fresh_graphs):
    """Every replay writes the shared pool that holds the graphs' outputs;
    what a call returned is a clone that no later replay touches."""
    dev = cuda_device()
    frame = _staged("asw", TINY_CONFIG, graphs.replay_stage)
    first = frame(*_pair(dev, 48, 64, seed=45))
    kept = [t.clone() for t in first]
    second = frame(*_pair(dev, 48, 64, seed=46))
    torch.cuda.synchronize()
    for f, k in zip(first, kept):
        assert torch.equal(f, k)
    assert not torch.equal(first.aggregated_cost, second.aggregated_cost)


def test_stage_runner_refuses_to_run_inside_a_capture(fresh_graphs):
    dev = cuda_device()
    x = torch.ones(8, device=dev)
    with pytest.raises(RuntimeError, match="inside another capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            graphs.replay_stage("median", torch.neg, x)
    assert not graphs.STAGES.graphs


@pytest.mark.parametrize("k_iters", [2, 0])
def test_captured_debug_equals_its_eager_chain(k_iters, fresh_graphs):
    """asw_pipeline_debug replays one graph: on the pair it was captured on
    and on another, every field, the nested result included, is bit-equal
    to asw_pipeline_debug_impl's, with one debug frame's launches."""
    dev = cuda_device()
    cfg = TINY_CONFIG.replace(k_iters=k_iters)
    for seed in (47, 48):
        pair = _pair(dev, 48, 64, seed=seed)
        launches, got = _one_frame_launches(
            lambda: asw.asw_pipeline_debug(*pair, cfg))
        want_launches, want = _one_frame_launches(
            lambda: asw.asw_pipeline_debug_impl(*pair, cfg))
        assert launches == want_launches
        assert type(got) is asw.ASWDebug
        assert type(got.result) is asw.ASWResult
        for g, w in zip(graphs.leaves(got), graphs.leaves(want)):
            assert torch.equal(g, w)
    assert len(fresh_graphs.graphs) == 1


# --- the band steps replayed from CUDA graphs (models/tiled.py,
# models/wavefront.py, models/wavefront_cross.py) ----------------------------

REF_CFG = StereoConfig()
# (method, bands, wavefront, config): the 400x450 scene at REFERENCE_CONFIG
# with aggr_d_chunks 3; its 3 ASW bands hold no wavefront at k = 6 (each
# band needs 194 rows), so the ASW wavefront in 3 bands runs r = 3, k = 2.
BAND_CASES = [
    ("asw", 2, True, REF_CFG.replace(aggr_d_chunks=3)),
    ("asw", 2, False, REF_CFG.replace(aggr_d_chunks=3)),
    ("asw", 3, True, REF_CFG.replace(aggr_d_chunks=3, r_iters=3, k_iters=2)),
    ("asw", 3, False, REF_CFG.replace(aggr_d_chunks=3)),
    ("cross", 2, True, REF_CFG), ("cross", 2, False, REF_CFG),
    ("cross", 3, True, REF_CFG), ("cross", 3, False, REF_CFG),
]


def _scene_pair(dev, H, W, d_max, seed):
    left, right, _, _ = synthetic_scene(np.random.default_rng(seed), H, W,
                                        d_max)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev)
                 for a in (left, right))


class _Keys:
    """An eager stage runner that records each band step's stage key."""

    def __init__(self):
        self.keys = []

    def run(self, name, fn, *args):
        self.keys.append(graphs.stage_key(name, fn, args))
        return fn(*args)


@pytest.mark.parametrize("method,bands,wf,cfg", BAND_CASES,
                         ids=[f"{m}-{b}-{'wavefront' if w else 'halo'}"
                              for m, b, w, _ in BAND_CASES])
def test_replayed_band_steps_equal_eager_and_whole_frame(method, bands, wf,
                                                         cfg, fresh_graphs):
    """Captured on one scene, replayed on another: the maps bit-equal to
    the eager steps (run=call_stage) and to the whole frame, a graph per
    distinct step key, one eager frame's launches a call, nothing captured
    on the second call, and the first call's maps unchanged by it."""
    from stereo_matchin_tpu_torch.utils import call_stage

    dev = cuda_device()
    if method == "asw":
        driver, impl = tiled.asw_pipeline_tiled, asw.asw_pipeline_impl
    else:
        driver, impl = tiled.cross_pipeline_tiled, \
            cross_based.cross_pipeline_impl
    results, kept = [], None
    for seed in (5, 6):
        left, right = _scene_pair(dev, 400, 450, cfg.d_max, seed)
        launches, got = _one_frame_launches(
            lambda: driver(left, right, cfg, bands, wavefront=wf))
        keys = _Keys()
        want_launches, want = _one_frame_launches(
            lambda: driver(left, right, cfg, bands, wavefront=wf,
                           run=keys.run))
        assert launches == want_launches and sum(launches.values()) > 0
        eager = driver(left, right, cfg, bands, wavefront=wf, run=call_stage)
        whole = impl(left, right, cfg)
        whole = ((whole.disparity, whole.filled) if method == "asw"
                 else (whole.initial, whole.final))
        for g, e, w in zip(got, eager, whole):
            assert torch.equal(g, e) and torch.equal(g, w)
        stats = graphs.STAGES.stats()
        assert stats["graphs"] == len(set(keys.keys)) <= bands
        if seed == 5:
            first = stats
            kept = [m.clone() for m in got]
        else:
            assert stats["capture_s"] == first["capture_s"]
        results.append(got)
    torch.cuda.synchronize()
    for m, k in zip(results[0], kept):
        assert torch.equal(m, k)
    assert not all(torch.equal(a, b) for a, b in zip(*results))


# --- K11 wta_merge, K12 median3x3, K6 on the ASW SAD cost -------------------

def _same_bits(got, want):
    """Bit-equal tensors: NaN confidences (0 / 0) included."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.is_floating_point():
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


@pytest.mark.parametrize("D,H,W,kind", [(61, 40, 300, "argmin"),
                                        (17, 30, 20, "last"),
                                        (33, 24, 70, "zero"),
                                        (280, 8, 700, "random"),
                                        (1, 5, 9, "argmin")])
@pytest.mark.parametrize("pen", ["none", "general", "half"])
def test_wta_merge_bit_equal_to_plain(D, H, W, kind, pen):
    from stereo_matchin_tpu_torch.ops.wta_fast import _wta_epilogue_plain

    dev = cuda_device()
    rng = np.random.default_rng(D + H + W)
    cost = torch.from_numpy(rng.integers(0, 30, (D, H, W)).astype(
        np.float32)).to(dev)
    cost[:, :2, :3] = BIG
    cost[: D // 2, 2:4] = 2 * BIG
    maps = (None, None)
    if pen != "none":
        ct = (rng.integers(0, D, (H, W)) + 0.5 if pen == "half"
              else rng.uniform(-2, D + 2, (H, W)))
        maps = tuple(torch.from_numpy(a.astype(np.float32)).to(dev)
                     for a in (rng.uniform(0, 2, (H, W)), ct))
    c1, c2, d1 = _two_min_plain(cost, *maps, big=BIG)
    d1 = {"argmin": d1, "zero": torch.zeros_like(d1),
          "last": torch.full_like(d1, D - 1),
          "random": torch.from_numpy(rng.integers(0, D, (H, W)).astype(
              np.int32)).to(dev)}[kind]
    inputs = (c1, c2, d1, *_diag_two_min_plain(cost, d1, *maps, big=BIG),
              *maps)
    before = kernels.LAUNCHES["wta_merge"]
    _same_bits(kw.wta_merge(*inputs, BIG, D),
               _wta_epilogue_plain(*inputs, BIG, D))
    assert kernels.LAUNCHES["wta_merge"] == before + 1


@pytest.mark.parametrize("refined", [False, True])
def test_wta_routes_launch_k3_k4_k11_and_equal_the_plain_ops(refined):
    dev = cuda_device()
    rng = np.random.default_rng(5)
    D, H, W = 61, 48, 96
    cost = torch.from_numpy(rng.integers(0, 30, (D, H, W)).astype(
        np.float32)).to(dev)
    args = ()
    if refined:
        args = (*(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
            rng.uniform(0, D, (H, W)), rng.uniform(0, 2, (H, W)),
            rng.integers(0, D, (H, W)) + 0.5, rng.uniform(0, 2, (H, W)))),
            0.05)
    fn = tops.wta_refined_fast if refined else tops.wta_fast
    kernels.reset_launches()
    got = fn(cost, *args, big=BIG)
    torch.cuda.synchronize()
    assert [kernels.LAUNCHES[k] for k in ("two_min", "wta_diag",
                                          "wta_merge")] == [1, 1, 1]
    _same_bits(got, fn(cost, *args, big=BIG, kernels="jnp"))
    assert kernels.LAUNCHES["wta_merge"] == 1


@pytest.mark.parametrize("shape,offset", [((288, 384, 3), 0), ((288, 384), 0),
                                          ((375, 450, 3), 0), ((37, 53), 1),
                                          ((1, 1), 0), ((5, 1, 3), 0),
                                          ((3, 300, 1), 0)])
def test_median3x3_bit_equal_to_plain(shape, offset):
    from stereo_matchin_tpu_torch.kernels.median import median3x3

    dev = cuda_device()
    rng = np.random.default_rng(sum(shape))
    count = int(np.prod(shape))
    flat = torch.from_numpy(rng.integers(0, 8, offset + count).astype(
        np.float32) / np.float32(7)).to(dev)
    img = flat[offset:].view(shape)
    before = kernels.LAUNCHES["median3x3"]
    got = median3x3(img)
    assert got.is_contiguous() and got.shape == img.shape
    assert torch.equal(got, tops.median3x3_plain(img))
    assert torch.equal(tops.median3x3(img), got)
    assert torch.equal(tops.median3x3(img[..., 0] if img.dim() == 3 else img,
                                      kernels="pallas"),
                       tops.median3x3_plain(img[..., 0] if img.dim() == 3
                                            else img))
    assert kernels.LAUNCHES["median3x3"] == before + 3


@pytest.mark.parametrize("H,W,D,d0", [(288, 384, 61, 0), (288, 384, 30, 31),
                                      (375, 450, 21, 42), (40, 600, 70, 210)])
def test_sad_volume_at_scale_255_bit_equal_to_plain(H, W, D, d0):
    dev = cuda_device()
    left, right = _pair(dev, H, W, seed=D + d0)
    before = kernels.LAUNCHES["sad_volume"]
    got = tops.sad_cost(left, right, D, 255.0, d0)
    assert kernels.LAUNCHES["sad_volume"] == before + 1
    assert torch.equal(got, tops.sad_cost_volume(left, right, D, 255.0, d0))
    assert torch.equal(tops.sad_cost(left, right, D, 255.0, d0, "jnp"), got)
    assert kernels.LAUNCHES["sad_volume"] == before + 1


# --- K13 epipolar_segment, K14 shard_merge (the sharded WTA) -----------------

def _wta_sharded():
    """parallel/wta_sharded.py (the package exports a function of its
    name)."""
    import importlib

    return importlib.import_module(
        "stereo_matchin_tpu_torch.parallel.wta_sharded")


def _shard_wta_bit_equal(vols, dl, d_pad, maps, d1_of, penalty=0.085):
    """One frame of the sharded WTA's steps through K13/K14 ("pallas")
    against their plain versions ("jnp") on the card, the same bits: K14's
    reference merge of the shards' K3 summaries, K13 on every shard from
    d1_of(the merged reference's d), K14's target merge of K13's segments.
    maps: the WTA_REF's (ref_value, ref_denom, ref_value_t, ref_denom_t)
    on the card, or None.  Returns the launches counted."""
    twta = _wta_sharded()
    ref_pen = (maps[1], maps[0], penalty) if maps else (None,) * 3
    tgt_pen = (maps[3], maps[2], penalty) if maps else (None,) * 3
    g = torch.stack([twta.local_two_min(v, *ref_pen, k * dl, BIG, "jnp")
                     for k, v in enumerate(vols)])
    before = dict(kernels.LAUNCHES)
    ref = twta.merge_reference_step(g, BIG, "jnp")
    _same_bits(twta.merge_reference_step(g, BIG, "pallas"), ref)
    d1 = d1_of(ref.d)
    segs = []
    for k, v in enumerate(vols):
        segs.append(twta.epipolar_segment(v, d1, k * dl, dl, d_pad, *tgt_pen,
                                          BIG, "pallas"))
        _same_bits(segs[-1:], [twta.epipolar_segment(
            v, d1, k * dl, dl, d_pad, *tgt_pen, BIG, "jnp")])
    g_t = torch.stack(segs)
    _same_bits(twta.merge_target_step(g_t, ref.c1, ref.c2, d1, BIG, "pallas"),
               twta.merge_target_step(g_t, ref.c1, ref.c2, d1, BIG, "jnp"))
    torch.cuda.synchronize()
    launched = {k: kernels.LAUNCHES[k] - before[k]
                for k in ("epipolar_segment", "shard_merge")}
    # Both of K13's walks, whichever the shape takes.
    from stereo_matchin_tpu_torch.kernels import wta_shard as kws

    sc = twta._scaled(tgt_pen[0], tgt_pen[2])
    for k, v in enumerate(vols):
        for walk in ("pixel", "segment"):
            _same_bits([kws.epipolar_segment(v, d1, k * dl, dl, d_pad, sc,
                                             tgt_pen[1], BIG, walk)],
                       segs[k:k + 1])
    return launched


@pytest.mark.parametrize("with_penalty", [False, True])
@pytest.mark.parametrize("case", list(SHARD_WTA_EDGES))
def test_shard_wta_kernels_bit_equal_to_plain(case, with_penalty):
    dev = cuda_device()
    D, shards, H, W, kind = SHARD_WTA_EDGES[case]
    rng = np.random.default_rng(sum(map(ord, case)) + with_penalty)
    cost, maps, rand = shard_wta_inputs(rng, D, shards, H, W, BIG)
    d_pad = cost.shape[0]
    dl = d_pad // shards
    vols = [torch.from_numpy(cost[k * dl:(k + 1) * dl]).to(dev)
            for k in range(shards)]
    d1_of = shard_wta_d1(kind, D, rand)
    maps = (tuple(torch.from_numpy(m).to(dev) for m in maps)
            if with_penalty else None)
    assert _shard_wta_bit_equal(vols, dl, d_pad, maps, d1_of) == {
        "epipolar_segment": shards, "shard_merge": 2}


def test_shard_wta_kernels_bit_equal_at_a_config3_shard():
    """Both shards of a config-3 (1, 2, 2) mesh: 140 of 280 planes of 994
    x 2880 each, integer costs, d1 uniform, with and without the
    penalty."""
    dev = cuda_device()
    H, W, D = 994, 2880, 280
    gen = torch.Generator(device=dev).manual_seed(61)
    vols = [torch.rand((D // 2, H, W), generator=gen, device=dev).mul_(
        400).floor_() for _ in range(2)]

    def ints(hi):
        return torch.randint(0, hi, (H, W), generator=gen, device=dev,
                             dtype=torch.int32)

    maps = (ints(D) + 0.5 * ints(2), torch.rand((H, W), generator=gen,
                                                device=dev) * 3,
            ints(D) + 0.5 * ints(2), torch.rand((H, W), generator=gen,
                                                device=dev) * 3)
    d1 = ints(D)
    for m in (None, maps):
        assert _shard_wta_bit_equal(vols, D // 2, D, m, lambda d: d1) == {
            "epipolar_segment": 2, "shard_merge": 2}
    del vols
    torch.cuda.empty_cache()


def test_shard_wta_wrappers_refuse_bad_arguments():
    from stereo_matchin_tpu_torch.kernels import wta_shard as kws

    dev = cuda_device()
    cost = torch.zeros((4, 5, 6), device=dev)
    d1 = torch.zeros((5, 6), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        kws.epipolar_segment(cost.transpose(1, 2).contiguous().transpose(
            1, 2), d1, 0, 4, 8)
    with pytest.raises(ValueError, match="n_local"):
        kws.epipolar_segment(cost, d1, 0, 5, 8)
    with pytest.raises(ValueError, match="lies on"):
        kws.epipolar_segment(cost, d1.cpu(), 0, 4, 8)
    g = torch.zeros((2, 3, 5, 6), device=dev)
    with pytest.raises(ValueError, match="gathered"):
        kws.shard_merge_reference(g[:, :2])
    with pytest.raises(ValueError, match="contiguous"):
        kws.shard_merge_reference(g.transpose(2, 3).contiguous().transpose(
            2, 3))


@pytest.mark.parametrize("d1_kind", ["uniform", "structured", "shifted"])
@pytest.mark.parametrize("D,shards,H,W", [(280, 1, 3, 2000), (280, 2, 40, 2880),
                                          (61, 2, 17, 3100), (62, 2, 9, 384)])
def test_epipolar_segment_staged_ring_bit_equal_to_plain(D, shards, H, W,
                                                         d1_kind):
    """K13 where its ring turns over many times: d1 uniform in [0, D) (a
    block stages nearly every plane of its shard, each window its segment
    and the spread of d1 before it), a structured d1 (a smooth surface in
    [0, 40) with about 3 in 32 outliers in [D // 3, D - 1]: planes above
    the staged range by direct loads) and the shifted pair's (37 with 3 in
    100 pixels uniform: on the second shard a short queue, several lanes
    a pixel), one shard of 280 planes, the two shards of config 3 at 2880
    columns, rows of three segments and the 288x384 frame's shards; with
    and without the penalty.  Same bits as the plain version."""
    dev = cuda_device()
    gen = torch.Generator(device=dev).manual_seed(D + H + W)
    vols = [torch.rand((D // shards, H, W), generator=gen, device=dev).mul_(
        30).floor_() for _ in range(shards)]
    d1 = {"uniform": lambda: torch.randint(0, D, (H, W), generator=gen,
                                           device=dev, dtype=torch.int32),
          "structured": lambda: structured_d1(H, W, D, D + W, dev),
          "shifted": lambda: shifted_d1(H, W, D, D + W, dev,
                                        min(37, D // 3))}[d1_kind]()

    def ints(hi):
        return torch.randint(0, hi, (H, W), generator=gen, device=dev,
                             dtype=torch.int32)

    maps = (ints(D) + 0.5 * ints(2), torch.rand((H, W), generator=gen,
                                                device=dev) * 3,
            ints(D) + 0.5 * ints(2), torch.rand((H, W), generator=gen,
                                                device=dev) * 3)
    for m in (None, maps):
        assert _shard_wta_bit_equal(vols, D // shards, D, m,
                                    lambda d: d1) == {
            "epipolar_segment": shards, "shard_merge": 2}


def test_epipolar_segment_refuses_a_ring_that_does_not_fit():
    """total_disp 6000 on rows of 8000 columns: each ring window may span
    the whole row (a segment and the 5998 columns before it), and the
    ring's windows are more than a block's shared memory, so the wrapper
    raises and runs no other walk; at total_disp 280 the ring fits."""
    from stereo_matchin_tpu_torch.kernels import wta_shard as kws

    dev = cuda_device()
    cost = torch.zeros((4, 2, 8000), device=dev)
    d1 = torch.zeros((2, 8000), dtype=torch.int32, device=dev)
    before = kernels.LAUNCHES["epipolar_segment"]
    with pytest.raises(ValueError, match="does not fit"):
        kws.epipolar_segment(cost, d1, 0, 4, 6000)
    assert kernels.LAUNCHES["epipolar_segment"] == before
    kws.epipolar_segment(cost, d1, 0, 4, 280)
    assert kernels.LAUNCHES["epipolar_segment"] == before + 1


@pytest.mark.parametrize("signed_zeros", [False, True])
@pytest.mark.parametrize("shape", [(1988, 2880, 3), (1025, 4096), (300, 2000, 4),
                                   (70, 45, 3), (33, 1, 3), (1, 90, 4),
                                   (2, 129), (67, 300, 1)])
def test_median3x3_bit_equal_to_plain_at_tile_edges(shape, signed_zeros):
    """K12's tiles at their edges: 32-row tiles (config 3's image, and a
    map whose last tile has one row), 16-row tiles of four channels (the
    generic C), H and W * C off the tile, H = 1, W = 1; on levels, and on
    levels whose zeros are +0.0 and -0.0 at random (which zero survives
    an exchange of equal values depends on the operands' order).  Same
    bits as the plain version."""
    from stereo_matchin_tpu_torch.kernels import median as km

    dev = cuda_device()
    H, W = shape[:2]
    C = shape[2] if len(shape) == 3 else 1
    ty = km.median_tiles(H, W, C)[1]
    assert ty == {(1988, 2880, 3): 32, (1025, 4096): 32,
                  (300, 2000, 4): 16}.get(shape, ty)
    gen = torch.Generator(device=dev).manual_seed(H + W + C)
    img = torch.randint(0, 8, shape, generator=gen, device=dev).float() / 7
    if signed_zeros:
        neg = torch.rand(shape, generator=gen, device=dev) < 0.5
        img = torch.where((img == 0) & neg, -0.0, img)
        assert bool(img.signbit().any())
    before = kernels.LAUNCHES["median3x3"]
    got, want = km.median3x3(img), tops.median3x3_plain(img)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert kernels.LAUNCHES["median3x3"] == before + 1


@pytest.mark.parametrize("W,n_local,total_disp", [
    (2880, 140, 280), (384, 31, 62), (3101, 5, 10), (1, 1, 1), (2000, 280, 280),
    (8000, 4, 6000)])
def test_segment_plan_is_the_walks(W, n_local, total_disp):
    """The plan the built K13 reports (kernels/wta_shard.py segment_plan)
    is the one tests/test_torch_wta_shard_tiles.py walks (k13_plan), and
    both refuse the same shapes."""
    from stereo_matchin_tpu_torch.kernels import wta_shard as kws

    cuda_device()
    try:
        want = k13_plan(W, n_local, total_disp)
    except ValueError:
        with pytest.raises(ValueError, match="does not fit"):
            kws.segment_plan(W, n_local, total_disp)
        return
    want.pop("unroll")
    want.pop("unroll_pixel")
    assert kws.segment_plan(W, n_local, total_disp) == want


@pytest.mark.parametrize("H,W,C", [(1988, 2880, 3), (1988, 2880, 1),
                                   (288, 384, 3), (300, 2000, 4), (1, 1, 1),
                                   (4, 4, 2000)])
def test_median_tiles_are_the_walks(H, W, C):
    """The tiles the built K12 reports (kernels/median.py median_tiles) are
    the ones tests/test_torch_median.py walks (k12_tiles), and both refuse
    the same shapes."""
    from stereo_matchin_tpu_torch.kernels import median as km

    cuda_device()
    try:
        want = k12_tiles(H, W, C)
    except ValueError:
        with pytest.raises(ValueError, match="does not fit"):
            km.median_tiles(H, W, C)
        return
    assert km.median_tiles(H, W, C) == want
