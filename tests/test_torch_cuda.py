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
from .torch_support import (ARMS_EDGES, OII_EDGES, SAD_EDGES, VOTE_EDGES,
                            arms_image, cuda_device, k4_queued, max_ulp, n,
                            oii_inputs, outlier_d1, sad_inputs, unorm8_pair,
                            vote_inputs)

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
        "wta_diag": cfg.k_iters + 1}
    assert all(kernels.LAUNCHES[k] == 0 for k in kernels.CROSS_KERNELS)
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
        "vote_h": 1, "vote_v": 1}
    assert all(kernels.LAUNCHES[k] == 0 for k in kernels.ASW_KERNELS)
    launched = dict(kernels.LAUNCHES)
    want = cross_based.cross_pipeline(left, right, cfg.replace(oii_impl="taps"))
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
        "two_min": 1 + r + 1 + k, "wta_diag": 1 + r + 1 + k}
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
    kernels launched per rank and frame (K3 at d0 on the disp shards)."""
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
                        two_min=(cfg.k_iters + 1) * frames)
        else:
            want.update(cross_arms=2 * frames, sad_volume=frames,
                        oii_pass_h=frames, oii_pass_v=frames, vote_h=frames,
                        vote_v=frames)
        assert all(r[k]["launches"] == want for r in ranks)


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
    assert len(fresh_graphs.frames) == 1
    stats = next(iter(fresh_graphs.frames.values())).stats
    assert stats["pool_bytes"] > 0 and stats["capture_s"] > 0


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
    assert len(fresh_graphs.frames) == 1


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
    frame = next(iter(fresh_graphs.frames.values()))
    assert frame.stats["output_bytes"] == sum(
        t.numel() * t.element_size() for t in got[0])
    assert frame.footprint == (frame.stats["pool_bytes"]
                               + frame.stats["output_bytes"])


def test_new_signature_captures_another_graph(fresh_graphs):
    dev = cuda_device()
    cfg = TINY_CONFIG
    left, right = _pair(dev, 48, 64, seed=28)
    asw.asw_pipeline(left, right, cfg)
    asw.asw_pipeline(left, right, cfg)
    assert len(fresh_graphs.frames) == 1
    small = _pair(dev, 40, 64, seed=28)
    got = asw.asw_pipeline(*small, cfg)
    assert len(fresh_graphs.frames) == 2
    cropped = asw.asw_pipeline(left, right, cfg, (3, 5))
    assert len(fresh_graphs.frames) == 3
    for g, w in zip(got, asw.asw_pipeline_impl(*small, cfg)):
        assert torch.equal(g, w)
    for g, w in zip(cropped, asw.asw_pipeline_impl(left, right, cfg, (3, 5))):
        assert torch.equal(g, w)


def test_least_recently_used_graph_is_evicted_past_four(fresh_graphs):
    dev = cuda_device()
    cfg = TINY_CONFIG
    pairs = {w: _pair(dev, 32, w, seed=w) for w in (40, 48, 56, 64, 72)}
    for w in (40, 48, 56, 64):
        cross_based.cross_pipeline(*pairs[w], cfg)
    cross_based.cross_pipeline(*pairs[40], cfg)       # 48 is now the oldest
    assert len(fresh_graphs.frames) == graphs.MAX_GRAPHS == 4
    cross_based.cross_pipeline(*pairs[72], cfg)
    widths = [key[1][0][0][1] for key in fresh_graphs.frames]
    assert widths == [56, 64, 40, 72]
    for w, (left, right) in pairs.items():
        got = cross_based.cross_pipeline(left, right, cfg)
        for g, want in zip(got, cross_based.cross_pipeline_impl(left, right,
                                                                cfg)):
            assert torch.equal(g, want), w
    assert len(fresh_graphs.frames) == 4


def test_host_copy_during_capture_raises_and_does_not_fall_back(
        fresh_graphs, monkeypatch):
    """A copy from the host is legal in the warm-up and not in the capture:
    the call raises, counts no launch and keeps no graph; the eager frame
    never stands in."""
    dev = cuda_device()
    cfg = TINY_CONFIG
    left, right = _pair(dev, 48, 64, seed=29)
    median = cross_based._median_stage
    monkeypatch.setattr(cross_based, "_median_stage", lambda img: median(
        img) + torch.tensor([0.0], device=img.device))
    before = dict(kernels.LAUNCHES)
    with pytest.raises(RuntimeError):
        cross_based.cross_pipeline(left, right, cfg)
    assert kernels.LAUNCHES == before
    assert not fresh_graphs.frames
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
    assert len(fresh_graphs.frames) == 1
