"""The plan of the strip kernels K9 (`support_w`) and K10 (`refine_pass`)
(kernels/asw_refine.py `strip_tiles`), walked block by block in numpy as
csrc/asw_refine.cu indexes: one thread per output pixel, the taps in
order, the neighbours clamped in the kernel (K9's colour to the image,
its distance to the frame; K10's maps to the frame, or a window of real
rows), a strip's planes read through a tap stride.  The walk must equal
the plain versions (ops/support.py support_weights, ops/refinement.py
refine_pass_v / refine_pass_v_win / refine_pass_h) bit for bit; K9's walk
stops at the exp's argument and applies the same torch.exp as the plain
version (on the card the exp phase of chip_smoke.py holds nvcc's expf
against torch.exp on every float32 in [-80, 0]).

Then the routing of the `kernels` keyword on the CPU, and the launch
tables of chip_smoke.py (expected_asw_launches, sharded_launches) held
against the K9/K10 calls of a frame on each route, with the wrappers
counted where a card would launch them.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from stereo_matchin_tpu_torch import kernels
from stereo_matchin_tpu_torch import ops as tops
from stereo_matchin_tpu_torch.config import StereoConfig
from stereo_matchin_tpu_torch.kernels import asw_refine as kr
from stereo_matchin_tpu_torch.models import asw, tiled
from stereo_matchin_tpu_torch.ops.support import weight_scales
from stereo_matchin_tpu_torch.parallel import asw_sharded, ops_tiled
from stereo_matchin_tpu_torch.utils import call_stage

from .torch_support import max_ulp, t, unorm8_pair

EPS = 1e-5
F32 = np.float32
GAMMAS = [(30.91, 28.21), (10.94, 118.78)]
# K9 cases, (radius, H, W, axis, row0, h_glob, rows): a width past two
# blocks; T = 1; H and W under T (T = 33, the compiled-in taps); frame
# rows 5..13 of 30; the centre rows of the second row shard's tile of a
# 24-row frame (shard rows 12..23, halo 3: tile rows 9..26 clamped to 23);
# the same at T = 33 with a tile taller than its frame.
SUPPORT_CASES = [(4, 20, 300, a, 0, None, None) for a in (0, 1)] + [
    (0, 5, 7, 0, 0, None, None), (0, 5, 7, 1, 0, None, None),
    (16, 10, 20, 0, 0, None, None), (16, 10, 20, 1, 0, None, None),
    (3, 9, 40, 0, 5, 30, None), (3, 18, 40, 0, 9, 24, (3, 12)),
    (16, 42, 20, 0, -6, 20, (16, 10))]
# K10 cases, (radius, H, W, rows of the strip it is a view of, first row
# of the view): whole strips, a cropped strip (a band's rows of a larger
# one), T = 1, H and W under T.
REFINE_CASES = [(4, 20, 300, 20, 0), (4, 12, 140, 20, 5), (0, 5, 7, 5, 0),
                (16, 10, 20, 10, 0), (16, 9, 13, 14, 3), (2, 3, 129, 9, 6)]


def _img(rng, H, W):
    return (rng.integers(0, 256, (H, W, 3)) / F32(255)).astype(F32)


def _maps(rng, rows, W, d_max=15):
    return (rng.integers(0, d_max + 1, (rows, W)).astype(F32),
            rng.uniform(0.001, 1.0, (rows, W)).astype(F32))


def _blocks(plan, H, W):
    """(x, y) of the live threads of each block, as the kernel's guard."""
    ty, tx = np.mgrid[0:plan.by, 0:plan.bx]
    gx, gy = plan.grid
    assert gx * plan.bx >= W and gy * plan.by >= H
    assert plan.bx * plan.by <= 1024 and gy <= kr.GRID_Y
    for bxi in range(gx):
        for byi in range(gy):
            x, y = bxi * plan.bx + tx, byi * plan.by + ty
            live = (x < W) & (y < H)
            yield x[live], y[live]


def walk_support(img, radius, gammas, axis, row0=0, h_glob=None, rows=None):
    """K9's exp arguments for one launch, (T, h_out, W) f32, and how many
    times each output was written."""
    H_in, W = img.shape[:2]
    y_first, h_out = (0, H_in) if rows is None else rows
    h_glob = H_in if h_glob is None else h_glob
    T, R = 2 * radius + 1, radius
    plan = kr.strip_tiles(T, h_out, W)
    assert plan.baked == (T == kr.BAKED_TAPS)
    inv_c, inv_p = (F32(v) for v in weight_scales(*gammas))
    last = h_glob - 1 if axis == 0 else W - 1
    args = np.full((T, h_out, W), np.nan, F32)
    written = np.zeros((T, h_out, W), np.int32)
    for x, j in _blocks(plan, h_out, W):
        y = y_first + j
        p = img[y, x] * F32(255)
        pos, n_img = (y, H_in) if axis == 0 else (x, W)
        i = row0 + y if axis == 0 else x
        for tap in range(T):
            off = tap - R
            q = np.clip(pos + off, 0, n_img - 1)
            qc = img[q, x] if axis == 0 else img[y, q]
            a = np.abs(p - qc * F32(255))
            c = ((a[:, 0] + a[:, 1]) + a[:, 2]) * inv_c
            dist = np.abs(i - np.clip(i + off, 0, last)).astype(F32) * inv_p
            args[tap, j, x] = -c - dist
            written[tap, j, x] += 1
    return args, written


def walk_refine(mode, strip, r0, H, d, conf, eps, dv=None):
    """K10's (value, den) for one launch over the rows r0 .. r0 + H - 1 of
    `strip` (T, rows, W), read through its flat storage with the tap
    stride, and how many times each output was written."""
    T, _, W = strip.shape
    R = (T - 1) // 2
    flat, base, w_tap = strip.reshape(-1), r0 * W, strip.shape[1] * W
    plan = kr.strip_tiles(T, H, W)
    dflat, cflat = d.reshape(-1), conf.reshape(-1)
    value = np.full((H, W), np.nan, F32)
    den_out = np.full((H, W), np.nan, F32)
    written = np.zeros((H, W), np.int32)
    for x, y in _blocks(plan, H, W):
        num = np.full(x.shape, eps, F32)
        den = np.full(x.shape, eps, F32)
        for tap in range(T):
            wt = flat[base + tap * w_tap + y * W + x]
            if mode == "h":
                nb = y * W + np.clip(x + tap - R, 0, W - 1)
                wf = wt * cflat[nb]
                dvn = dv.reshape(-1)[nb]
                num = num + (wf * dflat[nb]) * dvn
                den = den + wf * dvn
            else:
                r = np.clip(y + tap - R, 0, H - 1) if mode == "v" else y + tap
                nb = r * W + x
                wf = wt * cflat[nb]
                num = num + wf * dflat[nb]
                den = den + wf
        value[y, x] = num / den
        den_out[y, x] = den
        written[y, x] += 1
    return value, den_out, written


@pytest.mark.parametrize("case", SUPPORT_CASES)
@pytest.mark.parametrize("gammas", GAMMAS)
def test_support_walk_equals_plain(case, gammas):
    R, H, W, axis, row0, h_glob, rows = case
    img = _img(np.random.default_rng(H * W + R), H, W)
    args, written = walk_support(img, R, gammas, axis, row0, h_glob, rows)
    assert (written == 1).all()
    want = tops.support_weights(t(img), R, *gammas, axis, row0, h_glob,
                                kernels="jnp")
    y0, h = (0, H) if rows is None else rows
    assert max_ulp(torch.exp(t(args)), want[:, y0:y0 + h]) == 0
    got = kr.support_w(t(img), R, *gammas, axis, row0, h_glob, rows)
    assert torch.equal(got, want[:, y0:y0 + h])


@pytest.mark.parametrize("case", REFINE_CASES)
def test_refine_walk_equals_plain(case):
    R, H, W, rows, r0 = case
    rng = np.random.default_rng(H * W + rows)
    strip = tops.support_weights(t(_img(rng, rows, W)), R, *GAMMAS[1], 0,
                                 kernels="jnp").numpy()
    w = t(strip)[:, r0:r0 + H]
    d, conf = _maps(rng, H, W)
    want = tops.refine_pass_v(w, t(d), t(conf), R, EPS, kernels="jnp")
    *got, written = walk_refine("v", strip, r0, H, d, conf, EPS)
    assert (written == 1).all()
    assert max_ulp(got[0], want[0]) == 0 and max_ulp(got[1], want[1]) == 0
    vv, dv = (x.numpy() for x in want)
    want = tops.refine_pass_h(w, *(t(x) for x in (vv, dv, conf)), R, EPS,
                              kernels="jnp")
    *got, written = walk_refine("h", strip, r0, H, vv, conf, EPS, dv)
    assert (written == 1).all()
    assert max_ulp(got[0], want[0]) == 0 and max_ulp(got[1], want[1]) == 0


@pytest.mark.parametrize("R,h_glob,W,shards", [(4, 24, 40, 2), (2, 12, 30, 4),
                                               (0, 6, 9, 2)])
def test_window_walk_on_a_shard_equals_plain_and_whole_frame(R, h_glob, W,
                                                             shards):
    """K10 win on each row shard's exchanged maps (rows clamped to the
    frame, as the halo exchange leaves them) and weights of its centre
    rows: equal to the plain windowed pass and to the whole frame's
    vertical pass on the shard's rows."""
    rng = np.random.default_rng(h_glob + W)
    frame = _img(rng, h_glob, W)
    d, conf = _maps(rng, h_glob, W)
    whole = tops.support_weights(t(frame), R, *GAMMAS[1], 0, kernels="jnp")
    v = tops.refine_pass_v(whole, t(d), t(conf), R, EPS, kernels="jnp")
    h_loc = h_glob // shards
    for s in range(shards):
        row0 = s * h_loc
        win = np.clip(np.arange(row0 - R, row0 + h_loc + R), 0, h_glob - 1)
        halo = max(R, 1)
        tile = frame[np.clip(np.arange(row0 - halo, row0 + h_loc + halo), 0,
                             h_glob - 1)]
        w = ops_tiled.support_weights_tiled(t(tile), R, *GAMMAS[1], row0,
                                            h_glob, halo, kernels="jnp")
        args, _ = walk_support(tile, R, GAMMAS[1], 0, row0 - halo, h_glob,
                               (halo, h_loc))
        assert max_ulp(torch.exp(t(args)), w) == 0
        want = tops.refine_pass_v_win(w, t(d[win]), t(conf[win]), EPS,
                                      kernels="jnp")
        *got, written = walk_refine("win", w.numpy(), 0, h_loc, d[win],
                                    conf[win], EPS)
        assert (written == 1).all()
        for g, p, f in zip(got, want, v):
            assert max_ulp(g, p) == 0
            assert max_ulp(g, f[row0:row0 + h_loc]) == 0


def test_strip_plan_and_refusals():
    plan = kr.strip_tiles(33, 1988, 2880)
    assert plan.baked and plan.grid == (-(-2880 // plan.bx),
                                        -(-1988 // plan.by))
    assert not kr.strip_tiles(31, 5, 5).baked
    for T in (0, 4):
        with pytest.raises(ValueError):
            kr.strip_tiles(T, 5, 5)
    with pytest.raises(ValueError):
        kr.strip_tiles(33, kr.GRID_Y * kr.BLOCK[1] + 1, 5)
    w = torch.zeros(5, 4, 6)
    m = torch.zeros(4, 6)
    with pytest.raises(ValueError):
        kr.refine_pass(w, m, m, EPS, "x")
    with pytest.raises(ValueError):
        kr.refine_pass(w, m, m, EPS, "h")            # no dv
    with pytest.raises(ValueError):
        kr.refine_pass(w, m, m, EPS, "v", m)         # a dv it does not take
    with pytest.raises(ValueError):
        kr.refine_pass(w, m, m, EPS, "win")          # rows of a window
    with pytest.raises(ValueError):
        kr.refine_pass(torch.zeros(4, 4, 6), m, m, EPS, "v")
    with pytest.raises(ValueError):
        kr.support_w(torch.zeros(4, 6, 3), 2, 30.91, 28.21, 0, rows=(2, 3))
    with pytest.raises(ValueError):
        kr.support_w(torch.zeros(4, 6), 2, 30.91, 28.21, 0)


# --- routing of the kernels keyword on the CPU ------------------------------

def _public_calls(rng):
    """(name, fn(kernels) -> tensors) for every op that takes `kernels`."""
    H, W, R = 14, 20, 3
    img, img2 = (t(_img(rng, H, W)) for _ in range(2))
    d, conf = (t(x) for x in _maps(rng, H, W))
    dw, cw = (t(x) for x in _maps(rng, H + 2 * R, W))
    wv, wh = tops.refinement_weights(img, R, *GAMMAS[1], kernels="jnp")
    return [
        ("support_weights", lambda k: tops.support_weights(
            img, R, *GAMMAS[0], 0, 3, 30, kernels=k)),
        ("refinement_weights", lambda k: tops.refinement_weights(
            img2, R, *GAMMAS[1], kernels=k)),
        ("refine_pass_v", lambda k: tops.refine_pass_v(wv, d, conf, R, EPS,
                                                       kernels=k)),
        ("refine_pass_v_win", lambda k: tops.refine_pass_v_win(
            wv, dw, cw, EPS, kernels=k)),
        ("refine_pass_h", lambda k: tops.refine_pass_h(wh, d, conf, conf, R,
                                                       EPS, kernels=k)),
        ("refine_view", lambda k: tops.refine_view(wv, wh, d, conf, R, EPS,
                                                   kernels=k)),
        ("support_weights_tiled", lambda k: ops_tiled.support_weights_tiled(
            img, R, *GAMMAS[0], 7, 30, R, kernels=k)),
    ]


def _tensors(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("index", range(7))
def test_cpu_routes_are_the_plain_ops_and_launch_nothing(index):
    """"jnp" and "auto" on CPU tensors give the plain ops bit for bit and
    count no launch; "pallas" on a CPU tensor raises."""
    name, call = _public_calls(np.random.default_rng(index))[index]
    kernels.reset_launches()
    plain = _tensors(call("jnp"))
    auto = _tensors(call("auto"))
    assert len(plain) == len(auto)
    for a, b in zip(auto, plain):
        assert a.dtype == torch.float32 and torch.equal(a, b), name
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="pallas"):
        call("pallas")
    with pytest.raises(ValueError):
        call("triton")


def test_kernel_wrappers_on_the_cpu_are_the_plain_ops():
    rng = np.random.default_rng(3)
    img = t(_img(rng, 12, 17))
    d, conf = (t(x) for x in _maps(rng, 12, 17))
    kernels.reset_launches()
    for axis in (0, 1):
        assert torch.equal(kr.support_w(img, 2, *GAMMAS[0], axis),
                           tops.support_weights(img, 2, *GAMMAS[0], axis,
                                                kernels="jnp"))
    wv, wh = tops.refinement_weights(img, 2, *GAMMAS[1], kernels="jnp")
    for got, want in zip(kr.refine_pass(wv, d, conf, EPS, "v"),
                         tops.refine_pass_v(wv, d, conf, 2, EPS,
                                            kernels="jnp")):
        assert torch.equal(got, want)
    for got, want in zip(kr.refine_pass(wh, d, conf, EPS, "h", conf),
                         tops.refine_pass_h(wh, d, conf, conf, 2, EPS,
                                            kernels="jnp")):
        assert torch.equal(got, want)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


# --- launch tables ------------------------------------------------------------

CFG = StereoConfig(d_max=11, radius=2, arm_len=4, r_iters=2, k_iters=2)
REFINE_KEYS = ("support_w", "refine_v", "refine_win", "refine_h")


@pytest.fixture
def counted(monkeypatch):
    """A card's routing on CPU tensors: "auto" takes the kernel wrappers,
    which run their plain versions on the CPU, and each K9/K10 wrapper
    call is counted in kernels.LAUNCHES where the card would launch."""
    monkeypatch.setattr(kernels, "use_kernels", lambda mode, x: mode != "jnp")

    def counting(fn, key):
        def call(*args, **kw):
            kernels.LAUNCHES[key(*args, **kw)] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(kr, "support_w", counting(kr.support_w,
                                                  lambda *a, **k: "support_w"))
    monkeypatch.setattr(kr, "refine_pass", counting(
        kr.refine_pass, lambda w, d, conf, eps, mode, dv=None: "refine_" + mode))
    kernels.reset_launches()
    yield
    kernels.reset_launches()


def _refine_launches():
    return {k: kernels.LAUNCHES[k] for k in REFINE_KEYS}


def _want(table):
    return {k: table[k] for k in REFINE_KEYS}


@pytest.mark.parametrize("route,bands", [("whole", 1), ("wavefront", 2),
                                         ("wavefront", 3), ("halo", 2),
                                         ("halo", 3)])
def test_asw_launch_table(counted, route, bands):
    """expected_asw_launches' K9/K10 entries equal the wrapper calls of one
    frame on each route, and the frame equals the plain ops' frame."""
    left, right = (t(x) for x in unorm8_pair(np.random.default_rng(bands),
                                             48, 32))
    if route == "whole":
        got = asw.asw_pipeline(left, right, CFG)
        got = (got.disparity, got.filled)
    else:
        got = tiled.asw_pipeline_tiled(left, right, CFG, bands,
                                       wavefront=route == "wavefront")
    assert _refine_launches() == _want(chip_smoke.expected_asw_launches(
        CFG, bands, route, kernels))
    plain = asw.asw_pipeline(left, right, CFG.replace(kernels="jnp"))
    assert torch.equal(got[0], plain.disparity)
    assert torch.equal(got[1], plain.filled)


@pytest.mark.parametrize("k_iters", [2, 0])
def test_sharded_launch_table(counted, k_iters):
    """sharded_launches' K9/K10 entries equal the wrapper calls of one
    rank's frame: its weights step, its refinement strips and k
    refinement steps, each step as the shard runs it (call_stage), on a
    shard of 8 of 24 rows."""
    cfg = CFG.replace(k_iters=k_iters)
    rng = np.random.default_rng(k_iters)
    R, W, h_loc, row0, h_glob = cfg.radius, 32, 8, 8, 24
    left, right = (t(x) for x in unorm8_pair(rng, h_glob, W))
    pad = lambda x: x[torch.arange(row0 - R, row0 + h_loc + R).clamp(
        0, h_glob - 1)].contiguous()
    mine = lambda x: x[row0:row0 + h_loc].contiguous()
    args = (pad(left), pad(right), mine(left), mine(right), cfg, row0, h_glob)
    call_stage("asw_weights", asw_sharded._weights, *args, 0, cfg.num_disp)
    strips = call_stage("asw_refine_weights", asw_sharded._refine_weights,
                        *args)
    maps = torch.stack([t(x) for x in (*_maps(rng, h_loc + 2 * R, W),
                                       *_maps(rng, h_loc + 2 * R, W))])
    for _ in range(cfg.k_iters):
        call_stage("asw_refine", asw_sharded._refine, maps, *strips, cfg)
    assert _refine_launches() == _want(chip_smoke.sharded_launches(
        "asw", cfg, kernels))
