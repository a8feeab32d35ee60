#!/usr/bin/env python3
"""GPU smoke test of the PyTorch + CUDA port (`stereo_matchin_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100 (Hopper,
sm_90a), nvcc and PyTorch built for CUDA:

    python3 chip_smoke.py

It builds the CUDA kernels K1-K8 from `stereo_matchin_tpu_torch/csrc`,
holds each against its plain PyTorch version on the card (K1/K2 and K5-K8
also at the edge shapes of their tile plans), drives the ASW
and the cross-based pipelines at REFERENCE_CONFIG on the committed
fixture pair through the kernels and through the plain ops, checks the
launch counts of each path and its output against the JAX package's
stored results, times both routes of both paths, and runs the `run` CLI
on PNG files.  Then the band drivers: the windowed K2 and the row-anchored
K5 and K7-v against their plain versions, the ASW band drivers with
disparity chunks against the whole frame (kernels and plain ops), every
kernel against its plain version at BASELINE config 3's shapes (2880x1988,
280 disparities; K5 and K7 also on a colour ramp whose arms and windows are
nearly all of full length), both methods at config 3 whole, wavefront-banded and
halo-banded, bit-equal, with times and peak device memory held against
the band plan, and `run --bands 3`.  Phase 18 drives the harness and eval
surface under a temporary STEREO_REFERENCE_ROOT: `bench` on two pairs
(288x384 and 375x450, every timed run launching exactly one frame's
kernels; per-stage medians printed as one JSON line beside the warm frames
of phases 6 and 10), `eval` against goldens made from the JAX package's
stored maps, synth -> run -> eval --gt, and the debug and batched ASW
entries, bit-equal to the pipeline.  Before the last line it prints one
JSON object with each kernel's launches on its path, largest error against
its plain version, time (`ms`: eager calls, by CUDA events), device time
(`device_ms`: the same calls replayed from a CUDA graph, without the host's
dispatch), plain time (eager calls) and least time (`bound_ms`, from the
bytes and operations of the timed call at the H100's HBM and float32
peaks).  Any failed check raises; the last line of a passing run is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": N}}

It never imports jax.  Without CUDA it exits non-zero before printing a
result.
"""

from __future__ import annotations

import importlib.util
import itertools
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "data" / "asw_torch_fixture.npz"
CROSS_FIXTURE = ROOT / "tests" / "data" / "cross_torch_fixture.npz"
CSRC = "stereo_matchin_tpu_torch/csrc"
TPU_KERNELS = "stereo_matchin_tpu/kernels"
# One entry per CUDA kernel launch site: (name, CUDA source, replaced
# pallas_call site(s), launch counter, path whose launches it reports).
# K1-K4 run on the ASW path, K5-K8 on the cross path; the band drivers'
# path ("bands") launches K1/K2 with a disparity chunk's offset d0 (the
# d-chunked grid kernels) and the windowed K2 (the wavefront).
KERNELS = [
    ("asw_den", f"{CSRC}/asw_aggregation.cu",
     f"{TPU_KERNELS}/asw_aggregation_dres.py:319", "asw_den", "asw"),
    ("asw_pass_v", f"{CSRC}/asw_aggregation.cu",
     f"{TPU_KERNELS}/asw_aggregation_dres.py:445", "asw_pass_v", "asw"),
    ("asw_pass_h", f"{CSRC}/asw_aggregation.cu",
     f"{TPU_KERNELS}/asw_aggregation_dres.py:384", "asw_pass_h", "asw"),
    ("two_min", f"{CSRC}/wta_gather.cu",
     f"{TPU_KERNELS}/wta_gather.py:314", "two_min", "asw"),
    ("wta_diag", f"{CSRC}/wta_gather.cu",
     f"{TPU_KERNELS}/wta_gather.py:426", "wta_diag", "asw"),
    ("cross_arms", f"{CSRC}/cross_oii.cu",
     f"{TPU_KERNELS}/cross_oii.py:629", "cross_arms", "cross"),
    ("sad_volume", f"{CSRC}/sad_volume.cu",
     f"{TPU_KERNELS}/sad_volume.py:120", "sad_volume", "cross"),
    ("oii_pass_h", f"{CSRC}/cross_oii.cu",
     f"{TPU_KERNELS}/cross_oii.py:235; {TPU_KERNELS}/cross_oii.py:420",
     "oii_pass_h", "cross"),
    ("oii_pass_v", f"{CSRC}/cross_oii.cu",
     f"{TPU_KERNELS}/cross_oii.py:300", "oii_pass_v", "cross"),
    ("vote_h", f"{CSRC}/cross_oii.cu",
     f"{TPU_KERNELS}/cross_oii.py:814", "vote_h", "cross"),
    ("vote_v", f"{CSRC}/cross_oii.cu",
     f"{TPU_KERNELS}/cross_oii.py:853", "vote_v", "cross"),
    ("asw_pass_win", f"{CSRC}/asw_aggregation.cu",
     f"{TPU_KERNELS}/asw_aggregation_dres.py:500", "asw_pass_win", "bands"),
    ("asw_den_chunk", f"{CSRC}/asw_aggregation.cu",
     f"{TPU_KERNELS}/asw_aggregation.py:230", "asw_den", "bands"),
    ("asw_pass_v_chunk", f"{CSRC}/asw_aggregation.cu",
     f"{TPU_KERNELS}/asw_aggregation.py:354", "asw_pass_v", "bands"),
    ("asw_pass_h_chunk", f"{CSRC}/asw_aggregation.cu",
     f"{TPU_KERNELS}/asw_aggregation.py:417", "asw_pass_h", "bands"),
]
# BASELINE config 3 (Middlebury 2014 full size) and the band count the JAX
# package runs it at.
CONFIG3_HW = (1988, 2880)
CONFIG3_BANDS = 5
# Edge shapes of the aggregation kernels' tile plans, (T, H, W, D, d0): W off
# the tile width and D off the group, W under one tile, d0 >= W (every read
# clamps to column 0), the compiled-in T = 33 with a short group, a
# 150-wide frame at T = 33 past its last tile, and T = 61 (radius 30),
# whose vertical tiles have their rows halved.
AGGREGATION_EDGES = [(3, 13, 150, 11, 0), (5, 9, 20, 7, 3), (5, 17, 40, 9, 45),
                     (33, 20, 70, 13, 2), (33, 29, 150, 21, 160),
                     (61, 26, 70, 9, 4)]
# Edge shapes of the WTA kernels K3/K4, (D, H, W, d1 of K4, offset in
# floats of the volume's first element): one plane; three planes; H*W odd
# and a volume 4 bytes off a 16-byte boundary; W under a block of K4 and W
# off it; d1 = 0 and d1 = D - 1 (every pixel of a narrow frame in the left
# band x < d1); uniform random d1, also at config 3's depth (dense warps:
# K4's first pass walks them to the end); short d1 with a few outliers per
# warp at config 3's depth (K4's second pass walks the outliers from its
# queue).  The volumes hold small integers (exact ties) and a block of
# planes at or above the big cap.
WTA_EDGES = [(1, 48, 64, "argmin", 0), (3, 40, 64, "argmin", 0),
             (61, 37, 53, "random", 0), (61, 32, 96, "argmin", 1),
             (17, 30, 20, "last", 0), (33, 24, 300, "random", 0),
             (61, 32, 200, "zero", 0), (61, 32, 200, "last", 0),
             (280, 12, 700, "random", 0), (280, 8, 700, "outliers", 0)]
# NVIDIA H100 SXM peaks (NVIDIA's datasheet): HBM bytes per second and
# float32 operations per second outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def phase(title: str) -> None:
    print(f"\n== {title}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def max_ulp(a, b) -> int:
    """Largest distance in units in the last place between two f32 tensors."""
    import torch

    def key(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((key(a) - key(b)).abs().max())


def cuda_ms(fn, reps: int, graph: bool = False) -> float:
    """Mean device time of fn() over `reps` calls, by CUDA events, warm.
    graph: the calls are captured once into a CUDA graph and the graph is
    replayed, so the time is the device's alone, without the host's
    dispatch between launches (which a short kernel's eager calls wait
    on)."""
    import torch

    fn()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        run = g.replay
        run()
        torch.cuda.synchronize()
    else:
        def run():
            for _ in range(reps):
                fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, got, want, stats):
    """Kernel outputs against the plain version's: floats to 0 ulp, ints equal."""
    import torch

    worst = 0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{name}: {g.dtype}{tuple(g.shape)} vs "
                                 f"{w.dtype}{tuple(w.shape)}")
        if g.is_floating_point():
            if not torch.isfinite(g).all():
                raise AssertionError(f"{name}: non-finite kernel output")
            ulp = max_ulp(g, w)
            err = float((g.double() - w.double()).abs().max())
        else:
            ulp = int((g.long() - w.long()).abs().max())
            err = float(ulp)
        worst = max(worst, ulp)
        stats["max_abs_err"] = max(stats.get("max_abs_err", 0.0), err)
    print(f"  {name}: max ulp {worst}")
    if worst != 0:
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"by {worst} ulp (expected bit-equal)")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def record_work(stats, name, moved, ops):
    """The least work of the call that was timed: bytes read once and
    written once, and operations, from this run's tensors."""
    stats[name]["bytes"] = int(moved)
    stats[name]["ops"] = int(ops)


def bound(entry):
    """(bound_ms, bound_by): the larger of bytes over HBM_BYTES_PER_S and
    operations over FP32_OPS_PER_S."""
    t_bytes = entry["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = entry["ops"] / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_pair(rng, H, W):
    import torch

    codes = rng.integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    imgs = (codes / np.float32(255.0)).astype(np.float32)
    return torch.from_numpy(imgs[0]).cuda(), torch.from_numpy(imgs[1]).cuda()


def scene_pair(seed, H, W, d_max):
    """A synthetic scene (textured planes: arms of every length), on the
    card."""
    import torch

    from stereo_matchin_tpu_torch.eval import synthetic_scene

    left, right, _, _ = synthetic_scene(np.random.default_rng(seed), H, W,
                                        d_max)
    return tuple(torch.from_numpy(a.astype(np.float32)).cuda()
                 for a in (left, right))


def ramp_pair(H, W, shift=37):
    """A smooth colour ramp on the card: each channel a triangle wave that
    moves 0.5/255 a pixel along x and y or less, so it changes by less than
    tau = 0.1 over 2L = 50 pixels and nearly every cross arm reaches its
    full length; the right view is the left one moved by `shift` columns
    (disparity `shift`, wrapped at the right border)."""
    import torch

    y = torch.arange(H, device="cuda", dtype=torch.float32)[:, None]
    x = torch.arange(W, device="cuda", dtype=torch.float32)[None, :]
    s = 0.5 / 255

    def tri(t):
        return 1.0 - ((t % 2.0) - 1.0).abs()

    left = torch.stack([tri(x * s + 0 * y), tri(y * s + 0 * x),
                        tri((x + 2 * y) * s / 3 + 0.5)], dim=-1).contiguous()
    return left, torch.roll(left, -shift, dims=1).contiguous()


def window_taps(al, L):
    """(h, v): the taps of all windows of a pass along each axis, from the
    left arms: |minus| and |plus| within L, plus one, per pixel.  An OII or
    vote pass adds at most that many values per output (the OII's combined
    arms are no longer than the left ones)."""
    taps = lambda m, p: int((m.abs().clamp(max=L) + p.abs().clamp(max=L)
                             + 1).sum())
    return taps(al[0], al[1]), taps(al[2], al[3])


def window_means(al, L):
    """Mean window length (taps) of a pass along each axis."""
    return tuple(t / al[0].numel() for t in window_taps(al, L))


def aggregation_strips(left, right, cfg):
    """(wv_l, wv_r, wh_l, wh_r): the aggregation weight strips of a pair."""
    from stereo_matchin_tpu_torch import ops

    return tuple(ops.support_weights(img, cfg.radius, cfg.gamma_c,
                                     cfg.gamma_p, axis=axis)
                 for axis in (0, 1) for img in (left, right))


def check_kernels(pairs, cfg, stats):
    """K1-K4 against their plain versions on the card."""
    import torch

    from stereo_matchin_tpu_torch import ops
    from stereo_matchin_tpu_torch.kernels import asw_aggregation as ka
    from stereo_matchin_tpu_torch.kernels import wta_gather as kw
    from stereo_matchin_tpu_torch.ops.wta_fast import (_diag_two_min_plain,
                                                       _two_min_plain)

    rng = np.random.default_rng(7)
    eps = cfg.eps
    for label, (left, right) in pairs.items():
        H, W = left.shape[:2]
        wl, wr, hl, hr = aggregation_strips(left, right, cfg)
        # (num_disp, d0): the main path's planes, a D = 1 (mod 8) chunk at
        # an offset that is no multiple of 8.
        for D, d0 in ((cfg.num_disp, 0), (57, 5)):
            tag = f"{label} D={D} d0={d0}"
            cost = ops.sad_cost_volume(left, right, D, 255.0)
            for strips, axis in (((wl, wr), 1), ((hl, hr), 2)):
                den_k = ka.asw_den(*strips, eps, d0, D)
                den_p = ops.asw_den_plain(*strips, eps, d0, D)
                compare(f"asw_den {tag} axis={axis}", [den_k], [den_p],
                        stats["asw_den"])
                out_k = ka.asw_pass(cost, *strips, den_p, eps, axis, d0)
                out_p = ops.asw_pass_plain(cost, *strips, den_p, eps, axis, d0)
                key = "asw_pass_v" if axis == 1 else "asw_pass_h"
                compare(f"{key} {tag}", [out_k], [out_p], stats[key])
        # WTA kernels on the raw SAD volume (integer-valued: many exact
        # ties) with a block of planes above the big cap.
        cost = ops.sad_cost_volume(left, right, cfg.num_disp, 255.0)
        cost[:, :3, :5] = 2e5
        sc = torch.from_numpy(rng.uniform(0, 2, (H, W)).astype(np.float32)).cuda()
        ct = torch.from_numpy(rng.integers(0, cfg.num_disp, (H, W)).astype(
            np.float32)).cuda()
        for pen in ((None, None), (sc, ct)):
            tag = f"{label} penalty={'yes' if pen[0] is not None else 'no'}"
            got = kw.two_min(cost, *pen, big=cfg.big)
            want = _two_min_plain(cost, *pen, big=cfg.big)
            compare(f"two_min {tag}", got, want, stats["two_min"])
            d1 = want[2]
            got = kw.wta_diag(cost, d1, *pen, big=cfg.big)
            want = _diag_two_min_plain(cost, d1, *pen, big=cfg.big)
            compare(f"wta_diag {tag}", got, want, stats["wta_diag"])
    for D, H, W, kind, offset in WTA_EDGES:
        cost, pen, d1_of = wta_edge_inputs(rng, D, H, W, kind, offset)
        for p in ((None, None), pen):
            tag = (f"edge D={D} {H}x{W} d1={kind} offset={offset} "
                   f"penalty={'yes' if p[0] is not None else 'no'}")
            want = _two_min_plain(cost, *p, big=cfg.big)
            compare(f"two_min {tag}", kw.two_min(cost, *p, big=cfg.big), want,
                    stats["two_min"])
            d1 = d1_of(want[2])
            queued = k4_queued(d1, D)
            if kind == "outliers" and not queued:
                raise AssertionError(f"{tag}: K4's second pass has no work")
            compare(f"wta_diag {tag} ({queued} pixels queued)",
                    kw.wta_diag(cost, d1, *p, big=cfg.big),
                    _diag_two_min_plain(cost, d1, *p, big=cfg.big),
                    stats["wta_diag"])
    torch.cuda.synchronize()


def wta_edge_inputs(rng, D, H, W, kind, offset):
    """One WTA_EDGES case on the card: an integer volume (exact ties) with
    planes at the big cap over a corner, laid `offset` floats into its
    storage; a penalty (sc, ct); and K4's d1 from K3's ("argmin"), 0,
    D - 1, uniform in [0, D - 1], or ("outliers") at most the planes of
    K4's first pass with about 3 in [D // 3, D - 1] per 32 pixels."""
    import torch

    from stereo_matchin_tpu_torch.kernels import wta_gather as kw

    flat = rng.integers(0, 30, offset + D * H * W).astype(np.float32)
    cost = torch.from_numpy(flat).cuda()[offset:].view(D, H, W)
    cost[:, :3, :5] = 2e5
    pen = tuple(torch.from_numpy(a.astype(np.float32)).cuda() for a in
                (rng.uniform(0, 2, (H, W)), rng.integers(0, D, (H, W))))
    rand = rng.integers(0, D, H * W)
    if kind == "outliers":
        rand = rng.integers(0, min(D, kw.diag_head(D) + 1), H * W)
        out = rng.random(H * W) < 3 / 32
        rand[out] = rng.integers(D // 3, D, int(out.sum()))
    rand = torch.from_numpy(rand.reshape(H, W).astype(np.int32)).cuda()
    return cost, pen, {
        "argmin": lambda d1: d1, "zero": torch.zeros_like,
        "last": lambda d1: torch.full_like(d1, D - 1),
        "random": lambda d1: rand, "outliers": lambda d1: rand}[kind]


def k4_queued(d1, D):
    """Pixels whose diagonals K4's first pass leaves to its second: longer
    than kernels/wta_gather.py diag_head(D) planes, in a warp (32
    consecutive pixels) with at most K4_SPARSE such lanes."""
    import torch

    from stereo_matchin_tpu_torch.kernels import wta_gather as kw

    xs = torch.arange(d1.shape[1], device=d1.device)[None, :]
    longer = (d1.clamp(max=D - 1) - (d1 - xs).clamp(min=1) + 1
              > kw.diag_head(D)).flatten()
    longer = torch.cat([longer, longer.new_zeros(-longer.numel() % 32)])
    longer = longer.view(-1, 32)
    return int((longer & (longer.sum(1, keepdim=True) <= kw.K4_SPARSE)).sum())


def check_aggregation_edges(stats):
    """K1, K2 (both axes) and the windowed K2 against their plain versions
    at the tile plans' edge shapes (AGGREGATION_EDGES), 0 ulp."""
    import torch

    from stereo_matchin_tpu_torch import ops
    from stereo_matchin_tpu_torch.kernels import asw_aggregation as ka

    rng = np.random.default_rng(17)
    eps = 1e-5
    for T, H, W, D, d0 in AGGREGATION_EDGES:
        def card(*shape, hi=1.0):
            a = rng.uniform(0.01, hi, shape).astype(np.float32)
            return torch.from_numpy(a).cuda()

        wl, wr = card(T, H, W), card(T, H, W)
        cost, win = card(D, H, W, hi=765.0), card(D, H + T - 1, W, hi=765.0)
        tag = f"T={T} {H}x{W} D={D} d0={d0}"
        den = ops.asw_den_plain(wl, wr, eps, d0, D)
        compare(f"asw_den edge {tag}", [ka.asw_den(wl, wr, eps, d0, D)],
                [den], stats["asw_den"])
        for axis, key in ((1, "asw_pass_v"), (2, "asw_pass_h")):
            compare(f"{key} edge {tag}",
                    [ka.asw_pass(cost, wl, wr, den, eps, axis, d0)],
                    [ops.asw_pass_plain(cost, wl, wr, den, eps, axis, d0)],
                    stats[key])
        compare(f"asw_pass_win edge {tag}",
                [ka.asw_pass_win(win, wl, wr, den, eps, d0)],
                [ops.asw_pass_win_plain(win, wl, wr, den, eps, d0)],
                stats["asw_pass_win"])
    torch.cuda.synchronize()


def aggregation_work(kind, T, H, W, D, rows=None):
    """(bytes, ops) of one K1/K2 launch: the strips (2 T H W floats) read
    once, the cost (D x rows x W), den and output (D H W) once each; 2 T
    operations per K1 output, 3 T + 1 per K2 output (mul, mul, add; the
    divide)."""
    strips, vol = 2 * T * H * W * 4, D * H * W * 4
    if kind == "den":
        return strips + vol, 2 * T * D * H * W
    return (strips + D * (rows or H) * W * 4 + 2 * vol,
            (3 * T + 1) * D * H * W)


def wta_work(cost, d1, pen):
    """{"two_min": (bytes, ops), "wta_diag": (bytes, ops)} on these inputs:
    K3 reads every plane, K4 the diagonal b in [d1 - min(d1, x), d1] of
    each pixel; both read d1 or the penalty maps where given and write
    their outputs; ops: |ct - d|, * sc, + cost and three compares per
    element read."""
    D, H, W = cost.shape
    diag = diag_elements(d1)
    maps = nbytes(*pen) if pen[0] is not None else 0
    return {"two_min": (nbytes(cost) + maps + 3 * H * W * 4, 7 * D * H * W),
            "wta_diag": (diag * 4 + nbytes(d1) + maps + 4 * H * W * 4,
                         7 * diag)}


def diag_elements(d1):
    """Floats K4 reads for this d1: its diagonal and the base plane,
    min(d1, x) + 1 per pixel."""
    import torch

    xs = torch.arange(d1.shape[1], device=d1.device)[None, :]
    return int((torch.minimum(d1, xs) + 1).sum())


def diag_sectors(d1, D):
    """The 32-byte sectors (8 floats of a volume row) that K4's diagonals
    touch: b in [max(1, d1 - x), min(d1, D - 1)] at column x - d1 + b.  The
    card moves whole sectors, so scattered diagonals cost more than the 4
    bytes per element that `wta_work` counts."""
    import torch

    H, W = d1.shape
    ys, xs = torch.meshgrid(torch.arange(H, device=d1.device),
                            torch.arange(W, device=d1.device), indexing="ij")
    total = 0
    for b in range(1, D):
        m = (d1 >= b) & (xs >= d1 - b)
        total += torch.unique(ys[m] * W + (xs - d1 + b)[m] // 8 * 8).numel()
    return total


def time_kernels(left, right, cfg, stats, smi):
    """Kernel and plain-version device times at the main path's shapes."""
    import torch

    from stereo_matchin_tpu_torch import ops
    from stereo_matchin_tpu_torch.kernels import asw_aggregation as ka
    from stereo_matchin_tpu_torch.kernels import wta_gather as kw
    from stereo_matchin_tpu_torch.ops.wta_fast import (_diag_two_min_plain,
                                                       _two_min_plain)

    R, D, eps = cfg.radius, cfg.num_disp, cfg.eps
    wl, wr, hl, hr = aggregation_strips(left, right, cfg)
    cost = ops.sad_cost_volume(left, right, D, 255.0)
    den_v = ops.asw_den_plain(wl, wr, eps, 0, D)
    den_h = ops.asw_den_plain(hl, hr, eps, 0, D)
    d1 = _two_min_plain(cost)[2]
    sc = cost[0] * 0.01
    ct = cost[1] * 0.05
    # K3/K4 read their volume once per call: timed on four copies in turn
    # (108 MB, over the H100's 50 MB L2), each call reads it from HBM, as
    # its bound counts.
    vols = itertools.cycle([cost] + [cost.clone() for _ in range(3)])
    cases = {
        "asw_den": (lambda: ka.asw_den(wl, wr, eps, 0, D),
                    lambda: ops.asw_den_plain(wl, wr, eps, 0, D)),
        "asw_pass_v": (lambda: ka.asw_pass(cost, wl, wr, den_v, eps, 1),
                       lambda: ops.asw_pass_plain(cost, wl, wr, den_v, eps, 1)),
        "asw_pass_h": (lambda: ka.asw_pass(cost, hl, hr, den_h, eps, 2),
                       lambda: ops.asw_pass_plain(cost, hl, hr, den_h, eps, 2)),
        "two_min": (lambda: kw.two_min(next(vols), sc, ct, cfg.big),
                    lambda: _two_min_plain(cost, sc, ct, cfg.big)),
        "wta_diag": (lambda: kw.wta_diag(next(vols), d1, sc, ct, cfg.big),
                     lambda: _diag_two_min_plain(cost, d1, sc, ct, cfg.big)),
    }
    D_, H, W = cost.shape
    T = 2 * R + 1
    for name in ("asw_den", "asw_pass_v", "asw_pass_h"):
        record_work(stats, name, *aggregation_work(
            "den" if name == "asw_den" else "pass", T, H, W, D_))
    work = wta_work(cost, d1, (sc, ct))
    for name in ("two_min", "wta_diag"):
        record_work(stats, name, *work[name])
    for name, (kern, plain) in cases.items():
        times, line = turns(kern, plain, 20, 5)
        stats[name].update(times)
        print(f"  {name}: {line}  (D={D}, {left.shape[0]}x{left.shape[1]}, "
              f"T={2 * R + 1}; {smi})")


def cross_inputs(left, right, cfg, D=None, d0=0):
    """The cross path's kernel inputs, by the plain ops: median-filtered
    pair, its arms, the SAD volume of D planes from d0 and the h-pass
    result."""
    from stereo_matchin_tpu_torch import ops

    D = cfg.num_disp if D is None else D
    L = cfg.arm_len
    ml, mr = ops.median3x3(left), ops.median3x3(right)
    al, ar = (ops.cross_arms(m, L, cfg.tau, cfg.legacy_cross_arm_quirk)
              for m in (ml, mr))
    cost = ops.sad_cost_volume(ml, mr, D, 1.0, d0)
    temp = ops.oii_pass_plain(cost, al, ar, L, 2, d0)
    return ml, mr, al, ar, cost, temp


def check_cross_kernels(pairs, cfg, stats):
    """K5-K8 against their plain versions on the card."""
    import torch

    from stereo_matchin_tpu_torch import ops
    from stereo_matchin_tpu_torch.kernels import cross_oii as kc
    from stereo_matchin_tpu_torch.kernels.sad_volume import sad_volume

    L, q = cfg.arm_len, cfg.legacy_cross_arm_quirk
    rng = np.random.default_rng(11)
    for label, (left, right) in pairs.items():
        H, W = left.shape[:2]
        # (num_disp, d0): the main path's planes, and a chunk at an offset
        # that is no multiple of 8.
        for D, d0 in ((cfg.num_disp, 0), (57, 5)):
            tag = f"{label} D={D} d0={d0}"
            ml, mr, al, ar, cost, temp = cross_inputs(left, right, cfg, D, d0)
            if d0 == 0:
                for side, m in (("left", ml), ("right", mr)):
                    compare(f"cross_arms {label} {side}",
                            [kc.cross_arms(m, L, cfg.tau, q)],
                            [ops.cross_arms(m, L, cfg.tau, q)],
                            stats["cross_arms"])
            compare(f"sad_volume {tag}", [sad_volume(ml, mr, D, 1.0, d0)],
                    [cost], stats["sad_volume"])
            compare(f"oii_pass_h {tag}", [kc.oii_pass(cost, al, ar, L, 2, d0)],
                    [temp], stats["oii_pass_h"])
            compare(f"oii_pass_v {tag}", [kc.oii_pass(temp, al, ar, L, 1, d0)],
                    [ops.oii_pass_plain(temp, al, ar, L, 1, d0)],
                    stats["oii_pass_v"])
        # The vote on the path's own initial map, and on random bins of
        # d_max 300 (bins above 256).
        aggr = ops.oii_pass_plain(temp, al, ar, L, 1)
        initial = ops.disparity_to_image(ops.wta_argmin(aggr), cfg.d_max)
        big = torch.from_numpy(rng.integers(241, 301, (H, W)).astype(
            np.int32)).cuda()
        for tag, idx, D in (("path", ops.vote_indices(initial, cfg.d_max),
                             cfg.num_disp), ("d_max=300", big, 301)):
            rc = ops.vote_counts_plain(idx, al, D, L)
            compare(f"vote_h {label} {tag}", [kc.vote_h(idx, al, D, L)], [rc],
                    stats["vote_h"])
            compare(f"vote_v {label} {tag}", [kc.vote_v(rc, al, L)],
                    [ops.vote_mode_plain(rc, al, L)], stats["vote_v"])
    torch.cuda.synchronize()


def check_vote_edges(stats, kernels):
    """K8 at the edge shapes of its plans (tests/torch_support.py
    VOTE_EDGES, the card tests' shapes) against its plain versions, one
    launch each asserted; vote_v also on an rc one byte off a 16-byte
    boundary (no 16-byte copies)."""
    import torch

    from stereo_matchin_tpu_torch import ops
    from stereo_matchin_tpu_torch.kernels import cross_oii as kc
    from tests.torch_support import VOTE_EDGES, vote_inputs

    def launched(name, fn, *args):
        before = kernels.LAUNCHES[name]
        out = fn(*args)
        if kernels.LAUNCHES[name] != before + 1:
            raise AssertionError(f"{name}: {kernels.LAUNCHES[name] - before} "
                                 f"launches, expected 1")
        return out

    for H, W, D, L in VOTE_EDGES.values():
        idx, al = (torch.from_numpy(a).cuda() for a in vote_inputs(
            np.random.default_rng(H + D), D, H, W, L))
        tag = f"edge {H}x{W} D={D} L={L}"
        rc = ops.vote_counts_plain(idx, al, D, L)
        mode = ops.vote_mode_plain(rc, al, L)
        compare(f"vote_h {tag}", [launched("vote_h", kc.vote_h, idx, al, D, L)],
                [rc], stats["vote_h"])
        off = torch.empty(rc.numel() + 1, dtype=torch.uint8,
                          device=rc.device)[1:].view(rc.shape)
        off.copy_(rc)
        for where, r in (("", rc), (" rc off 16 bytes", off)):
            compare(f"vote_v {tag}{where}",
                    [launched("vote_v", kc.vote_v, r, al, L)], [mode],
                    stats["vote_v"])
    torch.cuda.synchronize()


def check_oii_edges(stats, kernels):
    """K7 at the edge shapes of its plans (tests/torch_support.py OII_EDGES,
    the card tests' shapes), both axes, against its plain version (0 ulp),
    one launch each asserted, also on a volume one float off a 16-byte
    boundary (4-byte copies); `D45_chunks` with chunks of 23 planes."""
    import torch

    from stereo_matchin_tpu_torch import ops
    from stereo_matchin_tpu_torch.kernels import cross_oii as kc
    from tests.torch_support import OII_EDGES, oii_inputs

    blocks = kc.OII_BLOCKS
    for case, (D, H, W, L, d0, row0, h_glob, full) in OII_EDGES.items():
        kc.OII_BLOCKS = 1 if case == "D45_chunks" else blocks
        vol, al, ar = (torch.from_numpy(a).cuda() for a in oii_inputs(
            np.random.default_rng(D * 31 + H * W + L), D, H, W, L, full))
        off = torch.empty(vol.numel() + 1, device=vol.device)[1:].view(
            vol.shape).copy_(vol)
        for axis, anchor in ((1, (row0, h_glob)), (2, (0, None))):
            key = "oii_pass_v" if axis == 1 else "oii_pass_h"
            want = ops.oii_pass_plain(vol, al, ar, L, axis, d0, *anchor)
            for where, v in (("", vol), (" vol off 16 bytes", off)):
                before = kernels.LAUNCHES[key]
                got = kc.oii_pass(v, al, ar, L, axis, d0, *anchor)
                if kernels.LAUNCHES[key] != before + 1:
                    raise AssertionError(f"{key}: not one launch")
                compare(f"{key} edge {case}{where}", [got], [want], stats[key])
    kc.OII_BLOCKS = blocks
    torch.cuda.synchronize()


def off16(x):
    """A copy of x whose first element lies 4 bytes past a 16-byte
    boundary."""
    import torch

    off = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    return off.view(x.shape).copy_(x)


def check_sad_edges(stats, kernels):
    """K6 at the edge shapes of its plan (tests/torch_support.py SAD_EDGES,
    the card tests' shapes) against its plain version (0 ulp), one launch
    each asserted, with the plan's chunks and with the largest (SAD_DC
    planes), also on a pair 4 bytes off a 16-byte boundary."""
    import torch

    from stereo_matchin_tpu_torch import ops
    from stereo_matchin_tpu_torch.kernels import sad_volume as ks
    from tests.torch_support import SAD_EDGES, sad_inputs

    blocks = ks.SAD_BLOCKS
    for case, (H, W, D, d0, scale) in SAD_EDGES.items():
        left, right = (torch.from_numpy(a).cuda() for a in sad_inputs(
            np.random.default_rng(H * W + D), H, W))
        want = ops.sad_cost_volume(left, right, D, scale, d0)
        for chunking in (blocks, 1):
            ks.SAD_BLOCKS = chunking
            for where, (l, r) in (("", (left, right)),
                                  (" pair off 16 bytes",
                                   (off16(left), off16(right)))):
                before = kernels.LAUNCHES["sad_volume"]
                got = ks.sad_volume(l, r, D, scale, d0)
                if kernels.LAUNCHES["sad_volume"] != before + 1:
                    raise AssertionError("sad_volume: not one launch")
                compare(f"sad_volume edge {case} dc "
                        f"{ks.sad_tiles(D, H, W).dc}{where}", [got], [want],
                        stats["sad_volume"])
    ks.SAD_BLOCKS = blocks
    torch.cuda.synchronize()


def check_arms_edges(stats, kernels):
    """K5 at the edge shapes of its plan (tests/torch_support.py ARMS_EDGES,
    the card tests' shapes), the legacy quirk on and off, against its plain
    version (equal integers), one launch each asserted, with the plan's v
    tiles and with the tallest, also on an image 4 bytes off a 16-byte
    boundary."""
    import torch

    from stereo_matchin_tpu_torch import ops
    from stereo_matchin_tpu_torch.kernels import cross_oii as kc
    from tests.torch_support import ARMS_EDGES, arms_image

    blocks = kc.ARMS_V_BLOCKS
    for case, (H, W, L, row0, h_glob, kind) in ARMS_EDGES.items():
        img = torch.from_numpy(arms_image(np.random.default_rng(H * W + L), H,
                                          W, kind)).cuda()
        for q in (True, False):
            want = ops.cross_arms(img, L, 0.10, q, row0, h_glob)
            for v_blocks in (blocks, 1):
                kc.ARMS_V_BLOCKS = v_blocks
                ty = kc.arms_tiles(H, W, L, 3 if q else 2).ty_v
                for where, im in (("", img), (" image off 16 bytes",
                                              off16(img))):
                    before = kernels.LAUNCHES["cross_arms"]
                    got = kc.cross_arms(im, L, 0.10, q, row0, h_glob)
                    if kernels.LAUNCHES["cross_arms"] != before + 1:
                        raise AssertionError("cross_arms: not one launch")
                    compare(f"cross_arms edge {case} quirk {q} v rows "
                            f"{ty}{where}", [got], [want], stats["cross_arms"])
    kc.ARMS_V_BLOCKS = blocks
    torch.cuda.synchronize()


def arms_walk(al):
    """(tests, warp_tests): the colour tests K5's walks make on arms al (an
    arm of n made n - 1 passing tests and, unless the frame or L cut it,
    one failing one: counted as n), and the same when each lane pays for
    the longest arm of its warp (32 consecutive columns of one row, as both
    tile kinds lay their lanes)."""
    import torch

    a = al.abs()
    W = a.shape[-1]
    pad = (-W) % 32
    g = torch.nn.functional.pad(a, (0, pad)).view(4, a.shape[1], -1, 32)
    return int(a.sum()), int(g.amax(-1).sum()) * 32


def cross_work(ml, mr, al, ar, D, L):
    """{kernel: (bytes, operations)} of K5-K8 on one frame or band of D
    planes: each input read once, each output written once; a pass over
    one axis reads only that axis's two arm planes."""
    H, W = ml.shape[:2]
    win_h, win_v = window_taps(al, L)
    vol, rc, plane = 4 * D * H * W, D * H * W, 4 * H * W
    arms = 2 * plane                      # one view's arms along one axis
    return {
        "cross_arms": (nbytes(ml) + nbytes(al), 8 * int((al.abs() + 1).sum())),
        "sad_volume": (nbytes(ml, mr) + vol, 14 * D * H * W),
        "oii_pass_h": (2 * vol + 2 * arms, D * (win_h + H * W)),
        "oii_pass_v": (2 * vol + 2 * arms, D * (win_v + H * W)),
        "vote_h": (plane + arms + rc, win_h),       # idx, arms -> rc
        "vote_v": (rc + arms + plane, D * (win_v + H * W)),  # -> mode
    }


def time_cross_kernels(left, right, cfg, stats, smi):
    """K5-K8 and plain-version device times at the cross path's shapes."""
    from stereo_matchin_tpu_torch import ops
    from stereo_matchin_tpu_torch.kernels import cross_oii as kc
    from stereo_matchin_tpu_torch.kernels.sad_volume import sad_volume

    D, L, tau, q = cfg.num_disp, cfg.arm_len, cfg.tau, cfg.legacy_cross_arm_quirk
    ml, mr, al, ar, cost, temp = cross_inputs(left, right, cfg)
    aggr = ops.oii_pass_plain(temp, al, ar, L, 1)
    idx = ops.vote_indices(ops.disparity_to_image(ops.wta_argmin(aggr),
                                                  cfg.d_max), cfg.d_max)
    rc = ops.vote_counts_plain(idx, al, D, L)
    cases = {
        "cross_arms": (lambda: kc.cross_arms(ml, L, tau, q),
                       lambda: ops.cross_arms(ml, L, tau, q)),
        "sad_volume": (lambda: sad_volume(ml, mr, D),
                       lambda: ops.sad_cost_volume(ml, mr, D)),
        "oii_pass_h": (lambda: kc.oii_pass(cost, al, ar, L, 2),
                       lambda: ops.oii_pass_plain(cost, al, ar, L, 2)),
        "oii_pass_v": (lambda: kc.oii_pass(temp, al, ar, L, 1),
                       lambda: ops.oii_pass_plain(temp, al, ar, L, 1)),
        "vote_h": (lambda: kc.vote_h(idx, al, D, L),
                   lambda: ops.vote_counts_plain(idx, al, D, L)),
        "vote_v": (lambda: kc.vote_v(rc, al, L),
                   lambda: ops.vote_mode_plain(rc, al, L)),
    }
    for name, moved_ops in cross_work(ml, mr, al, ar, D, L).items():
        record_work(stats, name, *moved_ops)
    tests, warp_tests = arms_walk(al)
    for name, (kern, plain) in cases.items():
        times, line = turns(kern, plain, 20, 5)
        stats[name].update(times)
        if name == "cross_arms":
            line += (f"; walk bound {8 * tests / FP32_OPS_PER_S * 1e3:.4f} ms,"
                     f" each warp paying its longest arm "
                     f"{8 * warp_tests / FP32_OPS_PER_S * 1e3:.4f} ms")
        print(f"  {name}: {line}  (D={D}, {left.shape[0]}x{left.shape[1]}, "
              f"L={L}; {smi})")


def check_band_kernels(pairs, cfg, stats):
    """The band drivers' kernels against their plain versions on the card:
    the windowed K2 over rows with R real margin rows on each side, K1/K2
    on a disparity chunk (d0 > 0), and K5 and K7-v on windows of frame
    rows anchored by row0/h_glob, one of them running past the frame
    bottom (edge-replicated rows)."""
    import torch

    from stereo_matchin_tpu_torch import ops
    from stereo_matchin_tpu_torch.kernels import asw_aggregation as ka
    from stereo_matchin_tpu_torch.kernels import cross_oii as kc

    R, eps, L = cfg.radius, cfg.eps, cfg.arm_len
    tau, q = cfg.tau, cfg.legacy_cross_arm_quirk
    for label, (left, right) in pairs.items():
        H, W = left.shape[:2]
        wl, wr, hl, hr = aggregation_strips(left, right, cfg)
        a, b = R + 5, H - R - 7
        for D, d0 in ((cfg.num_disp, 0), (57, 5)):
            tag = f"{label} D={D} d0={d0}"
            cost = ops.sad_cost_volume(left, right, D, 255.0, d0)
            den = ops.asw_den_plain(wl, wr, eps, d0, D)
            win = cost[:, a - R:b + R].contiguous()
            strips = [x[:, a:b].contiguous() for x in (wl, wr, den)]
            compare(f"asw_pass_win {tag} rows {a}..{b}",
                    [ka.asw_pass_win(win, *strips, eps, d0)],
                    [ops.asw_pass_win_plain(win, *strips, eps, d0)],
                    stats["asw_pass_win"])
        # One chunk of REFERENCE_CONFIG's 61 planes in 3 (21 planes, d0 21).
        D, d0 = 21, 21
        cost = ops.sad_cost_volume(left, right, D, 255.0, d0)
        for strips, axis in (((wl, wr), 1), ((hl, hr), 2)):
            den = ops.asw_den_plain(*strips, eps, d0, D)
            compare(f"asw_den_chunk {label} D={D} d0={d0} axis={axis}",
                    [ka.asw_den(*strips, eps, d0, D)], [den],
                    stats["asw_den_chunk"])
            key = "asw_pass_v_chunk" if axis == 1 else "asw_pass_h_chunk"
            compare(f"{key} {label} D={D} d0={d0}",
                    [ka.asw_pass(cost, *strips, den, eps, axis, d0)],
                    [ops.asw_pass_plain(cost, *strips, den, eps, axis, d0)],
                    stats[key])
        ml, mr = ops.median3x3(left), ops.median3x3(right)
        for row0, rows in ((H // 3, H // 2), (H - 100, 120)):
            idx = torch.arange(row0, row0 + rows, device=left.device)
            wml, wmr = (m[idx.clamp(max=H - 1)].contiguous() for m in (ml, mr))
            tag = f"{label} rows {row0}..{row0 + rows} of {H}"
            al = ops.cross_arms(wml, L, tau, q, row0, H)
            compare(f"cross_arms {tag}",
                    [kc.cross_arms(wml, L, tau, q, row0, H)], [al],
                    stats["cross_arms"])
            ar = ops.cross_arms(wmr, L, tau, q, row0, H)
            for D, d0 in ((cfg.num_disp, 0), (57, 5)):
                temp = ops.oii_pass_plain(
                    ops.sad_cost_volume(wml, wmr, D, 1.0, d0), al, ar, L, 2,
                    d0)
                compare(f"oii_pass_v {tag} D={D} d0={d0}",
                        [kc.oii_pass(temp, al, ar, L, 1, d0, row0, H)],
                        [ops.oii_pass_plain(temp, al, ar, L, 1, d0, row0, H)],
                        stats["oii_pass_v"])
    torch.cuda.synchronize()


def band_kernels_config3(left, right, cfg, stats, smi):
    """The ASW band drivers' kernels at config 3's shapes, against their
    plain versions (0 ulp) and timed: K1 and K2 on the second of 4
    disparity chunks of the whole frame, the windowed K2 on an interior
    wavefront band's level window, and K3/K4 on all D planes over that
    band's postaggregate rows [s - keep, e + keep): K3 with and without
    the penalty, K4 on the shifted pair's d1 and on a uniform random one,
    each beside its bound from this run's bytes (`wta_work`)."""
    import torch

    from stereo_matchin_tpu_torch import ops
    from stereo_matchin_tpu_torch.kernels import asw_aggregation as ka
    from stereo_matchin_tpu_torch.kernels import wta_gather as kw
    from stereo_matchin_tpu_torch.models import wavefront
    from stereo_matchin_tpu_torch.ops.wta_fast import (_diag_two_min_plain,
                                                       _two_min_plain)

    R, eps, D = cfg.radius, cfg.eps, cfg.num_disp
    chunk = -(-D // cfg.aggr_d_chunks)
    d0 = chunk
    H, W = left.shape[:2]
    wl, wr, hl, hr = aggregation_strips(left, right, cfg)
    cost = ops.sad_cost_volume(left, right, chunk, 255.0, d0)
    den_v = ops.asw_den_plain(wl, wr, eps, d0, chunk)
    den_h = ops.asw_den_plain(hl, hr, eps, d0, chunk)
    g = wavefront.plan_bands(H, CONFIG3_BANDS, cfg)[1]
    a, b = g.s, g.e
    win = cost[:, a - R:b + R].contiguous()
    strips = [x[:, a:b].contiguous() for x in (wl, wr, den_v)]
    keep = cfg.k_iters * R + 1
    t0, t1 = a - keep, b + keep
    tail = ops.sad_cost_volume(left[t0:t1], right[t0:t1], D, 255.0)
    tail[:, :3, :5] = 2e5                  # planes above the big cap
    sc, ct = tail[0] * 0.01, tail[1] * 0.05
    d1 = _two_min_plain(tail)[2]
    chunk_at = f"D={chunk} d0={d0}, {H} rows"
    tail_at = f"D={D}, rows {t0}..{t1}"
    T = 2 * R + 1
    record_work(stats, "asw_den_chunk", *aggregation_work("den", T, H, W, chunk))
    for name in ("asw_pass_v_chunk", "asw_pass_h_chunk"):
        record_work(stats, name, *aggregation_work("pass", T, H, W, chunk))
    record_work(stats, "asw_pass_win", *aggregation_work(
        "pass", T, b - a, W, chunk, rows=b - a + 2 * R))
    # K4 also on a seeded uniform d1 in [0, D - 1]: the longest diagonals,
    # scattered, in every warp, its worst case.
    noise = torch.from_numpy(np.random.default_rng(23).integers(
        0, D, tuple(d1.shape)).astype(np.int32)).cuda()
    # (name, where, kernel, plain version, timed): K1/K2 and the windowed
    # K2 record their times here; K3/K4 keep theirs at 288x384 (phase 3) in
    # the kernels line and print these beside their bounds.
    cases = [
        ("asw_den_chunk", chunk_at, lambda: ka.asw_den(wl, wr, eps, d0, chunk),
         lambda: ops.asw_den_plain(wl, wr, eps, d0, chunk), True),
        ("asw_pass_v_chunk", chunk_at,
         lambda: ka.asw_pass(cost, wl, wr, den_v, eps, 1, d0),
         lambda: ops.asw_pass_plain(cost, wl, wr, den_v, eps, 1, d0), True),
        ("asw_pass_h_chunk", chunk_at,
         lambda: ka.asw_pass(cost, hl, hr, den_h, eps, 2, d0),
         lambda: ops.asw_pass_plain(cost, hl, hr, den_h, eps, 2, d0), True),
        ("asw_pass_win", f"D={chunk} d0={d0}, rows {a}..{b}",
         lambda: ka.asw_pass_win(win, *strips, eps, d0),
         lambda: ops.asw_pass_win_plain(win, *strips, eps, d0), True),
        ("two_min", tail_at + ", no penalty",
         lambda: kw.two_min(tail, big=cfg.big),
         lambda: _two_min_plain(tail, big=cfg.big), False),
        ("two_min", tail_at, lambda: kw.two_min(tail, sc, ct, cfg.big),
         lambda: _two_min_plain(tail, sc, ct, cfg.big), False),
        ("wta_diag", tail_at + ", the shifted pair's d1",
         lambda: kw.wta_diag(tail, d1, sc, ct, cfg.big),
         lambda: _diag_two_min_plain(tail, d1, sc, ct, cfg.big), False),
        ("wta_diag", tail_at + ", uniform random d1",
         lambda: kw.wta_diag(tail, noise, sc, ct, cfg.big),
         lambda: _diag_two_min_plain(tail, noise, sc, ct, cfg.big), False),
    ]
    works = [wta_work(tail, d1, (None, None))["two_min"],
             wta_work(tail, d1, (sc, ct))["two_min"],
             wta_work(tail, d1, (sc, ct))["wta_diag"],
             wta_work(tail, noise, (sc, ct))["wta_diag"]]
    wta = []
    for name, at, kern, plain, timed_here in cases:
        got, want = kern(), plain()
        if not isinstance(got, (tuple, list)):
            got, want = [got], [want]
        compare(f"{name} config 3 ({at})", got, want, stats[name])
        del got, want
        times, line = turns(kern, plain, 5, 2)
        print(f"  {name}: {line}  ({at} x {W}, T={2 * R + 1}; {smi})")
        if timed_here:
            stats[name].update(times)
            continue
        moved, ops = works[len(wta)]
        bound_ms, bound_by = bound({"bytes": moved, "ops": ops})
        wta.append({"name": name, "at": f"{at} x {W}", **times,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "bytes": moved})
        print(f"    bound {bound_ms:.4f} ms ({bound_by}, {moved} bytes): "
              f"{bound_ms / times['device_ms'] * 100:.1f}% of it (device "
              f"time)")
        if name == "wta_diag":
            dd = d1 if len(wta) == 3 else noise
            n = diag_sectors(dd, D)
            by_sector = moved - 4 * diag_elements(dd) + 32 * n
            wta[-1].update(sectors=n, queued=k4_queued(dd, D))
            print(f"    its diagonals touch {n} 32-byte sectors: "
                  f"{by_sector / HBM_BYTES_PER_S * 1e3:.4f} ms at "
                  f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s with the maps, d1 and "
                  f"outputs; {wta[-1]['queued']} pixels queued for the "
                  f"second pass")
    print(json.dumps({"config3_wta": wta, "card": smi}))
    del cost, den_v, den_h, win, strips, tail, sc, ct, d1, noise
    torch.cuda.synchronize()


def turns(kern, plain, kreps, preps):
    """Times in the turns plain, kernel, kernel, plain (the first plain
    warms the allocator): ({"ms": the kernel's eager calls, host dispatch
    included, as its callers run it; "device_ms": the same calls replayed
    from a CUDA graph, the device's time alone; "plain_ms": the plain
    version's eager calls}, each the better of two runs; a line with both
    runs of each)."""
    p1 = cuda_ms(plain, preps)
    k1, g1 = cuda_ms(kern, kreps), cuda_ms(kern, kreps, graph=True)
    g2, k2 = cuda_ms(kern, kreps, graph=True), cuda_ms(kern, kreps)
    p2 = cuda_ms(plain, preps)
    return ({"ms": min(k1, k2), "device_ms": min(g1, g2),
             "plain_ms": min(p1, p2)},
            f"kernel {k1:.4f} / {k2:.4f} ms (device {g1:.4f} / {g2:.4f}), "
            f"plain {p1:.4f} / {p2:.4f} ms")


def band_inputs(left, right, cfg):
    """(row0, row1, ml, mr, al, ar): the image rows row0 .. row1 - 1 of the
    cross wavefront's last band at config 3 (rows past the frame bottom
    edge-replicated), median-filtered, and their arms anchored by
    row0/h_glob."""
    import torch

    from stereo_matchin_tpu_torch import ops
    from stereo_matchin_tpu_torch.models import wavefront_cross

    H, L = left.shape[0], cfg.arm_len
    g = wavefront_cross.plan_bands_cross(H, CONFIG3_BANDS, cfg)[-1]
    row0, row1 = g.g0, g.e + 3 * L + 3
    rows = torch.arange(row0, row1, device=left.device).clamp(max=H - 1)
    ml, mr = (ops.median3x3(x)[rows].contiguous() for x in (left, right))
    al, ar = (ops.cross_arms(m, L, cfg.tau, cfg.legacy_cross_arm_quirk, row0,
                             H) for m in (ml, mr))
    return row0, row1, ml, mr, al, ar


def cross_kernels_config3(left, right, cfg, stats, smi):
    """K5-K8 against their plain versions at config 3's shapes, all
    cfg.num_disp planes, on the image rows of the cross wavefront's last
    band: arms and the OII vertical pass anchored by row0/h_glob, rows
    past the frame bottom edge-replicated.  Each is timed there in turns
    with its plain version beside its bound (K7 with its mean window
    length, K5 with its walk bounds); K5 and K7 again on the same band of a
    colour ramp (ramp_pair), whose arms and windows are nearly all of full
    length; one `config3_cross` JSON line."""
    import torch

    from stereo_matchin_tpu_torch import ops
    from stereo_matchin_tpu_torch.kernels import cross_oii as kc
    from stereo_matchin_tpu_torch.kernels.sad_volume import sad_volume

    H = left.shape[0]
    D, L, tau, q = cfg.num_disp, cfg.arm_len, cfg.tau, cfg.legacy_cross_arm_quirk
    row0, row1, ml, mr, al, ar = band_inputs(left, right, cfg)
    tag = f"config 3 rows {row0}..{row1} of {H}, D={D}"
    work = cross_work(ml, mr, al, ar, D, L)
    c3 = {}

    # Kernel calls per timed run: 5 of the volume passes (1-6 ms each), 40
    # of K5 and K8 (0.1-0.7 ms), so that no run lasts under a few ms.
    def timed_turns(name, kern, plain, kreps, work=work, key=None, label=tag,
                    arms=al):
        key = key or name
        times, line = turns(kern, plain, kreps, 1)
        entry = dict(times, bytes=work[name][0], ops=work[name][1])
        entry["bound_ms"], entry["bound_by"] = bound(entry)
        taps = ""
        if name.startswith("oii_pass"):
            entry["mean_window"] = window_means(arms, L)[name == "oii_pass_v"]
            taps = f", mean window {entry['mean_window']:.2f} taps"
        if name == "cross_arms":
            tests, warp_tests = arms_walk(arms)
            entry["walk_bound_ms"] = 8 * tests / FP32_OPS_PER_S * 1e3
            entry["warp_walk_bound_ms"] = 8 * warp_tests / FP32_OPS_PER_S * 1e3
            entry["mean_arm"] = tests / arms.numel()
            taps = (f", mean arm {entry['mean_arm']:.2f}, walk bound "
                    f"{entry['walk_bound_ms']:.4f} ms, each warp paying its "
                    f"longest arm {entry['warp_walk_bound_ms']:.4f} ms")
        c3[key] = entry
        print(f"  {key}: {line}; bound {entry['bound_ms']:.4f} ms "
              f"({entry['bound_by']}{taps})  ({label}; {smi})")

    for side, m, want in (("left", ml, al), ("right", mr, ar)):
        compare(f"cross_arms {tag} {side}",
                [kc.cross_arms(m, L, tau, q, row0, H)], [want],
                stats["cross_arms"])
    timed_turns("cross_arms", lambda: kc.cross_arms(ml, L, tau, q, row0, H),
                lambda: ops.cross_arms(ml, L, tau, q, row0, H), 40)
    cost = ops.sad_cost_volume(ml, mr, D, 1.0)
    compare(f"sad_volume {tag}", [sad_volume(ml, mr, D, 1.0)], [cost],
            stats["sad_volume"])
    timed_turns("sad_volume", lambda: sad_volume(ml, mr, D, 1.0),
                lambda: ops.sad_cost_volume(ml, mr, D, 1.0), 5)
    temp = ops.oii_pass_plain(cost, al, ar, L, 2)
    compare(f"oii_pass_h {tag}", [kc.oii_pass(cost, al, ar, L, 2)], [temp],
            stats["oii_pass_h"])
    timed_turns("oii_pass_h", lambda: kc.oii_pass(cost, al, ar, L, 2),
                lambda: ops.oii_pass_plain(cost, al, ar, L, 2), 5)
    del cost
    aggr = ops.oii_pass_plain(temp, al, ar, L, 1, 0, row0, H)
    compare(f"oii_pass_v {tag}", [kc.oii_pass(temp, al, ar, L, 1, 0, row0, H)],
            [aggr], stats["oii_pass_v"])
    timed_turns("oii_pass_v", lambda: kc.oii_pass(temp, al, ar, L, 1, 0, row0, H),
                lambda: ops.oii_pass_plain(temp, al, ar, L, 1, 0, row0, H), 5)
    del temp
    idx = ops.vote_indices(ops.disparity_to_image(ops.wta_argmin(aggr),
                                                  cfg.d_max), cfg.d_max)
    del aggr
    rc = ops.vote_counts_plain(idx, al, D, L)
    compare(f"vote_h {tag}", [kc.vote_h(idx, al, D, L)], [rc], stats["vote_h"])
    timed_turns("vote_h", lambda: kc.vote_h(idx, al, D, L),
                lambda: ops.vote_counts_plain(idx, al, D, L), 40)
    compare(f"vote_v {tag}", [kc.vote_v(rc, al, L)],
            [ops.vote_mode_plain(rc, al, L)], stats["vote_v"])
    timed_turns("vote_v", lambda: kc.vote_v(rc, al, L),
                lambda: ops.vote_mode_plain(rc, al, L), 40)
    del rc, idx, al, ar, ml, mr

    # K5 and K7 again at the band's shape on long arms and windows: a
    # smooth colour ramp (ramp_pair), nearly every arm at its full length L.
    _, _, ml, mr, al, ar = band_inputs(*ramp_pair(H, left.shape[1]), cfg)
    work = cross_work(ml, mr, al, ar, D, L)
    label = f"{tag}, colour ramp moved 37 columns"
    compare(f"cross_arms {label}", [kc.cross_arms(ml, L, tau, q, row0, H)],
            [al], stats["cross_arms"])
    timed_turns("cross_arms", lambda: kc.cross_arms(ml, L, tau, q, row0, H),
                lambda: ops.cross_arms(ml, L, tau, q, row0, H), 40, work,
                "cross_arms_long", label, al)
    cost = ops.sad_cost_volume(ml, mr, D, 1.0)
    temp = ops.oii_pass_plain(cost, al, ar, L, 2)
    compare(f"oii_pass_h {label}", [kc.oii_pass(cost, al, ar, L, 2)], [temp],
            stats["oii_pass_h"])
    timed_turns("oii_pass_h", lambda: kc.oii_pass(cost, al, ar, L, 2),
                lambda: ops.oii_pass_plain(cost, al, ar, L, 2), 5, work,
                "oii_pass_h_long", label, al)
    del cost
    compare(f"oii_pass_v {label}",
            [kc.oii_pass(temp, al, ar, L, 1, 0, row0, H)],
            [ops.oii_pass_plain(temp, al, ar, L, 1, 0, row0, H)],
            stats["oii_pass_v"])
    timed_turns("oii_pass_v", lambda: kc.oii_pass(temp, al, ar, L, 1, 0, row0, H),
                lambda: ops.oii_pass_plain(temp, al, ar, L, 1, 0, row0, H), 5,
                work, "oii_pass_v_long", label, al)
    del temp, al, ar, ml, mr
    torch.cuda.synchronize()
    print(json.dumps({"config3_cross": c3, "rows": [row0, row1], "D": D,
                      "card": smi}))


class BandPeaks:
    """Peak device memory per band: wraps the function each band ends with
    (module.name), records torch.cuda.max_memory_allocated() when it
    returns and restarts the peak count for the next band."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.peaks = []

    def __enter__(self):
        import torch

        self.orig = getattr(self.module, self.name)

        def wrapped(*args, **kwargs):
            out = self.orig(*args, **kwargs)
            torch.cuda.synchronize()
            self.peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            return out

        setattr(self.module, self.name, wrapped)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def expected_asw_launches(cfg, bands, route, kernels):
    """Launches of one ASW frame: c = disparity chunks, per chunk and band
    K1 x2 and r levels of K2; the wavefront's first band runs the clamped
    vertical pass, its later bands the windowed one; K3 and K4 k+1 times
    per band."""
    D = cfg.num_disp
    chunk = -(-D // max(cfg.aggr_d_chunks, 1))
    c, r, k = -(-D // chunk), cfg.r_iters, cfg.k_iters
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    want.update(asw_den=2 * c * bands, asw_pass_h=c * r * bands,
                two_min=(k + 1) * bands, wta_diag=(k + 1) * bands)
    if route == "wavefront":
        want.update(asw_pass_v=c * r, asw_pass_win=c * r * (bands - 1))
    else:
        want.update(asw_pass_v=c * r * bands)
    return want


def expected_cross_launches(bands, kernels):
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    want.update(cross_arms=2 * bands, sad_volume=bands, oii_pass_h=bands,
                oii_pass_v=bands, vote_h=bands, vote_v=bands)
    return want


def check_launches(label, got, want):
    print(f"  {label} launches: {got}")
    if got != want:
        raise AssertionError(f"{label}: launch counts {got} != {want}")


def check_maps_equal(label, got, want):
    import torch

    for name, g, w in zip(("map 0", "map 1"), got, want):
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{label}: {name} differs from the whole "
                                 f"frame's")
    print(f"  {label}: maps bit-equal to the whole frame's")


def asw_band_phase(cfg, kernels):
    """The ASW band drivers on a synthetic scene: 2 bands, aggr_d_chunks 3,
    through the kernels and the plain ops, against the whole frame."""
    import torch

    from stereo_matchin_tpu_torch.models import asw, tiled

    # 375 rows cannot hold two wavefront bands at REFERENCE_CONFIG: each
    # needs 2 * keep = 2 * (k * radius + 1) = 194 rows.
    left, right = scene_pair(5, 400, 450, cfg.d_max)
    plain = cfg.replace(kernels="jnp")
    kernels.reset_launches()
    whole = asw.asw_pipeline(left, right, cfg)
    torch.cuda.synchronize()
    check_launches("whole frame", dict(kernels.LAUNCHES),
                   expected_asw_launches(cfg, 1, "whole", kernels))
    whole = (whole.disparity, whole.filled)
    whole_p = asw.asw_pipeline(left, right, plain)
    check_maps_equal("whole frame, plain ops", (whole_p.disparity,
                                                 whole_p.filled), whole)
    launches = {}
    for route in ("wavefront", "halo"):
        kernels.reset_launches()
        got = tiled.asw_pipeline_tiled(left, right, cfg, 2,
                                       wavefront=route == "wavefront")
        torch.cuda.synchronize()
        launches[route] = dict(kernels.LAUNCHES)
        check_launches(route, launches[route],
                       expected_asw_launches(cfg, 2, route, kernels))
        check_maps_equal(f"{route}, kernels", got, whole)
        got_p = tiled.asw_pipeline_tiled(left, right, plain, 2,
                                         wavefront=route == "wavefront")
        if dict(kernels.LAUNCHES) != launches[route]:
            raise AssertionError("the plain band route launched a kernel")
        check_maps_equal(f"{route}, plain ops", got_p, whole)
    return launches


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def config3_pair(seed):
    """A seeded UNORM8 pair at config 3's size, made on the card: the right
    view is the left one shifted by 37 columns plus noise of +-8 codes."""
    import torch

    H, W = CONFIG3_HW
    gen = torch.Generator(device="cuda").manual_seed(seed)
    codes = torch.randint(0, 256, (H, W, 3), generator=gen, device="cuda",
                          dtype=torch.int32)
    noise = torch.randint(-8, 9, (H, W, 3), generator=gen, device="cuda",
                          dtype=torch.int32)
    shifted = (torch.roll(codes, -37, dims=1) + noise).clamp_(0, 255)
    return tuple((c.float() / 255.0).contiguous() for c in (codes, shifted))


def config3_asw(cfg, kernels, smi):
    """Config 3 ASW through the kernels: whole frame, wavefront and halo
    bands (5), twice, and once the wavefront in 8 bands of 256 kept rows;
    times, and peak memory per band held against the band plan
    (models.tiled.asw_plan_bytes)."""
    import torch

    from stereo_matchin_tpu_torch.models import asw, tiled, wavefront

    H, W = CONFIG3_HW
    B = CONFIG3_BANDS
    left, right = config3_pair(3)
    vol_row = cfg.num_disp * W * 4                 # bytes of one volume row
    band = -(-H // B)
    # route: (bands, wavefront switch, kept rows of each band)
    routes = {
        "whole": (1, None, [H]),
        "wavefront": (B, True, [g.e - g.s for g in
                                wavefront.plan_bands(H, B, cfg)]),
        "halo": (B, False, [min(H, (b + 1) * band) - b * band
                            for b in range(B)]),
        "wavefront8": (8, True, [g.e - g.s for g in
                                 wavefront.plan_bands(H, 8, cfg)])}

    def run(route):
        bands, wf, _ = routes[route]
        if bands == 1:
            res = asw.asw_pipeline(left, right, cfg)
            return res.disparity, res.filled
        return tiled.asw_pipeline_tiled(left, right, cfg, bands, wavefront=wf)

    maps, launches, over = {}, {}, []
    for rep, names in enumerate((("whole", "wavefront", "halo"),
                                 ("whole", "wavefront", "halo",
                                  "wavefront8"))):
        for route in names:
            bands, wf, kept = routes[route]
            kernels.reset_launches()
            with BandPeaks(asw, "asw_postaggregate") as bp:
                maps[route], ms = timed(lambda: run(route))
            launches[route] = dict(kernels.LAUNCHES)
            if len(bp.peaks) != len(kept):
                raise AssertionError(f"{route}: {len(bp.peaks)} bands seen")
            plan = [tiled.asw_plan_bytes(n, W, cfg, banded=bands > 1)
                    for n in kept]
            over += [(route, i, p, q) for i, (p, q) in
                     enumerate(zip(bp.peaks, plan)) if p > q]
            print(f"  ASW {route} (run {rep + 1}): {ms:.1f} ms; peak "
                  f"{max(bp.peaks) / 1e9:.3f} GB; per band (kept rows: peak "
                  f"GB, volume rows per kept row, plan GB) "
                  + "; ".join(f"{n}: {p / 1e9:.3f}, {p / vol_row / n:.3f}, "
                              f"{q / 1e9:.3f}"
                              for n, p, q in zip(kept, bp.peaks, plan))
                  + f"; {smi}")
        for route in names:
            bands, wf, _ = routes[route]
            check_launches(f"ASW {route}", launches[route],
                           expected_asw_launches(
                               cfg, bands, "wavefront" if wf else route,
                               kernels))
            if route == "whole":
                continue
            for name, g, w in zip(("disparity", "filled"), maps[route],
                                  maps["whole"]):
                if not torch.equal(g, w):
                    n = int((g != w).sum())
                    raise AssertionError(f"config 3 ASW {route}: {name} "
                                         f"differs on {n} pixels")
            print(f"  ASW {route}: disparity and filled bit-equal to the "
                  f"whole frame")
        d = maps["whole"][0]
        if d.shape != (H, W) or not torch.isfinite(d).all():
            raise AssertionError(f"bad disparity map {tuple(d.shape)}")
        maps.clear()
    print(f"  auto_bands at config 3 on this card: "
          f"{tiled.auto_bands((H, W, 3), cfg)}")
    if over:
        raise AssertionError(
            "config 3 ASW peaked above the band plan: " + "; ".join(
                f"{r} band {i}: {p / 1e9:.3f} > {q / 1e9:.3f} GB"
                for r, i, p, q in over))


def config3_cross(cfg, kernels, stats, smi):
    """Config 3 cross-based: K5-K8 against their plain versions on one
    band's rows, then the whole frame, wavefront and halo bands through the
    kernels; times and peak memory."""
    import torch

    from stereo_matchin_tpu_torch.models import cross_based, tiled

    H, W = CONFIG3_HW
    B = CONFIG3_BANDS
    t0 = time.perf_counter()
    left, right = scene_pair(4, H, W, cfg.d_max)
    print(f"  synthetic scene {H}x{W} made in "
          f"{time.perf_counter() - t0:.1f} s (host; {smi})")
    cross_kernels_config3(left, right, cfg, stats, smi)
    runs = {"whole": lambda: cross_based.cross_pipeline(left, right, cfg),
            "wavefront": lambda: tiled.cross_pipeline_tiled(
                left, right, cfg, B, wavefront=True),
            "halo": lambda: tiled.cross_pipeline_tiled(
                left, right, cfg, B, wavefront=False)}
    launches, maps = {}, {}
    for rep in range(2):
        for route, fn in runs.items():
            kernels.reset_launches()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            out, ms = timed(fn)
            peak = torch.cuda.max_memory_allocated()
            launches[route] = dict(kernels.LAUNCHES)
            maps[route] = ((out.initial, out.final) if route == "whole"
                           else out)
            print(f"  cross {route} (run {rep + 1}): {ms:.1f} ms; peak "
                  f"{peak / 1e9:.3f} GB; {smi}")
            del out
        check_launches("cross whole", launches["whole"],
                       expected_cross_launches(1, kernels))
        for route in ("wavefront", "halo"):
            check_launches(f"cross {route}", launches[route],
                           expected_cross_launches(B, kernels))
            for name, g, w in zip(("initial", "final"), maps[route],
                                  maps["whole"]):
                if not torch.equal(g, w):
                    n = int((g != w).sum())
                    raise AssertionError(f"config 3 cross {route}: {name} "
                                         f"differs on {n} pixels")
            print(f"  cross {route}: initial and final bit-equal to the "
                  f"whole frame")


def reference_root(tmp, cfg, fx, cfx):
    """A temporary reference checkout: `tsukuba` from the committed 288x384
    pair with the JAX package's maps as its goldens, and `teddy` a seeded
    375x450 synthetic scene (no goldens)."""
    from stereo_matchin_tpu_torch.eval import synthetic_scene
    from stereo_matchin_tpu_torch.io import png

    root = tmp / "reference"
    ts, td = root / "tsukuba", root / "teddy"
    ts.mkdir(parents=True)
    td.mkdir()
    png.write_rgb(ts / "im1.png", fx["left"])
    png.write_rgb(ts / "im5.png", fx["right"])
    for name, c in (("asw_disparity.png", fx["disparity"]),
                    ("cross_based_initial.png", cfx["initial"]),
                    ("cross_based_disparity.png", cfx["final"])):
        png.write_gray(ts / name, c / np.float32(255.0))
    left, right, _, _ = synthetic_scene(np.random.default_rng(18), 375, 450,
                                        cfg.d_max)
    png.write_rgb(td / "im2.png", left)
    png.write_rgb(td / "im6.png", right)
    return root


def cli_output(cli, args):
    """(exit code, standard output) of one CLI command, echoed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(args)
    text = buf.getvalue()
    print("  " + text.strip().replace("\n", "\n  "))
    return rc, text


def bench_phase(cli, tmp, cfg, kernels, warm, smi):
    """bench --pairs tsukuba teddy --runs 3 on the card: the TSV, each
    timed run's launches (one frame of its method), and the per-stage
    medians beside the warm frames of phases 6 and 10."""
    import torch

    from stereo_matchin_tpu_torch.bench import harness

    runs = {"asw": [], "cross": []}
    orig = {m: getattr(harness, f"time_{m}_method") for m in runs}

    def recorded(method):
        def timed(left, right, cfg):
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            times = orig[method](left, right, cfg)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            runs[method].append(("x".join(map(str, left.shape[:2])),
                                 dict(kernels.LAUNCHES), dict(times, wall=wall)))
            return times
        return timed

    for m in runs:
        setattr(harness, f"time_{m}_method", recorded(m))
    try:
        rc = cli(["bench", "--pairs", "tsukuba", "teddy", "--runs", "3",
                  "--out", str(tmp / "bench"), "--device", "cuda"])
    finally:
        for m, fn in orig.items():
            setattr(harness, f"time_{m}_method", fn)
    if rc != 0:
        raise AssertionError(f"bench exited with {rc}")
    tsv = tmp / "bench" / f"{torch.cuda.get_device_name(0)}.tsv"
    lines = tsv.read_text().split("\n")
    header = "\t".join(["id"] + harness.CROSS_COLUMNS + ["", ""] +
                       harness.ASW_COLUMNS)
    if lines.count(header) != 2 or sum(ln.startswith("Run ")
                                       for ln in lines) != 6:
        raise AssertionError(f"{tsv.name}: not two pairs of 3 runs with every "
                             f"column")
    print(f"  {tsv.name}: 2 pairs x 3 runs, every column")
    want = {"asw": expected_asw_launches(cfg, 1, "whole", kernels),
            "cross": expected_cross_launches(1, kernels)}
    medians = {}
    for method, recs in runs.items():
        if len(recs) != 8:
            raise AssertionError(f"{method}: {len(recs)} timed runs, not 8")
        for size, launches, _ in recs:
            if launches != want[method]:
                raise AssertionError(f"bench {method} {size}: launches "
                                     f"{launches} != {want[method]}")
        print(f"  {method}: each of 8 timed runs launched one frame's "
              f"{ {k: v for k, v in want[method].items() if v} }")
        for size in ("288x384", "375x450"):
            timed = [t for s, _, t in recs if s == size][1:]   # no warm-up
            medians.setdefault(method, {})[size] = {
                k: round(statistics.median(t[k] for t in timed), 4)
                for k in timed[0]}
    print(json.dumps({"harness_medians_ms": medians, "warm_frames_ms": warm,
                      "card": smi}))


def harness_phase(cfg, kernels, fx, cfx, res_k, left, right, warm, smi):
    """Phase 18: the harness, eval, synth and the debug and batched ASW
    entries on the card, under a temporary STEREO_REFERENCE_ROOT."""
    import os
    import re

    import torch

    from stereo_matchin_tpu_torch.__main__ import main as cli
    from stereo_matchin_tpu_torch.models import asw

    old = os.environ.get("STEREO_REFERENCE_ROOT")
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        tmp = pathlib.Path(tmp)
        os.environ["STEREO_REFERENCE_ROOT"] = str(reference_root(tmp, cfg, fx,
                                                                 cfx))
        try:
            print(" (b) bench at REFERENCE_CONFIG")
            bench_phase(cli, tmp, cfg, kernels, warm, smi)
            print(" (c) eval --pairs tsukuba against the JAX goldens")
            rc, text = cli_output(cli, ["eval", "--pairs", "tsukuba",
                                        "--device", "cuda"])
            exact = {m.group(1): float(m.group(2)) for m in re.finditer(
                r"tsukuba/(\S+\.png): exact=([0-9.]+)%", text)}
            if rc != 0 or len(exact) != 3 or min(exact.values()) < 99.5:
                raise AssertionError(f"eval: rc {rc}, exact {exact}")
            print(" (d) synth -> run --pics -> eval --pics --gt")
            scene = tmp / "scene"
            cli_output(cli, ["synth", "--out", str(scene), "--seed", "18"])
            pics = str(scene / "pics.txt")
            if cli_output(cli, ["run", "--pics", pics, "--out",
                                str(scene / "maps"), "--device", "cuda"])[0]:
                raise AssertionError("run --pics failed")
            rc, text = cli_output(cli, ["eval", "--pics", pics, "--gt",
                                        str(scene / "gt.pfm"), "--device",
                                        "cuda"])
            if rc != 0 or len(re.findall(r"vs GT: bad1=[0-9.]+% bad2=", text)) != 2:
                raise AssertionError(f"eval --gt: rc {rc}")
        finally:
            if old is None:
                os.environ.pop("STEREO_REFERENCE_ROOT", None)
            else:
                os.environ["STEREO_REFERENCE_ROOT"] = old

    print(" (e) asw_pipeline_debug")
    r, k = cfg.r_iters, cfg.k_iters
    kernels.reset_launches()
    dbg = asw.asw_pipeline_debug(left, right, cfg)
    torch.cuda.synchronize()
    want = expected_asw_launches(cfg, 1, "whole", kernels)
    want.update(two_min=1 + r + 1 + k, wta_diag=1 + r + 1 + k)
    check_launches("debug", dict(kernels.LAUNCHES), want)
    for f in res_k._fields:
        if not torch.equal(getattr(dbg.result, f), getattr(res_k, f)):
            raise AssertionError(f"debug result {f} differs from asw_pipeline")
    if not torch.equal(dbg.aggr_wta_left[-1], res_k.wta_left):
        raise AssertionError("debug: last aggregation round != wta_left")
    print(f"  result bit-equal to asw_pipeline; aggr_wta {tuple(dbg.aggr_wta_left.shape)}, "
          f"refine_wta {tuple(dbg.refine_wta_left.shape)}; last round == wta_left")
    del dbg

    print(" (f) asw_pipeline_batched, B=2")
    l2, r2 = random_pair(np.random.default_rng(18), *left.shape[:2])
    kernels.reset_launches()
    got = asw.asw_pipeline_batched(torch.stack([left, l2]),
                                   torch.stack([right, r2]), cfg)
    torch.cuda.synchronize()
    want = expected_asw_launches(cfg, 1, "whole", kernels)
    check_launches("batched", dict(kernels.LAUNCHES),
                   {n: 2 * v for n, v in want.items()})
    for b, frame in enumerate((res_k, asw.asw_pipeline(l2, r2, cfg))):
        for f in frame._fields:
            if not torch.equal(getattr(got, f)[b], getattr(frame, f)):
                raise AssertionError(f"batched frame {b} {f} differs")
    print("  both frames bit-equal to asw_pipeline")


def codes(img):
    from stereo_matchin_tpu_torch import ops

    return ops.unorm8_code(img).cpu().numpy()


def red(img):
    r = img.cpu().numpy()
    return (r[..., 0] == 1.0) & (r[..., 1] == 0.0) & (r[..., 2] == 0.0)


def main() -> int:
    import torch

    phase("1. card")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke test needs an NVIDIA GPU")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.device_count()} device(s)")
    print(f"device 0: {kind}")
    print(f"nvidia-smi: {smi}")
    torch.cuda.set_device(0)

    from stereo_matchin_tpu_torch import REFERENCE_CONFIG, kernels
    from stereo_matchin_tpu_torch.kernels import _build
    from stereo_matchin_tpu_torch.models import asw, cross_based

    phase("2. build")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"built {lib.relative_to(ROOT)} from "
          f"{[str(s.relative_to(ROOT)) for s in _build.sources()]} in "
          f"{time.perf_counter() - t0:.1f} s ({smi})")

    cfg = REFERENCE_CONFIG
    fx = np.load(FIXTURE)
    left, right = (torch.from_numpy((fx[k] / np.float32(255.0)).astype(
        np.float32)).cuda() for k in ("left", "right"))
    pairs = {"288x384 fixture": (left, right),
             "375x450 random": random_pair(np.random.default_rng(3), 375, 450)}

    phase("3. kernels against their plain versions on the card")
    stats = {k[0]: {} for k in KERNELS}
    check_kernels(pairs, cfg, stats)
    check_aggregation_edges(stats)
    time_kernels(left, right, cfg, stats, smi)

    phase("4. ASW slice at REFERENCE_CONFIG: kernels against plain ops")
    kernels.reset_launches()
    res_k = asw.asw_pipeline(left, right, cfg)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    res_p = asw.asw_pipeline(left, right, cfg.replace(kernels="jnp"))
    torch.cuda.synchronize()
    print(f"  launches in one frame: {launches} (asw_pass v+h: "
          f"{launches['asw_pass_v'] + launches['asw_pass_h']})")
    want = expected_asw_launches(cfg, 1, "whole", kernels)
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if dict(kernels.LAUNCHES) != launches:
        raise AssertionError("the plain path launched a kernel")
    H, W = left.shape[:2]
    for f in ("disparity", "filled", "wta_left", "wta_right"):
        k, p = getattr(res_k, f), getattr(res_p, f)
        if k.shape != (H, W) or not torch.isfinite(k).all():
            raise AssertionError(f"{f}: bad output {tuple(k.shape)}")
        n = int((codes(k) != codes(p)).sum())
        print(f"  {f}: {n} differing codes")
        if n:
            raise AssertionError(f"{f}: kernel and plain paths differ")
    for f in ("consistency_pre", "consistency_post"):
        n = int((red(getattr(res_k, f)) != red(getattr(res_p, f))).sum())
        print(f"  {f} red mask: {n} differing pixels")
        if n:
            raise AssertionError(f"{f}: kernel and plain paths differ")
    ulp = max_ulp(res_k.aggregated_cost, res_p.aggregated_cost)
    print(f"  aggregated volume: max ulp {ulp}")
    if ulp:
        raise AssertionError("aggregated volumes differ")

    phase("5. ASW slice against the JAX package's stored output")
    for f in ("disparity", "filled", "wta_left", "wta_right"):
        frac = float((codes(getattr(res_k, f)) == fx[f]).mean())
        print(f"  {f}: {frac * 100:.4f}% codes equal to JAX")
        if f == "disparity" and frac < 0.995:
            raise AssertionError(f"disparity agrees with JAX on only "
                                 f"{frac * 100:.3f}% of pixels")
    for f, key in (("consistency_pre", "red_pre"),
                   ("consistency_post", "red_post")):
        frac = float((red(getattr(res_k, f)) == fx[key]).mean())
        print(f"  {f} red mask: {frac * 100:.4f}% equal to JAX")

    phase("6. warm per-frame time (host clock around synchronized frames)")
    frame_ms = {"kernels": [], "plain": []}
    for mode in ("plain", "kernels", "kernels", "plain") * 2:
        c = cfg if mode == "kernels" else cfg.replace(kernels="jnp")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        asw.asw_pipeline(left, right, c)
        torch.cuda.synchronize()
        frame_ms[mode].append((time.perf_counter() - t0) * 1e3)
    for mode, v in frame_ms.items():
        print(f"  {mode}: median {statistics.median(v):.2f} ms per frame "
              f"({', '.join(f'{x:.2f}' for x in v)}) at REFERENCE_CONFIG "
              f"{H}x{W} on {smi}")

    phase("7. cross kernels against their plain versions on the card")
    cross_pairs = {"288x384 fixture": (left, right),
                   "375x450 synthetic": scene_pair(3, 375, 450, cfg.d_max)}
    check_cross_kernels(cross_pairs, cfg, stats)
    check_vote_edges(stats, kernels)
    check_oii_edges(stats, kernels)
    check_sad_edges(stats, kernels)
    check_arms_edges(stats, kernels)
    time_cross_kernels(left, right, cfg, stats, smi)

    phase("8. cross slice at REFERENCE_CONFIG: kernels against plain ops")
    kernels.reset_launches()
    cross_k = cross_based.cross_pipeline(left, right, cfg)
    torch.cuda.synchronize()
    cross_launches = dict(kernels.LAUNCHES)
    taps = cfg.replace(oii_impl="taps")
    cross_p = cross_based.cross_pipeline(left, right, taps)
    torch.cuda.synchronize()
    print(f"  launches in one frame: {cross_launches}")
    want = dict.fromkeys(kernels.ASW_KERNELS, 0)
    want.update(cross_arms=2, sad_volume=1, oii_pass_h=1, oii_pass_v=1,
                vote_h=1, vote_v=1)
    if cross_launches != want:
        raise AssertionError(f"launch counts {cross_launches} != {want}")
    if dict(kernels.LAUNCHES) != cross_launches:
        raise AssertionError("the plain path launched a kernel")
    for f in ("initial", "final", "median_left"):
        k, p = getattr(cross_k, f), getattr(cross_p, f)
        shape = (H, W, 3) if f == "median_left" else (H, W)
        if k.shape != shape or not torch.isfinite(k).all():
            raise AssertionError(f"{f}: bad output {tuple(k.shape)}")
        ulp = max_ulp(k, p)
        print(f"  {f}: max ulp {ulp} between the kernel and plain paths")
        if ulp:
            raise AssertionError(f"{f}: kernel and plain paths differ")

    phase("9. cross slice against the JAX package's stored output")
    cfx = np.load(CROSS_FIXTURE)
    got = {"initial": codes(cross_k.initial), "final": codes(cross_k.final),
           "median_left": codes(cross_k.median_left)}
    for f, c in got.items():
        frac = float((c == cfx[f]).mean())
        print(f"  {f}: {frac * 100:.4f}% codes equal to JAX")
        if f == "initial" and frac < 0.995:
            raise AssertionError(f"initial agrees with JAX on only "
                                 f"{frac * 100:.3f}% of pixels")

    phase("10. cross warm per-frame time (host clock around synchronized "
          "frames)")
    cross_ms = {"kernels": [], "plain": []}
    for mode in ("plain", "kernels", "kernels", "plain") * 4:
        c = cfg if mode == "kernels" else taps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cross_based.cross_pipeline(left, right, c)
        torch.cuda.synchronize()
        cross_ms[mode].append((time.perf_counter() - t0) * 1e3)
    for mode, v in cross_ms.items():
        print(f"  {mode}: median {statistics.median(v):.2f} ms per frame "
              f"({', '.join(f'{x:.2f}' for x in v)}) at REFERENCE_CONFIG "
              f"{H}x{W} on {smi}")

    phase("11. run CLI (--method both) on PNG files")
    if importlib.util.find_spec("PIL") is None:
        raise AssertionError("no PNG codec: PIL is not installed")
    from stereo_matchin_tpu_torch.io import png
    from stereo_matchin_tpu_torch.__main__ import main as cli

    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        tmp = pathlib.Path(tmp)
        png.write_rgb(tmp / "l.png", fx["left"])
        png.write_rgb(tmp / "r.png", fx["right"])
        (tmp / "pics.txt").write_text(f"{tmp / 'l.png'}\n{tmp / 'r.png'}\n")
        rc = cli(["run", "--pics", str(tmp / "pics.txt"), "--out",
                  str(tmp / "out"), "--device", "cuda"])
        out = tmp / "out" / tmp.name
        if rc != 0:
            raise AssertionError(f"CLI exited with {rc}")
        for name, want in (("asw_disparity.png", codes(res_k.disparity)),
                           ("cross_based_initial.png", got["initial"]),
                           ("cross_based_disparity.png", got["final"])):
            if not np.array_equal(codes(torch.from_numpy(
                    png.read_gray(str(out / name)))), want):
                raise AssertionError(f"CLI {name} differs from the slice")
            print(f"  {name} equals the slice's codes")
        if not np.array_equal(codes(torch.from_numpy(
                png.read_rgb(str(out / "median.png")))), got["median_left"]):
            raise AssertionError("CLI median.png differs from the slice")
        print("  median.png equals the slice's median-filtered left image")

    phase("12. band drivers' kernels against their plain versions on the "
          "card")
    check_band_kernels(cross_pairs, cfg, stats)

    phase("13. ASW band drivers, REFERENCE_CONFIG with aggr_d_chunks=3, "
          "2 bands, 400x450 synthetic scene")
    band_launches = asw_band_phase(cfg.replace(aggr_d_chunks=3), kernels)

    c3 = cfg.replace(d_max=279, aggr_d_chunks=4)
    phase(f"14. config 3 ASW kernels against their plain versions, and "
          f"timed: {CONFIG3_HW[0]}x{CONFIG3_HW[1]}, d_max 279, "
          f"aggr_d_chunks 4")
    l3, r3 = config3_pair(3)
    band_kernels_config3(l3, r3, c3, stats, smi)
    del l3, r3

    phase(f"15. config 3 ASW through the kernels: whole frame, wavefront and "
          f"halo bands ({CONFIG3_BANDS}), wavefront in 8 bands")
    config3_asw(c3, kernels, smi)

    phase(f"16. config 3 cross-based: kernels against their plain versions "
          f"on one band's rows; whole frame, wavefront and halo bands "
          f"({CONFIG3_BANDS})")
    config3_cross(cfg.replace(d_max=279), kernels, stats, smi)

    phase("17. run CLI --bands 3 on PNG files")
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        tmp = pathlib.Path(tmp)
        png.write_rgb(tmp / "l.png", fx["left"])
        png.write_rgb(tmp / "r.png", fx["right"])
        (tmp / "pics.txt").write_text(f"{tmp / 'l.png'}\n{tmp / 'r.png'}\n")
        rc = cli(["run", "--pics", str(tmp / "pics.txt"), "--out",
                  str(tmp / "out"), "--device", "cuda", "--bands", "3"])
        out = tmp / "out" / tmp.name
        if rc != 0:
            raise AssertionError(f"CLI exited with {rc}")
        if sorted(p.name for p in out.iterdir()) != [
                "asw_disparity.png", "cross_based_disparity.png",
                "cross_based_initial.png"]:
            raise AssertionError(f"CLI --bands wrote {list(out.iterdir())}")
        for name, want in (("asw_disparity.png", codes(res_k.disparity)),
                           ("cross_based_initial.png", got["initial"]),
                           ("cross_based_disparity.png", got["final"])):
            if not np.array_equal(codes(torch.from_numpy(
                    png.read_gray(str(out / name)))), want):
                raise AssertionError(f"CLI --bands 3 {name} differs from the "
                                     f"whole-frame slice")
            print(f"  {name} equals the whole-frame slice's codes")

    phase("18. harness and eval on the card: bench, eval, synth -> run -> "
          "eval, asw_pipeline_debug, asw_pipeline_batched")
    warm = {"asw_288x384_phase6": round(statistics.median(
                frame_ms["kernels"]), 4),
            "cross_288x384_phase10": round(statistics.median(
                cross_ms["kernels"]), 4)}
    harness_phase(cfg, kernels, fx, cfx, res_k, left, right, warm, smi)

    path_launches = {
        "asw": launches, "cross": cross_launches,
        "bands": band_launches["wavefront"]}
    report = {"kernels": []}
    for name, source, replaces, key, path in KERNELS:
        bound_ms, bound_by = bound(stats[name])
        report["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": path_launches[path][key],
            "max_abs_err": stats[name]["max_abs_err"],
            "ms": stats[name]["ms"], "device_ms": stats[name]["device_ms"],
            "plain_ms": stats[name]["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            # No single PyTorch call computes any of these functions (the
            # weights differ per tap and plane, the order of the f32 sums
            # is fixed, the arms and votes have no library form), so none
            # is timed; PERF.md section 6 gives the reason per kernel.
            "library_ms": None})
    for entry in report["kernels"]:
        if entry["launches"] < 1:
            raise AssertionError(f"{entry['name']}: no launch on its path")
    print()
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
