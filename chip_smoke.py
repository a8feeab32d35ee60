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
entries, bit-equal to the pipeline.  Phase 19 drives the sharded
pipelines (parallel/) in one spawn of 4 gloo ranks sharing the card
(meshes (1,2,2), (1,4,1), (1,1,4) and (2,2,1) at REFERENCE_CONFIG on
288x384, then config 3 on (1,2,2); both methods bit-equal to the
unsharded frames of phases 4, 8, 15 and 16, every rank's launches
asserted) and once more through one NCCL rank.  Phase 20 runs `run
--method both` and `run --method cross` over 8 seeded 375x450 scenes,
decoding ahead (io/loader.py): every file byte-equal to those of `run`'s
own per-pair work on the pairs decoded inline and the launches asserted,
timed against that inline loop beside PIL's encode and decode times; and
`ops.asw_aggregate_2d` on the card against the CPU (0 ulp, 64x96 crop),
timed with its peak memory at REFERENCE_CONFIG.  Phase 21 holds the
frames captured as CUDA graphs (`asw_pipeline`, `cross_pipeline`,
`asw_pipeline_batched`; utils/graphs.py) against their eager chains
(`*_impl`): every field bit-equal on pairs other than the captured one,
one frame's launches a call, held results unchanged, from 288x384 up to
the config-3 whole frames; warm medians in turns, capture seconds, pool
bytes and first-call peaks, and the busy share of a replayed 288x384 ASW
frame under torch.profiler.  Phase 22 drives the per-stage harness with
its stages replayed from CUDA graphs (utils/graphs.py StageGraphs) at
288x384 and 375x450, both methods: the first run's captures (stage
graphs, seconds, pool and static-input bytes beside the eager frame's
peak), every stage of a frame on two more pairs replayed bit-equal to
its eager call, the TSV medians captured against the eager stages in
turns (each run one frame's launches), the device ms per stage of a
profiled eager frame and the ratio of each method's total to it; the
captured `asw_pipeline_debug` against `asw_pipeline_debug_impl` on every
field; and config 3 through both harness methods with no out-of-memory
error.  Before the last line it
prints one JSON object with each kernel's launches on its path (and per
rank on the sharded path at config 3), largest error against its plain
version, time (`ms`: eager calls, by CUDA events), device time
(`device_ms`: the same calls replayed from a CUDA graph, without the
host's dispatch), plain time (eager calls) and least time (`bound_ms`,
from the bytes and operations of the timed call at the H100's HBM and
float32 peaks).  Any failed check raises; the last line of a passing run
is

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
# planes at or above the big cap.  The last field is K3's disparity offset
# d0 (plane d holds disparity d0 + d, as a disp shard's volume does): 0,
# then two shard volumes, one of them 4 bytes off a 16-byte boundary.
WTA_EDGES = [(1, 48, 64, "argmin", 0, 0), (3, 40, 64, "argmin", 0, 0),
             (61, 37, 53, "random", 0, 0), (61, 32, 96, "argmin", 1, 0),
             (17, 30, 20, "last", 0, 0), (33, 24, 300, "random", 0, 0),
             (61, 32, 200, "zero", 0, 0), (61, 32, 200, "last", 0, 0),
             (280, 12, 700, "random", 0, 0), (280, 8, 700, "outliers", 0, 0),
             (31, 32, 96, "argmin", 0, 30), (140, 12, 700, "argmin", 1, 140)]
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
    for D, H, W, kind, offset, d0 in WTA_EDGES:
        cost, pen, d1_of = wta_edge_inputs(rng, D, H, W, kind, offset)
        for p in ((None, None), pen):
            tag = (f"edge D={D} {H}x{W} d1={kind} offset={offset} d0={d0} "
                   f"penalty={'yes' if p[0] is not None else 'no'}")
            want = _two_min_plain(cost, *p, big=cfg.big, d0=d0)
            compare(f"two_min {tag}", kw.two_min(cost, *p, big=cfg.big, d0=d0),
                    want, stats["two_min"])
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


def config3_pair(seed, hw=CONFIG3_HW):
    """A seeded UNORM8 pair at config 3's size (or `hw`), made on the card:
    the right view is the left one shifted by 37 columns plus noise of +-8
    codes."""
    import torch

    H, W = hw
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
    (models.tiled.asw_plan_bytes).  Returns the whole frame's maps (on the
    host)."""
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

    whole = {}

    def run(route):
        bands, wf, _ = routes[route]
        if bands == 1:                     # eager: BandPeaks syncs inside
            res = asw.asw_pipeline_impl(left, right, cfg)
            whole.update((f, getattr(res, f)) for f in SHARDED_MAPS["asw"])
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
    return {f: v.cpu() for f, v in whole.items()}


def config3_cross(cfg, kernels, stats, smi):
    """Config 3 cross-based: K5-K8 against their plain versions on one
    band's rows, then the whole frame, wavefront and halo bands through the
    kernels; times and peak memory.  Returns the whole frame's maps (on
    the host)."""
    import torch

    from stereo_matchin_tpu_torch.models import cross_based, tiled

    H, W = CONFIG3_HW
    B = CONFIG3_BANDS
    t0 = time.perf_counter()
    left, right = scene_pair(4, H, W, cfg.d_max)
    print(f"  synthetic scene {H}x{W} made in "
          f"{time.perf_counter() - t0:.1f} s (host; {smi})")
    cross_kernels_config3(left, right, cfg, stats, smi)
    runs = {"whole": lambda: cross_based.cross_pipeline_impl(left, right,
                                                             cfg),
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
            if route == "whole":
                whole = {f: getattr(out, f).cpu()
                         for f in SHARDED_MAPS["cross"]}
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
    return whole


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


# The maps of each method that the sharded phase holds bit-equal.
SHARDED_MAPS = {"asw": ("disparity", "filled", "consistency_pre",
                        "consistency_post", "wta_left", "wta_right"),
                "cross": ("initial", "final", "median_left")}
# The meshes of the sharded phase at 288x384 over 4 ranks, (batch, row,
# disp): D = 61 pads to 62 on 2 disp shards and to 64 on 4; (2, 2, 1) takes
# a batch of two frames.
SHARDED_MESHES = [(1, 2, 2), (1, 4, 1), (1, 1, 4), (2, 2, 1)]


def config3_batch(dev, seed):
    """config3_pair as a batch of one frame (a rank makes its own)."""
    return tuple(x[None] for x in config3_pair(seed))


def scene_batch(dev, seed, H, W, d_max):
    """scene_pair as a batch of one frame (a rank makes its own)."""
    return tuple(x[None] for x in scene_pair(seed, H, W, d_max))


def sharded_launches(method, cfg, kernels):
    """Launches of one frame on one rank of the sharded pipelines: K1 x2,
    the windowed K2 and K2 h r times, K3 k + 1 times at the shard's d0 (the
    target scan is plain), or K5 x2 and K6-K8 once each."""
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    if method == "asw":
        want.update(asw_den=2, asw_pass_win=cfg.r_iters,
                    asw_pass_h=cfg.r_iters, two_min=cfg.k_iters + 1)
    else:
        want.update(cross_arms=2, sad_volume=1, oii_pass_h=1, oii_pass_v=1,
                    vote_h=1, vote_v=1)
    return want


def check_sharded(ranks, cases, refs, kernels, smi):
    """Each case's gathered maps against its unsharded frames (refs[pair]
    [method]: field -> (B, H, W[, 3]) host tensor), bit for bit, and every
    rank's launches; prints per-rank frame ms and peak memory.  Returns
    the ranks' records per case."""
    import torch

    from stereo_matchin_tpu_torch import StereoConfig

    out = []
    for k, case in enumerate(cases):
        recs = [r[k] for r in ranks]
        ms = "; ".join(", ".join(f"{x:.1f}" for x in r["ms"]) for r in recs)
        peak = ", ".join(f"{r['peak'] / 1e9:.3f}" for r in recs)
        tag = (f"{case.method} mesh {case.mesh} {case.pair}"
               + (f" halo {case.halo_mode}" if case.method == "asw" else ""))
        print(f"  {tag}: frame ms per rank (cold, warm) {ms}; peak GB per "
              f"rank {peak}; {smi}")
        want = sharded_launches(case.method, StereoConfig(**case.cfg),
                                kernels)
        for r in recs:
            if r["launches"] != want:
                raise AssertionError(f"{tag}: rank {r['coord']} launched "
                                     f"{r['launches']}, want {want}")
        out.append(recs)
        if case.halo_mode == "local":
            continue
        got = recs[0]["maps"]
        for f in SHARDED_MAPS[case.method]:
            w = refs[case.pair][case.method][f]
            g = torch.from_numpy(got[f])
            if g.shape != w.shape or not torch.equal(g, w):
                raise AssertionError(f"{tag}: {f} differs from the unsharded "
                                     f"frame")
        print(f"  {tag}: {', '.join(SHARDED_MAPS[case.method])} bit-equal to "
              f"the unsharded frames; launches per rank as expected")
    return out


def epipolar_scan_time(c3_kw, smi):
    """The plain target scan of one config-3 (1, 2, 2) shard (140 planes of
    994 x 2880, parallel/wta_sharded.py epipolar_partial, 279 steps), alone
    on the card in this process: a sharded ASW frame runs it k + 1 = 7
    times a rank."""
    import torch

    from stereo_matchin_tpu_torch.parallel.wta_sharded import epipolar_partial

    H, W = CONFIG3_HW
    D = c3_kw["d_max"] + 1
    gen = torch.Generator(device="cuda").manual_seed(5)
    cost = torch.rand((D // 2, H // 2, W), generator=gen, device="cuda")
    d1 = torch.randint(0, D, (H // 2, W), generator=gen, device="cuda",
                       dtype=torch.int32)
    sc = torch.rand((H // 2, W), generator=gen, device="cuda")
    ct = torch.rand((H // 2, W), generator=gen, device="cuda") * D
    scan = lambda: epipolar_partial(cost, d1, D // 2, D // 2, D, sc, ct)
    scan()
    _, ms = timed(scan)
    print(f"  config-3 shard's plain epipolar scan ({D // 2} planes of "
          f"{H // 2}x{W}, {D - 1} steps, with the penalty): {ms:.1f} ms "
          f"alone on the card, 7 a frame; {smi}")


def sharded_phase(cfg, kernels, left, right, refs, c3_refs, smi):
    """The sharded pipelines (parallel/) in one spawn of 4 gloo ranks on the
    one card, then one NCCL rank.  refs: the unsharded 288x384 frames of
    phases 4 and 8 (method -> field -> tensor); c3_refs: phases 15 and
    16's whole config-3 frames (the same, on the host).  Returns rank 0's
    launches in the config-3 (1, 2, 2) frames, per method."""
    import dataclasses

    import torch

    from stereo_matchin_tpu_torch.models import asw, cross_based
    from stereo_matchin_tpu_torch.parallel.distributed import spawn
    from stereo_matchin_tpu_torch.parallel.dryrun import Case, sharded_maps

    H, W = left.shape[:2]
    sl, sr = scene_pair(5, H, W, cfg.d_max)
    scene = {"asw": asw.asw_pipeline(sl, sr, cfg),
             "cross": cross_based.cross_pipeline(sl, sr, cfg)}
    host = lambda *xs: tuple(x.cpu().numpy() for x in xs)
    pairs = {"fixture": host(left[None], right[None]),
             "batch": host(torch.stack([left, sl]), torch.stack([right, sr])),
             "config3_asw": (config3_batch, (3,)),
             "config3_cross": (scene_batch, (4, *CONFIG3_HW, 279))}
    refs = {
        "fixture": {m: {f: refs[m][f][None].cpu() for f in SHARDED_MAPS[m]}
                    for m in refs},
        "batch": {m: {f: torch.stack([refs[m][f], getattr(scene[m], f)])
                      .cpu() for f in SHARDED_MAPS[m]} for m in refs},
        "config3_asw": {"asw": {f: v[None] for f, v in c3_refs["asw"].items()}},
        "config3_cross": {"cross": {f: v[None] for f, v in
                                    c3_refs["cross"].items()}}}
    ref_kw = dataclasses.asdict(cfg.replace(median_dispatch_quirk=False))
    c3_kw = dict(ref_kw, d_max=279)
    cases = []
    for mesh in SHARDED_MESHES:
        pair = "batch" if mesh[0] > 1 else "fixture"
        cases += [Case("asw", mesh, ref_kw, pair),
                  Case("cross", mesh, ref_kw, pair)]
    cases += [Case("asw", (1, 2, 2), c3_kw, "config3_asw"),
              Case("asw", (1, 2, 2), c3_kw, "config3_asw", "local"),
              Case("cross", (1, 2, 2), c3_kw, "config3_cross")]
    print("  4 gloo ranks share this one card: collectives are staged "
          "through host memory, and the times are of ranks taking turns on "
          "one card, not multi-card scaling")
    del scene
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(sharded_maps, 4, "gloo", (cases, pairs, "cuda", 2), 900)
    print(f"  spawn of 4 ranks: {time.perf_counter() - t0:.1f} s in all")
    recs = check_sharded(ranks, cases, refs, kernels, smi)
    for e, loc in zip(recs[-3], recs[-2]):
        ex, lo = e["ms"][-1], loc["ms"][-1]
        print(f"  config 3 ASW (1, 2, 2) rank {e['coord']}, warm: exchange "
              f"{ex:.1f} ms, local halos {lo:.1f} ms (the row axis's "
              f"share: {ex - lo:.1f} ms); {smi}")
    epipolar_scan_time(c3_kw, smi)

    t0 = time.perf_counter()
    nccl = [Case("asw", (1, 1, 1), ref_kw, "fixture"),
            Case("cross", (1, 1, 1), ref_kw, "fixture")]
    ranks = spawn(sharded_maps, 1, "nccl",
                  (nccl, {"fixture": pairs["fixture"]}, "cuda", 2), 300)
    print(f"  NCCL at world size 1 (the one card; NCCL between cards is not "
          f"run here): {time.perf_counter() - t0:.1f} s")
    check_sharded(ranks, nccl, refs, kernels, smi)
    return {"asw": recs[-3][0]["launches"], "cross": recs[-1][0]["launches"]}


# Phase 20: `run` over seeded synthetic scenes at the reference's 375x450
# size, decoding ahead (io/loader.py).
RUN_SCENES = 8
RUN_HW = (375, 450)


def write_scenes(root, cfg):
    """RUN_SCENES seeded synthetic scenes as PNG pairs root/scene<k>/imL.png
    and imR.png, and one pics.txt naming them all.  Returns the pics.txt
    path and its pairs."""
    from stereo_matchin_tpu_torch.eval import synthetic_scene
    from stereo_matchin_tpu_torch.io import parse_pics_txt, png

    lines = []
    for k in range(RUN_SCENES):
        left, right, _, _ = synthetic_scene(np.random.default_rng(200 + k),
                                            *RUN_HW, cfg.d_max)
        d = root / f"scene{k}"
        d.mkdir()
        png.write_rgb(d / "imL.png", left)
        png.write_rgb(d / "imR.png", right)
        lines += [str(d / "imL.png"), str(d / "imR.png")]
    pics = root / "pics.txt"
    pics.write_text("\n".join(lines) + "\n")
    return pics, parse_pics_txt(str(pics))


def inline_run(argv, pairs):
    """`run`'s own per-pair work (`__main__._run_pair`, on the arguments
    `run` parses from argv) with each pair decoded inline (`_load`) just
    before it, in place of the loader."""
    import torch

    from stereo_matchin_tpu_torch.__main__ import (_config_from_args, _load,
                                                   _parser, _run_pair)

    args = _parser().parse_args(argv)
    cfg, dev = _config_from_args(args), torch.device(args.device)
    for pair in pairs:
        _run_pair(args, cfg, dev, pair, *_load(pair, dev))
    return 0


def artifacts(out):
    """The bytes of every file under out/, by its path relative to out."""
    return {str(f.relative_to(out)): f.read_bytes()
            for f in sorted(out.rglob("*")) if f.is_file()}


def decode_times(pairs):
    """Host ms of PIL decoding: per pair (both views, one thread; median
    over the pairs), and all the views once in one thread and once split
    over two threads, the least of two turns each (two threads take about
    half the time only where PIL releases the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    from stereo_matchin_tpu_torch.io import png

    per_pair = []
    for pair in pairs:
        t0 = time.perf_counter()
        png.read_rgb(pair.left), png.read_rgb(pair.right)
        per_pair.append((time.perf_counter() - t0) * 1e3)
    views = [p for pair in pairs for p in (pair.left, pair.right)]

    def decode_all(paths):
        for p in paths:
            png.read_rgb(p)

    one, two = [], []
    with ThreadPoolExecutor(2) as pool:
        for _ in range(2):
            t0 = time.perf_counter()
            decode_all(views)
            one.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            for f in [pool.submit(decode_all, views[k::2]) for k in (0, 1)]:
                f.result()
            two.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(per_pair), min(one), min(two)


def encode_ms(out, pairs):
    """Host ms of PIL encoding one pair's artifacts, as read back from
    out/<pair>/ (the maps already on the host), median over the pairs."""
    from stereo_matchin_tpu_torch.io import png

    per_pair = []
    for pair in pairs:
        files = sorted((out / pair.name).iterdir())
        imgs = [np.round(png.read_rgb(f) * 255).astype(np.uint8)
                for f in files]
        t0 = time.perf_counter()
        for f, img in zip(files, imgs):
            png.write_rgb(f, img)
        per_pair.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(per_pair)


def run_turns(tmp, pics, pairs, cfg, kernels, method, turns):
    """`run --method <method>` against the inline loop in turns (one pair
    inline as an untimed warm-up, then inline, run, run, inline, `turns`
    times): every turn's files byte-equal to the first inline turn's, and
    every run's launches one frame of each of its methods a pair.  Returns
    the seconds per pair of each turn, per mode, and the first inline
    turn's directory."""
    import contextlib
    import io

    import torch

    from stereo_matchin_tpu_torch.__main__ import main as cli

    n = len(pairs)
    flags = [a for f in ("d_max", "radius", "arm_len", "r_iters", "k_iters")
             for a in (f"--{f}", str(getattr(cfg, f)))]

    def argv(out):
        return ["run", "--pics", str(pics), "--out", str(out), "--method",
                method, "--device", "cuda"] + flags

    want = dict.fromkeys(kernels.LAUNCHES, 0)
    if method in ("both", "asw"):
        want = expected_asw_launches(cfg, 1, "whole", kernels)
    if method in ("both", "cross"):
        for name, v in expected_cross_launches(1, kernels).items():
            want[name] += v
    with contextlib.redirect_stdout(io.StringIO()):
        inline_run(argv(tmp / f"{method}_warm"), pairs[:1])
    secs = {"inline": [], "run": []}
    first = None
    for turn, mode in enumerate(("inline", "run", "run", "inline") * turns):
        out = tmp / f"{method}_{turn}"
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = (inline_run(argv(out), pairs) if mode == "inline"
                  else cli(argv(out)))
        torch.cuda.synchronize()
        secs[mode].append((time.perf_counter() - t0) / n)
        if rc != 0:
            raise AssertionError(f"{mode} --method {method} exited with {rc}")
        if first is None:
            first, files = out, artifacts(out)
            continue
        if mode == "run" and dict(kernels.LAUNCHES) != {
                k: v * n for k, v in want.items()}:
            raise AssertionError(f"run --method {method}: launches "
                                 f"{dict(kernels.LAUNCHES)}, want {n} x "
                                 f"{want}")
        got = artifacts(out)
        if got != files:
            bad = sorted(set(got) ^ set(files)) or sorted(
                k for k in files if got[k] != files[k])
            raise AssertionError(f"{mode} --method {method}, turn {turn}: "
                                 f"{bad} differ from the first inline turn")
    print(f"  run --method {method}: {len(files)} files of {n} pairs, each "
          f"byte-equal over {4 * turns - 1} turns to the first inline turn "
          f"(`_run_pair` on pairs decoded by `_load`); launches per pair "
          f"as expected: {want}")
    return secs, first


def run_phase(cfg, kernels, smi):
    """Phase 20 (a): `run` on the card over RUN_SCENES scenes, decoding
    ahead: --method both (the default) and --method cross (a cheap frame,
    where decoding is a large share of a pair); the files against the
    inline loop's, the launches, the seconds per pair beside the inline
    loop's, and PIL's encode and decode times."""
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        tmp = pathlib.Path(tmp)
        pics, pairs = write_scenes(tmp, cfg)
        secs, encode = {}, {}
        for method, turns in (("both", 1), ("cross", 2)):
            secs[method], first = run_turns(tmp, pics, pairs, cfg, kernels,
                                            method, turns)
            encode[method] = encode_ms(first, pairs)
        decode, one, two = decode_times(pairs)
    fmt = lambda v: ", ".join(f"{x:.4f}" for x in v)
    for method, v in secs.items():
        print(f"  --method {method}, {len(pairs)} pairs of {RUN_HW[0]}x"
              f"{RUN_HW[1]}: run (decode ahead) {fmt(v['run'])} s per pair; "
              f"inline loop (decode, pipelines, write) {fmt(v['inline'])} s "
              f"per pair; PIL encode of its {3 if method == 'cross' else 6} "
              f"PNGs {encode[method]:.2f} ms a pair; {smi}")
    print(f"  PIL decode of one pair (two views) on the host: {decode:.2f} ms "
          f"(median of {len(pairs)}); all {2 * len(pairs)} views {one:.1f} ms "
          f"in one thread, {two:.1f} ms over two threads ({one / two:.2f}x)")
    return {"s_per_pair": secs, "encode_ms_per_pair": encode,
            "decode_ms_per_pair": decode, "decode_1_thread_ms": one,
            "decode_2_threads_ms": two}


def asw2d_phase(left, right, cfg, smi):
    """Phase 20 (b): ops.asw_aggregate_2d on the card against the CPU at 0
    ulp on a 64x96 crop (D = 16, radius 16), then the full REFERENCE_CONFIG
    call at 288x384 timed (host clock around synchronized calls, one cold
    and two warm) with its peak device memory."""
    import torch

    from stereo_matchin_tpu_torch import ops
    from stereo_matchin_tpu_torch.models import asw

    def inputs(l, r, D):
        w = asw.asw_weights(l, r, cfg)
        return (ops.sad_cost_volume(l, r, D, 255.0), w.wv_l, w.wv_r, w.wh_l,
                w.wh_r)

    R = cfg.radius
    crop = inputs(left[:64, :96].contiguous(), right[:64, :96].contiguous(),
                  16)
    got = ops.asw_aggregate_2d(*crop, R)
    want = ops.asw_aggregate_2d(*(a.cpu() for a in crop), R)
    ulp = max_ulp(got.cpu(), want)
    print(f"  64x96 crop, D=16, radius {R}: card against CPU max ulp {ulp}")
    if ulp or not torch.isfinite(got).all():
        raise AssertionError("asw_aggregate_2d on the card differs from the "
                             "CPU")
    full = inputs(left, right, cfg.num_disp)
    del got, want, crop
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = [timed(lambda: ops.asw_aggregate_2d(*full, R))[1] for _ in range(3)]
    peak = torch.cuda.max_memory_allocated()
    out = ops.asw_aggregate_2d(*full, R)
    if out.shape != full[0].shape or not torch.isfinite(out).all():
        raise AssertionError(f"asw_aggregate_2d: bad output "
                             f"{tuple(out.shape)}")
    H, W = left.shape[:2]
    print(f"  {H}x{W}, D={cfg.num_disp}, radius {R}: "
          f"{', '.join(f'{x:.2f}' for x in ms)} ms (cold, warm, warm); peak "
          f"{(peak - base) / 1e9:.3f} GB above the {base / 1e9:.3f} GB of "
          f"its inputs and the live tensors; {smi}")
    return {"ms": ms, "peak_gb_above_inputs": (peak - base) / 1e9}


# Phase 21: the whole frames captured once per signature as CUDA graphs
# (utils/graphs.py) and replayed, against their eager chains (*_impl).

def eager_batched(left, right, cfg):
    """asw_pipeline_batched's result through the eager chain, frame by
    frame."""
    import torch

    from stereo_matchin_tpu_torch.models import asw

    frames = [asw.asw_pipeline_impl(l, r, cfg) for l, r in zip(left, right)]
    return asw.ASWResult(*(torch.stack(f) for f in zip(*frames)))


def memory_of(fn, kernels):
    """(result, ms, memory, launches) of one call of fn.  Memory, in bytes
    above the card's state before the call (cached blocks released before
    and after): `peak_allocated` (tensors; blind to blocks freed back into
    a graph's pool during its capture), `peak_reserved` (every segment, the
    graphs' pools included) and `held` (the drop of the card's free memory
    across the call, its result still held; net of any graph the call
    evicted)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    reserved = torch.cuda.memory_reserved()
    free = torch.cuda.mem_get_info()[0]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    out, ms = timed(fn)
    torch.cuda.empty_cache()
    return out, ms, {
        "peak_allocated": torch.cuda.max_memory_allocated() - base,
        "peak_reserved": torch.cuda.max_memory_reserved() - reserved,
        "held": free - torch.cuda.mem_get_info()[0]}, dict(kernels.LAUNCHES)


def captured_against_eager(label, entry, eager, cfg, pairs, kernels, graphs):
    """(a) One signature: the captured entry on pairs[0] (its capture) and
    on the others (replays), each result bit-equal on every field to the
    eager chain's on the same pair and counting exactly its launches, and
    the previous pair's result, still held, unchanged after the next call.
    Returns the capture's stats (utils.graphs), the first call's seconds
    and memory, and the eager frame's memory (memory_of)."""
    import torch

    # The first call's own eviction for the count, done before its memory
    # is read, so that the reading is the new graph's alone.
    graphs.CACHE.evict_to(graphs.MAX_GRAPHS - 1)
    held, stats = None, None
    for k, (left, right) in enumerate(pairs):
        got, ms, mem, launches = memory_of(lambda: entry(left, right, cfg),
                                           kernels)
        if k == 0:
            stats = dict(list(graphs.CACHE.frames.values())[-1].stats,
                         first_call_s=ms / 1e3, **{
                             f"first_call_{m}_bytes": v
                             for m, v in mem.items()})
        want, _, eager_mem, eager_launches = memory_of(
            lambda: eager(left, right, cfg), kernels)
        if k == 0:
            stats |= {f"eager_{m}_bytes": v for m, v in eager_mem.items()}
        if launches != eager_launches:
            raise AssertionError(f"{label}, pair {k}: the captured call "
                                 f"launched {launches}, the eager frame "
                                 f"{eager_launches}")
        for f in want._fields:
            g, w = getattr(got, f), getattr(want, f)
            if g.shape != w.shape or not torch.equal(g, w):
                n = int((g != w).sum()) if g.shape == w.shape else -1
                raise AssertionError(f"{label}, pair {k}: captured {f} "
                                     f"differs from the eager chain's on {n} "
                                     f"elements")
        if held is not None and not all(
                torch.equal(a, b) for a, b in zip(*held)):
            raise AssertionError(f"{label}: the result held from pair {k - 1} "
                                 f"changed in the call on pair {k}")
        held = (got, want)
        del got, want
    print(f"  {label}: captured on pair 0, replayed on {len(pairs) - 1} "
          f"more; every field bit-equal to the eager chain's; each call's "
          f"launches equal one eager frame's {launches}; held results "
          f"unchanged")
    return stats


def frame_turns(entry, eager, left, right, cfg, rounds):
    """(b) Warm frame ms, host clock around synchronized calls, in the
    turns eager, captured, captured, eager, `rounds` times."""
    ms = {"captured": [], "eager": []}
    for _ in range(rounds):
        for mode in ("eager", "captured", "captured", "eager"):
            fn = entry if mode == "captured" else eager
            ms[mode].append(timed(lambda: fn(left, right, cfg))[1])
    return ms


def busy_share(fn):
    """(c) (host ms, device ms, device launches) of one call of fn under
    torch.profiler, after one call unprofiled."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, host_ms = timed(fn)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return (host_ms, sum(e.device_time_total for e in rows) / 1e3,
            sum(e.count for e in rows))


def graph_phase(cfg, kernels, left, right, smi):
    """Phase 21: every captured signature against the eager chain (a),
    their warm medians in turns (b), and the device's busy share of one
    replayed and one eager 288x384 ASW frame (c).  The cache starts empty,
    and the config-3 frames are captured after the smaller signatures."""
    import torch

    from stereo_matchin_tpu_torch.models import asw, cross_based
    from stereo_matchin_tpu_torch.utils import graphs

    graphs.clear_caches()
    rng = np.random.default_rng(21)
    small = [(left, right)] + [random_pair(rng, 288, 384) for _ in range(2)]

    def kitti_batch():
        pairs = [random_pair(rng, 375, 1242) for _ in range(4)]
        return tuple(torch.stack([p[k] for p in pairs]) for k in (0, 1))

    c3 = cfg.replace(d_max=279, aggr_d_chunks=4)          # phase 15's
    A = (asw.asw_pipeline, asw.asw_pipeline_impl)
    C = (cross_based.cross_pipeline, cross_based.cross_pipeline_impl)
    # label: (entry, eager chain, cfg, pairs, rounds of timing turns)
    cases = {
        "asw 288x384": (*A, cfg, lambda: small, 10),
        "asw 288x384 plain ops": (*A, cfg.replace(kernels="jnp"),
                                  lambda: small, 0),
        "cross 288x384": (*C, cfg, lambda: small, 10),
        "cross 288x384 taps": (*C, cfg.replace(oii_impl="taps"),
                               lambda: small, 0),
        "asw 375x450 scenes": (*A, cfg, lambda: [scene_pair(
            s, 375, 450, cfg.d_max) for s in (31, 32, 33)], 10),
        "cross 375x450 scenes": (*C, cfg, lambda: [scene_pair(
            s, 375, 450, cfg.d_max) for s in (31, 32, 33)], 10),
        "asw_pipeline_batched B=4 375x1242 d_max 63": (
            asw.asw_pipeline_batched, eager_batched, cfg.replace(d_max=63),
            lambda: [kitti_batch() for _ in range(3)], 3),
        "asw config 3, aggr_d_chunks 4": (*A, c3, lambda: [
            config3_pair(s) for s in (21, 22, 23)], 10),
        "cross config 3": (*C, cfg.replace(d_max=279), lambda: [
            config3_pair(s) for s in (21, 22, 23)], 10),
    }
    report, extra = {}, {}
    for label, (entry, eager, c, make_pairs, rounds) in cases.items():
        pairs = make_pairs()
        rep = captured_against_eager(label, entry, eager, c, pairs, kernels,
                                     graphs)
        gb = {k: v / 1e9 for k, v in rep.items() if k.endswith("_bytes")}
        print(f"  {label}: capture {rep['capture_s']:.3f} s after a "
              f"{rep['warmup_s']:.3f} s warm-up, pool "
              f"{gb['pool_bytes']:.3f} GB, result "
              f"{gb['output_bytes']:.3f} GB; first call "
              f"{rep['first_call_s']:.3f} s, peak "
              f"{gb['first_call_peak_allocated_bytes']:.3f} GB allocated / "
              f"{gb['first_call_peak_reserved_bytes']:.3f} GB reserved, "
              f"holding {gb['first_call_held_bytes']:.3f} GB after it; "
              f"eager frame peak "
              f"{gb['eager_peak_allocated_bytes']:.3f} / "
              f"{gb['eager_peak_reserved_bytes']:.3f} GB, holding "
              f"{gb['eager_held_bytes']:.3f}; {smi}")
        if rounds:
            ms = frame_turns(entry, eager, *pairs[0], c, rounds)
            for mode, v in ms.items():
                rep[f"{mode}_ms_quartiles"] = statistics.quantiles(v, n=4)
                rep[f"{mode}_calls"] = len(v)
            q = {m: rep[f"{m}_ms_quartiles"][1] for m in ms}
            print(f"  {label}: warm median captured {q['captured']:.3f} ms, "
                  f"eager {q['eager']:.3f} ms ({len(ms['eager'])} calls "
                  f"each, in turns; captured / eager "
                  f"{q['captured'] / q['eager']:.3f}); {smi}")
        if label == "asw 288x384":
            print(" (c) busy share of one 288x384 ASW frame, torch.profiler")
            for mode, fn in (("captured", lambda: entry(left, right, c)),
                             ("eager", lambda: eager(left, right, c))):
                host, dev, n = busy_share(fn)
                # The same call unprofiled: its span on the card's
                # timeline by CUDA events, and the kernels' share of it.
                span = cuda_ms(fn, 10)
                extra[f"busy_{mode}"] = {"host_ms": host, "device_ms": dev,
                                         "device_launches": n,
                                         "busy": dev / host,
                                         "event_ms": span,
                                         "busy_of_event_ms": dev / span}
                print(f"  {mode}: {host:.3f} ms host, {dev:.3f} ms device "
                      f"({dev / host * 100:.1f}% busy) in {n} device "
                      f"launches; unprofiled, {span:.3f} ms a call by CUDA "
                      f"events ({dev / span * 100:.1f}% of it in the "
                      f"profiled kernels); {smi}")
        if label.startswith("asw config 3"):
            vol = entry(*pairs[0], c).aggregated_cost
            extra["config3_aggregated_cost_clone_ms"] = cuda_ms(vol.clone, 3)
            extra["config3_aggregated_cost_gb"] = nbytes(vol) / 1e9
            print(f"  clone of the {nbytes(vol) / 1e9:.2f} GB aggregated_cost: "
                  f"{extra['config3_aggregated_cost_clone_ms']:.3f} ms")
            del vol
        report[label] = rep
        del pairs
    print(" (d) first calls under memory pressure: config-3-size frames of "
          "four sizes in turn, results held")
    extra["large_sizes"] = large_sizes(cfg, kernels, graphs, smi)
    print(" (e) mixed sizes: KITTI 2015's four image sizes, both methods, "
          "from an empty cache")
    extra["mixed_sizes"] = mixed_sizes(cfg, graphs, smi)
    q = {m: report["asw 288x384"][f"{m}_ms_quartiles"][1]
         for m in ("captured", "eager")}
    print(f"  288x384 ASW: the captured median is "
          f"{'under' if q['captured'] < q['eager'] / 2 else 'NOT under'} "
          f"half the eager one ({q['captured']:.3f} against {q['eager']:.3f} "
          f"ms)")
    graphs.clear_caches()
    return {"captured_frames": report, **extra}


# (H, W) near config 3's, each its own signature, as the full-size scenes
# of Middlebury 2014 each have their own size.
LARGE_HW = [(1988, 2880), (2000, 2964), (1920, 2820), (1940, 2960)]
# KITTI 2015's image sizes (H, W).
KITTI_HW = [(375, 1242), (370, 1224), (374, 1238), (376, 1241)]


def large_sizes(cfg, kernels, graphs, smi):
    """(d) `run --method asw` over the sizes LARGE_HW and the first one
    again, then `--method both` over LARGE_HW, at d_max 279 (ASW with
    aggr_d_chunks 4): every call a first call, the previous pair's results
    held through it, each new signature's warm-up and capture beside up to
    MAX_GRAPHS graphs of about 20 GB.  No call may run out of memory; the
    last pair's maps are held against the eager chains'."""
    import torch

    from stereo_matchin_tpu_torch.models import asw, cross_based

    c3 = cfg.replace(d_max=279, aggr_d_chunks=4)
    runs = {"asw": [("asw", asw.asw_pipeline, asw.asw_pipeline_impl, c3)],
            "both": [("asw", asw.asw_pipeline, asw.asw_pipeline_impl, c3),
                     ("cross", cross_based.cross_pipeline,
                      cross_based.cross_pipeline_impl,
                      cfg.replace(d_max=279))]}
    report = {}
    for method, entries in runs.items():
        graphs.clear_caches()
        sizes = LARGE_HW + LARGE_HW[:1] if method == "asw" else LARGE_HW
        held, rows = [], []
        for k, hw in enumerate(sizes):
            pair = config3_pair(40 + k, hw)
            out = []
            for name, entry, _, c in entries:
                res, ms = timed(lambda: entry(*pair, c))
                out.append(res)
                free, total = torch.cuda.mem_get_info()
                rows.append({"hw": hw, "method": name, "s": ms / 1e3,
                             "graphs": len(graphs.CACHE.frames),
                             "footprints_gb": sum(
                                 f.footprint for f in
                                 graphs.CACHE.frames.values()) / 1e9,
                             "free_gb": free / 1e9})
                print(f"  --method {method}, {hw[0]}x{hw[1]} {name}: "
                      f"{ms / 1e3:.3f} s, {rows[-1]['graphs']} graphs "
                      f"held ({rows[-1]['footprints_gb']:.3f} GB of pools "
                      f"and clones), {free / 1e9:.3f} of {total / 1e9:.3f} "
                      f"GB free after it; {smi}")
            held = out                   # the previous pair's results go
        graphs.clear_caches()
        for (name, _, eager, c), got in zip(entries, held):
            want = eager(*pair, c)
            for f in want._fields:
                if not torch.equal(getattr(got, f), getattr(want, f)):
                    raise AssertionError(f"large sizes, --method {method}: "
                                         f"{name} {f} differs from the eager "
                                         f"chain's")
            del want
        del held, out, pair
        report[method] = rows
        print(f"  --method {method}: no call ran out of memory; the last "
              f"pair's maps equal the eager chains'")
    return report


def mixed_sizes(cfg, graphs, smi):
    """(e) Eight pairs of KITTI_HW's sizes at d_max 63, each through ASW and
    then cross as `run --method both` calls them, in two orders: sizes in
    turn (eight signatures through a cache of MAX_GRAPHS) and in blocks
    (a size's two pairs in a row).  Each run starts from an empty cache,
    as a new `run` process does (kernels loaded); captured beside eager in
    the turns eager, captured, captured with a cache of 8, captured, eager;
    every map bit-equal between them.  Reports seconds a run, first calls
    (misses) a run, and the first pair's seconds: a `run` of a single
    pair."""
    import torch

    from stereo_matchin_tpu_torch.models import asw, cross_based

    c = cfg.replace(d_max=63)
    rng = np.random.default_rng(63)
    pairs = {hw: [random_pair(rng, *hw) for _ in range(2)] for hw in KITTI_HW}
    orders = {"in turn": [(hw, i) for i in range(2) for hw in KITTI_HW],
              "in blocks": [(hw, i) for hw in KITTI_HW for i in range(2)]}
    captured = (asw.asw_pipeline, cross_based.cross_pipeline)
    entries = {"captured": captured, "captured, 8 graphs": captured,
               "eager": (asw.asw_pipeline_impl,
                         cross_based.cross_pipeline_impl)}
    cap = graphs.MAX_GRAPHS
    misses = []
    cache_first_call = graphs.CACHE.first_call

    def counted_first_call(*args):
        misses.append(args[0])
        return cache_first_call(*args)

    report = {}
    graphs.CACHE.first_call = counted_first_call
    try:
        for order, seq in orders.items():
            rep = {m: {"s": [], "first_pair_s": [], "first_calls": []}
                   for m in entries}
            want = None
            for mode in ("eager", "captured", "captured, 8 graphs",
                         "captured", "eager"):
                graphs.clear_caches()
                graphs.MAX_GRAPHS = 8 if mode.endswith("8 graphs") else cap
                misses.clear()
                a_fn, c_fn = entries[mode]
                maps, secs = [], []
                for hw, i in seq:
                    left, right = pairs[hw][i]
                    got, ms = timed(lambda: (
                        a_fn(left, right, c).disparity,
                        c_fn(left, right, c).final))
                    maps.append(got)
                    secs.append(ms / 1e3)
                want = want or maps
                if not all(torch.equal(g, w) for gm, wm in zip(maps, want)
                           for g, w in zip(gm, wm)):
                    raise AssertionError(f"mixed sizes {order}: the {mode} "
                                         f"maps differ from the eager ones")
                rep[mode]["s"].append(sum(secs))
                rep[mode]["first_pair_s"].append(secs[0])
                rep[mode]["first_calls"].append(len(misses))
            report[order] = rep
            print(f"  {order}: {len(seq)} pairs, both methods: captured "
                  f"{', '.join(f'{x:.3f}' for x in rep['captured']['s'])} s "
                  f"with {rep['captured']['first_calls']} first calls of "
                  f"{2 * len(seq)} (a cache of 8: "
                  f"{rep['captured, 8 graphs']['s'][0]:.3f} s, "
                  f"{rep['captured, 8 graphs']['first_calls'][0]}), eager "
                  f"{', '.join(f'{x:.3f}' for x in rep['eager']['s'])} s; "
                  f"the first pair (a `run` of one pair) captured "
                  f"{', '.join(f'{x:.3f}' for x in rep['captured']['first_pair_s'])}"
                  f" s, eager "
                  f"{', '.join(f'{x:.3f}' for x in rep['eager']['first_pair_s'])}"
                  f" s; maps bit-equal; {smi}")
    finally:
        del graphs.CACHE.first_call
        graphs.MAX_GRAPHS = cap
    graphs.clear_caches()
    return report


# Phase 22: the harness's stages replayed from CUDA graphs (utils/graphs.py
# StageGraphs, the port's counterpart of the JAX package's stage jits)
# against the eager stages, and the debug entry captured.

# Timing turns (eager, captured, captured, eager) per size and method.
STAGE_ROUNDS = 5


def staged_frame(method, cfg, run):
    """A frame of `method` with every stage through `run`, as the harness
    runs it."""
    from stereo_matchin_tpu_torch.models import asw, cross_based

    if method == "asw":
        return lambda left, right: asw.asw_pipeline_from_weights(
            left, right, asw.asw_weights(left, right, cfg, run=run), cfg,
            run=run)
    return lambda left, right: cross_based.cross_pipeline_staged(
        left, right, cfg, run=run)


class StageTwin:
    """A stage runner that replays each stage from its graph, runs it
    eagerly as well, and holds the two bit-equal, container types
    included."""

    def __init__(self, label):
        self.label, self.calls = label, 0

    def run(self, name, fn, *args):
        import torch

        from stereo_matchin_tpu_torch.utils import graphs

        got = graphs.replay_stage(name, fn, *args)
        want = fn(*args)
        g, w = graphs.leaves(got), graphs.leaves(want)
        if type(got) is not type(want) or len(g) != len(w):
            raise AssertionError(f"{self.label} {name}: replayed "
                                 f"{type(got).__name__} of {len(g)} tensors, "
                                 f"eager {type(want).__name__} of {len(w)}")
        for i, (a, b) in enumerate(zip(g, w)):
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(
                    a, b):
                raise AssertionError(f"{self.label} {name}: output {i} of "
                                     f"the replay differs from the eager "
                                     f"stage's")
        self.calls += 1
        return got


def eager_timer(harness):
    """harness.StageTimer with the stage run eagerly between its CUDA
    events (the host's dispatch included), as the harness timed stages
    before they were replayed from graphs."""
    import torch

    class EagerStageTimer(harness.StageTimer):
        def run(self, name, fn, *args):
            stream = torch.cuda.current_stream()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            out = fn(*args)
            end.record(stream)
            self._pending.append((name, start, end))
            return out

    return EagerStageTimer


def timed_method(harness, method, left, right, cfg, kernels, want,
                 eager=False):
    """(TSV columns, wall ms) of one harness run of `method`, captured
    (the harness as it is) or eager (eager_timer); it must launch exactly
    one frame's kernels."""
    fn = getattr(harness, f"time_{method}_method")
    timer = harness.StageTimer
    if eager:
        harness.StageTimer = eager_timer(harness)
    try:
        kernels.reset_launches()
        times, ms = timed(lambda: fn(left, right, cfg))
    finally:
        harness.StageTimer = timer
    if dict(kernels.LAUNCHES) != want:
        mode = "eager" if eager else "captured"
        raise AssertionError(f"{method} harness run ({mode}): launches "
                             f"{dict(kernels.LAUNCHES)} != one frame's {want}")
    return times, ms


def stage_device_ms(method, left, right, cfg):
    """(ms per stage name, ms outside every stage) of the device time of one
    warm eager frame under torch.profiler, attributed to stages as
    scripts/profile_frame.py --stages does (utils.profiling
    stage_device_ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from stereo_matchin_tpu_torch.utils import profiling

    stages = set()

    def run(name, fn, *args):
        stages.add(name)
        with record_function(name):
            return fn(*args)

    frame = staged_frame(method, cfg, run)
    frame(left, right)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        frame(left, right)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    by_stage = profiling.stage_device_ms(events, stages)
    outside = by_stage.pop(None, (0.0, 0))[0]
    if not by_stage:
        raise AssertionError(f"{method}: the profile attributed no device "
                             f"time to a stage")
    return {name: ms for name, (ms, _) in by_stage.items()}, outside


def eager_peak(fn):
    """Bytes allocated above the state before one call of fn, at its
    peak."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated() - base


def stages_of_one_size(label, pairs, cfg, kernels, smi):
    """(a)-(d) at one size, both methods: the first harness run captures
    (stage seconds, pool and slot bytes beside the eager frame's peak);
    every stage on two more pairs replayed bit-equal to its eager call;
    TSV medians captured against eager in turns, each run one frame's
    launches; the profiled device ms per stage and the ratio of each
    method's total to it."""
    from stereo_matchin_tpu_torch.bench import harness
    from stereo_matchin_tpu_torch.models import asw, cross_based
    from stereo_matchin_tpu_torch.utils import graphs

    impls = {"asw": asw.asw_pipeline_impl,
             "cross": cross_based.cross_pipeline_impl}
    wants = {"asw": expected_asw_launches(cfg, 1, "whole", kernels),
             "cross": expected_cross_launches(1, kernels)}
    totals = {"asw": ("total WTA method", "ref_w"),
              "cross": ("cross method total",)}
    report = {}
    left, right = pairs[0]
    for method, impl in impls.items():
        graphs.STAGES.clear()
        peak = eager_peak(lambda: impl(left, right, cfg))
        _, first_ms = timed_method(harness, method, left, right, cfg,
                                   kernels, wants[method])
        st = graphs.STAGES.stats()
        rep = {"first_run_ms": first_ms, "eager_peak_bytes": peak, **st}
        print(f"  {label} {method}: first run {first_ms:.1f} ms captured "
              f"{st['graphs']} stage graphs ({st['warmup_s']:.3f} s of "
              f"warm-ups, {st['capture_s']:.3f} s of captures); pool "
              f"{st['pool_bytes'] / 1e9:.3f} GB and static inputs "
              f"{st['input_bytes'] / 1e9:.3f} GB against the eager frame's "
              f"peak {peak / 1e9:.3f} GB; {smi}")
        for k, (l2, r2) in enumerate(pairs[1:], 1):
            twin = StageTwin(f"{label} {method} pair {k}")
            got = staged_frame(method, cfg, twin.run)(l2, r2)
            want = impl(l2, r2, cfg)
            for f in want._fields:
                if not torch_equal(getattr(got, f), getattr(want, f)):
                    raise AssertionError(f"{label} {method} pair {k}: {f} "
                                         f"differs from the eager chain's")
            if graphs.STAGES.stats()["graphs"] != st["graphs"]:
                raise AssertionError(f"{label} {method}: a stage was "
                                     f"captured again on pair {k}")
        print(f"  {label} {method}: on {len(pairs) - 1} more pairs each of "
              f"the {twin.calls} stages of a frame replayed bit-equal to its "
              f"eager call; frames equal to the eager chain's")
        runs = {"eager": [], "captured": []}
        for _ in range(STAGE_ROUNDS):
            for mode in ("eager", "captured", "captured", "eager"):
                runs[mode].append(timed_method(
                    harness, method, left, right, cfg, kernels, wants[method],
                    eager=mode == "eager"))
        device, outside = stage_device_ms(method, left, right, cfg)
        columns = (harness.asw_columns(device, cfg) if method == "asw"
                   else harness.cross_columns(device))
        med = {mode: {c: statistics.median(t[c] for t, _ in r)
                      for c in r[0][0]} for mode, r in runs.items()}
        med["device"] = columns
        wall = {mode: statistics.median(ms for _, ms in r)
                for mode, r in runs.items()}
        total = {mode: sum(m[c] for c in totals[method])
                 for mode, m in med.items()}
        rep |= {"tsv_medians_ms": med, "run_wall_median_ms": wall,
                "device_outside_stages_ms": outside, "totals_ms": total,
                "captured_over_device": total["captured"] / total["device"],
                "eager_over_device": total["eager"] / total["device"],
                "runs": len(runs["captured"])}
        cols = harness.ASW_COLUMNS + ["ref_w"] if method == "asw" else \
            harness.CROSS_COLUMNS
        print(f"  {label} {method}, TSV medians of {len(runs['captured'])} "
              f"runs each in turns, ms (captured / eager / device):")
        for c in cols:
            print(f"    {c:>20}: {med['captured'][c]:9.4f} / "
                  f"{med['eager'][c]:9.4f} / {columns[c]:9.4f}")
        print(f"  {label} {method}: {' + '.join(totals[method])} captured "
              f"{total['captured']:.4f} ms, eager {total['eager']:.4f}, "
              f"device {total['device']:.4f} (+{outside:.4f} outside every "
              f"stage): captured / device "
              f"{rep['captured_over_device']:.3f}, eager / device "
              f"{rep['eager_over_device']:.3f}; a run's wall median "
              f"captured {wall['captured']:.3f} ms, eager "
              f"{wall['eager']:.3f}; {smi}")
        report[method] = rep
    return report


def torch_equal(a, b):
    import torch

    return a.shape == b.shape and torch.equal(a, b)


def debug_captured(label, pairs, cfg, kernels):
    """asw_pipeline_debug captured on pairs[0], replayed on the others:
    every field, the nested result included, bit-equal to
    asw_pipeline_debug_impl's on the same pair, each call one debug
    frame's launches."""
    from stereo_matchin_tpu_torch.models import asw
    from stereo_matchin_tpu_torch.utils import graphs

    r, k = cfg.r_iters, cfg.k_iters
    want_launches = expected_asw_launches(cfg, 1, "whole", kernels)
    want_launches.update(two_min=1 + r + 1 + k, wta_diag=1 + r + 1 + k)
    for n, (left, right) in enumerate(pairs):
        kernels.reset_launches()
        got, ms = timed(lambda: asw.asw_pipeline_debug(left, right, cfg))
        check_launches(f"{label} debug pair {n} (captured)",
                       dict(kernels.LAUNCHES), want_launches)
        kernels.reset_launches()
        want, eager_ms = timed(lambda: asw.asw_pipeline_debug_impl(
            left, right, cfg))
        check_launches(f"{label} debug pair {n} (eager)",
                       dict(kernels.LAUNCHES), want_launches)
        if type(got) is not asw.ASWDebug or type(got.result) is not \
                asw.ASWResult:
            raise AssertionError(f"{label} debug: {type(got).__name__}")
        for f in want._fields:
            g, w = getattr(got, f), getattr(want, f)
            for i, (a, b) in enumerate(zip(graphs.leaves(g),
                                           graphs.leaves(w))):
                if not torch_equal(a, b):
                    raise AssertionError(f"{label} debug pair {n}: {f}"
                                         f"{f'[{i}]' if f == 'result' else ''}"
                                         f" differs from the eager chain's")
        print(f"  {label} debug pair {n}: every field (result's "
              f"{len(want.result)} too) bit-equal to asw_pipeline_debug_impl;"
              f" {ms:.1f} ms {'(the capture) ' if n == 0 else ''}against "
              f"{eager_ms:.1f} eager")


def config3_stages(cfg, kernels, smi):
    """(e) Config 3 through time_asw_method and time_cross_method: the first
    run captures, then one replayed run and one eager run, each one
    frame's launches, with no out-of-memory error."""
    import torch

    from stereo_matchin_tpu_torch.bench import harness
    from stereo_matchin_tpu_torch.utils import graphs

    graphs.clear_caches()
    left, right = config3_pair(22)
    cases = {"asw": cfg.replace(d_max=279, aggr_d_chunks=4),
             "cross": cfg.replace(d_max=279)}
    report = {}
    for method, c in cases.items():
        graphs.STAGES.clear()
        want = (expected_asw_launches(c, 1, "whole", kernels)
                if method == "asw" else expected_cross_launches(1, kernels))
        torch.cuda.reset_peak_memory_stats()
        rep = {}
        for mode in ("first", "captured", "eager"):
            times, ms = timed_method(harness, method, left, right, c,
                                     kernels, want, eager=mode == "eager")
            total = (times["total WTA method"] + times["ref_w"]
                     if method == "asw" else times["cross method total"])
            rep[mode] = {"wall_ms": ms, "total_ms": total}
        st = graphs.STAGES.stats()
        free, card = torch.cuda.mem_get_info()
        rep |= st | {"peak_reserved_bytes": torch.cuda.max_memory_reserved(),
                     "free_bytes": free}
        print(f"  config 3 {method}: {st['graphs']} stage graphs, pool "
              f"{st['pool_bytes'] / 1e9:.3f} GB, static inputs "
              f"{st['input_bytes'] / 1e9:.3f} GB, captures "
              f"{st['capture_s']:.3f} s after {st['warmup_s']:.3f} s of "
              f"warm-ups; runs (wall / stage total ms): first "
              f"{rep['first']['wall_ms']:.1f} / {rep['first']['total_ms']:.1f}"
              f", captured {rep['captured']['wall_ms']:.1f} / "
              f"{rep['captured']['total_ms']:.1f}, eager "
              f"{rep['eager']['wall_ms']:.1f} / {rep['eager']['total_ms']:.1f}"
              f"; peak reserved {rep['peak_reserved_bytes'] / 1e9:.3f} GB, "
              f"{free / 1e9:.3f} of {card / 1e9:.3f} GB free after; no "
              f"out-of-memory error; {smi}")
        report[method] = rep
    graphs.clear_caches()
    return report


def stage_phase(cfg, kernels, left, right, smi):
    """Phase 22: at 288x384 and 375x450 both methods' stages through the
    harness, replayed against eager (stages_of_one_size), the debug entry
    captured against its eager chain, then config 3 (config3_stages)."""
    from stereo_matchin_tpu_torch.utils import graphs

    graphs.clear_caches()
    rng = np.random.default_rng(22)
    sizes = {"288x384": [(left, right)] + [random_pair(rng, 288, 384)
                                           for _ in range(2)],
             "375x450": [scene_pair(s, 375, 450, cfg.d_max)
                         for s in (41, 42, 43)]}
    report = {}
    for label, pairs in sizes.items():
        print(f" ({'a' if label == '288x384' else 'b'}) {label}: stages, "
              f"then the debug entry")
        report[label] = stages_of_one_size(label, pairs, cfg, kernels, smi)
        debug_captured(label, pairs[:2], cfg, kernels)
        graphs.clear_caches()
    r = report["288x384"]
    for method, limit in (("asw", 1.25), ("cross", 2.0)):
        ratio = r[method]["captured_over_device"]
        print(f"  288x384 {method}: the captured stage total is "
              f"{ratio:.3f}x its device time, "
              f"{'within' if ratio <= limit else 'NOT within'} {limit}x")
    print(" (c) config 3 through the harness")
    report["config3"] = config3_stages(cfg, kernels, smi)
    return report


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
    res_p = asw.asw_pipeline_impl(left, right, cfg.replace(kernels="jnp"))
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
    # The eager chain through the kernels and through the plain ops; phase
    # 21 (b) times the captured frame.
    frame_ms = {"kernels": [], "plain": []}
    for mode in ("plain", "kernels", "kernels", "plain") * 2:
        c = cfg.replace(kernels="jnp") if mode == "plain" else cfg
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        asw.asw_pipeline_impl(left, right, c)
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
    cross_p = cross_based.cross_pipeline_impl(left, right, taps)
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
        c = taps if mode == "plain" else cfg
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cross_based.cross_pipeline_impl(left, right, c)
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
    c3_whole = {"asw": config3_asw(c3, kernels, smi)}

    phase(f"16. config 3 cross-based: kernels against their plain versions "
          f"on one band's rows; whole frame, wavefront and halo bands "
          f"({CONFIG3_BANDS})")
    c3_whole["cross"] = config3_cross(cfg.replace(d_max=279), kernels, stats,
                                      smi)

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

    phase("19. sharded pipelines (parallel/): 4 gloo ranks on this card at "
          "REFERENCE_CONFIG on meshes (1,2,2), (1,4,1), (1,1,4), (2,2,1) and "
          "at config 3 on (1,2,2), both methods bit-equal to the unsharded "
          "frames; one NCCL rank")
    sharded = sharded_phase(
        cfg, kernels, left, right,
        {"asw": {f: getattr(res_k, f) for f in SHARDED_MAPS["asw"]},
         "cross": {f: getattr(cross_k, f) for f in SHARDED_MAPS["cross"]}},
        c3_whole, smi)
    del c3_whole

    phase("20. run CLI (--method both, --method cross) decoding ahead over "
          "8 synthetic 375x450 scenes, against the inline loop; "
          "asw_aggregate_2d on the card against the CPU, and timed at "
          "REFERENCE_CONFIG")
    print(" (a) run, decode ahead")
    run_report = run_phase(cfg, kernels, smi)
    print(" (b) asw_aggregate_2d")
    asw2d_report = asw2d_phase(left, right, cfg, smi)
    print(json.dumps({"run_decode_ahead": run_report,
                      "asw_aggregate_2d": asw2d_report, "card": smi}))

    phase("21. captured frames against eager frames: asw_pipeline, "
          "cross_pipeline and asw_pipeline_batched replayed from CUDA graphs "
          "against asw_pipeline_impl / cross_pipeline_impl, 288x384 up to "
          "config 3")
    print(" (a) bit-equal on every field, launches, held results; (b) warm "
          "medians in turns")
    print(json.dumps(graph_phase(cfg, kernels, left, right, smi)
                     | {"card": smi}))

    phase("22. the harness's stages replayed from CUDA graphs against the "
          "eager stages at 288x384 and 375x450, against the profiler's "
          "device time; asw_pipeline_debug captured; config 3 through the "
          "harness")
    print(json.dumps({"stage_graphs": stage_phase(cfg, kernels, left, right,
                                                  smi), "card": smi}))

    path_launches = {
        "asw": launches, "cross": cross_launches,
        "bands": band_launches["wavefront"]}
    report = {"kernels": []}
    for name, source, replaces, key, path in KERNELS:
        bound_ms, bound_by = bound(stats[name])
        report["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": path_launches[path][key],
            # Per rank and frame on the sharded path at config 3, (1, 2, 2).
            "sharded_launches": sharded[
                "asw" if key in kernels.ASW_KERNELS else "cross"][key],
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
