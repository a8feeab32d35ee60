#!/usr/bin/env python3
"""GPU smoke test of the PyTorch + CUDA port (`stereo_matchin_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100 (Hopper,
sm_90a), nvcc and PyTorch built for CUDA:

    python3 chip_smoke.py

It builds the CUDA kernels K1-K8 from `stereo_matchin_tpu_torch/csrc`,
holds each against its plain PyTorch version on the card, drives the ASW
and the cross-based pipelines at REFERENCE_CONFIG on the committed
fixture pair through the kernels and through the plain ops, checks the
launch counts of each path and its output against the JAX package's
stored results, times both routes of both paths, and runs the `run` CLI
on PNG files.  Any failed check raises; the last line of a passing run is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": N}}

It never imports jax.  Without CUDA it exits non-zero before printing a
result.
"""

from __future__ import annotations

import importlib.util
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
# One entry per CUDA kernel: (name, CUDA source, replaced pallas_call
# site(s), launch counter).  K1-K4 run on the ASW path, K5-K8 on the cross
# path.
KERNELS = [
    ("asw_den", f"{CSRC}/asw_aggregation.cu",
     f"{TPU_KERNELS}/asw_aggregation_dres.py:319", "asw_den"),
    ("asw_pass_v", f"{CSRC}/asw_aggregation.cu",
     f"{TPU_KERNELS}/asw_aggregation_dres.py:445", "asw_pass_v"),
    ("asw_pass_h", f"{CSRC}/asw_aggregation.cu",
     f"{TPU_KERNELS}/asw_aggregation_dres.py:384", "asw_pass_h"),
    ("two_min", f"{CSRC}/wta_gather.cu",
     f"{TPU_KERNELS}/wta_gather.py:314", "two_min"),
    ("wta_diag", f"{CSRC}/wta_gather.cu",
     f"{TPU_KERNELS}/wta_gather.py:426", "wta_diag"),
    ("cross_arms", f"{CSRC}/cross_oii.cu",
     f"{TPU_KERNELS}/cross_oii.py:629", "cross_arms"),
    ("sad_volume", f"{CSRC}/sad_volume.cu",
     f"{TPU_KERNELS}/sad_volume.py:120", "sad_volume"),
    ("oii_pass_h", f"{CSRC}/cross_oii.cu",
     f"{TPU_KERNELS}/cross_oii.py:235; {TPU_KERNELS}/cross_oii.py:420",
     "oii_pass_h"),
    ("oii_pass_v", f"{CSRC}/cross_oii.cu",
     f"{TPU_KERNELS}/cross_oii.py:300", "oii_pass_v"),
    ("vote_h", f"{CSRC}/cross_oii.cu",
     f"{TPU_KERNELS}/cross_oii.py:814", "vote_h"),
    ("vote_v", f"{CSRC}/cross_oii.cu",
     f"{TPU_KERNELS}/cross_oii.py:853", "vote_v"),
]


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


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls, by CUDA events, warm."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
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


def random_pair(rng, H, W):
    import torch

    codes = rng.integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    imgs = (codes / np.float32(255.0)).astype(np.float32)
    return torch.from_numpy(imgs[0]).cuda(), torch.from_numpy(imgs[1]).cuda()


def scene_pair(seed, H, W, d_max):
    """A synthetic scene (textured planes: arms of every length), on the
    card."""
    import torch

    from stereo_matchin_tpu.eval import synthetic_scene

    left, right, _, _ = synthetic_scene(np.random.default_rng(seed), H, W,
                                        d_max)
    return tuple(torch.from_numpy(a.astype(np.float32)).cuda()
                 for a in (left, right))


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
    torch.cuda.synchronize()


def time_kernels(left, right, cfg, stats):
    """Kernel and plain-version device times at the main path's shapes."""
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
    cases = {
        "asw_den": (lambda: ka.asw_den(wl, wr, eps, 0, D),
                    lambda: ops.asw_den_plain(wl, wr, eps, 0, D)),
        "asw_pass_v": (lambda: ka.asw_pass(cost, wl, wr, den_v, eps, 1),
                       lambda: ops.asw_pass_plain(cost, wl, wr, den_v, eps, 1)),
        "asw_pass_h": (lambda: ka.asw_pass(cost, hl, hr, den_h, eps, 2),
                       lambda: ops.asw_pass_plain(cost, hl, hr, den_h, eps, 2)),
        "two_min": (lambda: kw.two_min(cost, sc, ct, cfg.big),
                    lambda: _two_min_plain(cost, sc, ct, cfg.big)),
        "wta_diag": (lambda: kw.wta_diag(cost, d1, sc, ct, cfg.big),
                     lambda: _diag_two_min_plain(cost, d1, sc, ct, cfg.big)),
    }
    for name, (kern, plain) in cases.items():
        # plain, kernel, kernel, plain: the first plain warms the allocator.
        p1 = cuda_ms(plain, 5)
        k1 = cuda_ms(kern, 20)
        k2 = cuda_ms(kern, 20)
        p2 = cuda_ms(plain, 5)
        stats[name]["ms"] = min(k1, k2)
        stats[name]["plain_ms"] = min(p1, p2)
        print(f"  {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
              f"{p2:.4f} ms  (D={D}, {left.shape[0]}x{left.shape[1]}, "
              f"T={2 * R + 1})")


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


def time_cross_kernels(left, right, cfg, stats):
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
    for name, (kern, plain) in cases.items():
        p1 = cuda_ms(plain, 5)
        k1 = cuda_ms(kern, 20)
        k2 = cuda_ms(kern, 20)
        p2 = cuda_ms(plain, 5)
        stats[name]["ms"] = min(k1, k2)
        stats[name]["plain_ms"] = min(p1, p2)
        print(f"  {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
              f"{p2:.4f} ms  (D={D}, {left.shape[0]}x{left.shape[1]}, L={L})")


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
          f"{time.perf_counter() - t0:.1f} s")

    cfg = REFERENCE_CONFIG
    fx = np.load(FIXTURE)
    left, right = (torch.from_numpy((fx[k] / np.float32(255.0)).astype(
        np.float32)).cuda() for k in ("left", "right"))
    pairs = {"288x384 fixture": (left, right),
             "375x450 random": random_pair(np.random.default_rng(3), 375, 450)}

    phase("3. kernels against their plain versions on the card")
    stats = {k[3]: {} for k in KERNELS}
    check_kernels(pairs, cfg, stats)
    time_kernels(left, right, cfg, stats)

    phase("4. ASW slice at REFERENCE_CONFIG: kernels against plain ops")
    kernels.reset_launches()
    res_k = asw.asw_pipeline(left, right, cfg)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    res_p = asw.asw_pipeline(left, right, cfg.replace(kernels="jnp"))
    torch.cuda.synchronize()
    print(f"  launches in one frame: {launches} (asw_pass v+h: "
          f"{launches['asw_pass_v'] + launches['asw_pass_h']})")
    want = {"asw_den": 2, "asw_pass_v": cfg.r_iters,
            "asw_pass_h": cfg.r_iters, "two_min": cfg.k_iters + 1,
            "wta_diag": cfg.k_iters + 1}
    want.update(dict.fromkeys(kernels.CROSS_KERNELS, 0))
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
    time_cross_kernels(left, right, cfg, stats)

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
    from stereo_matchin_tpu.io import png
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

    main_path = {**{k: launches[k] for k in kernels.ASW_KERNELS},
                 **{k: cross_launches[k] for k in kernels.CROSS_KERNELS}}
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": main_path[key],
         "max_abs_err": stats[key]["max_abs_err"],
         "ms": stats[key]["ms"], "plain_ms": stats[key]["plain_ms"]}
        for name, source, replaces, key in KERNELS]}
    print()
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
