#!/usr/bin/env python3
"""The frame and stage graphs' cache (utils/graphs.py) of several checkouts,
in turns on one card.

    python3 scripts/cache_turns.py [--checkout NAME=DIR]... [--out FILE]
        [--timeout SECONDS]

"change" is this checkout; NAME=DIR adds an unpacked `git archive` of
another commit (the parent, say).  Each checkout runs in a process of its
own, from DIR, with DIR's package and DIR's chip_smoke.py, in the turns:
the checkouts in order, then in reverse (parent, change, change, parent).
A run builds the kernels and measures, on the card:

  * `frames`: the captured frames' first call (seconds, peak reserved
    above the card's state before it, bytes held after it, chip_smoke.py
    memory_of) from an empty cache, and their warm medians beside the eager
    chains' (chip_smoke.py frame_turns, 5 rounds of eager, captured,
    captured, eager): ASW and cross at 288 x 384 REFERENCE_CONFIG, and at
    config 3 (1988 x 2880, d_max 279, ASW aggr_d_chunks 4);
  * `large_sizes`: `run --method asw` over chip_smoke.py LARGE_HW and the
    first size again at config 3, the previous result held through each
    call: each call's seconds and whether it was a first call, and the
    cache's bytes after the five calls (the card's reserved bytes, results
    dropped and cached blocks released, above those before the first);
  * `mixed_sizes`: chip_smoke.py mixed_sizes (phase 21 (e): KITTI 2015's
    four sizes, 8 pairs, both methods, sizes in turn and in blocks);
  * `bands`: chip_smoke.py band_case (phase 23 (b)) on config 3 in 5
    bands, both methods and drivers, and the ASW wavefront in 4 bands (the
    plan of models.tiled.auto_bands for a 24 GB card), 2 rounds of turns:
    the first call's and a replay's peak reserved, the pool, and the warm
    medians.

Every map is held against the eager chain's or the whole frame's, as the
smoke holds them.  Prints each run's JSON line and writes them all to
--out (default bench_out/cache_turns.json) with the card's nvidia-smi name
and power limit; each run's own output goes beside it (FILE.<k>_<NAME>.log).
Needs an NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
ROUNDS = 5


def frame_cases(smoke, cfg):
    from stereo_matchin_tpu_torch.models import asw, cross_based

    c3 = cfg.replace(d_max=279)
    A = (asw.asw_pipeline, asw.asw_pipeline_impl)
    C = (cross_based.cross_pipeline, cross_based.cross_pipeline_impl)
    small = smoke.random_pair(np.random.default_rng(21), 288, 384)
    big = smoke.config3_pair(21)
    return {"asw 288x384": (*A, cfg, small),
            "cross 288x384": (*C, cfg, small),
            "asw config 3": (*A, c3.replace(aggr_d_chunks=4), big),
            "cross config 3": (*C, c3, big)}


def frames(smoke, cfg, kernels, graphs):
    import torch

    report = {}
    for label, (entry, eager, c, pair) in frame_cases(smoke, cfg).items():
        graphs.clear_caches()
        got, ms, mem, _ = smoke.memory_of(lambda: entry(*pair, c), kernels)
        want = eager(*pair, c)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{label}: captured differs from eager")
        del got, want
        turns = smoke.frame_turns(entry, eager, *pair, c, ROUNDS)
        report[label] = {"first_call_s": ms / 1e3, **{
            f"first_call_{k}_bytes": v for k, v in mem.items()}, **{
            f"{m}_ms": v for m, v in turns.items()}}
        print(f"  {label}: first call {ms / 1e3:.3f} s, peak reserved "
              f"{mem['peak_reserved'] / 1e9:.3f} GB; warm median captured "
              f"{statistics.median(turns['captured']):.3f} ms, eager "
              f"{statistics.median(turns['eager']):.3f} ms")
    graphs.clear_caches()
    return report


def large_sizes(smoke, cfg, graphs):
    import torch

    from stereo_matchin_tpu_torch.models import asw

    c3 = cfg.replace(d_max=279, aggr_d_chunks=4)
    graphs.clear_caches()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    seen, first_call = [], graphs.CACHE.first_call

    def counted(*args):
        seen.append(args[0])
        return first_call(*args)

    graphs.CACHE.first_call = counted
    rows, held = [], None
    try:
        for k, hw in enumerate(smoke.LARGE_HW + smoke.LARGE_HW[:1]):
            pair = smoke.config3_pair(40 + k, hw)
            before = len(seen)
            res, ms = smoke.timed(lambda: asw.asw_pipeline(*pair, c3))
            rows.append({"hw": hw, "s": ms / 1e3,
                         "first_call": len(seen) > before})
            print(f"  {hw[0]}x{hw[1]}: {ms / 1e3:.3f} s, "
                  f"{'a first call' if rows[-1]['first_call'] else 'a replay'}")
            held = res
        want = asw.asw_pipeline_impl(*pair, c3)
        if not all(torch.equal(g, w) for g, w in zip(held, want)):
            raise AssertionError("large sizes: the last map differs")
        del held, want, res, pair
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        cache = torch.cuda.memory_reserved() - base
    finally:
        del graphs.CACHE.first_call
    graphs.clear_caches()
    print(f"  the cache holds {cache / 1e9:.3f} GB after the five calls")
    return {"calls": rows, "cache_bytes": cache}


def bands(smoke, cfg, kernels):
    from stereo_matchin_tpu_torch.models import asw, cross_based

    H, W = smoke.CONFIG3_HW
    c3 = {"asw": cfg.replace(d_max=279, aggr_d_chunks=4),
          "cross": cfg.replace(d_max=279)}
    pairs = {"asw": smoke.config3_pair(3),
             "cross": smoke.scene_pair(4, H, W, 279)}
    report = {}
    for method in ("asw", "cross"):
        if method == "asw":
            res = asw.asw_pipeline_impl(*pairs[method], c3[method])
            whole = (res.disparity, res.filled)
        else:
            res = cross_based.cross_pipeline_impl(*pairs[method],
                                                  c3[method])
            whole = (res.initial, res.final)
        del res
        cases = [(smoke.CONFIG3_BANDS, True), (smoke.CONFIG3_BANDS, False)]
        if method == "asw":
            cases.append((4, True))
        for bands_, wf in cases:
            label = (f"config 3 {method} {'wavefront' if wf else 'halo'} "
                     f"{bands_} bands")
            report[label] = smoke.band_case(
                label, method, c3[method], bands_, wf, pairs[method], whole,
                kernels, "", rounds=2)
        del whole
    return report


def worker(name: str, checkout: pathlib.Path) -> dict:
    """One run of the measurements on `checkout`'s package and smoke."""
    sys.path.insert(0, str(checkout))
    import chip_smoke as smoke
    import torch

    from stereo_matchin_tpu_torch import REFERENCE_CONFIG, kernels
    from stereo_matchin_tpu_torch.kernels import _build
    from stereo_matchin_tpu_torch.utils import graphs

    if not torch.cuda.is_available():
        raise SystemExit("cache_turns: no CUDA device")
    if not pathlib.Path(graphs.__file__).is_relative_to(checkout):
        raise SystemExit(f"cache_turns: imported {graphs.__file__}, not "
                         f"{checkout}'s package")
    smi = smoke.nvidia_smi_line()
    _build.build()
    _build.library()
    cfg = REFERENCE_CONFIG
    out = {"checkout": name, "card": smi}
    print(" frames")
    out["frames"] = frames(smoke, cfg, kernels, graphs)
    print(" large sizes")
    out["large_sizes"] = large_sizes(smoke, cfg, graphs)
    print(" mixed sizes")
    out["mixed_sizes"] = smoke.mixed_sizes(cfg, graphs, smi)
    print(" config 3 in 5 bands")
    out["bands"] = bands(smoke, cfg, kernels)
    graphs.clear_caches()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkout", action="append", default=[],
                    metavar="NAME=DIR")
    ap.add_argument("--out", default="bench_out/cache_turns.json")
    ap.add_argument("--timeout", type=float, default=900)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        name, path = args.worker.split("=", 1)
        print(json.dumps(worker(name, pathlib.Path(path).resolve())))
        return 0
    checkouts = {"change": ROOT}
    for spec in args.checkout:
        name, path = spec.split("=", 1)
        checkouts[name] = pathlib.Path(path).resolve()
    order = list(checkouts)[1:] + ["change"]
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    runs = []
    for k, name in enumerate(order + order[::-1]):
        log = out.with_name(f"{out.name}.{k}_{name}.log")
        with open(log, "w") as f:
            proc = subprocess.run(
                [sys.executable, str(pathlib.Path(__file__).resolve()),
                 "--worker", f"{name}={checkouts[name]}"],
                cwd=checkouts[name], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, timeout=args.timeout)
            f.write(proc.stdout)
        if proc.returncode:
            print(proc.stdout[-4000:])
            raise SystemExit(f"cache_turns: run {k} ({name}) failed with "
                             f"{proc.returncode}; its output is in {log}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    out.write_text(json.dumps(runs, indent=1))
    print(f"cache_turns: {len(runs)} runs in {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
