"""Command-line interface of the PyTorch port — the reference binary's
workflow (a pics.txt of pairs, both methods, PNGs and a timing file per
device; main.cpp:134-156,166,357-367,621-631):

  STEREO_REFERENCE_ROOT=<reference checkout> \
      python -m stereo_matchin_tpu_torch run   --pairs tsukuba teddy --out out/
  python -m stereo_matchin_tpu_torch run   --pics pics.txt --method asw
  python -m stereo_matchin_tpu_torch bench --pairs tsukuba --runs 10
  python -m stereo_matchin_tpu_torch eval  --pairs tsukuba teddy
  python -m stereo_matchin_tpu_torch synth --out synth/

`run`, `bench` and `eval` compute on the card (`cuda`) unless --device
names another device; with no card and no --device they exit with an
error instead of computing on the CPU.  Pairs by name (--pairs, default
tsukuba) and their goldens lie under $STEREO_REFERENCE_ROOT; --pics names
pair files instead.

`run` writes the reference's artifacts into <out>/<pair>/, through the
port's `io.png`: for the cross-based method cross_based_initial.png,
cross_based_disparity.png and median.png; for the ASW method
asw_disparity.png, asw_consistency_pre-reff.png and
asw_consistency_post-reff.png.  --method both (the default) writes all
six.  --bands N > 1 runs the row-band drivers (models/tiled.py: the
wavefront strip carry where the band layout allows, halo bands otherwise)
and, as the JAX CLI does, writes the disparity maps only; --bands 0 picks
the band count from the card's memory (models.tiled.auto_bands; one band
on the CPU) and prints it.

`bench` writes the per-stage TSV (bench/harness.py) to <out>/<device>.tsv.
`eval` compares each map of a registered pair with the reference's stored
artifact (exit code 1 where bad2 > 1%) and, with --gt, prints bad-pixel
rates against a ground-truth file (.pfm / .pgm / .png).  `synth` writes a
seeded synthetic pair with its ground truth (imL.png, imR.png, gt.pfm with
the non-occluded mask, pics.txt) for the synth -> run -> eval loop with
no data on disk; it computes nothing on a device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _config_from_args(args):
    from .config import StereoConfig

    kw = {f: getattr(args, f) for f in ("d_max", "radius", "arm_len",
                                        "r_iters", "k_iters", "aggr_d_chunks",
                                        "kernels", "oii_impl")
          if getattr(args, f) is not None}
    return StereoConfig(**kw)


def _resolve_pairs(args):
    from .io import REGISTRY, parse_pics_txt

    if args.pics:
        return parse_pics_txt(args.pics)
    names = args.pairs or ["tsukuba"]
    unknown = [n for n in names if n not in REGISTRY]
    if unknown:
        raise SystemExit(f"unknown pairs {unknown}; registered: {list(REGISTRY)}")
    try:
        return [REGISTRY[n] for n in names]
    except LookupError as e:
        raise SystemExit(f"stereo_matchin_tpu_torch: {e}") from None


def _load(pair, device):
    import torch

    from .io import load_pair

    return tuple(torch.from_numpy(a).to(device) for a in load_pair(pair))


def cmd_run(args) -> int:
    import torch

    from .io import png, safe_pair_name
    from .models import asw, cross_based, tiled

    cfg = _config_from_args(args)
    device = torch.device(args.device)
    if args.bands < 0:
        raise SystemExit(f"--bands must be >= 0, got {args.bands}")
    for pair in _resolve_pairs(args):
        out_dir = os.path.join(args.out, safe_pair_name(pair.name))
        os.makedirs(out_dir, exist_ok=True)
        left, right = _load(pair, device)
        bands = args.bands
        if bands == 0:
            bands = tiled.auto_bands(left.shape, cfg, device=device)
            print(f"{pair.name}: auto bands -> {bands}")
        t0 = time.perf_counter()
        if args.method in ("both", "cross"):
            if bands > 1:
                initial, final = tiled.cross_pipeline_tiled(left, right, cfg,
                                                            bands)
            else:
                res = cross_based.cross_pipeline(left, right, cfg)
                initial, final = res.initial, res.final
                png.write_rgb(os.path.join(out_dir, "median.png"),
                              res.median_left.cpu().numpy())
            png.write_gray(os.path.join(out_dir, "cross_based_initial.png"),
                           initial.cpu().numpy())
            png.write_gray(os.path.join(out_dir, "cross_based_disparity.png"),
                           final.cpu().numpy())
        if args.method in ("both", "asw") and bands > 1:
            disparity, _ = tiled.asw_pipeline_tiled(left, right, cfg, bands)
            png.write_gray(os.path.join(out_dir, "asw_disparity.png"),
                           disparity.cpu().numpy())
        elif args.method in ("both", "asw"):
            res = asw.asw_pipeline(left, right, cfg)
            png.write_gray(os.path.join(out_dir, "asw_disparity.png"),
                           res.disparity.cpu().numpy())
            png.write_rgb(os.path.join(out_dir, "asw_consistency_pre-reff.png"),
                          res.consistency_pre.cpu().numpy())
            png.write_rgb(os.path.join(out_dir, "asw_consistency_post-reff.png"),
                          res.consistency_post.cpu().numpy())
        print(f"{pair.name}: artifacts in {out_dir} on {device} "
              f"({time.perf_counter() - t0:.2f}s; a first CUDA run includes "
              f"the kernel build)")
    return 0


def cmd_bench(args) -> int:
    from .bench import run_benchmark

    path = run_benchmark(_resolve_pairs(args), _config_from_args(args),
                         runs=args.runs, out_dir=args.out, device=args.device)
    print(f"per-stage report: {path}")
    return 0


def _parse_gt_args(entries):
    """--gt entries are '<pair>=<path>' (or a bare path for a single pair)."""
    gt = {}
    for e in entries or []:
        name, sep, path = e.partition("=")
        if not sep:
            gt[None] = e  # bare path: applies to the sole pair
        else:
            gt[name] = path
    return gt


def cmd_eval(args) -> int:
    import torch

    from .eval import bad_pixel_pct, compare_to_golden
    from .io.groundtruth import read_groundtruth
    from .models import asw, cross_based

    cfg = _config_from_args(args)
    device = torch.device(args.device)
    gt_by_pair = _parse_gt_args(args.gt)
    pairs = _resolve_pairs(args)
    if None in gt_by_pair:
        if len(pairs) != 1:
            print("--gt without '<pair>=' needs exactly one pair",
                  file=sys.stderr)
            return 2
        gt_by_pair[pairs[0].name] = gt_by_pair.pop(None)
    failed = False

    def score_gt(name, label, img01):
        gt_path = gt_by_pair.get(name)
        if gt_path is None:
            return
        gt, valid = read_groundtruth(gt_path, scale=args.gt_scale)
        got = img01.cpu().numpy().astype(np.float64) * cfg.d_max
        if got.shape != gt.shape:
            print(f"{name}/{label}: GT shape {gt.shape} != map {got.shape}",
                  file=sys.stderr)
            return
        b1 = bad_pixel_pct(got, gt, threshold=1.0, mask=valid)
        b2 = bad_pixel_pct(got, gt, threshold=2.0, mask=valid)
        print(f"{name}/{label} vs GT: bad1={b1:.2f}% bad2={b2:.2f}% "
              f"(valid {valid.mean() * 100:.1f}%)")

    def score_golden(name, art, img01):
        nonlocal failed
        c = compare_to_golden(img01.cpu().numpy(), name, art, cfg.d_max)
        print(f"{name}/{art}: {c}")
        failed |= c.bad2_pct > 1.0

    for pair in pairs:
        name = pair.name
        # Only registered pairs have the reference's stored artifacts.
        golden = pair.golden_dir is not None
        left, right = _load(pair, device)
        if args.method in ("both", "cross"):
            res = cross_based.cross_pipeline(left, right, cfg)
            if golden:
                score_golden(name, "cross_based_initial.png", res.initial)
                score_golden(name, "cross_based_disparity.png", res.final)
            score_gt(name, "cross_based_disparity", res.final)
        if args.method in ("both", "asw"):
            res = asw.asw_pipeline(left, right, cfg)
            if golden:
                score_golden(name, "asw_disparity.png", res.disparity)
            score_gt(name, "asw_disparity", res.disparity)
    return 1 if failed else 0


def cmd_synth(args) -> int:
    """Generate a synthetic stereo pair with known ground truth."""
    from .eval.synthetic import synthetic_scene
    from .io import png
    from .io.groundtruth import write_pfm

    rng = np.random.default_rng(args.seed)
    left, right, gt, mask = synthetic_scene(rng, args.height, args.width,
                                            args.disp)
    os.makedirs(args.out, exist_ok=True)
    lp = os.path.join(args.out, "imL.png")
    rp = os.path.join(args.out, "imR.png")
    png.write_rgb(lp, left)
    png.write_rgb(rp, right)
    write_pfm(os.path.join(args.out, "gt.pfm"), gt, invalid_mask=~mask)
    with open(os.path.join(args.out, "pics.txt"), "w") as f:
        f.write(f"{lp}\n{rp}\n")
    print(f"scene in {args.out}: imL/imR.png ({args.height}x{args.width}, "
          f"max disparity {args.disp}), gt.pfm (nonocc mask), pics.txt")
    print(f"  run:  python -m stereo_matchin_tpu_torch run --pics "
          f"{args.out}/pics.txt --out {args.out}/maps")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="stereo_matchin_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--pairs", nargs="*", default=None,
                       help="registered pair names (default: tsukuba), read "
                            "under $STEREO_REFERENCE_ROOT")
        p.add_argument("--pics", default=None,
                       help="reference-format pics.txt with pair paths")
        p.add_argument("--method", choices=["both", "cross", "asw"],
                       default="both")
        for f in ("d_max", "radius", "arm_len", "r_iters", "k_iters",
                  "aggr_d_chunks"):
            p.add_argument(f"--{f}", type=int, default=None)
        p.add_argument("--kernels", choices=["auto", "jnp", "pallas"],
                       default=None,
                       help="ASW: auto = CUDA kernels on a CUDA device; jnp = "
                            "plain PyTorch ops; pallas = demand the CUDA "
                            "kernels")
        p.add_argument("--oii_impl", choices=["auto", "prefix", "taps",
                                              "pallas"], default=None,
                       help="cross: auto = CUDA kernels on a CUDA device, "
                            "taps elsewhere; taps / prefix = plain PyTorch "
                            "ops; pallas = demand the CUDA kernels")
        p.add_argument("--device", default="cuda",
                       help="torch device (default: cuda; pass cpu to run "
                            "the plain ops on the host)")

    p_run = sub.add_parser("run", help="run the pipelines, write PNG artifacts")
    common(p_run)
    p_run.add_argument("--out", default="out")
    p_run.add_argument("--bands", type=int, default=1,
                       help="row bands for frames whose cost volume does not "
                            "fit the device (wavefront strip carry where the "
                            "layout allows, halo bands otherwise); disparity "
                            "maps only; 0 = from the card's memory "
                            "(models.tiled.auto_bands; 1 on the CPU)")
    p_run.set_defaults(fn=cmd_run)

    p_bench = sub.add_parser("bench", help="per-stage TSV benchmark")
    common(p_bench)
    p_bench.add_argument("--runs", type=int, default=10)
    p_bench.add_argument("--out", default="bench_out")
    p_bench.set_defaults(fn=cmd_bench)

    p_eval = sub.add_parser("eval", help="compare outputs to goldens")
    common(p_eval)
    p_eval.add_argument("--gt", nargs="*", default=None, metavar="PAIR=PATH",
                        help="ground-truth disparity files (.pfm/.pgm/.png); "
                             "bad-pixel rates are printed per final map")
    p_eval.add_argument("--gt-scale", type=float, default=None,
                        help="stored-value-per-disparity override "
                             "(defaults: pfm 1, pgm 16, png 4)")
    p_eval.set_defaults(fn=cmd_eval)

    p_synth = sub.add_parser(
        "synth", help="generate a synthetic pair + ground-truth PFM")
    p_synth.add_argument("--out", default="synth")
    p_synth.add_argument("--width", type=int, default=384)
    p_synth.add_argument("--height", type=int, default=288)
    p_synth.add_argument("--disp", type=int, default=24,
                         help="scene's maximum disparity in pixels")
    p_synth.add_argument("--seed", type=int, default=0)
    p_synth.set_defaults(fn=cmd_synth)

    args = ap.parse_args(argv)
    if getattr(args, "device", "").startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("stereo_matchin_tpu_torch: no CUDA device is "
                             "available; pass --device cpu to run on the host")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
