"""Command-line interface of the PyTorch port (the `run` command).

  STEREO_REFERENCE_ROOT=<reference checkout> \
      python -m stereo_matchin_tpu_torch run --pairs tsukuba --out out/
  python -m stereo_matchin_tpu_torch run --pics pics.txt --method cross --device cpu

It runs on the card (`cuda`) unless --device names another device; with
no card and no --device it exits with an error instead of computing on
the CPU.

`run` writes the reference's artifacts into <out>/<pair>/, through
the port's `io.png`: for the cross-based method
cross_based_initial.png, cross_based_disparity.png and median.png; for the
ASW method asw_disparity.png, asw_consistency_pre-reff.png and
asw_consistency_post-reff.png.  --method both (the default) writes all six.

--bands N > 1 runs the row-band drivers (models/tiled.py: the wavefront
strip carry where the band layout allows, halo bands otherwise) and, as
the JAX CLI does, writes the disparity maps only: cross_based_initial.png,
cross_based_disparity.png and asw_disparity.png.  --bands 0 picks the band
count from the card's memory (models.tiled.auto_bands; one band on the
CPU) and prints it.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


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
        left = torch.from_numpy(png.read_rgb(pair.left)).to(device)
        right = torch.from_numpy(png.read_rgb(pair.right)).to(device)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="stereo_matchin_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_run = sub.add_parser("run", help="run the pipelines, write PNG artifacts")
    p_run.add_argument("--pairs", nargs="*", default=None,
                       help="registered pair names (default: tsukuba), read "
                            "under $STEREO_REFERENCE_ROOT")
    p_run.add_argument("--pics", default=None,
                       help="reference-format pics.txt with pair paths")
    p_run.add_argument("--out", default="out")
    p_run.add_argument("--method", choices=["both", "cross", "asw"],
                       default="both")
    for f in ("d_max", "radius", "arm_len", "r_iters", "k_iters",
              "aggr_d_chunks"):
        p_run.add_argument(f"--{f}", type=int, default=None)
    p_run.add_argument("--bands", type=int, default=1,
                       help="row bands for frames whose cost volume does not "
                            "fit the device (wavefront strip carry where the "
                            "layout allows, halo bands otherwise); disparity "
                            "maps only; 0 = from the card's memory "
                            "(models.tiled.auto_bands; 1 on the CPU)")
    p_run.add_argument("--kernels", choices=["auto", "jnp", "pallas"],
                       default=None,
                       help="ASW: auto = CUDA kernels on a CUDA device; jnp = "
                            "plain PyTorch ops; pallas = demand the CUDA kernels")
    p_run.add_argument("--oii_impl", choices=["auto", "prefix", "taps", "pallas"],
                       default=None,
                       help="cross: auto = CUDA kernels on a CUDA device, taps "
                            "elsewhere; taps / prefix = plain PyTorch ops; "
                            "pallas = demand the CUDA kernels")
    p_run.add_argument("--device", default="cuda",
                       help="torch device (default: cuda; pass cpu to run "
                            "the plain ops on the host)")
    p_run.set_defaults(fn=cmd_run)
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("stereo_matchin_tpu_torch: no CUDA device is "
                             "available; pass --device cpu to run on the host")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
