"""Command-line interface of the PyTorch port (the `run` command, ASW method).

  python -m stereo_matchin_tpu_torch run --pairs tsukuba --out out/
  python -m stereo_matchin_tpu_torch run --pics pics.txt --device cuda

`run` writes the reference's ASW artifacts into <out>/<pair>/:
asw_disparity.png, asw_consistency_pre-reff.png and
asw_consistency_post-reff.png, through `stereo_matchin_tpu.io.png`.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _config_from_args(args):
    from stereo_matchin_tpu.config import StereoConfig

    kw = {f: getattr(args, f) for f in ("d_max", "radius", "r_iters",
                                        "k_iters", "kernels")
          if getattr(args, f) is not None}
    return StereoConfig(**kw)


def _resolve_pairs(args):
    from stereo_matchin_tpu.io import REGISTRY, parse_pics_txt

    if args.pics:
        return parse_pics_txt(args.pics)
    return [REGISTRY[n] for n in (args.pairs or ["tsukuba"])]


def cmd_run(args) -> int:
    import torch

    from stereo_matchin_tpu.io import png
    from stereo_matchin_tpu.io.datasets import safe_pair_name

    from .models import asw

    if args.method != "asw":
        raise NotImplementedError(
            "the cross-based method is not ported yet (ROADMAP A7-A8)")
    cfg = _config_from_args(args)
    device = torch.device(args.device)
    for pair in _resolve_pairs(args):
        out_dir = os.path.join(args.out, safe_pair_name(pair.name))
        os.makedirs(out_dir, exist_ok=True)
        left = torch.from_numpy(png.read_rgb(pair.left)).to(device)
        right = torch.from_numpy(png.read_rgb(pair.right)).to(device)
        t0 = time.perf_counter()
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
    p_run = sub.add_parser("run", help="run the ASW pipeline, write PNG artifacts")
    p_run.add_argument("--pairs", nargs="*", default=None,
                       help="registered pair names (default: tsukuba)")
    p_run.add_argument("--pics", default=None,
                       help="reference-format pics.txt with pair paths")
    p_run.add_argument("--out", default="out")
    p_run.add_argument("--method", choices=["asw", "cross", "both"],
                       default="asw")
    for f in ("d_max", "radius", "r_iters", "k_iters"):
        p_run.add_argument(f"--{f}", type=int, default=None)
    p_run.add_argument("--kernels", choices=["auto", "jnp", "pallas"],
                       default=None,
                       help="auto: CUDA kernels on a CUDA device; jnp: plain "
                            "PyTorch ops; pallas: demand the CUDA kernels")
    p_run.add_argument("--device", default=None,
                       help="torch device (default: cuda if available, else cpu)")
    p_run.set_defaults(fn=cmd_run)
    args = ap.parse_args(argv)
    if args.device is None:
        import torch

        args.device = "cuda" if torch.cuda.is_available() else "cpu"
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
