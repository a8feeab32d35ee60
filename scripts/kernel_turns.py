#!/usr/bin/env python3
"""K13 (`epipolar_segment`) and K12 (`median3x3`) of several checkouts, in
turns on one card.

    python3 scripts/kernel_turns.py [--checkout NAME=DIR]... [--reps N]
        [--out FILE]

Builds `csrc/wta_shard.cu` and `csrc/median.cu` into one library per
build, with nvcc's flags of `kernels/_build.py` and `-Xptxas -v` (whose
register, shared-memory and spill lines it prints): "change" from this
checkout and NAME from DIR/stereo_matchin_tpu_torch/csrc (an unpacked
`git archive` of another commit, the parent say, whose kernels keep the
same C entry points); a build whose K13 exports epipolar_segment_walk_f32
is also timed with each walk forced ("NAME pixel", "NAME segment").
Each library is loaded with ctypes beside the others and called through
its C entry points on the same inputs: K13 on
both shards of config-3 (1, 2, 2) and (1, 4, 2) meshes (140 of 280 planes
of 994 or 497 x 2880, integer costs, the target penalty) and of 288 x
384 (1, 2, 2) and (1, 1, 2) ones (31 of 62 planes of 144 or 288 x 384),
each with d1 uniform in [0, D), structured
(tests/torch_support.py structured_d1: a smooth surface in [0, 40) with
about 3 in 32 outliers in [D // 3, D - 1]) and shifted (shifted_d1: 37,
the shift of chip_smoke.py config3_pair, or D // 3 where smaller, with 3
in 100 pixels uniform in [0, D)); K12 on a config-3 image (1988 x 2880 x
3) and map and on a 288 x 384 image and map.  Every output is held to
the plain version's bits (parallel/wta_sharded.py epipolar_partial +
stack_two_min, ops/median.py median3x3_plain); a build that differs is
reported and fails the run.  Then each case is timed in turns (the
builds in order, then in reverse, twice): device ms of `--reps` calls
replayed from a CUDA graph and eager ms, by CUDA events, beside the least
time of the bytes (chip_smoke.py's bound: K13 4 bytes a counted step and
24 a pixel, K12 the image read and written once) and, for K13, the
floats the change stages and loads directly (chip_smoke.py
segment_walk).  Prints one JSON line per case and writes them all to
--out (default bench_out/kernel_turns.json), with the card's nvidia-smi
name and power limit.  Needs an NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCES = ("wta_shard.cu", "median.cu")


def build(name, csrc, tmp):
    """One library of SOURCES under tmp; returns (CDLL, ptxas lines)."""
    from stereo_matchin_tpu_torch.kernels import _build

    nvcc = _build.nvcc_path()
    objs, info = [], []
    for src in SOURCES:
        obj = str(tmp / f"{name}_{src}.o")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
               "-o", obj, str(csrc / src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{res.stderr}")
        info += [ln.strip() for ln in res.stderr.splitlines()
                 if "registers" in ln or "spill" in ln or "entry" in ln]
        objs.append(obj)
    lib = str(tmp / f"lib{name}.so")
    subprocess.run([nvcc, *_build.LINK_FLAGS, "-o", lib, *objs], check=True)
    cdll = ctypes.CDLL(lib)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    cdll.epipolar_segment_f32.argtypes = [p] * 5 + [i] * 6 + [f, p]
    cdll.epipolar_segment_f32.restype = i
    if hasattr(cdll, "epipolar_segment_walk_f32"):
        cdll.epipolar_segment_walk_f32.argtypes = [p] * 5 + [i] * 6 + [f, i,
                                                                       p]
        cdll.epipolar_segment_walk_f32.restype = i
    cdll.median3x3_f32.argtypes = [p, p, i, i, i, p]
    cdll.median3x3_f32.restype = i
    return cdll, info


def k13_call(lib, walk, cost, d1, d0, n_local, total_disp, sc, ct, big,
             out):
    """A call of K13 through lib: the walk its shape takes (walk None), or
    the walk forced (1 pixel, 2 segment)."""
    import torch

    Dl, H, W = cost.shape
    args = (cost.data_ptr(), d1.data_ptr(), sc.data_ptr(), ct.data_ptr(),
            out.data_ptr(), Dl, H, W, d0, n_local, total_disp, big)

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        rc = (lib.epipolar_segment_f32(*args, stream) if walk is None
              else lib.epipolar_segment_walk_f32(*args, walk, stream))
        if rc:
            raise RuntimeError(f"epipolar_segment returned {rc}")
        return out
    return run


def k12_call(lib, img, out):
    import torch

    H, W = img.shape[:2]
    C = img.shape[2] if img.dim() == 3 else 1

    def run():
        rc = lib.median3x3_f32(img.data_ptr(), out.data_ptr(), H, W, C,
                               torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"median3x3_f32 returned {rc}")
        return out
    return run


def cases(big):
    """{name: (the plain version's output, make(lib, walk) -> call or
    None, (bytes, ops), extra fields)}."""
    import torch

    import chip_smoke
    from stereo_matchin_tpu_torch.ops.median import median3x3_plain
    from tests.torch_support import shifted_d1, structured_d1

    twta = chip_smoke.wta_sharded_module()
    gen = torch.Generator(device="cuda").manual_seed(67)
    out = {}
    for frame, (H, W, D) in {
            "config 3": (chip_smoke.CONFIG3_HW[0] // 2,
                         chip_smoke.CONFIG3_HW[1], 280),
            "config 3 (1,4,2)": (chip_smoke.CONFIG3_HW[0] // 4,
                                 chip_smoke.CONFIG3_HW[1], 280),
            "288x384": (144, 384, 62),
            "288x384 (1,1,2)": (288, 384, 62)}.items():
        dl = D // 2
        vols = [torch.rand((dl, H, W), generator=gen, device="cuda").mul_(
            400).floor_() for _ in range(2)]
        sc = torch.rand((H, W), generator=gen, device="cuda") * 3 * 0.085
        ct = (torch.randint(0, D, (H, W), generator=gen, device="cuda")
              + 0.5 * torch.randint(0, 2, (H, W), generator=gen,
                                    device="cuda")).float()
        d1s = {"uniform": torch.randint(0, D, (H, W), generator=gen,
                                        device="cuda", dtype=torch.int32),
               "structured": structured_d1(H, W, D, 71, "cuda"),
               "shifted": shifted_d1(H, W, D, 73, "cuda", min(37, D // 3))}
        for kind, d1 in d1s.items():
            for k, v in enumerate(vols):
                d0 = k * dl
                walk = chip_smoke.segment_walk(d1, d0, dl, D)
                want = twta.stack_two_min(twta.epipolar_partial(
                    v, d1, d0, dl, D, sc, ct, big))
                out[f"epipolar_segment {frame} {kind} shard {k}"] = (
                    want,
                    lambda lib, walk, v=v, d1=d1, d0=d0, dl=dl, D=D, sc=sc,
                    ct=ct: k13_call(lib, walk, v, d1, d0, dl, D, sc, ct, big,
                                    torch.empty((3,) + tuple(d1.shape),
                                                device="cuda")),
                    (4 * walk["loads"] + 24 * H * W, 6 * walk["steps"]),
                    walk | {"at": f"{dl} planes of {H}x{W} at d0 {d0}, "
                                  f"D={D}, d1 {kind}, penalty"})
    levels = (lambda H, W, C: (torch.randint(
        0, 256, (H, W, C) if C else (H, W), generator=gen,
        device="cuda").float() / 255))
    for tag, (h, w, c) in {"config 3 image": (1988, 2880, 3),
                           "config 3 map": (1988, 2880, 0),
                           "288x384 image": (288, 384, 3),
                           "288x384 map": (288, 384, 0)}.items():
        img = levels(h, w, c)
        out[f"median3x3 {tag}"] = (
            median3x3_plain(img),
            lambda lib, walk, img=img: None if walk else k12_call(
                lib, img, torch.empty_like(img)),
            (2 * img.numel() * 4, 38 * img.numel()),
            {"at": "x".join(map(str, img.shape))})
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--checkout", action="append", default=[],
                    help="NAME=DIR: the kernels of an unpacked checkout")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "bench_out" / "kernel_turns.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_turns: needs an NVIDIA GPU")
    import chip_smoke

    smi = chip_smoke.nvidia_smi_line()
    csrc = ROOT / "stereo_matchin_tpu_torch" / "csrc"
    builds = {"change": csrc}
    for v in args.checkout:
        name, _, path = v.partition("=")
        builds[name] = pathlib.Path(path) / "stereo_matchin_tpu_torch" / "csrc"
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, src in builds.items():
            lib, info = build(name, src, pathlib.Path(tmp))
            libs[name] = (lib, None)
            if hasattr(lib, "epipolar_segment_walk_f32"):   # K13's walks
                libs[f"{name} pixel"] = (lib, 1)
                libs[f"{name} segment"] = (lib, 2)
            print(f"{name}:")
            for ln in info:
                print(f"  {ln}")
        report, failed = [], []
        for case, (want, make, work, extra) in cases(1e5).items():
            calls = {name: make(lib, walk)
                     for name, (lib, walk) in libs.items()}
            calls = {name: fn for name, fn in calls.items() if fn}
            same = {}
            for name, fn in calls.items():
                got = fn()
                torch.cuda.synchronize()
                same[name] = torch.equal(got.view(torch.int32),
                                         want.view(torch.int32))
                if not same[name]:
                    failed.append(f"{case}: {name}")
            times = {name: {"device_ms": [], "ms": []} for name in calls}
            order = list(calls)
            for names in (order, order[::-1]) * 2:       # in turns
                for name in names:
                    fn = calls[name]
                    times[name]["device_ms"].append(round(chip_smoke.cuda_ms(
                        fn, args.reps, graph=True), 4))
                    times[name]["ms"].append(round(chip_smoke.cuda_ms(
                        fn, args.reps), 4))
            bound_ms, bound_by = chip_smoke.bound({"bytes": work[0],
                                                   "ops": work[1]})
            entry = {"case": case, **extra, "bytes": work[0],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "same_bits": same, "times": times, "card": smi}
            if "staged" in extra:
                entry["staged_ms"] = (4 * (extra["staged"] + extra["direct"])
                                      / chip_smoke.HBM_BYTES_PER_S * 1e3)
            print(json.dumps(entry), flush=True)
            report.append(entry)
            del calls
            torch.cuda.empty_cache()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    if failed:
        print(f"FAILED: differs from the plain version: {failed}")
        return 1
    print(f"every build gave the plain version's bits ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
