#!/usr/bin/env python3
"""The control of a cell's check: the plain reference in a lower precision
put in the program's place, compared with the float32 reference exactly
as a run compares the program.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

On the card, in bfloat16: for each seed it makes the cell's pairs as a
run does and, for the first pair of each frame size, prints one JSON line with each compared number
beside the configuration's limit.  The control must come out as not
correct: its numbers are the upper readings the limits are set below
(PERF.md).  A run of the benchmark never runs it.
"""

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def control(cell, seed: int, dtype, device) -> list:
    """[(pair index, {name: (number, limit)}, reference seconds)] for the
    first pair of each size of `cell` made from `seed`."""
    import importlib
    import types

    import torch

    from benchmark import harness, scene

    tr = cell.traffic
    sizes = [tuple(s) for s in tr["sizes"]]
    pairs = scene.make_pairs(seed, sizes, tr["pairs_per_size"], tr["d_max"],
                             device, tr["scene"])
    params = types.SimpleNamespace(**harness.params_of(cell))
    ref = importlib.import_module(
        f"benchmark.reference.{cell.config['reference']}")
    out = []
    for i in range(len(sizes)):
        t = time.perf_counter()
        maps = ref.frame(pairs[i].left, pairs[i].right, params, dtype)
        checks = harness.check(cell, pairs, [(0, i, maps)], params,
                               getattr(torch, cell.config["precision"]))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out.append((i, checks, time.perf_counter() - t))
        del maps
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch

    from benchmark import harness

    device = torch.device("cuda", 0)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        for pair, checks, seconds in control(cell, seed, torch.bfloat16,
                                             device):
            print(json.dumps({
                "workload": args.workload, "seed": seed, "pair": pair,
                "dtype": "bfloat16", "seconds": seconds,
                "correct": all(n <= lim for n, lim in checks.values()),
                "checks": {k: {"value": n, "limit": lim}
                           for k, (n, lim) in checks.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
