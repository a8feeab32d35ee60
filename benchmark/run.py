#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: loads the cell (BENCHMARK.json), makes its
pairs on the card from the seed, warms up each of its signatures, runs
the captured entry in a closed loop for `--seconds`, checks sampled
frames against the plain reference and prints one JSON line: the
end-to-end metrics with --trace 0, the per-layer ones (from a
torch.profiler stretch of the window) with --trace 1.  Exits non-zero,
with no result, without the CUDA devices the cell asks for.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # The checkout's root, not this directory, heads the import path.
    sys.path[0] = str(ROOT)
    from benchmark import harness

    return harness.main(args, PROCESS_START)


if __name__ == "__main__":
    sys.exit(main())
