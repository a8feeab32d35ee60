"""Helpers of the benchmark's CPU tests: a copy of the benchmark in a
temporary directory with its traffic cut to CPU sizes, and runs of a
cell there on the CPU."""

import json
import pathlib
import shutil
import time

import torch

from benchmark import harness

REPO = pathlib.Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 11


def small_root(tmp: pathlib.Path, d_max: int = 15) -> pathlib.Path:
    """BENCHMARK.json and benchmark/ copied into `tmp`, every traffic mix
    at 40x64-ish frames, `d_max` and 2 pairs a size."""
    shutil.copy(REPO / "BENCHMARK.json", tmp)
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for p in (tmp / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        t["sizes"] = [[40 + i, 64 + 2 * i] for i in range(len(t["sizes"]))]
        t["d_max"] = d_max
        t["pairs_per_size"] = 2
        p.write_text(json.dumps(t))
    return tmp


def cpu_run(root, workload: str, seconds: float = 0.3, trace: bool = False,
            seed: int = SEED) -> dict:
    """One run of `workload` on the CPU.  The window is doubled until it
    holds every pair of the cell once: on a loaded CPU one frame can take
    longer than a short window."""
    cell = harness.load_cell(workload, trace, root)
    n_pairs = len(cell.traffic["sizes"]) * cell.traffic["pairs_per_size"]
    while True:
        out = harness.run_cell(cell, seed, seconds, trace,
                               torch.device("cpu"), time.perf_counter())
        if out["attempted"] >= n_pairs:
            return out
        seconds *= 2
