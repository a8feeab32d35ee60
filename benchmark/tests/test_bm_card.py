"""On the card (marker `cuda`; skips elsewhere): each cell's traffic cut to
small sizes runs through the CUDA kernels and the captured entries with
`correct` true, and with a fault underneath false.  The cells' own
sizes run through `benchmark/run.py` on the card (PERF.md)."""

import json

import pytest
import torch

from benchmark import harness
from benchmark.tests.support import SEED, small_root

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(scope="module")
def card_root(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return small_root(tmp_path_factory.mktemp("bench"), d_max=31)


def card_run(root, workload, trace=False):
    import time

    cell = harness.load_cell(workload, trace, root)
    return harness.run_cell(cell, SEED, 0.5, trace, torch.device("cuda", 0),
                            time.perf_counter())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_card(card_root, workload):
    out = card_run(card_root, workload)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["memory_peak_bytes"] > 0
    traced = card_run(card_root, workload, trace=True)
    assert traced["correct"]
    assert 0 < traced["device"]["busy_s"] <= traced["device"]["window_s"]
    assert "frame_device_ms" in traced["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("method,cell", [("asw", "asw-ref.kitti"),
                                         ("cross", "cross-ref.mb2014f")])
def test_fault_fails_on_the_card(card_root, tmp_path, method, cell):
    root = small_root(tmp_path, d_max=31)
    config = root / "benchmark" / "configs" / f"{method}-ref.json"
    body = json.loads(config.read_text())
    body["entry"] = f"benchmark.tests.faults:{method}_altered"
    config.write_text(json.dumps(body))
    assert not card_run(root, cell)["correct"]
