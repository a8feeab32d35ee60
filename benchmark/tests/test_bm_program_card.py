"""On the card (marker `cuda`; skips elsewhere): a traced run of each cell,
its traffic cut to small sizes, reports the four metrics that read the
program's spans and counters, the frame entry's idle inside the device's
and the launch's inside the entry's, with the spans mapped onto the
trace within the residual the readers allow."""

import json
import time

import pytest
import torch

from benchmark import harness, program_spans
from benchmark.tests.support import SEED, small_root

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(scope="module")
def card_root(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return small_root(tmp_path_factory.mktemp("bench"), d_max=31)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reads_the_programs_spans_and_counters(
        card_root, workload, monkeypatch):
    from stereo_matchin_tpu_torch.utils import profiling

    profiling.SPANS.clear()
    runs = []
    load_reader = harness.load_reader

    def spying(root, name):
        read = load_reader(root, name)
        return lambda run: (runs.append(run), read(run))[1]

    monkeypatch.setattr(harness, "load_reader", spying)
    cell = harness.load_cell(workload, True, card_root)
    out = harness.run_cell(cell, SEED, 0.5, True, torch.device("cuda", 0),
                           time.perf_counter())
    assert out["correct"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    mapped = program_spans.alignment(runs[0])
    print(workload, "frames", len(runs[0].trace.frames), "residual",
          mapped and mapped[1])
    assert 0 <= got["launch_idle_pct"] <= got["entry_idle_pct"] \
        <= got["device_idle_pct"]
    assert got["first_call_s"] > 0 and got["cache_reserved_gb"] > 0
    _, residual, entries = mapped
    assert residual <= program_spans.RESIDUAL_US
    assert len(entries) == len(runs[0].trace.frames)
