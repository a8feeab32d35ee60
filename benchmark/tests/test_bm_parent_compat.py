"""The benchmark as it stands against a program without the spans and
counters its newer readers read: a traced run on the CPU with the
program's recorder and counters hidden still gives its result line, with
every metric the older benchmark reported and none of the four that read
the program (`entry_idle_pct`, `launch_idle_pct`, `first_call_s`,
`cache_reserved_gb`).

On the CPU the harness's trace (CUDA activities only) cannot start, so
the profiler records CPU activities here; the stretch it gives holds no
map copy, and the trace's metrics read nothing."""

import json

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import tracing
from benchmark.tests.support import cpu_run, small_root
from stereo_matchin_tpu_torch.utils import profiling

NEW = {"entry_idle_pct", "launch_idle_pct", "first_call_s",
       "cache_reserved_gb"}


def _cpu_tracer(monkeypatch):
    def start(self):
        self.prof = profile(activities=[ProfilerActivity.CPU])
        self.prof.__enter__()

    monkeypatch.setattr(tracing.Tracer, "start", start)


def _older(root):
    """`root`'s BENCHMARK.json without the four metrics."""
    path = root / "BENCHMARK.json"
    manifest = json.loads(path.read_text())
    manifest["per_layer"] = [m for m in manifest["per_layer"]
                             if m["name"] not in NEW]
    path.write_text(json.dumps(manifest))


@pytest.mark.parametrize("cell", ["asw-ref.kitti", "cross-ref.mb2014f"])
def test_a_program_without_spans_or_counters_gives_the_older_line(
        tmp_path, monkeypatch, cell):
    _cpu_tracer(monkeypatch)
    (tmp_path / "older").mkdir()
    (tmp_path / "newer").mkdir()
    older = small_root(tmp_path / "older")
    _older(older)
    before = cpu_run(older, cell, trace=True)
    for name in ("SPANS", "COUNTERS", "SpanRecorder", "GraphCounters"):
        monkeypatch.delattr(profiling, name)
    out = cpu_run(small_root(tmp_path / "newer"), cell, trace=True)
    assert out["correct"] and before["correct"]
    assert set(out["metrics"]) == set(before["metrics"])
    assert not set(out["metrics"]) & NEW
    assert {k for k in out if k != "setup"} == {
        k for k in before if k != "setup"}
