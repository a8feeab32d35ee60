"""The port's per-stage benchmark harness (bench/harness.py), its staged
cross pipeline, its profiling utilities and the pipeline's disparity
quantization, on the CPU, against the JAX package and against the port's own pipelines.

The harness runs the pipelines' own stage functions through a
run(name, fn, *args) callable, so its dataflow must give the pipelines'
bits; the staged cross pipeline is bit-equal to JAX's cross_pipeline_staged
with oii_impl="taps" (the tolerance tests/test_torch_pipeline_cross.py
states: nothing on the cross path is multiplied, so XLA has no fused
multiply-add to contract).
"""

from __future__ import annotations

import collections
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_matchin_tpu import bench as jbench
from stereo_matchin_tpu import ops as jops
from stereo_matchin_tpu.eval import synthetic_scene
from stereo_matchin_tpu.models import asw as jasw
from stereo_matchin_tpu.models import cross_based as jcross
from stereo_matchin_tpu_torch import bench as tbench
from stereo_matchin_tpu_torch.bench import harness
from stereo_matchin_tpu_torch.models import asw as tasw
from stereo_matchin_tpu_torch.models import cross_based as tcross
from stereo_matchin_tpu_torch.utils import (Stopwatch, call_stage, device_sync,
                                            trace)

from .torch_support import TINY, config_pair, n, t

# The JAX harness test's configuration (tests/test_bench_harness.py).
SMALL = dict(d_max=7, radius=2, arm_len=3, r_iters=2, k_iters=2)


def _pair(seed=5, H=16, W=24):
    """The JAX harness test's pair: random codes, the right view rolled."""
    rng = np.random.default_rng(seed)
    left = (rng.integers(0, 256, (H, W, 3)) / np.float32(255.0)).astype(
        np.float32)
    return left, np.roll(left, -2, axis=1)


class Recorder:
    """A pass-through stage runner that keeps each stage's name and its
    last output."""

    def __init__(self):
        self.names = []
        self.last = {}

    def run(self, name, fn, *args):
        out = fn(*args)
        self.names.append(name)
        self.last[name] = out
        return out


def test_columns_equal_jax():
    assert tbench.CROSS_COLUMNS == jbench.CROSS_COLUMNS
    assert tbench.ASW_COLUMNS == jbench.ASW_COLUMNS
    assert tbench.__all__ == jbench.__all__


@pytest.mark.parametrize("method,columns,total", [
    ("cross", tbench.CROSS_COLUMNS, "cross method total"),
    ("asw", tbench.ASW_COLUMNS, "total WTA method"),
])
def test_stage_times_cover_columns(method, columns, total):
    _, cfg = config_pair(**SMALL)
    left, right = (t(a) for a in _pair())
    fn = tbench.time_cross_method if method == "cross" else \
        tbench.time_asw_method
    times = fn(left, right, cfg)
    for col in columns:
        assert col in times, col
        assert times[col] >= 0.0, col
    assert times[total] > 0
    if method == "cross":
        assert times["integral_h"] == times["integral_v"] == 0.0
        assert times["cross_full"] == times["cross_h"] + times["cross_v"]
    else:
        assert times["ref_w"] > 0 and "ref_w" not in columns


@pytest.mark.parametrize("kw", [{}, dict(aggr_d_chunks=3),
                                dict(wta_ref_conf_bug=False, k_iters=1)],
                         ids=["small", "d_chunks", "conf_bug_fixed"])
@pytest.mark.parametrize("runner", ["recorder", "stage_timer"])
def test_asw_stage_dataflow_bit_equal_to_pipeline(kw, runner):
    """The harness's ASW dataflow (asw_weights + asw_pipeline_from_weights
    through a stage runner) gives asw_pipeline's bits, with every stage
    under its column's name."""
    _, cfg = config_pair(**{**SMALL, **kw})
    left, right, _, _ = synthetic_scene(np.random.default_rng(8), 24, 32,
                                        cfg.d_max)
    left, right = t(left.astype(np.float32)), t(right.astype(np.float32))
    rec = Recorder()
    run = rec.run if runner == "recorder" else harness.StageTimer().run
    weights = tasw.asw_weights(left, right, cfg, run=run)
    got = tasw.asw_pipeline_from_weights(left, right, weights, cfg, run=run)
    want = tasw.asw_pipeline(left, right, cfg)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    if runner == "stage_timer":
        return
    assert torch.equal(rec.last["median"], want.disparity)
    chunks, r, k = max(cfg.aggr_d_chunks, 1), cfg.r_iters, cfg.k_iters
    assert collections.Counter(rec.names) == {
        "ref_w": 2, "supp_w": 4, "aggr": chunks, "v_aggr": chunks * (r + 1),
        "h_aggr": chunks * (r + 1), "wta": 1, "consistency": 1,
        "v_ref_L": k, "h_ref_L": k, "v_ref_R": k, "h_ref_R": k,
        "wta_ref": k, "consistency_ref": k, "median": 1}


def test_stage_timer_host_clock():
    """Each stage is dispatched once and its output returned; a stage with
    no CUDA tensor argument is timed by the host clock."""
    calls = []

    def stage(x):
        calls.append(x)
        return len(calls)

    timer = tbench.StageTimer()
    assert timer.run("a", stage, 7) == 1
    assert timer.run("a", stage, torch.ones(2)) == 2
    assert len(calls) == 2
    assert set(timer.times) == {"a"} and timer.ms("a") >= 0.0
    assert timer.ms("missing") == 0.0


@pytest.mark.parametrize("kw", [dict(**TINY), dict(**TINY, median_dispatch_quirk=True),
                                dict(**TINY, legacy_cross_arm_quirk=False),
                                dict(**SMALL)],
                         ids=["tiny", "median_quirk", "arm_quirk_off", "small"])
def test_cross_pipeline_staged_equals_pipeline_and_jax(kw):
    jcfg, cfg = config_pair(**kw, oii_impl="taps")
    left, right, _, _ = synthetic_scene(np.random.default_rng(11), 40, 56,
                                        cfg.d_max)
    left, right = left.astype(np.float32), right.astype(np.float32)
    rec = Recorder()
    staged = tcross.cross_pipeline_staged(t(left), t(right), cfg, run=rec.run)
    whole = tcross.cross_pipeline(t(left), t(right), cfg)
    want = jcross.cross_pipeline_staged(jnp.asarray(left), jnp.asarray(right),
                                        jcfg)
    for f in whole._fields:
        assert torch.equal(getattr(staged, f), getattr(whole, f)), f
        np.testing.assert_array_equal(n(getattr(staged, f)),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert rec.names == ["medL_solo", "medR_solo", "cross_h", "cross_v",
                         "aggregation", "aggr_h", "init_disp", "final_disp"]
    # The prefix route (integral images, another float order) runs the
    # same stages; its maps are compared in test_torch_pipeline_cross.py.
    prefix = tcross.cross_pipeline_staged(t(left), t(right),
                                          cfg.replace(oii_impl="prefix"))
    assert torch.equal(prefix.median_left, whole.median_left)
    with pytest.raises(ValueError, match="pallas"):
        tcross.cross_pipeline_staged(t(left), t(right),
                                     cfg.replace(oii_impl="pallas"))


_NUMBER = re.compile(r"-?\d+\.\d{3}")


def test_run_benchmark_tsv_has_the_jax_layout(tmp_path, monkeypatch):
    """Both harnesses on one synthetic pair handed to each loader: the same
    lines apart from the numbers and the device name."""
    left, right, _, _ = synthetic_scene(np.random.default_rng(2), 16, 24, 7)
    pair = (left.astype(np.float32), right.astype(np.float32))
    monkeypatch.setattr("stereo_matchin_tpu.io.load_pair", lambda name: pair)
    monkeypatch.setattr(harness, "load_pair", lambda name: pair)
    jcfg, cfg = config_pair(**SMALL)
    names = ["tsukuba", "teddy"]
    jpath = jbench.run_benchmark(names, jcfg, runs=2,
                                 out_dir=str(tmp_path / "jax"))
    tpath = tbench.run_benchmark(names, cfg, runs=2,
                                 out_dir=str(tmp_path / "port"), device="cpu")
    assert tpath == str(tmp_path / "port" / "cpu.tsv")
    jname = jpath.rsplit("/", 1)[1][:-len(".tsv")]

    def layout(path, device):
        text = open(path).read().replace(device, "<device>")
        return _NUMBER.sub("<ms>", text).split("\n")

    want, got = layout(jpath, jname), layout(tpath, "cpu")
    assert got == want
    assert sum(line.startswith("Run ") for line in got) == 4
    rows = [line.split("\t") for line in open(tpath).read().split("\n")
            if line.startswith("Run ")]
    assert all(len(r) == 1 + len(tbench.CROSS_COLUMNS) + 2 +
               len(tbench.ASW_COLUMNS) for r in rows)


@pytest.mark.parametrize("quantize", [True, False])
def test_pipeline_quantization_equals_jax(quantize):
    """The pipeline's _to_image(d) * d_max, the value its consistency
    stages read, equals JAX's: ops.quantize_disparity (the JAX harness's
    op) where quantized, the JAX pipeline's _to_image(d) * d_max where
    not."""
    rng = np.random.default_rng(3)
    for d_max in (7, 15, 60, 279):
        d = rng.integers(0, d_max + 1, (9, 13)).astype(np.float32)
        jcfg, cfg = config_pair(d_max=d_max, quantize_maps=quantize)
        got = n(tasw._to_image(t(d), cfg) * d_max)
        if quantize:
            want = jops.quantize_disparity(jnp.asarray(d), d_max)
        else:
            want = jasw._to_image(jnp.asarray(d), jcfg) * d_max
        np.testing.assert_array_equal(got, np.asarray(want))


def test_device_sync_and_stopwatch_on_the_cpu():
    """device_sync walks nested outputs and has nothing to wait for on the
    CPU; Stopwatch accumulates sections and reports them, longest first."""
    x = torch.ones(3)
    device_sync(None)
    device_sync({"a": [x, (x, 1)], "b": "text"})
    sw = Stopwatch()
    assert sw.timed("add", torch.add, x, x).tolist() == [2.0, 2.0, 2.0]
    sw.timed("add", torch.add, x, x)
    with sw.section("sum", sync_value=x) as h:
        h["out"] = x.sum()
    assert sw.counts == {"add": 2, "sum": 1}
    assert all(v >= 0.0 for v in sw.ms.values())
    lines = sw.report().split("\n")
    assert len(lines) == 2
    assert all(re.fullmatch(r"(add|sum)\s+\d+\.\d{3} ms  \(x[12]\)", ln)
               for ln in lines)
    assert call_stage("any", torch.add, x, 1.0).tolist() == [2.0, 2.0, 2.0]


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "trace")):
        torch.ones(8).cumsum(0)
    doc = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert "traceEvents" in doc
