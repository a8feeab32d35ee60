"""The roofline metrics' byte and operation counts against hand counts."""

import types

import pytest

from benchmark import harness, peaks, tracing
from benchmark.tests.support import REPO


def metric_module(name):
    return harness.load_reader(REPO, name).__globals__


AGGR = metric_module("aggr_roofline_pct")
OII = metric_module("oii_roofline_pct")


def test_aggregation_launch_counts():
    T, H, W, n = 3, 2, 5, 4
    # K1: two 3x2x5 strips of floats in, a 4x2x5 denominator out.
    assert AGGR["den_work"](T, H, W, n) == ((2 * 30 + 40) * 4, 2 * 3 * 40)
    # K2: the strips, the cost and the denominator in, the output out.
    assert AGGR["pass_work"](T, H, W, n) == ((2 * 30 + 3 * 40) * 4, 10 * 40)


def test_aggregation_frame_sums_chunks_and_rounds():
    H, W, T, r = 2, 5, 3, 2
    whole = AGGR["frame_least_seconds"](H, W, 7, T, r, 0)
    want = (2 * peaks.least_seconds(*AGGR["den_work"](T, H, W, 7))
            + 2 * r * peaks.least_seconds(*AGGR["pass_work"](T, H, W, 7)))
    assert whole == pytest.approx(want)
    # 7 planes in 3 chunks: 3 + 3 + 1 planes.
    chunked = AGGR["frame_least_seconds"](H, W, 7, T, r, 3)
    want = sum(2 * peaks.least_seconds(*AGGR["den_work"](T, H, W, n))
               + 2 * r * peaks.least_seconds(*AGGR["pass_work"](T, H, W, n))
               for n in (3, 3, 1))
    assert chunked == pytest.approx(want)


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert peaks.least_seconds(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_config3_aggregation_bound_is_bytes():
    """Config 3 in 4 chunks: K2's 6.32 GB and K1's 3.11 GB a launch
    (PERF.md's kernel table, rows 7-9), bytes-bound."""
    H, W, T = 1988, 2880, 33
    b, ops = AGGR["pass_work"](T, H, W, 70)
    assert b == pytest.approx(6320.9e6, rel=1e-4)
    assert b / peaks.HBM_BYTES_PER_S > ops / peaks.FP32_OPS_PER_S
    assert AGGR["den_work"](T, H, W, 70)[0] == pytest.approx(3114.6e6, rel=1e-4)


def test_oii_pass_bytes():
    # Volume in and out (4 x 3 x 5 floats each), two int32 arm planes of
    # each view.
    assert OII["pass_bytes"](3, 5, 4) == 2 * 4 * 60 + 2 * 2 * 4 * 15


def run_with(kernels_us, frames, **params):
    p = dict(d_max=6, radius=1, r_iters=2, aggr_d_chunks=0, arm_len=25)
    p.update(params)
    tr = tracing.Trace((0.0, 1e9), [(0.0, us, name) for name, us in kernels_us],
                       [], frames)
    return harness.Run(None, types.SimpleNamespace(**p), [], 1.0, 1.0, 1, tr)


def test_roofline_shares():
    frames = [(4, 8), (4, 8)]
    least = AGGR["frame_least_seconds"](4, 8, 7, 3, 2, 0)
    spent_us = 2 * least * 1e6 * 4          # the kernels at a quarter
    r = run_with([("void asw_tile_kernel<1, 4, 33>(float const*)", spent_us),
                  ("other", 1e6)], frames)
    assert AGGR["read"](r) == pytest.approx(25.0)
    least = 2 * OII["pass_bytes"](4, 8, 7) / peaks.HBM_BYTES_PER_S
    least *= 2                              # two frames, spent twice over
    r = run_with([("oii_h_kernel(float const*)", least * 1e6),
                  ("oii_v_kernel(float const*)", least * 1e6)], frames)
    assert OII["read"](r) == pytest.approx(50.0)
    assert OII["read"](run_with([("oii_h_kernel", 1.0)], frames,
                                arm_len=79)) is None
    assert AGGR["read"](run_with([("other", 1.0)], frames)) is None
