"""utils.profiling.stage_device_ms on hand-built Chrome trace events: the
device time of each stage of a profiled frame.

The first case is a trace whose runtime calls carry host timestamps past
the end of their stage's host-side span: CUPTI stamps them on its clock,
the profiler stamps the ranges on its own, and the two can disagree (an
H100 trace showed a kernel starting 5.6 us before the call that launched
it).  Matching launch times to host spans then puts the launches outside
their stage; the device-side extents the profiler writes for each range
("gpu_user_annotation", linked by correlation, on the device's clock)
keep them in it."""

from __future__ import annotations

import pytest

from stereo_matchin_tpu_torch.utils import profiling


def _kernel(ts, dur, corr, cat="kernel"):
    return {"cat": cat, "ts": ts, "dur": dur, "args": {"correlation": corr}}


def _runtime(ts, corr):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
            "dur": 5, "args": {"correlation": corr}}


def _span(name, ts, dur, cat="user_annotation"):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur}


def _by_stage(events, stages):
    """stage_device_ms with the sums rounded past float noise."""
    return {k: (round(ms, 9), count) for k, (ms, count) in
            profiling.stage_device_ms(events, stages).items()}


def _ref_w_trace():
    """Two "ref_w" ranges of two launches each, then "supp_w" and a glue
    kernel after it; the launch calls' host timestamps are late by 120."""
    host = [_span("ref_w", 0, 200), _span("ref_w", 210, 90),
            _span("supp_w", 310, 60)]
    calls = [_runtime(t + 120, c) for t, c in ((150, 1), (190, 2),
                                               (250, 3), (290, 4),
                                               (330, 5), (385, 6))]
    kernels = [_kernel(140, 8, 1), _kernel(180, 8, 2), _kernel(240, 8, 3),
               _kernel(282, 8, 4), _kernel(322, 8, 5), _kernel(376, 4, 6)]
    device = [_span("ref_w", 140, 48, "gpu_user_annotation"),
              _span("ref_w", 240, 50, "gpu_user_annotation"),
              _span("supp_w", 322, 8, "gpu_user_annotation")]
    return host, calls, kernels, device


def test_device_extents_hold_the_stages_whose_launch_times_drift():
    host, calls, kernels, device = _ref_w_trace()
    stages = {"ref_w", "supp_w"}
    got = _by_stage(host + calls + kernels + device, stages)
    assert got == {"ref_w": (0.032, 4), "supp_w": (0.008, 1),
                   None: (0.004, 1)}
    # Without the device-side extents the host times decide, and the
    # drifted launches leave their stages.
    drifted = _by_stage(host + calls + kernels, stages)
    assert drifted.get("ref_w", (0.0, 0))[1] < 4


def test_device_extents_nest_and_repeat():
    """An activity goes to the innermost extent that holds it; copies and
    sets count; an activity between extents is glue (None); a range not
    named in `stages` holds nothing."""
    events = [
        _span("h_aggr", 0, 100, "gpu_user_annotation"),
        _span("v_aggr", 20, 30, "gpu_user_annotation"),
        _span("v_aggr", 60, 10, "gpu_user_annotation"),
        _span("other", 120, 20, "gpu_user_annotation"),
        _kernel(5, 10, 1), _kernel(22, 4, 2), _kernel(44, 6, 3, "gpu_memset"),
        _kernel(52, 6, 4), _kernel(61, 8, 5, "gpu_memcpy"),
        _kernel(104, 2, 6), _kernel(125, 10, 7),
    ]
    got = _by_stage(events, {"h_aggr", "v_aggr"})
    assert got == {"h_aggr": (0.016, 2), "v_aggr": (0.018, 3),
                   None: (0.012, 2)}


def test_host_fallback_takes_the_innermost_range():
    """Without device-side extents: a launch inside an outer range after an
    inner one has closed goes to the outer range, not outside."""
    events = [_span("wta_ref", 0, 100), _span("wta", 10, 10),
              _runtime(15, 1), _runtime(50, 2), _runtime(150, 3),
              _kernel(1000, 4, 1), _kernel(1010, 6, 2), _kernel(1020, 8, 3)]
    got = _by_stage(events, {"wta", "wta_ref"})
    assert got == {"wta": (0.004, 1), "wta_ref": (0.006, 1), None: (0.008, 1)}


@pytest.mark.parametrize("with_device", [True, False])
def test_a_launch_without_its_runtime_record_is_glue(with_device):
    """An activity whose launch the trace cannot place goes to None."""
    events = [_span("median", 0, 10), _kernel(100, 2, 9)]
    if with_device:
        events.append(_span("median", 50, 5, "gpu_user_annotation"))
    got = _by_stage(events, {"median"})
    assert got == {None: (0.002, 1)}
