"""Per-stage benchmark harness reproducing the reference's timing report;
PyTorch port of `stereo_matchin_tpu/bench/harness.py`.

The reference writes a tab-separated file named after the device
(`main.cpp:166`), one header (`main.cpp:181`) and one row per run with
per-kernel event times and totals (`main.cpp:394-411,634-708`).  This
harness writes that artifact from the pipelines' own stages:
`time_cross_method` runs models.cross_based.cross_pipeline_staged and
`time_asw_method` runs models.asw.asw_weights + asw_pipeline_from_weights,
each with StageTimer.run as the stage runner, so a timed run computes and
launches exactly what one frame of the pipeline does.

  * cross method: medL_solo medR_solo med_full cross_h cross_v cross_full
    aggregation integral_h aggr_h integral_v aggr_v init_disp final_disp
    cross_method_total  (the taps order and K7 fold integral + window into
    one pass; the integral_* columns then read 0.000 and both passes land
    in aggr_h, keeping the totals comparable)
  * ASW method: aggr supp_w v_aggr_mean h_aggr_mean total_aggregation wta
    consistency v_ref_mean_L v_ref_mean_R h_ref_mean_L h_ref_mean_R
    wta_mean_LR consistency_mean total_refinement median total_wta_method
    (K1's two denominators are timed inside the first v_aggr and h_aggr,
    so total aggregation holds all of K1 and K2; the refinement strips
    are timed as "ref_w", outside the columns and the total, as the JAX
    harness leaves them untimed)

Timing.  On a CUDA device each stage replays its CUDA graph
(utils.graphs.STAGES, the port's counterpart of the JAX harness's stage
jits: captured on the first call of each stage signature, which is the
warm-up run of run_benchmark).  StageTimer records an event on the current
stream just before and just after the replay and reads the intervals
after one torch.cuda.synchronize() at the end of the method: it adds no
sync the pipeline lacks.  An interval holds the stage's kernels as the
card runs them from the graph, and any wait of the card for the host to
launch the graph.  It leaves out the copy of the stage's tensors into the
graph's static inputs, the clones of its outputs, and the glue ops
between stages (the UNORM8 conversions and red diagnostics, the
median-truncate quirk), which run eagerly outside every stage.  On the
CPU StageTimer reads time.perf_counter around fn itself.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List

import torch

from ..config import StereoConfig
from ..io import load_pair
from ..utils import graphs

# Column remapping vs the reference TSV: the reference's cross_h/cross_v
# are its horizontal/vertical cross kernels; here each _arms_stage call
# computes ALL FOUR arms of one image, so cross_h carries the LEFT image's
# arms and cross_v the RIGHT image's.  cross_full (their sum) and the
# method total remain directly comparable; the two sub-columns are not.
CROSS_COLUMNS = [
    "medL_solo", "medR_solo", "med_full", "cross_h", "cross_v", "cross_full",
    "aggregation", "integral_h", "aggr_h", "integral_v", "aggr_v",
    "init_disp", "final_disp", "cross method total",
]
ASW_COLUMNS = [
    "aggr", "supp_w", "v_aggr_mean", "h_aggr_mean", "total aggregation",
    "wta", "consistency", "v_ref_mean_L", "v_ref_mean_R", "h_ref_mean_L",
    "h_ref_mean_R", "wta_mean_LR", "consistency_mean", "total refinement",
    "median", "total WTA method",
]


class StageTimer:
    """Times named stages and accumulates them, in ms per call.

    A stage whose first tensor argument lies on a CUDA device replays its
    graph (graphs.STAGES) between two CUDA events on that device's current
    stream, read after one synchronize; any other stage runs fn under the
    host clock.  Each stage runs once, so a timed run launches what one
    frame launches.
    """

    def __init__(self):
        self._ms: Dict[str, float] = {}
        self._pending: list = []          # (name, start event, end event)

    def run(self, name: str, fn: Callable, *args):
        device = next((a.device for a in args if isinstance(a, torch.Tensor)),
                      None)
        if device is None or device.type != "cuda":
            t0 = time.perf_counter()
            out = fn(*args)
            self._add(name, (time.perf_counter() - t0) * 1000.0)
            return out
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        out = graphs.STAGES.call(name, fn, args, start, end)
        self._pending.append((name, start, end))
        return out

    def _add(self, name: str, ms: float) -> None:
        self._ms[name] = self._ms.get(name, 0.0) + ms

    @property
    def times(self) -> Dict[str, float]:
        """ms per stage name; on CUDA, one synchronize reads every event."""
        if self._pending:
            torch.cuda.synchronize()
            for name, start, end in self._pending:
                self._add(name, start.elapsed_time(end))
            self._pending.clear()
        return self._ms

    def ms(self, name: str) -> float:
        return self.times.get(name, 0.0)


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def cross_columns(ms: Dict[str, float]) -> Dict[str, float]:
    """The cross method's TSV columns from ms per stage name (a timed run's
    StageTimer.times, or any other reading of the same stages)."""
    times = dict(ms)
    times["med_full"] = times["medL_solo"] + times["medR_solo"]
    times["cross_full"] = times["cross_h"] + times["cross_v"]
    times["integral_h"] = 0.0   # folded into aggr_h by the taps order
    times["integral_v"] = 0.0
    times["aggr_v"] = 0.0
    times["cross method total"] = sum(
        times[k] for k in ("med_full", "cross_full", "aggregation", "aggr_h",
                           "init_disp", "final_disp"))
    return times


def asw_columns(ms: Dict[str, float], cfg: StereoConfig) -> Dict[str, float]:
    """The ASW method's TSV columns, and "ref_w", from ms per stage name."""
    r, k = max(cfg.r_iters, 1), max(cfg.k_iters, 1)
    t = {name: ms.get(name, 0.0) for name in (
        "aggr", "supp_w", "v_aggr", "h_aggr", "wta", "consistency", "v_ref_L",
        "v_ref_R", "h_ref_L", "h_ref_R", "wta_ref", "consistency_ref",
        "median", "ref_w")}
    times = {
        "aggr": t["aggr"],
        "supp_w": t["supp_w"],
        "v_aggr_mean": t["v_aggr"] / r,
        "h_aggr_mean": t["h_aggr"] / r,
        "total aggregation": t["v_aggr"] + t["h_aggr"],
        "wta": t["wta"],
        "consistency": t["consistency"],
        "v_ref_mean_L": t["v_ref_L"] / k,
        "v_ref_mean_R": t["v_ref_R"] / k,
        "h_ref_mean_L": t["h_ref_L"] / k,
        "h_ref_mean_R": t["h_ref_R"] / k,
        "wta_mean_LR": t["wta_ref"] / k,
        "consistency_mean": t["consistency_ref"] / k,
        "median": t["median"],
        "ref_w": t["ref_w"],
    }
    times["total refinement"] = (t["v_ref_L"] + t["v_ref_R"] + t["h_ref_L"] +
                                 t["h_ref_R"] + t["wta_ref"] +
                                 t["consistency_ref"])
    times["total WTA method"] = (times["aggr"] + times["supp_w"] +
                                 times["total aggregation"] + times["wta"] +
                                 times["consistency"] +
                                 times["total refinement"] + times["median"])
    return times


def time_cross_method(left, right, cfg: StereoConfig) -> Dict[str, float]:
    """One timed run of the cross pipeline, stage by stage."""
    from ..models.cross_based import cross_pipeline_staged

    t = StageTimer()
    cross_pipeline_staged(left, right, cfg, run=t.run)
    return cross_columns(t.times)


def time_asw_method(left, right, cfg: StereoConfig) -> Dict[str, float]:
    """One timed run of the ASW pipeline, stage by stage (the stages of
    models.asw.asw_pipeline)."""
    from ..models.asw import asw_pipeline_from_weights, asw_weights

    t = StageTimer()
    weights = asw_weights(left, right, cfg, run=t.run)
    asw_pipeline_from_weights(left, right, weights, cfg, run=t.run)
    return asw_columns(t.times, cfg)


def run_benchmark(pair_names: List, cfg: StereoConfig, runs: int = 10,
                  out_dir: str = "bench_out", device="cuda") -> str:
    """Full reference-style benchmark: all pairs x `runs`, one TSV named
    after the device.  pair_names: registered names or StereoPairs (a
    pics.txt's)."""
    device = torch.device(device)
    name = _device_name(device)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.tsv")
    with open(path, "w") as f:
        for pair in pair_names:
            label = pair if isinstance(pair, str) else pair.name
            left, right = (torch.from_numpy(a).to(device)
                           for a in load_pair(pair))
            f.write(f"\n{name} - {label}\n")
            f.write("id\t" + "\t".join(CROSS_COLUMNS) + "\t\t\t" +
                    "\t".join(ASW_COLUMNS) + "\n")
            # Warm-up run (not recorded; on the card it builds the
            # kernels), like the reference's separately reported first
            # iteration.
            time_cross_method(left, right, cfg)
            time_asw_method(left, right, cfg)
            for run in range(runs):
                ct = time_cross_method(left, right, cfg)
                at = time_asw_method(left, right, cfg)
                row = [f"Run {run + 1}"]
                row += [f"{ct[c]:.3f}" for c in CROSS_COLUMNS]
                row += ["", ""]
                row += [f"{at[c]:.3f}" for c in ASW_COLUMNS]
                f.write("\t".join(row) + "\n")
    return path
