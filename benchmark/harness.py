"""One run of one cell: set-up, a measured window of frames, the check
against the plain reference, and the result line.

Everything that belongs to a configuration, a traffic mix or a metric is
data found by name (`benchmark/README.md`):

  * BENCHMARK.json's `workloads` entry names the configuration and the
    traffic mix; its `configs` entry names the configuration's file;
  * the configuration's file names the program's entry, its parameters,
    the map a user keeps, the maps compared with which reference
    (`benchmark/reference/<reference>.py`) and each one's limit;
  * `benchmark/traffic/<traffic>.json` holds the frame sizes, d_max, the
    memory plan and the pairs;
  * `benchmark/metrics/<metric>.py` reads one metric from the run.

The window is a closed loop with one frame in flight: take the next pair
of the pool (all resident on the device), call the captured entry, copy
the kept map to the host (into a pinned buffer of its size made in
set-up, so the window allocates no host memory either).  Set-up is process start to the first timed
frame; it ends with one first call (warm-up and capture) and one replay
of each of the cell's signatures.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import pathlib
import random
import statistics
import subprocess
import sys
import time
import types
from typing import NamedTuple

import torch

from . import scene
from .tracing import Tracer, busy_us, idle_gaps, top_ops, window_us

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Top-level modules a run may not hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "stereo_matchin_tpu")
TRACE_SECONDS = 3.0


class Cell(NamedTuple):
    name: str
    workload: dict
    config: dict
    traffic: dict
    metrics: list       # manifest entries of the metrics the run reports
    root: pathlib.Path


class Frame(NamedTuple):
    pair: int
    size: tuple         # (H, W)
    d_max: int
    t_call: float       # host clock at the entry call
    t_return: float     # the entry returned (the replay is enqueued)
    t_host: float       # the kept map is on the host


class Run(NamedTuple):
    """What a metric's reader is given."""
    cell: Cell
    params: types.SimpleNamespace   # the method's parameters
    frames: list                    # Frame of each frame of the window
    window_s: float
    setup_s: float
    peak_reserved_bytes: int
    trace: object                   # tracing.Trace of the stretch, or None


def _one(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_manifest(root=ROOT) -> dict:
    return json.loads((pathlib.Path(root) / "BENCHMARK.json").read_text())


def reported_metrics(manifest: dict, cell: str, trace: bool) -> list:
    """The metrics a run of `cell` reports: end-to-end ones with
    --trace 0, per-layer ones with --trace 1.  A metric without a
    `workloads` key goes to every cell (a per-layer one: every cell that
    reports the end-to-end metric it moves)."""
    e2e = [m["name"] for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return [m for m in manifest["end_to_end"] if m["name"] in e2e]
    return [m for m in manifest["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in e2e else [])]


def load_cell(name: str, trace: bool = False, root=ROOT) -> Cell:
    root = pathlib.Path(root)
    manifest = load_manifest(root)
    wl = _one(manifest["workloads"], name, "workload")
    entry = _one(manifest["configs"], wl["config"], "config")
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (root / "benchmark" / "traffic" / f"{wl['traffic']}.json").read_text())
    return Cell(name, wl, config, traffic,
                reported_metrics(manifest, name, trace), root)


def load_reader(root, name: str):
    """`read(run)` of benchmark/metrics/<name>.py."""
    path = pathlib.Path(root) / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def resolve(ref: str):
    """"package.module:attr" -> the attribute."""
    mod, _, attr = ref.partition(":")
    return getattr(importlib.import_module(mod), attr)


def params_of(cell: Cell) -> dict:
    """The method's parameters: the configuration's, with the traffic's
    disparity range and memory plan."""
    p = dict(cell.config["params"])
    p["d_max"] = cell.traffic["d_max"]
    p["aggr_d_chunks"] = cell.traffic.get("aggr_d_chunks", 0)
    return p


class Sampler:
    """The frames whose maps are checked: `k` of each frame size, drawn
    uniformly over the window's frames of that size (reservoir sampling
    seeded by the run's seed).  A sampled frame's compared maps are copied
    into buffers made in set-up, so the window allocates nothing and the
    caching allocator's blocks stay as the first calls left them."""

    def __init__(self, seed: int, k: int, fields):
        self.rng = random.Random(seed)
        self.k, self.fields = k, tuple(fields)
        self.seen, self.kept, self.buffers = {}, {}, {}
        self.pool = None

    def reserve(self, size, result) -> None:
        """Buffers for `k` frames of `size`, shaped as `result`'s maps.  On
        the card they come from a pool of their own: carved from the
        caching allocator's free blocks they could split a block the next
        frame's results would have reused, and grow the reserved peak."""
        maps = [getattr(result, f) for f in self.fields]
        pool = contextlib.nullcontext()
        if maps[0].is_cuda:
            if self.pool is None:
                self.pool = torch.cuda.MemPool()
            pool = torch.cuda.use_mem_pool(self.pool)
        with pool:
            self.buffers[size] = [{f: torch.empty_like(m) for f, m in
                                   zip(self.fields, maps)}
                                  for _ in range(self.k)]

    def offer(self, frame_no: int, frame: Frame, result) -> None:
        size = frame.size
        i = self.seen.get(size, 0)
        self.seen[size] = i + 1
        j = i if i < self.k else self.rng.randrange(i + 1)
        if j < self.k:
            maps = self.buffers[size][j]
            for f in self.fields:
                maps[f].copy_(getattr(result, f))
            self.kept.setdefault(size, {})[j] = (frame_no, frame.pair, maps)

    def samples(self) -> list:
        return sorted(s for slots in self.kept.values()
                      for s in slots.values())


def differing_pixels(got: torch.Tensor, want: torch.Tensor) -> int:
    """Pixels of an (H, W) or (H, W, C) map whose values differ (a NaN
    differs from everything); a map of the wrong shape differs at all."""
    if tuple(got.shape) != tuple(want.shape):
        return int(want.shape[0] * want.shape[1])
    diff = got.to(want.device) != want
    if diff.dim() == 3:
        diff = diff.any(dim=-1)
    return int(diff.sum())


def check(cell: Cell, pairs, samples, params, dtype=torch.float32) -> dict:
    """{name: (number, limit)} over the sampled frames: per compared map,
    the pixels that differ from the reference's, summed."""
    ref = importlib.import_module(
        f"benchmark.reference.{cell.config['reference']}")
    limits = cell.config["check"]
    counts = dict.fromkeys(limits, 0)
    cache = {}
    for _, pair, maps in samples:
        if pair not in cache:
            p = pairs[pair]
            cache.clear()
            cache[pair] = ref.frame(p.left, p.right, params, dtype)
        for field in limits:
            counts[field] += differing_pixels(maps[field], cache[pair][field])
    return {f"{f}_diff_px": (counts[f], limits[f]) for f in limits}


def card_name(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    return torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0


def _pinned_like(t: torch.Tensor) -> torch.Tensor:
    """A host buffer for `t`, pinned where `t` lies on the card."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float) -> dict:
    """Set-up, window, check on `device`: the result's fields, the
    set-up's split under "setup" (without the import check, which
    `main` makes)."""
    cfg_file, traffic = cell.config, cell.traffic
    split = {"imports_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.set_device(device)
        torch.empty(1, device=device)
    split["cuda_init_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if device.type == "cuda" and cfg_file.get("prepare"):
        resolve(cfg_file["prepare"])()
    split["library_s"] = time.perf_counter() - t

    params = params_of(cell)
    stereo = resolve(cfg_file["config_class"])(**params)
    entry = resolve(cfg_file["entry"])
    map_key = cfg_file["map"]
    sizes = [tuple(s) for s in traffic["sizes"]]
    t = time.perf_counter()
    pairs = scene.make_pairs(seed, sizes, traffic["pairs_per_size"],
                             traffic["d_max"], device, traffic["scene"])
    _sync(device)
    split["pairs_s"] = time.perf_counter() - t

    # One first call (warm-up and capture) and one replay per signature.
    t = time.perf_counter()
    peak = _peak(device)
    # No result of a call may live on into the next: the caching
    # allocator would then give the next call's clones other blocks than
    # the window's frames find, and the reserved peak would grow by a
    # frame's results (6.6 GB at Middlebury full size).
    sampler = Sampler(seed, traffic["check_frames"], cfg_file["check"])
    host = {}
    for size in sizes:
        first = next(p for p in pairs if tuple(p.left.shape[:2]) == size)
        for _ in range(2):
            peak = max(peak, _peak(device))
            res = entry(first.left, first.right, stereo)
            if size not in host:
                host[size] = _pinned_like(getattr(res, map_key))
                sampler.reserve(size, res)
            host[size].copy_(getattr(res, map_key))
            res = None
    _sync(device)
    split["first_calls_s"] = time.perf_counter() - t

    tracer = None
    if trace:
        # The profiler starts (CUPTI's set-up) before the window; its
        # first recorded frame is left out of the stretch, and the frames
        # after the stretch run untraced.
        tracer = Tracer(min(TRACE_SECONDS, seconds / 4))
        tracer.start()
    frames = []
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    dm = traffic["d_max"]
    while True:
        i = len(frames)
        p = pairs[i % len(pairs)]
        size = tuple(p.left.shape[:2])
        if tracer:
            tracer.before_frame(i, size)
        t0 = time.perf_counter()
        res = entry(p.left, p.right, stereo)
        t1 = time.perf_counter()
        host[size].copy_(getattr(res, map_key))
        t2 = time.perf_counter()
        frames.append(Frame(i % len(pairs), size, dm, t0, t1, t2))
        sampler.offer(i, frames[-1], res)
        res = None
        if tracer:
            tracer.after_frame()
        if t2 - t_window >= seconds:
            break
    window_s = frames[-1].t_host - t_window
    peak = max(peak, _peak(device))
    tr = tracer.read() if tracer else None

    # The check: the program's state freed, the reference on the sampled
    # frames' own pairs.
    resolve(cfg_file["release"])()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = check(cell, pairs, sampler.samples(), types.SimpleNamespace(
        **params), getattr(torch, cfg_file["precision"]))
    check_s = time.perf_counter() - t

    run = Run(cell, types.SimpleNamespace(**params), frames, window_s,
              setup_s, peak, tr)
    metrics = {}
    for m in cell.metrics:
        value = load_reader(cell.root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": card_name(device), "count": cell.workload["chips"],
           "memory_peak_bytes": peak}
    out = {"correct": all(n <= lim for n, lim in checks.values()),
           "attempted": len(frames), "failed": 0, "metrics": metrics,
           "device": dev}
    if tr is not None:
        dev["busy_s"] = busy_us(tr) / 1e6
        dev["window_s"] = window_us(tr) / 1e6
        out["breakdown"] = {"device_ops": top_ops(tr),
                            "idle_gaps": idle_gaps(tr)}
        # What the profiler costs a frame: the traced frames' median host
        # ms beside that of the frames after the stretch.
        end = tr.first + len(tr.frames)
        out["traced_frame_ms"] = {
            part: statistics.median((f.t_host - f.t_call) * 1e3 for f in fr)
            for part, fr in (("traced", frames[tr.first:end]),
                             ("after", frames[end:])) if fr}
    split["setup_s"] = setup_s
    out["setup"] = split
    ms = sorted((f.t_host - f.t_call) * 1e3 for f in frames)
    out["frame_ms"] = {q: ms[min(len(ms) - 1, int(x * len(ms)))] for q, x in
                       (("min", 0), ("p25", .25), ("p50", .5), ("p75", .75),
                        ("p95", .95), ("max", 1))}
    out["check_s"] = check_s
    out["frames_checked"] = len(sampler.samples())
    out["checks"] = {k: {"value": n, "limit": lim}
                     for k, (n, lim) in checks.items()}
    return out


def forbidden_modules(names=None) -> list:
    """Top-level names among `names` (default: sys.modules) that a run may
    not hold, compared whole (the port's name begins with the JAX
    package's)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(args, t_start: float) -> int:
    """One run on the card; the result as the last line of stdout."""
    cell = load_cell(args.workload, bool(args.trace))
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    out["card"] = power_limit()
    checks = out.pop("checks")
    out["checks"] = checks
    print(f"setup split: {json.dumps(out['setup'])}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr,
              flush=True)
    print(json.dumps(out), flush=True)
    return 0
