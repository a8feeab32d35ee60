"""Row-band drivers for frames whose cost volume is too big for one device;
PyTorch port of `stereo_matchin_tpu/models/tiled.py`.

Each band runs the ordinary single-frame pipeline over a slice of rows with
enough overlap that every kept row lies beyond the pipeline's vertical
influence radius from the cut, so the banded maps EQUAL the whole-frame
maps (pinned by tests/test_torch_bands_*.py).  The strip-carrying
wavefront drivers (models/wavefront.py, models/wavefront_cross.py) compute
every aggregation row once instead; `wavefront` routes between the two.

Influence radii (one side):
  ASW:   aggregation r passes x R  +  support reads R  +  refinement
         k passes x R  +  final median 1   ->  (r + k + 1) * R + 1
  cross: median 1 + arm reads (L+1) + OII vertical window L + vote
         vertical reach L + final median 1  ->  3L + 4

Bands run one after another on the device's stream.  PyTorch's caching
allocator reuses a freed block in stream order, so a band's workspace is
free for the next band as soon as the host drops it: no synchronize is
needed to bound the memory (measured on the card, PERF.md section 5).

Each halo band runs as one step (`_asw_band`, `_cross_halo_band`: the
eager chain over the band's slice, of which only the maps leave) through
a stage runner `run(name, fn, *args)`, with cfg and the band's crop as
its static arguments: on CUDA tensors utils.replay_stage replays each
step from a CUDA graph, as the JAX package jits its band step, and the
bands of one slice shape and crop share a graph; utils.call_stage runs
the steps eagerly.  The band graphs of a frame share the stage graphs'
pool and are held for the frame (the memory rule in utils/graphs.py), so
a captured banded frame holds about its largest band's peak.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..config import StereoConfig
from ..utils import graphs
from . import asw as asw_mod
from . import cross_based as cross_mod


def asw_reach(cfg: StereoConfig) -> int:
    return (cfg.r_iters + cfg.k_iters + 1) * cfg.radius + 1


def cross_reach(cfg: StereoConfig) -> int:
    return 3 * cfg.arm_len + 4


#: The ASW memory plan, in cost-volume rows (D * W * 4 bytes each), of a
#: frame or band run as the entries run them on the card: captured as CUDA
#: graphs.  Measured as the peak of torch.cuda.max_memory_reserved() over
#: a first call, where the captures happen, and over a replay, at BASELINE
#: config 3 (2880 x 1988, d_max 279, radius 16, r 7, k 6, aggr_d_chunks 4)
#: on an NVIDIA H100 80GB HBM3 (PERF.md, sections 5 and 6).  The captured
#: whole frame peaked at 26.91 GB, 4.20 volume rows per row: its pool and
#: the clone of its result, the aggregated volume among them.  A captured
#: banded frame holds one pool for its band graphs (about its largest
#: band's peak, which eager bands reach at 4.43 volume rows per kept row
#: on a fixed 1.62 reaches); a band's first call warms up inside that
#: pool, so no second band's worth lies beside it.  First calls peaked at
#: 15.39, 11.49 and 12.91 GB for 5 wavefront, 5 halo and 8 wavefront
#: bands, replays at 16.04, 11.53 and 13.55 GB: at most 6.27 and 6.58
#: volume rows per (largest band's kept rows + 1.7 reaches).  The plan
#: rounds them up, so auto_bands picks no band count whose captured frame
#: does not fit.  At config 3 the volumes outweigh the 2*radius + 1 tap
#: weight strips; a config with few disparities against its taps is
#: outside what was measured.  The JAX package's 10.5 volumes per row was
#: XLA's plan on a TPU.
_ASW_ROW_VOLUMES = 4.6           # whole frame, per row
_ASW_BAND_ROW_VOLUMES = 7.0      # band, per (kept row + fixed rows)
_ASW_BAND_REACHES = 1.7          # band, fixed, in asw_reach rows


def asw_plan_bytes(rows: int, width: int, cfg: StereoConfig,
                   banded: bool) -> float:
    """Planned peak device memory of a captured ASW frame of `rows` rows,
    or of a captured banded frame whose largest band keeps `rows` rows
    (banded=True), its first call included."""
    if banded:
        volume_rows = _ASW_BAND_ROW_VOLUMES * (
            rows + _ASW_BAND_REACHES * asw_reach(cfg))
    else:
        volume_rows = _ASW_ROW_VOLUMES * rows
    return volume_rows * cfg.num_disp * width * 4


def _largest_band(H: int, num_bands: int, cfg: StereoConfig) -> int:
    """Kept rows of the largest band asw_pipeline_tiled runs."""
    from .wavefront import plan_bands

    geoms = plan_bands(H, num_bands, cfg)
    if geoms is None:
        return math.ceil(H / num_bands)
    return max(g.e - g.s for g in geoms)


def auto_bands(shape, cfg: StereoConfig, hbm_bytes: int | None = None,
               safety: float = 0.85, device="cuda") -> int:
    """Smallest ASW band count whose frame or largest band is planned
    (asw_plan_bytes) to fit in `safety * hbm_bytes`; 1 means no banding.
    `hbm_bytes` defaults to the memory of a CUDA `device`; the plan was
    measured on the card only, so elsewhere it returns 1 unless
    `hbm_bytes` is given.  A planning rule from measured peaks, not a
    guarantee."""
    H, W = shape[:2]
    if hbm_bytes is None:
        device = torch.device(device)
        if device.type != "cuda":
            return 1
        hbm_bytes = torch.cuda.get_device_properties(device).total_memory
    budget = safety * hbm_bytes
    if asw_plan_bytes(H, W, cfg, banded=False) <= budget:
        return 1
    for bands in range(2, H + 1):
        rows = _largest_band(H, bands, cfg)
        if asw_plan_bytes(rows, W, cfg, banded=True) <= budget:
            return bands
    raise ValueError(f"no band of a {H}x{W} frame at {cfg.num_disp} "
                     f"disparities is planned to fit in {budget:.3g} bytes")


def _run_banded(run, name: str, step: Callable, left, right, cfg, reach: int,
                num_bands: int, band_crop: Callable = None):
    """Generic band loop.  Each band's slice goes through run(name, step,
    l, r, cfg[, crop]) -> maps of its rows (a tuple); band_crop(halo_top,
    halo_bot) -> rows the step itself sheds from each side mid-run, passed
    as its crop (no crop when None).  Returns the tuple of whole-frame
    maps."""
    H = left.shape[0]
    band = math.ceil(H / num_bands)
    pieces = []
    with graphs.STAGES.hold():
        for b in range(num_bands):
            y0, y1 = b * band, min(H, (b + 1) * band)
            if y0 >= y1:
                break
            lo, hi = max(0, y0 - reach), min(H, y1 + reach)
            if band_crop:
                crop = band_crop(y0 - lo, hi - y1)
                maps = run(name, step, left[lo:hi], right[lo:hi], cfg, crop)
            else:
                crop = (0, 0)
                maps = run(name, step, left[lo:hi], right[lo:hi], cfg)
            off = y0 - lo - crop[0]
            pieces.append([m[off:off + (y1 - y0)] for m in maps])
    return tuple(torch.cat(p, dim=0) for p in zip(*pieces))


def _asw_band(l, r, cfg: StereoConfig, crop: tuple):
    """One halo band: asw_pipeline_impl over the slice with its crop, of
    which only (disparity, filled) leave (the JAX package's
    _asw_band_jit): the (D, H, W) volume stays inside the step."""
    res = asw_mod.asw_pipeline_impl(l, r, cfg, crop)
    return res.disparity, res.filled


def asw_pipeline_tiled(left, right, cfg: StereoConfig, num_bands: int,
                       wavefront: str | bool = "auto",
                       run=graphs.replay_stage):
    """Banded ASW run; returns (disparity, filled), equal to the whole-frame
    asw_pipeline's maps.

    wavefront: "auto" routes to the strip-carrying driver
    (models/wavefront.py, no halo recompute) whenever its band layout
    holds; True forces it (raising where it does not); False forces the
    halo-recompute band loop below.  run: the stage runner of the band
    steps, replaying CUDA graphs by default (utils.call_stage: eager)."""
    if wavefront not in ("auto", True, False):
        raise ValueError(f"wavefront must be 'auto', True or False, got "
                         f"{wavefront!r}")
    if wavefront in ("auto", True):
        from . import wavefront as wf

        if wf.wavefront_supported(left.shape, cfg, num_bands):
            return wf.asw_pipeline_wavefront(left, right, cfg, num_bands,
                                             run=run)
        if wavefront is True:
            raise ValueError(
                "wavefront=True but the wavefront band layout is "
                "unsupported at this geometry/config")
    # The aggregation needs the whole halo; everything after it reaches
    # only k*radius + 1 rows, so each band sheds the rest right after the
    # aggregation (asw_pipeline's crop).
    keep = cfg.k_iters * cfg.radius + 1

    def band_crop(h_top, h_bot):
        return max(0, h_top - keep), max(0, h_bot - keep)

    return _run_banded(run, "asw_band", _asw_band, left, right, cfg,
                       asw_reach(cfg), num_bands, band_crop)


def translation_invariant(cfg: StereoConfig, tensor) -> StereoConfig:
    """The band drivers need an OII sum whose value at a row does not
    depend on where the band starts: "prefix" (and "auto" on the CPU,
    which means "prefix" in the JAX package) become "taps" on the CPU and
    the kernels ("pallas") on CUDA."""
    if cfg.median_dispatch_quirk:
        raise ValueError(
            "median_dispatch_quirk models the reference's truncated "
            "full-frame Median dispatches (golden comparisons only) and is "
            "not meaningful per band; use cross_pipeline")
    if cfg.oii_impl in ("auto", "prefix"):
        impl = "pallas" if tensor.device.type == "cuda" else "taps"
        cfg = cfg.replace(oii_impl=impl)
    return cfg


def _cross_halo_band(l, r, cfg: StereoConfig):
    """One cross halo band: cross_pipeline_impl over the slice, of which
    only (initial, final) leave."""
    res = cross_mod.cross_pipeline_impl(l, r, cfg)
    return res.initial, res.final


def cross_pipeline_tiled(left, right, cfg: StereoConfig, num_bands: int,
                         wavefront: str | bool = "auto",
                         run=graphs.replay_stage):
    """Banded cross-method run; returns (initial, final), equal to the
    whole-frame cross_pipeline's maps with a translation-invariant OII
    route (see translation_invariant).

    wavefront: "auto" routes to the strip-carrying driver
    (models/wavefront_cross.py) whenever the band geometry supports the
    strips; True forces it; False forces the halo-recompute band loop.
    run: the stage runner of the band steps, replaying CUDA graphs by
    default (utils.call_stage: eager)."""
    if wavefront not in ("auto", True, False):
        raise ValueError(f"wavefront must be 'auto', True or False, got "
                         f"{wavefront!r}")
    cfg = translation_invariant(cfg, left)
    if wavefront in ("auto", True):
        from . import wavefront_cross as wfc

        if wfc.cross_wavefront_supported(left.shape, cfg, num_bands):
            return wfc.cross_pipeline_wavefront(left, right, cfg, num_bands,
                                                run=run)
        if wavefront is True:
            raise ValueError(
                "wavefront=True but the cross wavefront band layout is "
                "unsupported at this geometry/config")
    return _run_banded(run, "cross_band", _cross_halo_band, left, right, cfg,
                       cross_reach(cfg), num_bands)
