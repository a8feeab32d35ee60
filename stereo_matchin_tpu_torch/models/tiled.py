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
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..config import StereoConfig
from . import asw as asw_mod
from . import cross_based as cross_mod


def asw_reach(cfg: StereoConfig) -> int:
    return (cfg.r_iters + cfg.k_iters + 1) * cfg.radius + 1


def cross_reach(cfg: StereoConfig) -> int:
    return 3 * cfg.arm_len + 4


#: The ASW memory plan, in cost-volume rows (D * W * 4 bytes each), from
#: torch.cuda.max_memory_allocated() at BASELINE config 3 (2880 x 1988,
#: d_max 279, radius 16, r 7, k 6, aggr_d_chunks 4) on an NVIDIA H100 80GB
#: HBM3 (PERF.md section 5).  The whole frame peaked at 3.24 volume rows
#: per row.  The wavefront's interior bands peaked at 2751 and 3318 volume
#: rows with 256 and 384 kept rows: 4.43 per kept row on a fixed 365 rows
#: (1.62 reaches: strips, windows and the postaggregate's 2*keep extra
#: rows); halo bands lie below that line.  The plan rounds them up.  At
#: config 3 the volumes outweigh the 2*radius + 1 tap weight strips; a
#: config with few disparities against its taps is outside what was
#: measured.  The JAX package's 10.5 volumes per row was XLA's plan on a
#: TPU.
_ASW_ROW_VOLUMES = 3.3           # whole frame, per row
_ASW_BAND_ROW_VOLUMES = 4.5      # band, per kept row
_ASW_BAND_REACHES = 1.7          # band, fixed, in asw_reach rows


def asw_plan_bytes(rows: int, width: int, cfg: StereoConfig,
                   banded: bool) -> float:
    """Planned peak device memory of an ASW frame of `rows` rows, or of a
    band of `rows` kept rows (banded=True)."""
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


def _run_banded(run_band: Callable, left, right, reach: int, num_bands: int,
                band_crop: Callable = None):
    """Generic band loop.  run_band(left_slice, right_slice, crop) -> dict of
    (rows, W) maps; band_crop(halo_top, halo_bot) -> rows the pipeline
    itself sheds from each side mid-run ((0, 0) when None).  Returns the
    dict of whole-frame maps."""
    H = left.shape[0]
    band = math.ceil(H / num_bands)
    pieces = []
    for b in range(num_bands):
        y0, y1 = b * band, min(H, (b + 1) * band)
        if y0 >= y1:
            break
        lo, hi = max(0, y0 - reach), min(H, y1 + reach)
        crop = band_crop(y0 - lo, hi - y1) if band_crop else (0, 0)
        out = run_band(left[lo:hi], right[lo:hi], crop)
        off = y0 - lo - crop[0]
        pieces.append({k: v[off:off + (y1 - y0)] for k, v in out.items()})
    return {k: torch.cat([p[k] for p in pieces], dim=0) for k in pieces[0]}


def asw_pipeline_tiled(left, right, cfg: StereoConfig, num_bands: int,
                       wavefront: str | bool = "auto"):
    """Banded ASW run; returns (disparity, filled), equal to the whole-frame
    asw_pipeline's maps.

    wavefront: "auto" routes to the strip-carrying driver
    (models/wavefront.py, no halo recompute) whenever its band layout
    holds; True forces it (raising where it does not); False forces the
    halo-recompute band loop below."""
    if wavefront not in ("auto", True, False):
        raise ValueError(f"wavefront must be 'auto', True or False, got "
                         f"{wavefront!r}")
    if wavefront in ("auto", True):
        from . import wavefront as wf

        if wf.wavefront_supported(left.shape, cfg, num_bands):
            return wf.asw_pipeline_wavefront(left, right, cfg, num_bands)
        if wavefront is True:
            raise ValueError(
                "wavefront=True but the wavefront band layout is "
                "unsupported at this geometry/config")
    reach = asw_reach(cfg)
    # The aggregation needs the whole halo; everything after it reaches
    # only k*radius + 1 rows, so each band sheds the rest right after the
    # aggregation (asw_pipeline's crop).  The bands run eagerly: a captured
    # graph per band shape would hold the first, middle and last bands'
    # peaks at once, the memory the bands exist to bound.
    keep = cfg.k_iters * cfg.radius + 1

    def run_band(l, r, crop):
        res = asw_mod.asw_pipeline_impl(l, r, cfg, crop)
        return {"disparity": res.disparity, "filled": res.filled}

    def band_crop(h_top, h_bot):
        return max(0, h_top - keep), max(0, h_bot - keep)

    out = _run_banded(run_band, left, right, reach, num_bands, band_crop)
    return out["disparity"], out["filled"]


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


def cross_pipeline_tiled(left, right, cfg: StereoConfig, num_bands: int,
                         wavefront: str | bool = "auto"):
    """Banded cross-method run; returns (initial, final), equal to the
    whole-frame cross_pipeline's maps with a translation-invariant OII
    route (see translation_invariant).

    wavefront: "auto" routes to the strip-carrying driver
    (models/wavefront_cross.py) whenever the band geometry supports the
    strips; True forces it; False forces the halo-recompute band loop."""
    if wavefront not in ("auto", True, False):
        raise ValueError(f"wavefront must be 'auto', True or False, got "
                         f"{wavefront!r}")
    cfg = translation_invariant(cfg, left)
    if wavefront in ("auto", True):
        from . import wavefront_cross as wfc

        if wfc.cross_wavefront_supported(left.shape, cfg, num_bands):
            return wfc.cross_pipeline_wavefront(left, right, cfg, num_bands)
        if wavefront is True:
            raise ValueError(
                "wavefront=True but the cross wavefront band layout is "
                "unsupported at this geometry/config")

    def run_band(l, r, crop):                  # eager, as the ASW bands
        res = cross_mod.cross_pipeline_impl(l, r, cfg)
        return {"initial": res.initial, "final": res.final}

    out = _run_banded(run_band, left, right, cross_reach(cfg), num_bands)
    return out["initial"], out["final"]
