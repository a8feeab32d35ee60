"""Wavefront band driver for the ASW method: bands without halo recompute;
PyTorch port of `stereo_matchin_tpu/models/wavefront.py`.

The halo band driver (models/tiled.py) recomputes the whole vertical
influence halo, (r + k + 1)*R + 1 rows per side.  But each level of the
aggregation ladder (one vertical and one horizontal pass) reaches exactly
R rows, so band b can hand band b + 1

  * a 2R-row strip of every intermediate level's output (levels 1..r-1),
  * a 2*keep-row strip of the aggregated volume (keep = k*R + 1, the
    reach of everything after the aggregation),

and every aggregation row is computed exactly once over the frame.

Band layout (kept rows [s, e), N = e - s, lo_i = s + keep + (r - i)*R):

  level i output     [lo_i, lo_i + N)
  level i input      [lo_i - R, lo_i + N + R): the previous band's 2R-row
                     strip of level i-1, then this band's level i-1 rows
  level r            [s + keep, e + keep), after the previous band's
                     2*keep strip: the aggregated rows [s - keep, e + keep)

The first band runs the plain ladder from the frame top (there is nothing
above it to reuse) and captures the strips.  Rows at or past the frame
bottom H are never computed: where a window reaches them it reads copies
of row H - 1, the clamp of the whole-frame passes.  Each output row is the
same kernel expression over the same input rows as in the whole frame, so
the maps are EQUAL to the whole-frame maps (pinned by
tests/test_torch_bands_asw.py).

Every level of an interior band is the windowed vertical pass (K2
`asw_pass_win` on CUDA) over [strip ; rows of the level below], then K2's
horizontal pass, per disparity chunk (cfg.aggr_d_chunks).  The JAX
package's padded lanes and its full-extent ladder over garbage rows are
not ported: they answer TPU costs.

Each band runs as one step (`_first_band`, `_mid_band`, `_last_band`: its
weights, its ladder, asw_postaggregate and the cut to its kept rows)
through a stage runner `run(name, fn, *args)`, with cfg and the band's
canonical geometry (`_canon`) as its static arguments: on CUDA tensors
utils.replay_stage replays each step from a CUDA graph, as the JAX
package jits its band steps, and the interior bands of a lane-aligned
plan share one graph; utils.call_stage runs the steps eagerly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..config import StereoConfig
from .. import ops
from ..kernels import use_kernels
from ..utils import graphs
from . import asw as asw_mod


@dataclass(frozen=True)
class _Geom:
    """Geometry of one band, in frame rows."""
    s: int       # first kept row
    e: int       # one past the last kept row
    g0: int      # image slice start
    g1: int      # image slice end
    H: int       # frame height
    first: bool
    last: bool


def _keep(cfg: StereoConfig) -> int:
    return cfg.k_iters * cfg.radius + 1


def _canon(g: _Geom) -> _Geom:
    """A band's geometry translated to slice-local rows: the static key of
    its band step (the JAX package's _canon).

    A band step is translation-invariant: every row index it computes is a
    difference of geometry fields, so stepping at the canonical form gives
    the same bits, and equal-shape bands share one CUDA graph (the stage
    runner keys a step by its static arguments' values): with the
    lane-aligned plan every interior band replays the first interior
    band's graph.  Where the slice bottom is not clamped (g1 < H) the
    frame height folds down to g1: no window row reaches past g1 (g1 = e +
    keep + r*R covers the deepest ladder read), so every frame-bottom
    comparison is equal-false either way; the frame-top arm of each test
    is unreachable on a non-first band (plan_bands keeps s - keep - R >=
    0).  The first band starts at row 0 and is its own canonical form."""
    if g.first:
        return g
    o = g.g0
    H = (g.g1 if g.g1 < g.H else g.H) - o
    return _Geom(g.s - o, g.e - o, 0, g.g1 - o, H, g.first, g.last)


def plan_bands(H: int, num_bands: int, cfg: StereoConfig, align: int = 128):
    """Band geometries, or None where the strip layout does not hold (bands
    too short for the strips).  The same cuts as the JAX package's
    plan_bands: band boundaries snap to multiples of `align` where the
    constraints allow, else the bands split evenly.  Where a band is cut
    never changes a value."""
    R, r, keep = cfg.radius, cfg.r_iters, _keep(cfg)
    if num_bands < 2 or H < 2 * num_bands:
        return None
    band = math.ceil(H / num_bands)
    # N >= 2*keep: the aggregated strip comes from this band's level-r
    # rows.  N >= keep + (r-1)*R + 1: every level window starts at a real
    # row (lo_1 <= H-1).
    n_min = max(2 * keep, keep + (r - 1) * R + 1, 2 * R)

    def build(edges):
        geoms = []
        for i in range(len(edges) - 1):
            s, e = edges[i], edges[i + 1]
            first, last = i == 0, i == len(edges) - 2
            if not first and (e - s < n_min or s - keep - R < 0):
                return None
            if not last and e + keep > H:
                return None
            g0 = 0 if first else s - keep - R
            g1 = min(H, e + keep + r * R)
            geoms.append(_Geom(s, e, g0, g1, H, first, last))
        return geoms if len(geoms) >= 2 else None

    for step in (band // align * align, -(-band // align) * align):
        if step < max(align, n_min):
            continue
        edges = sorted({min(i * step, H) for i in range(num_bands)} | {H})
        if any(b - a > band + align for a, b in zip(edges, edges[1:])):
            continue
        geoms = build(edges)
        if geoms:
            return geoms
    return build(list(range(0, H, band)) + [H])


def wavefront_supported(left_shape, cfg: StereoConfig, num_bands: int) -> bool:
    return plan_bands(left_shape[0], num_bands, cfg) is not None


def _rows(x: torch.Tensor, x0: int, a: int, b: int) -> torch.Tensor:
    """Frame rows [a, b) of x (C, n, W), whose row 0 is frame row x0; rows
    past x's last row are copies of it (the frame-bottom clamp)."""
    n = x.shape[1]
    real = x[:, a - x0:min(b, x0 + n) - x0]
    if b > x0 + n:
        real = ops.edge_pad(real, 0, b - x0 - n, 1)
    return real


def _passes(cfg: StereoConfig, tensor):
    """(asw_den, asw_pass, asw_pass_win) of the route cfg.kernels picks."""
    if use_kernels(cfg.kernels, tensor):
        from ..kernels.asw_aggregation import asw_den, asw_pass, asw_pass_win

        return asw_den, asw_pass, asw_pass_win
    return ops.asw_den_plain, ops.asw_pass_plain, ops.asw_pass_win_plain


def _first_aggregate(l, r, w, cfg: StereoConfig, g: _Geom):
    """The plain ladder over the slice [0, g1) (models.asw.ladder_levels),
    capturing the strips for the next band: level j's rows [hi_j - 2R,
    hi_j), hi_j = e + keep + (r - j)*R, and the aggregated rows [e - keep,
    e + keep).  Returns (aggregated rows [0, e + keep), strips, astrip)."""
    R, D, r_it = cfg.radius, cfg.num_disp, cfg.r_iters
    keep, e = _keep(cfg), g.e
    W = l.shape[1]
    opts = dict(dtype=torch.float32, device=l.device)
    acc = torch.empty((D, e + keep, W), **opts)
    strips = torch.empty((r_it - 1, D, 2 * R, W), **opts)
    astrip = torch.empty((D, 2 * keep, W), **opts)
    for d0, j, c in asw_mod.ladder_levels(l, r, w, cfg):
        n = c.shape[0]
        if 0 < j < r_it:
            hi = e + keep + (r_it - j) * R
            strips[j - 1, d0:d0 + n] = _rows(c, 0, hi - 2 * R, hi)
        elif j == r_it:
            acc[d0:d0 + n] = c[:, :e + keep]
            astrip[d0:d0 + n] = c[:, e - keep:e + keep]
        del c                                # see asw.ladder_levels
    return acc, strips, astrip


def _wave_aggregate(l, r, w, strips_in, astrip_in, cfg: StereoConfig,
                    g: _Geom):
    """The ladder of an interior or last band over the slice [g0, g1).
    Level i computes its real rows [lo_i, min(lo_i + N, H)) as the
    windowed vertical pass over [previous band's level i-1 strip ; this
    band's level i-1 rows] (level 0, the SAD cost, is computed over its
    whole window), then the horizontal pass.  Returns (aggregated rows
    [s - keep, min(e + keep, H)), strips, astrip); the last band emits no
    strips."""
    R, D, r_it, eps = cfg.radius, cfg.num_disp, cfg.r_iters, cfg.eps
    keep = _keep(cfg)
    s, e, g0, g1, H = g.s, g.e, g.g0, g.g1, g.H
    N, W = e - s, l.shape[1]
    asw_den, asw_pass, asw_pass_win = _passes(cfg, l)
    chunk, _ = asw_mod._chunk_geometry(D, cfg.aggr_d_chunks)
    lo = {i: s + keep + (r_it - i) * R for i in range(1, r_it + 1)}
    n_real = {i: min(lo[i] + N, H) - lo[i] for i in lo}
    # The rows every level's output covers, and their weight strips.
    E0, E1 = lo[r_it], lo[1] + n_real[1]
    wv_l, wv_r, wh_l, wh_r = (x[:, E0 - g0:E1 - g0].contiguous() for x in (
        w.wv_l, w.wv_r, w.wh_l, w.wh_r))
    # Level 0: the SAD cost over level 1's input window, from the images.
    c0, c1 = lo[1] - R, lo[1] + n_real[1] + R
    l0, r0 = (x[c0 - g0:min(c1, g1) - g0] for x in (l, r))

    def level_rows(x, i):                # rows [lo_i, lo_i + n_i) of an E array
        return x[:, lo[i] - E0:lo[i] - E0 + n_real[i]].contiguous()

    opts = dict(dtype=torch.float32, device=l.device)
    # The aggregated rows: the previous band's strip, then level r's rows.
    acc = torch.empty((D, 2 * keep + n_real[r_it], W), **opts)
    acc[:, :2 * keep] = astrip_in
    emit = not g.last
    if emit:
        strips = torch.empty((r_it - 1, D, 2 * R, W), **opts)
        astrip = torch.empty((D, 2 * keep, W), **opts)
    else:
        strips = astrip = None
    for d0 in range(0, D, chunk):
        n = min(chunk, D - d0)
        den_v = asw_den(wv_l, wv_r, eps, d0, n)
        den_h = asw_den(wh_l, wh_r, eps, d0, n)
        prev = _rows(ops.sad_cost(l0, r0, n, 255.0, d0, cfg.kernels), c0, c0,
                     c1)
        for i in range(1, r_it + 1):
            hi = lo[i] + n_real[i] + R
            if i == 1:
                win = prev
            else:
                win = torch.cat([strips_in[i - 2, d0:d0 + n],
                                 _rows(prev, lo[i - 1], lo[i] + R, hi)], dim=1)
            v = asw_pass_win(win.contiguous(), level_rows(wv_l, i),
                             level_rows(wv_r, i), level_rows(den_v, i), eps,
                             d0)
            prev = asw_pass(v, level_rows(wh_l, i), level_rows(wh_r, i),
                            level_rows(den_h, i), eps, 2, d0)
            if emit and i < r_it:
                top = lo[i] + N              # = the next band's lo_{i+1} + R
                strips[i - 1, d0:d0 + n] = _rows(prev, lo[i], top - 2 * R, top)
        acc[d0:d0 + n, 2 * keep:] = prev
        if emit:
            astrip[d0:d0 + n] = _rows(prev, lo[r_it], e - keep, e + keep)
    return acc, strips, astrip


def _tail(aggr, w, cfg: StereoConfig, g: _Geom):
    """asw_postaggregate over a band's aggregated rows [lo, hi), cut to its
    kept rows [s, e): (disparity, filled)."""
    keep = _keep(cfg)
    lo = 0 if g.first else g.s - keep
    hi = min(g.e + keep, g.H)
    res = asw_mod.asw_postaggregate(aggr, w, cfg, (lo - g.g0, g.g1 - hi))
    off = g.s - lo
    return (res.disparity[off:off + g.e - g.s],
            res.filled[off:off + g.e - g.s])


def _first_band(l, r, cfg: StereoConfig, g: _Geom):
    """The first band, from its image slice [0, g1): (disparity, filled) of
    its kept rows and the strips it hands the next band."""
    w = asw_mod.asw_weights(l, r, cfg)
    aggr, strips, astrip = _first_aggregate(l, r, w, cfg, g)
    return (*_tail(aggr, w, cfg, g), strips, astrip)


def _mid_band(l, r, strips, astrip, cfg: StereoConfig, g: _Geom):
    """An interior band, from its image slice [g0, g1) and the strips of
    the band above: (disparity, filled) of its kept rows and the strips it
    hands the next band (None for the last band)."""
    w = asw_mod.asw_weights(l, r, cfg)
    aggr, strips, astrip = _wave_aggregate(l, r, w, strips, astrip, cfg, g)
    return (*_tail(aggr, w, cfg, g), strips, astrip)


def _last_band(l, r, strips, astrip, cfg: StereoConfig, g: _Geom):
    """The last band: _mid_band, whose strips come back None (g.last)."""
    return _mid_band(l, r, strips, astrip, cfg, g)


def asw_pipeline_wavefront(left, right, cfg: StereoConfig, num_bands: int,
                           align: int = 128, run=graphs.replay_stage):
    """Banded ASW run with the strip carry; returns (disparity, filled),
    equal to the whole-frame asw_pipeline's maps.  Each band step computes
    its weights from its own image slice (models.asw.asw_weights) and runs
    through run(name, step, *args) with its canonical geometry: by
    default replayed from a CUDA graph on CUDA tensors (the frame holds
    its band graphs, utils.graphs), eagerly with utils.call_stage."""
    H = left.shape[0]
    geoms = plan_bands(H, num_bands, cfg, align)
    if geoms is None:
        raise ValueError(
            f"wavefront band layout unsupported at H={H}, "
            f"num_bands={num_bands} (bands shorter than the strip "
            f"windows); use models.tiled.asw_pipeline_tiled")
    asw_mod._check_pair(left, right)
    pieces = []
    strips = astrip = None
    with graphs.STAGES.hold():
        for g in geoms:
            l, r = left[g.g0:g.g1], right[g.g0:g.g1]
            if g.first:
                out = run("first_band", _first_band, l, r, cfg, _canon(g))
            elif g.last:
                out = run("last_band", _last_band, l, r, strips, astrip, cfg,
                          _canon(g))
            else:
                out = run("mid_band", _mid_band, l, r, strips, astrip, cfg,
                          _canon(g))
            disparity, filled, strips, astrip = out
            pieces.append((disparity, filled))
    return (torch.cat([p[0] for p in pieces], dim=0),
            torch.cat([p[1] for p in pieces], dim=0))
