"""Wavefront band driver for the cross-based method; PyTorch port of
`stereo_matchin_tpu/models/wavefront_cross.py`.

The halo band driver (models/tiled.cross_pipeline_tiled) recomputes a
3L+4-row halo of every stage per band side.  Here band b hands band b + 1
strips sized by each stage's own vertical reach, and every row of the
volume stages is computed once:

  * `temp` (the OII horizontal pass), 2L rows: the OII vertical pass
    reaches L rows (`oii_vcross.cl`);
  * `initial` (the WTA map), 2L rows: the vote reaches L rows
    (`disparity.cl`);
  * `voted`, 2 rows: the final median reaches 1 row.

The cheap per-pixel stages (median, arms, SAD cost) are recomputed from
the band's image slice.  Stage windows sit the reach of their consumers
below the kept rows (temp 2L+1, initial L+1, voted 1) and fit exactly.

Rows are anchored to the frame: the arm walk tests its bounds on frame
rows and the OII vertical pass drops frame row 0 (`row0`/`h_glob` of
cross_arms and oii_pass, K5 and K7 on CUDA), and rows past the frame
bottom H read copies of row H - 1 -- the reference's clamp reads, for the
vote's arms too.  The maps EQUAL the whole-frame cross_pipeline's with a
translation-invariant OII route (pinned by tests/test_torch_bands_cross.py).

Each band runs as one step (`_first_band_c`, `_mid_band_c`,
`_last_band_c` over `_cross_band`) through a stage runner `run(name, fn,
*args)`, with cfg and the band's canonical geometry (`_canon_c`) as its
static arguments and the carried strips as three tensor arguments: on
CUDA tensors utils.replay_stage replays each step from a CUDA graph, as
the JAX package jits its band steps, and the interior bands share one
graph; utils.call_stage runs the steps eagerly.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import StereoConfig
from .. import ops
from ..kernels import oii_route
from ..utils import graphs
from .wavefront import _Geom, _canon


class CrossStrips(NamedTuple):
    """The rows a band hands the next, just above each of its fresh
    windows."""
    temp: torch.Tensor       # (D, 2L, W) OII horizontal pass
    initial: torch.Tensor    # (2L, W) WTA map
    voted: torch.Tensor      # (2, W) vote


def plan_bands_cross(H: int, num_bands: int, cfg: StereoConfig):
    """Band geometries, or None when bands are too short for the strips
    (the temp/initial strips are the last 2L rows of this band's fresh
    windows, and every stage window must start at a real row).  The same
    cuts as the JAX package's plan_bands_cross."""
    L = cfg.arm_len
    if num_bands < 2 or H < 2 * num_bands:
        return None
    band = math.ceil(H / num_bands)
    n_min = 2 * L + 2
    edges = list(range(0, H, band)) + [H]
    geoms = []
    for i in range(len(edges) - 1):
        s, e = edges[i], edges[i + 1]
        first, last = i == 0, i == len(edges) - 2
        if not first and (e - s < n_min or s - 2 * L - 1 < 0):
            return None
        g0 = 0 if first else s - 2 * L - 1
        g1 = min(H, e + 3 * L + 3)
        geoms.append(_Geom(s, e, g0, g1, H, first, last))
    return geoms if len(geoms) >= 2 else None


def cross_wavefront_supported(left_shape, cfg: StereoConfig,
                              num_bands: int) -> bool:
    return plan_bands_cross(left_shape[0], num_bands, cfg) is not None


def _canon_c(g: _Geom) -> _Geom:
    """A band's geometry translated to slice-local rows: the static key of
    its band step (the JAX package's _canon_c; models.wavefront._canon).
    The step computes only differences of geometry fields, with the rows
    handed to the kernels (`row0`/`h_glob` of the arms and the OII
    vertical pass) anchored the same way, so equal-shape interior bands
    share one CUDA graph.  Where g1 is not clamped (g1 < H) the frame
    height folds to g1: the deepest read of any stage window is row e + 3L
    + 1 (arm walks below the temp window) < g1 = e + 3L + 3, so the bottom
    masks and clamps are equal either way, and the frame-top mask arm is
    unreachable from the kept rows (plan_bands_cross keeps s - 2L - 1 >=
    0)."""
    return _canon(g)


def _fix_bottom(x: torch.Tensor, first_virtual: int, axis: int = 0):
    """Rows at and past index `first_virtual` (the frame bottom) become
    copies of the row before it."""
    n = x.shape[axis] - first_virtual
    if n <= 0:
        return x
    return ops.edge_pad(x.narrow(axis, 0, first_virtual), 0, n, axis)


def _cross_band(l, r, strips, cfg: StereoConfig, g: _Geom):
    """One band.  l/r: image slice rows [g0, g1); strips: None for the
    first band, else the CrossStrips of the band above.  Returns the kept
    rows of (initial, final) and this band's CrossStrips (None for the
    last band)."""
    L, D, H = cfg.arm_len, cfg.num_disp, g.H
    s, e, g0, g1, first = g.s, g.e, g.g0, g.g1, g.first
    N, M = e - s, L + 1
    if oii_route(cfg.oii_impl, l) == "kernels":
        from ..kernels.cross_oii import cross_arms, oii_pass
        from ..kernels.sad_volume import sad_volume
    else:
        cross_arms, sad_volume = ops.cross_arms, ops.sad_cost_volume
        oii_pass = ops.oii_pass_plain

    # Fresh windows (frame rows) of each stage; the first band starts
    # every window at the frame top.
    t_lo = 0 if first else s + 2 * L + 1       # OII-h (temp)
    i_lo = 0 if first else s + L + 1           # OII-v + WTA (initial)
    v_lo = 0 if first else s + 1               # vote (voted)
    t_hi, i_hi, v_hi = e + 2 * L + 1, e + L + 1, e + 1
    a_lo, a_hi = (0 if first else s + 1 - L), t_hi     # arms

    # Rows past the frame bottom: edge-replicated images.
    need = e + 3 * L + 3
    lp, rp = (ops.edge_pad(x, 0, max(need - g1, 0), 0) for x in (l, r))
    ml, mr = ops.median3x3(lp, cfg.kernels), ops.median3x3(rp, cfg.kernels)

    def arms_of(m):
        """Arms of rows [a_lo, a_hi), walked with M rows of image margin
        (none above the frame top: the frame mask ends those walks)."""
        top = 0 if first else a_lo - M - g0
        a = cross_arms(m[top:a_hi - g0 + M].contiguous(), L, cfg.tau,
                       cfg.legacy_cross_arm_quirk, row0=top + g0, h_glob=H)
        return a[:, a_lo - g0 - top:a_hi - g0 - top]

    arms_l, arms_r = arms_of(ml), arms_of(mr)

    def arm_rows(arms, y0, y1):
        return arms[:, y0 - a_lo:y1 - a_lo].contiguous()

    # SAD cost and OII-h over the fresh temp window ([0, 1] scale).
    cost = sad_volume(ml[t_lo - g0:t_hi - g0].contiguous(),
                      mr[t_lo - g0:t_hi - g0].contiguous(), D)
    temp_fresh = oii_pass(cost, arm_rows(arms_l, t_lo, t_hi),
                          arm_rows(arms_r, t_lo, t_hi), L, 2)
    del cost
    # temp rows [i_lo - L, t_hi) (from the frame top for the first band).
    temp = temp_fresh if first else torch.cat([strips.temp, temp_fresh],
                                              dim=1)
    y_t = 0 if first else i_lo - L
    aggr = oii_pass(temp, arm_rows(arms_l, y_t, t_hi),
                    arm_rows(arms_r, y_t, t_hi), L, 1, row0=y_t, h_glob=H)
    aggr = aggr[:, i_lo - y_t:i_hi - y_t]
    initial_fresh = ops.disparity_to_image(ops.wta_argmin(aggr), cfg.d_max,
                                           cfg.quantize_maps)
    del aggr
    initial_fresh = _fix_bottom(initial_fresh, H - i_lo)

    # initial rows [v_lo - L, i_hi).
    initial = (initial_fresh if first else
               torch.cat([strips.initial, initial_fresh], dim=0))
    y_i = 0 if first else v_lo - L
    # Rows past the frame bottom vote with row H-1's ARMS: disparity.cl
    # reads the arms image with the same CLAMP_TO_EDGE as the map, while a
    # virtual row's own walk sees other neighbours.
    al_vote = _fix_bottom(arm_rows(arms_l, y_i, i_hi), H - y_i, axis=1)
    voted_win = ops.histogram_vote(initial, al_vote.contiguous(), cfg.d_max,
                                   quantize=cfg.quantize_maps, arm_len=L,
                                   impl=cfg.oii_impl)
    voted_fresh = _fix_bottom(voted_win[v_lo - y_i:v_hi - y_i], H - v_lo)

    # voted rows [s - 1, v_hi): the final median's reach.
    voted = (voted_fresh if first else
             torch.cat([strips.voted, voted_fresh], dim=0))
    final = ops.median3x3(voted, cfg.kernels)
    y_v = 0 if first else s - 1
    kept = (initial[s - y_i:e - y_i], final[s - y_v:e - y_v])
    if g.last:
        return (*kept, None)
    return (*kept, CrossStrips(temp[:, -2 * L:].contiguous(),
                               initial[-2 * L:], voted[-2:]))


def _first_band_c(l, r, cfg: StereoConfig, g: _Geom):
    """The first band: (initial, final) of its kept rows and its
    CrossStrips."""
    return _cross_band(l, r, None, cfg, g)


def _mid_band_c(l, r, temp, initial, voted, cfg: StereoConfig, g: _Geom):
    """An interior band, from the strips of the band above as three
    tensors: (initial, final) of its kept rows and its CrossStrips (None
    for the last band)."""
    return _cross_band(l, r, CrossStrips(temp, initial, voted), cfg, g)


def _last_band_c(l, r, temp, initial, voted, cfg: StereoConfig, g: _Geom):
    """The last band: _mid_band_c, whose strips come back None (g.last)."""
    return _mid_band_c(l, r, temp, initial, voted, cfg, g)


def cross_pipeline_wavefront(left, right, cfg: StereoConfig, num_bands: int,
                             run=graphs.replay_stage):
    """Banded cross-method run with the strip carry; returns (initial,
    final), equal to the whole-frame cross_pipeline's maps with a
    translation-invariant OII route ("taps" on the CPU, the kernels on
    CUDA; see models.tiled.translation_invariant).  Each band step runs
    through run(name, step, *args) with its canonical geometry: by
    default replayed from a CUDA graph on CUDA tensors (the frame holds
    its band graphs, utils.graphs), eagerly with utils.call_stage."""
    from .tiled import translation_invariant

    cfg = translation_invariant(cfg, left)
    H = left.shape[0]
    geoms = plan_bands_cross(H, num_bands, cfg)
    if geoms is None:
        raise ValueError(
            f"cross wavefront layout unsupported at H={H}, "
            f"num_bands={num_bands}; use models.tiled.cross_pipeline_tiled")
    if left.shape != right.shape or left.dim() != 3 or left.shape[2] != 3:
        raise ValueError(f"need two (H, W, 3) images, got {tuple(left.shape)} "
                         f"and {tuple(right.shape)}")
    pieces = []
    strips = None
    with graphs.STAGES.hold():
        for g in geoms:
            l, r = left[g.g0:g.g1], right[g.g0:g.g1]
            if g.first:
                out = run("first_band_c", _first_band_c, l, r, cfg,
                          _canon_c(g))
            elif g.last:
                out = run("last_band_c", _last_band_c, l, r, *strips, cfg,
                          _canon_c(g))
            else:
                out = run("mid_band_c", _mid_band_c, l, r, *strips, cfg,
                          _canon_c(g))
            initial, final, strips = out
            pieces.append((initial, final))
    return (torch.cat([p[0] for p in pieces], dim=0),
            torch.cat([p[1] for p in pieces], dim=0))
