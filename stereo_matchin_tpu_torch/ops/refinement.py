"""Iterative ASW disparity refinement (separable confidence-weighted mean);
PyTorch port of `stereo_matchin_tpu/ops/refinement.py` (reference
kernels/asw_refinement_v.cl, asw_refinement_h.cl).

Vertical pass:   num = eps + sum_t w(t) * F(nb) * D(nb)
                 den = eps + sum_t w(t) * F(nb)
Horizontal pass: num = eps + sum_t w(t) * F(nb) * value_v(nb) * den_v(nb)
                 den = eps + sum_t w(t) * F(nb) * den_v(nb)
value = num / den; F is the confidence at the neighbour.
"""

from __future__ import annotations

from .common import edge_pad
from .support import support_weights


def refinement_weights(img, radius: int, gamma_c: float, gamma_p: float):
    """(w_vertical, w_horizontal), each (T, H, W), for one view."""
    wv = support_weights(img, radius, gamma_c, gamma_p, axis=0)
    wh = support_weights(img, radius, gamma_c, gamma_p, axis=1)
    return wv, wh


def refine_pass_v(w, d_est, conf, radius: int, eps: float = 1e-5):
    """w: (T, H, W) vertical weights; d_est, conf: (H, W). Returns (value, den)."""
    return refine_pass_v_win(w, edge_pad(d_est, radius, radius, 0),
                             edge_pad(conf, radius, radius, 0), eps)


def refine_pass_v_win(w, d_win, conf_win, eps: float = 1e-5):
    """The vertical pass over a window of real rows: d_win, conf_win are
    (H + T - 1, W) and output row y reads rows y .. y + T - 1 (a row
    shard's halo-exchanged tile; parallel/asw_sharded.py).  w: (T, H, W)."""
    T, H = w.shape[:2]
    num = d_win.new_full((H, d_win.shape[1]), eps)
    den = d_win.new_full((H, d_win.shape[1]), eps)
    for t in range(T):
        F = conf_win.narrow(0, t, H)
        num = num + w[t] * F * d_win.narrow(0, t, H)
        den = den + w[t] * F
    return num / den, den


def refine_pass_h(w, value_v, den_v, conf, radius: int, eps: float = 1e-5):
    """Horizontal refinement over the vertical pass outputs."""
    W = value_v.shape[1]
    conf_p = edge_pad(conf, radius, radius, 1)
    vv_p = edge_pad(value_v, radius, radius, 1)
    dv_p = edge_pad(den_v, radius, radius, 1)
    num = value_v.new_full(value_v.shape, eps)
    den = value_v.new_full(value_v.shape, eps)
    for t in range(2 * radius + 1):
        F = conf_p.narrow(1, t, W)
        dv = dv_p.narrow(1, t, W)
        num = num + w[t] * F * vv_p.narrow(1, t, W) * dv
        den = den + w[t] * F * dv
    return num / den, den


def refine_view(wv, wh, d_est, conf, radius: int, eps: float = 1e-5):
    """Full separable refinement for one view: returns (value_h, den_h)."""
    vv, dv = refine_pass_v(wv, d_est, conf, radius, eps)
    return refine_pass_h(wh, vv, dv, conf, radius, eps)
