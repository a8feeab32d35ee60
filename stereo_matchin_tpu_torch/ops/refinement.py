"""Iterative ASW disparity refinement (separable confidence-weighted mean);
PyTorch port of `stereo_matchin_tpu/ops/refinement.py` (reference
kernels/asw_refinement_v.cl, asw_refinement_h.cl).

Vertical pass:   num = eps + sum_t w(t) * F(nb) * D(nb)
                 den = eps + sum_t w(t) * F(nb)
Horizontal pass: num = eps + sum_t w(t) * F(nb) * value_v(nb) * den_v(nb)
                 den = eps + sum_t w(t) * F(nb) * den_v(nb)
value = num / den; F is the confidence at the neighbour.

Each function takes `kernels` (kernels.use_kernels): "auto" runs the CUDA
kernels on CUDA tensors -- K9 for the strips (kernels/asw_refine.py
support_w) and K10 for the passes (refine_pass), the fusions XLA makes of
the JAX functions' tap chains, bit-equal to these ops -- "jnp" these ops.
"""

from __future__ import annotations

from .common import edge_pad
from .support import support_weights


def _kernel_pass(kernels: str, w):
    """K10's wrapper where `kernels` routes w to the CUDA kernels, else None."""
    from ..kernels import use_kernels

    if not use_kernels(kernels, w):
        return None
    from ..kernels.asw_refine import refine_pass
    return refine_pass


def _taps(w, radius: int):
    if w.shape[0] != 2 * radius + 1:
        raise ValueError(f"{w.shape[0]} taps do not match radius {radius}")


def refinement_weights(img, radius: int, gamma_c: float, gamma_p: float,
                       kernels: str = "auto"):
    """(w_vertical, w_horizontal), each (T, H, W), for one view."""
    wv = support_weights(img, radius, gamma_c, gamma_p, axis=0,
                         kernels=kernels)
    wh = support_weights(img, radius, gamma_c, gamma_p, axis=1,
                         kernels=kernels)
    return wv, wh


def refine_pass_v(w, d_est, conf, radius: int, eps: float = 1e-5,
                  kernels: str = "auto"):
    """w: (T, H, W) vertical weights; d_est, conf: (H, W). Returns (value, den)."""
    k = _kernel_pass(kernels, w)
    if k is not None:
        _taps(w, radius)
        return k(w, d_est, conf, eps, "v")
    return refine_pass_v_win(w, edge_pad(d_est, radius, radius, 0),
                             edge_pad(conf, radius, radius, 0), eps,
                             kernels="jnp")


def refine_pass_v_win(w, d_win, conf_win, eps: float = 1e-5,
                      kernels: str = "auto"):
    """The vertical pass over a window of real rows: d_win, conf_win are
    (H + T - 1, W) and output row y reads rows y .. y + T - 1 (a row
    shard's halo-exchanged tile; parallel/asw_sharded.py).  w: (T, H, W)."""
    k = _kernel_pass(kernels, w)
    if k is not None:
        return k(w, d_win, conf_win, eps, "win")
    T, H = w.shape[:2]
    num = d_win.new_full((H, d_win.shape[1]), eps)
    den = d_win.new_full((H, d_win.shape[1]), eps)
    for t in range(T):
        F = conf_win.narrow(0, t, H)
        num = num + w[t] * F * d_win.narrow(0, t, H)
        den = den + w[t] * F
    return num / den, den


def refine_pass_h(w, value_v, den_v, conf, radius: int, eps: float = 1e-5,
                  kernels: str = "auto"):
    """Horizontal refinement over the vertical pass outputs."""
    k = _kernel_pass(kernels, w)
    if k is not None:
        _taps(w, radius)
        return k(w, value_v, conf, eps, "h", den_v)
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


def refine_view(wv, wh, d_est, conf, radius: int, eps: float = 1e-5,
                kernels: str = "auto"):
    """Full separable refinement for one view: returns (value_h, den_h)."""
    vv, dv = refine_pass_v(wv, d_est, conf, radius, eps, kernels)
    return refine_pass_h(wh, vv, dv, conf, radius, eps, kernels)
