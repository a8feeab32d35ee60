"""Plain PyTorch reference of the iterative ASW frame (Kowalczuk, Psota and
Perez 2013; the reference binary's main.cpp:412-758).

A frozen copy of the port's plain route (`models/asw.py`
asw_pipeline_impl over ops/support.py, aggregation.py, wta.py,
wta_fast.py, refinement.py): support weights -> SAD cost -> r x
(vertical, horizontal) aggregation -> WTA with the target view's
epipolar scan -> consistency -> k x (refinement of both views -> WTA
with the refinement prior as penalty -> consistency) -> median.  It
imports nothing of the program and takes only the benchmark's inputs.

Each step runs where its values do not depend on the split: the
aggregation in chunks of disparity planes, the WTAs in blocks of rows,
so that a full-size Middlebury frame fits beside the card's other
tenants; every value is the one the whole volume gives.  `dt` runs the
arithmetic in another precision (the control); float32 is the
configuration's.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import (consistency, disparity_to_image, edge_pad, image_from_q,
                     median3x3, red_diagnostic, sad_cost_volume,
                     shifted_columns, to_unit)

COMPARED = ("disparity", "consistency_pre", "consistency_post")
PLANE_ELEMS = 1 << 28      # elements of a disparity chunk of the aggregation
ROW_ELEMS = 1 << 27        # elements of a row block of a WTA


def support_weights(img, radius: int, gamma_c: float, gamma_p: float,
                    axis: int, dt):
    """(T, H, W) weights exp(-SAD255 / gamma_c - dist / gamma_p) of the
    clamped neighbour at offset t - radius along `axis`."""
    inv_c = float(np.float32(1.0) / np.float32(gamma_c))
    inv_p = float(np.float32(1.0) / np.float32(gamma_p))
    p = img.to(dt).movedim(-1, 0) * 255.0
    n = p.shape[1 + axis]
    ext = edge_pad(p, radius, radius, 1 + axis)
    coords = torch.arange(n, device=img.device)
    out = []
    for t in range(2 * radius + 1):
        a = (p - ext.narrow(1 + axis, t, n)).abs()
        c_diff = ((a[0] + a[1]) + a[2]) * inv_c
        clamped = (coords + (t - radius)).clamp(0, n - 1)
        dist = (coords - clamped).abs().to(dt) * inv_p
        dist2d = dist[:, None] if axis == 0 else dist[None, :]
        out.append(torch.exp(-c_diff - dist2d))
    return torch.stack(out, dim=0)


def aggregation_den(w_left, w_right, eps: float, d0: int, n: int):
    T, H, W = w_left.shape
    den = torch.full((n, H, W), eps, dtype=w_left.dtype, device=w_left.device)
    for t in range(T):
        den = den + w_left[t][None] * shifted_columns(w_right[t], n, d0)
    return den.contiguous()


def aggregation_pass(cost, w_left, w_right, den, eps: float, axis: int,
                     d0: int):
    """num / den with num = eps + sum_t wL * wR(x - d0 - d) * C[nb(t)]."""
    T = w_left.shape[0]
    R = (T - 1) // 2
    D, n = cost.shape[0], cost.shape[axis]
    ext = edge_pad(cost, R, R, axis)
    num = torch.full_like(cost, eps)
    for t in range(T):
        ww = w_left[t][None] * shifted_columns(w_right[t], D, d0)
        num = num + ww * ext.narrow(axis, t, n)
    return (num / den).contiguous()


def aggregate(left, right, w, p, dt):
    """The (D, H, W) volume after r rounds, chunk by chunk of planes."""
    D, (H, W) = p.d_max + 1, left.shape[:2]
    planes = max(1, min(D, PLANE_ELEMS // (H * W)))
    out = torch.empty((D, H, W), dtype=dt, device=left.device)
    l, r = left.to(dt), right.to(dt)
    for d0 in range(0, D, planes):
        n = min(planes, D - d0)
        c = sad_cost_volume(l, r, n, 255.0, d0)
        den_v = aggregation_den(w["wv_l"], w["wv_r"], p.eps, d0, n)
        den_h = aggregation_den(w["wh_l"], w["wh_r"], p.eps, d0, n)
        for _ in range(p.r_iters):
            c = aggregation_pass(c, w["wv_l"], w["wv_r"], den_v, p.eps, 1, d0)
            c = aggregation_pass(c, w["wh_l"], w["wh_r"], den_h, p.eps, 2, d0)
        out[d0:d0 + n] = c
        del c, den_v, den_h
    return out


def two_min_scan(v, big: float):
    """(c1, c2, d1): two-min over ascending d, ties to the lowest d; values
    >= big never update the tracker."""
    c1_raw, d1_raw = torch.min(v, dim=0)
    any_update = c1_raw < big
    d1 = torch.where(any_update, d1_raw, 0).to(torch.int32)
    c1 = torch.clamp(c1_raw, max=big)
    ids = torch.arange(v.shape[0], device=v.device)[:, None, None]
    masked = torch.where(ids == d1_raw[None], torch.inf, v)
    c2 = torch.clamp(masked.amin(dim=0), max=big)
    c2 = torch.where(any_update, c2, big)
    return c1, c2, d1


def masked_two_min_high_tie(vals, fallback_d, big: float):
    D = vals.shape[0]
    j = torch.argmin(vals.flip(0), dim=0)
    b_win = ((D - 1) - j).to(torch.int32)
    c1_raw = vals.amin(dim=0)
    ids = torch.arange(D, dtype=torch.int32, device=vals.device)[:, None, None]
    masked = torch.where(ids == b_win[None], torch.inf, vals)
    c2_raw = masked.amin(dim=0)
    any_update = c1_raw < big
    d = torch.where(any_update, b_win, fallback_d.to(torch.int32))
    c1 = torch.clamp(c1_raw, max=big)
    c2 = torch.where(any_update, torch.clamp(c2_raw, max=big), big)
    return c1, c2, d


def diagonal_two_min(cost, d1, pen_scale, pen_center, big: float):
    """The target view's unclamped probes: cost[b, y, x - d1 + b] for b in
    [max(1, d1 - x), d1], two-min with ties to the largest b; and the base
    plane b0 = max(d1 - x, 0) of the clamped tail."""
    D, H, W = cost.shape
    dev = cost.device
    xs = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    bs = torch.arange(D, dtype=torch.int32, device=dev)[:, None, None]
    idx = (torch.arange(W, device=dev)[None, None, :]
           - d1.to(torch.int64)[None]
           + torch.arange(D, device=dev)[:, None, None]).clamp_(0, W - 1)
    gathered = torch.gather(cost, 2, idx)
    if pen_scale is not None:
        i_of_b = (d1[None] - bs).to(cost.dtype)
        vals = gathered + pen_scale[None] * (pen_center[None] - i_of_b).abs()
    else:
        vals = gathered
    lo = (d1[None] - xs[None]).clamp(min=1)
    mask = (bs >= lo) & (bs <= d1[None]) & (vals < big)
    vals = torch.where(mask, vals, torch.inf)
    mc1, mc2, md = masked_two_min_high_tie(vals, d1, big)
    b0 = (d1 - xs).clamp(min=0)
    base = torch.gather(gathered, 0, b0[None].to(torch.int64))[0]
    return mc1, mc2, md, base


def tail_and_merge(d1, mc1, mc2, md, base, pen_scale, pen_center, big, D):
    """The clamped tail's two-min in closed form, merged with the main
    scan; (d int32, conf)."""
    dt = base.dtype
    inf = torch.inf
    xs = torch.arange(d1.shape[1], dtype=torch.int32,
                      device=d1.device)[None, :]
    b0 = (d1 - xs).clamp(min=0)
    lo = torch.clamp(xs.to(dt) + 1.0, min=1.0)
    hi = torch.clamp(d1.to(dt) - 1.0, max=float(D - 2))
    n = hi - lo + 1.0
    if pen_scale is not None:
        ct = pen_center
        p = torch.minimum(torch.maximum(torch.round(ct), lo), hi)

        def v_of(i):
            return base + pen_scale * (ct - i).abs()

        v1 = v_of(p)
        q_lo = torch.where(p - 1.0 >= lo, v_of(p - 1.0), inf)
        q_hi = torch.where(p + 1.0 <= hi, v_of(p + 1.0), inf)
        v2 = torch.minimum(q_lo, q_hi)
    else:
        v1 = v2 = base
    tc1 = torch.where((n >= 1.0) & (v1 < big), v1, inf)
    tc2 = torch.where((n >= 2.0) & (v2 < big), v2, inf)
    t_any = tc1 < big
    tc1c = torch.clamp(tc1, max=big)
    tc2c = torch.where(t_any, torch.clamp(tc2, max=big), big)
    take_t = tc1c < mc1
    c1 = torch.where(take_t, tc1c, mc1)
    d = torch.where(take_t, b0, md)
    c2 = torch.minimum(torch.minimum(mc2, tc2c), torch.maximum(mc1, tc1c))
    return d, (c2 - c1) / c2


def wta_block(cost, ref_scale, ref_center, t_scale, t_center, big: float):
    """(disp_ref, conf_ref, disp_target, conf_target) of a block of rows."""
    D = cost.shape[0]
    v = cost
    if ref_scale is not None:
        ds = torch.arange(D, device=cost.device).to(cost.dtype)[:, None, None]
        v = cost + ref_scale[None] * (ref_center[None] - ds).abs()
    c1, c2, d1 = two_min_scan(v, big)
    del v
    mc1, mc2, md, base = diagonal_two_min(cost, d1, t_scale, t_center, big)
    d_t, conf_t = tail_and_merge(d1, mc1, mc2, md, base, t_scale, t_center,
                                 big, D)
    return (d1.to(c1.dtype), (c2 - c1) / c2, d_t.to(c1.dtype), conf_t)


def wta(cost, big: float, ref_scale=None, ref_center=None, t_scale=None,
        t_center=None):
    """The reference- and target-view WTA, block of rows by block of rows
    (every value depends on its own row only)."""
    D, H, W = cost.shape
    rows = max(1, ROW_ELEMS // (D * W))
    parts = []
    for y0 in range(0, H, rows):
        sl = slice(y0, min(H, y0 + rows))
        pick = (lambda m: None if m is None else m[sl])
        parts.append(wta_block(cost[:, sl], pick(ref_scale), pick(ref_center),
                               pick(t_scale), pick(t_center), big))
    return tuple(torch.cat(f, dim=0) for f in zip(*parts))


def refine_pass_v(w, d_est, conf, radius: int, eps: float):
    T, H = w.shape[:2]
    d_win = edge_pad(d_est.to(w.dtype), radius, radius, 0)
    conf_win = edge_pad(conf.to(w.dtype), radius, radius, 0)
    num = d_win.new_full((H, d_win.shape[1]), eps)
    den = d_win.new_full((H, d_win.shape[1]), eps)
    for t in range(T):
        F = conf_win.narrow(0, t, H)
        num = num + w[t] * F * d_win.narrow(0, t, H)
        den = den + w[t] * F
    return num / den, den


def refine_pass_h(w, value_v, den_v, conf, radius: int, eps: float):
    W = value_v.shape[1]
    conf_p = edge_pad(conf.to(w.dtype), radius, radius, 1)
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


def frame(left: torch.Tensor, right: torch.Tensor, p,
          dt=torch.float32) -> dict:
    """The compared maps of one frame: `disparity` (median-filtered,
    occlusion-filled), `consistency_pre` and `consistency_post` (the red
    diagnostics after the first WTA and after the last refinement).

    left, right: (H, W, 3) float32 on the UNORM8 grid; p: the method's
    parameters (StereoConfig's field names)."""
    R, dm = p.radius, p.d_max

    def image(d):
        return disparity_to_image(d, dm, p.quantize_maps)

    w = {}
    for side, img in (("l", left), ("r", right)):
        w["wv_" + side] = support_weights(img, R, p.gamma_c, p.gamma_p, 0, dt)
        w["wh_" + side] = support_weights(img, R, p.gamma_c, p.gamma_p, 1, dt)
        w["rv_" + side] = support_weights(img, R, p.ref_gamma_c,
                                          p.ref_gamma_p, 0, dt)
        w["rh_" + side] = support_weights(img, R, p.ref_gamma_c,
                                          p.ref_gamma_p, 1, dt)
    aggr = aggregate(left, right, w, p, dt)
    for k in ("wv_l", "wv_r", "wh_l", "wh_r"):
        del w[k]

    d_ref, conf_ref, d_tar, conf_tar = wta(aggr, p.big)
    left_img, right_img = image(d_ref), image(d_tar)
    filled_q, conf_ref, conf_tar, ok = consistency(
        left_img * dm, right_img * dm, conf_ref, conf_tar)
    red_post = red_pre = red_diagnostic(left_img, ok)
    right_q = right_img * dm
    for _ in range(p.k_iters):
        vv_l, dv_l = refine_pass_v(w["rv_l"], filled_q, conf_ref, R, p.eps)
        val_l, den_l = refine_pass_h(w["rh_l"], vv_l, dv_l, conf_ref, R, p.eps)
        vv_r, dv_r = refine_pass_v(w["rv_r"], right_q, conf_tar, R, p.eps)
        val_r, den_r = refine_pass_h(w["rh_r"], vv_r, dv_r, conf_tar, R, p.eps)
        r_ref, r_cref, r_tar, r_ctar = wta(
            aggr, p.big, p.penalty * den_l, val_l, p.penalty * den_r, val_r)
        if p.wta_ref_conf_bug:
            # asw_wta_ref.cl:63-66 writes the target confidence into the
            # reference one; the target buffer keeps its previous value.
            new_ref, new_tar = r_ctar, conf_tar
        else:
            new_ref, new_tar = r_cref, r_ctar
        left_img = image(r_ref)
        right_q = image(r_tar) * dm
        filled_q, conf_ref, conf_tar, ok = consistency(
            left_img * dm, right_q, new_ref, new_tar)
        red_post = red_diagnostic(left_img, ok)
    filled = (image_from_q(filled_q, dm) if p.quantize_maps
              else to_unit(filled_q, dm))
    return {"disparity": median3x3(filled), "consistency_pre": red_pre,
            "consistency_post": red_post}
