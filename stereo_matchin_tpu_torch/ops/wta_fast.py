"""Vectorised WTA — exact replacement for the sequential epipolar scans;
PyTorch port of `stereo_matchin_tpu/ops/wta_fast.py`.

With the slope-1 bresenham of asw_wta.cl, every unclamped probe (i <= x)
of left pixel x reads cost[b, y, x - d1 + b] for b in [max(1, d1-x), d1]:
one diagonal of the volume, then a masked two-min with ties to the
LARGEST b (the earlier scan step).  The clamped tail (i > x, pixels with
x < d1) revisits the single plane b0 = d1 - x and is solved in closed
form by `_tail_and_merge`.  Results equal the sequential scans in ops/wta.py.

On a CUDA tensor the reference-view two-min and the diagonal two-min run
as the CUDA kernels K3 and K4 (kernels/wta_gather.py); `_two_min_plain`
and `_diag_two_min_plain` are their plain versions.  The diagonal is read
straight from the (D, H, W) volume: none of the TPU package's sheared
copies are built.
"""

from __future__ import annotations

import torch

from .wta import WTAResult, two_min_scan


def _masked_two_min_high_tie(vals, fallback_d, big):
    """Two smallest of (D, H, W) `vals` (inf = missing) over axis 0 with
    ties to the LARGEST plane index; sequential big-cap semantics."""
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


def _gather_diagonal(cost, d1):
    """gathered[b, y, x] = cost[b, y, clip(x - d1[y, x] + b, 0, W-1)]."""
    D, H, W = cost.shape
    xs = torch.arange(W, device=cost.device)[None, :]
    bs = torch.arange(D, device=cost.device)[:, None, None]
    idx = (xs[None] - d1.to(torch.int64)[None] + bs).clamp_(0, W - 1)
    return torch.gather(cost, 2, idx)


def _diag_two_min_plain(cost, d1, penalty_scale=None, penalty_center=None,
                        big: float = 1e5):
    """Plain version of kernel K4: the unclamped-probe two-min and the
    tail base plane.  Returns (mc1, mc2, md int32, base)."""
    D, H, W = cost.shape
    dev = cost.device
    xs = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    bs = torch.arange(D, dtype=torch.int32, device=dev)[:, None, None]
    gathered = _gather_diagonal(cost, d1)
    if penalty_scale is not None:
        i_of_b = (d1[None] - bs).to(cost.dtype)              # step index i
        vals = gathered + penalty_scale[None] * (penalty_center[None] - i_of_b).abs()
    else:
        vals = gathered
    lo = (d1[None] - xs[None]).clamp(min=1)                  # b >= max(1, d1-x)
    mask = (bs >= lo) & (bs <= d1[None]) & (vals < big)
    vals = torch.where(mask, vals, torch.inf)
    mc1, mc2, md = _masked_two_min_high_tie(vals, d1, big)
    b0 = (d1 - xs).clamp(min=0)
    base = torch.gather(gathered, 0, b0[None].to(torch.int64))[0]
    return mc1, mc2, md, base


def _target_scan_fast(cost, d1, penalty_scale=None, penalty_center=None,
                      big: float = 1e5, kernels: str = "auto"):
    """Exact vectorised asw_wta.cl:55-67 / asw_wta_ref.cl:40-51 target scan.
    d1: (H, W) int32.  Returns (d_target int32, conf_target)."""
    from ..kernels import use_kernels

    D, H, W = cost.shape
    if use_kernels(kernels, cost):
        from ..kernels.wta_gather import wta_diag

        mc1, mc2, md, base = wta_diag(cost, d1, penalty_scale,
                                      penalty_center, big)
    else:
        mc1, mc2, md, base = _diag_two_min_plain(cost, d1, penalty_scale,
                                                 penalty_center, big)
    xs = torch.arange(W, dtype=torch.int32, device=cost.device)[None, :]
    b0 = (d1 - xs).clamp(min=0)
    return _tail_and_merge(d1, xs, mc1, mc2, md, base, b0, penalty_scale,
                           penalty_center, big, D)


def _tail_and_merge(d1, xs, mc1, mc2, md, base, b0, penalty_scale,
                    penalty_center, big, D):
    """Clamped-tail two-min in closed form, merged with the main scan.

    v(i) = base + sc*|ct - i| over the integers i in [max(1, x+1),
    min(D-2, d1-1)] is V-shaped in i, so the two smallest values sit at
    the in-range integer nearest ct and its best in-range neighbour;
    ties (ct exactly half-integer) give equal values, so the scan's
    first-wins order never changes (c1, c2).  The main scan is earlier in
    scan order, so it keeps ties."""
    dt = base.dtype
    inf = torch.inf
    lo = torch.clamp(xs.to(dt) + 1.0, min=1.0)
    hi = torch.clamp(d1.to(dt) - 1.0, max=float(D - 2))
    n = hi - lo + 1.0                                        # valid count
    if penalty_scale is not None:
        ct = penalty_center
        p = torch.minimum(torch.maximum(torch.round(ct), lo), hi)

        def v_of(i):
            return base + penalty_scale * (ct - i).abs()

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


def _two_min_plain(cost, pen_scale=None, pen_center=None, big: float = 1e5):
    """Plain version of kernel K3: two_min_scan of cost + sc*|ct - d|."""
    if pen_scale is None:
        return two_min_scan(cost, big=big)
    ds = torch.arange(cost.shape[0], dtype=cost.dtype,
                      device=cost.device)[:, None, None]
    pen = pen_scale[None] * (pen_center[None] - ds).abs()
    return two_min_scan(cost, penalty=pen, big=big)


def _two_min(cost, pen_scale=None, pen_center=None, big: float = 1e5,
             kernels: str = "auto"):
    from ..kernels import use_kernels

    if use_kernels(kernels, cost):
        from ..kernels.wta_gather import two_min

        return two_min(cost, pen_scale, pen_center, big)
    return _two_min_plain(cost, pen_scale, pen_center, big)


def wta_fast(cost, big: float = 1e5, kernels: str = "auto") -> WTAResult:
    """Reference- and target-view WTA (asw_WTA), equal to the sequential
    scans."""
    c1, c2, d1 = _two_min(cost, big=big, kernels=kernels)
    conf_ref = (c2 - c1) / c2
    d_t, conf_t = _target_scan_fast(cost, d1, big=big, kernels=kernels)
    return WTAResult(d1.to(cost.dtype), conf_ref, d_t.to(cost.dtype), conf_t)


def wta_refined_fast(cost, ref_value, ref_denom, ref_value_t, ref_denom_t,
                     penalty: float, big: float = 1e5,
                     kernels: str = "auto") -> WTAResult:
    """asw_WTA_REF: re-WTA with the refinement prior as the soft penalty
    (penalty * den) * |ref - d|."""
    c1, c2, d1 = _two_min(cost, penalty * ref_denom, ref_value, big=big,
                          kernels=kernels)
    conf_ref = (c2 - c1) / c2
    d_t, conf_t = _target_scan_fast(
        cost, d1, penalty_scale=penalty * ref_denom_t,
        penalty_center=ref_value_t, big=big, kernels=kernels)
    return WTAResult(d1.to(cost.dtype), conf_ref, d_t.to(cost.dtype), conf_t)
