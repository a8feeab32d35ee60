"""Vectorised WTA — exact replacement for the sequential epipolar scans;
PyTorch port of `stereo_matchin_tpu/ops/wta_fast.py`.

With the slope-1 bresenham of asw_wta.cl, every unclamped probe (i <= x)
of left pixel x reads cost[b, y, x - d1 + b] for b in [max(1, d1-x), d1]:
one diagonal of the volume, then a masked two-min with ties to the
LARGEST b (the earlier scan step).  The clamped tail (i > x, pixels with
x < d1) revisits the single plane b0 = d1 - x and is solved in closed
form by `_tail_and_merge`.  Results equal the sequential scans in ops/wta.py.

On a CUDA tensor the reference-view two-min, the diagonal two-min and the
epilogue (the clamped tail, the merge, both confidences and the f32
disparities) run as the CUDA kernels K3, K4 and K11
(kernels/wta_gather.py); `_two_min_plain`, `_diag_two_min_plain` and
`_wta_epilogue_plain` are their plain versions.  The diagonal is read
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


def _tail_and_merge(d1, mc1, mc2, md, base, penalty_scale, penalty_center,
                    big, D):
    """Clamped-tail two-min in closed form, merged with the main scan
    (mc1, mc2, md), the tail revisiting plane b0 = max(d1 - x, 0) whose
    cost is `base`.  Returns (d int32, conf).

    v(i) = base + sc*|ct - i| over the integers i in [max(1, x+1),
    min(D-2, d1-1)] is V-shaped in i, so the two smallest values sit at
    the in-range integer nearest ct and its best in-range neighbour;
    ties (ct exactly half-integer) give equal values, so the scan's
    first-wins order never changes (c1, c2).  The main scan is earlier in
    scan order, so it keeps ties."""
    dt = base.dtype
    inf = torch.inf
    xs = torch.arange(d1.shape[1], dtype=torch.int32,
                      device=d1.device)[None, :]
    b0 = (d1 - xs).clamp(min=0)
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


def _two_min_plain(cost, pen_scale=None, pen_center=None, big: float = 1e5,
                   d0: int = 0):
    """Plain version of kernel K3: two_min_scan of cost + sc*|ct - d|, d
    the disparity d0 + k of plane k (d1 stays the plane index k)."""
    if pen_scale is None:
        return two_min_scan(cost, big=big)
    ds = (torch.arange(cost.shape[0], device=cost.device) + d0).to(
        cost.dtype)[:, None, None]
    pen = pen_scale[None] * (pen_center[None] - ds).abs()
    return two_min_scan(cost, penalty=pen, big=big)


def _two_min(cost, pen_scale=None, pen_center=None, big: float = 1e5,
             kernels: str = "auto", d0: int = 0):
    from ..kernels import use_kernels

    if use_kernels(kernels, cost):
        from ..kernels.wta_gather import two_min

        return two_min(cost, pen_scale, pen_center, big, d0)
    return _two_min_plain(cost, pen_scale, pen_center, big, d0)


def _wta_epilogue_plain(c1, c2, d1, mc1, mc2, md, base, penalty_scale,
                        penalty_center, big, D):
    """Plain version of kernel K11: from K3's (c1, c2, d1) and K4's (mc1,
    mc2, md, base), the reference view's disparity as f32 and (c2 - c1) /
    c2, and the target view's `_tail_and_merge` with its disparity as f32.
    Returns (disp_ref, conf_ref, disp_target, conf_target)."""
    conf_ref = (c2 - c1) / c2
    d_t, conf_t = _tail_and_merge(d1, mc1, mc2, md, base, penalty_scale,
                                  penalty_center, big, D)
    return d1.to(c1.dtype), conf_ref, d_t.to(c1.dtype), conf_t


def _wta(cost, ref_scale, ref_center, t_scale, t_center, big: float,
         kernels: str) -> WTAResult:
    """K3 -> K4 -> K11 on a CUDA tensor (kernels.use_kernels), their plain
    versions elsewhere; the penalty maps of each view are optional."""
    from ..kernels import use_kernels

    c1, c2, d1 = _two_min(cost, ref_scale, ref_center, big=big,
                          kernels=kernels)
    if use_kernels(kernels, cost):
        from ..kernels.wta_gather import wta_diag, wta_merge

        diag = wta_diag(cost, d1, t_scale, t_center, big)
        return WTAResult(*wta_merge(c1, c2, d1, *diag, t_scale, t_center, big,
                                    cost.shape[0]))
    diag = _diag_two_min_plain(cost, d1, t_scale, t_center, big)
    return WTAResult(*_wta_epilogue_plain(c1, c2, d1, *diag, t_scale,
                                          t_center, big, cost.shape[0]))


def wta_fast(cost, big: float = 1e5, kernels: str = "auto") -> WTAResult:
    """Reference- and target-view WTA (asw_WTA), equal to the sequential
    scans."""
    return _wta(cost, None, None, None, None, big, kernels)


def wta_refined_fast(cost, ref_value, ref_denom, ref_value_t, ref_denom_t,
                     penalty: float, big: float = 1e5,
                     kernels: str = "auto") -> WTAResult:
    """asw_WTA_REF: re-WTA with the refinement prior as the soft penalty
    (penalty * den) * |ref - d|."""
    return _wta(cost, penalty * ref_denom, ref_value, penalty * ref_denom_t,
                ref_value_t, big, kernels)
