"""Winner-take-all with second-best confidence and the derived target-view
disparity, and the cross method's plain argmin; PyTorch port of
`stereo_matchin_tpu/ops/wta.py` (reference kernels/asw_wta.cl,
asw_wta_ref.cl, init_disparity.cl).

`two_min_scan` is the plain version of the CUDA kernel K3
(kernels/wta_gather.py `two_min`).  `epipolar_target_scan` replays the
reference's sequential bresenham scan step by step; it is the oracle the
vectorised scan in ops/wta_fast.py is tested against.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class WTAResult(NamedTuple):
    disp_ref: torch.Tensor      # (H, W) float — left/reference disparity (integer-valued)
    conf_ref: torch.Tensor      # (H, W) float — (c2-c1)/c2
    disp_target: torch.Tensor   # (H, W) float — derived right/target disparity
    conf_target: torch.Tensor   # (H, W) float


def two_min_scan(cost: torch.Tensor, penalty: torch.Tensor | None = None,
                 big: float = 1e5):
    """Two-min over ascending d of cost (+ penalty), the reference tracker.

    Returns (c1, c2, d1 int32): ties to the lowest d; values >= big never
    update the tracker (then d1 = 0 and c1 = c2 = big)."""
    v = cost if penalty is None else cost + penalty
    c1_raw, d1_raw = torch.min(v, dim=0)          # first minimum: lowest d
    any_update = c1_raw < big
    d1 = torch.where(any_update, d1_raw, 0).to(torch.int32)
    c1 = torch.clamp(c1_raw, max=big)
    ids = torch.arange(v.shape[0], device=v.device)[:, None, None]
    masked = torch.where(ids == d1_raw[None], torch.inf, v)
    c2 = torch.clamp(masked.amin(dim=0), max=big)
    c2 = torch.where(any_update, c2, big)
    return c1, c2, d1


def epipolar_target_scan(cost: torch.Tensor, d1: torch.Tensor,
                         penalty_scale=None, penalty_center=None,
                         big: float = 1e5):
    """Target-view disparity by probing the epipolar diagonal, one scan
    step at a time (asw_wta.cl:55-67 / asw_wta_ref.cl:40-51).

    cost: (D, H, W); d1: (H, W) int left winner.  The optional penalty is
    penalty_scale * |penalty_center - i| with i the step index.
    Returns (d_target float, conf_target)."""
    D, H, W = cost.shape
    dev = cost.device
    d1 = d1.to(torch.int64)
    xs = torch.arange(W, device=dev)[None, :]
    yy = torch.arange(H, device=dev)[:, None].expand(H, W)
    c1 = torch.full((H, W), big, dtype=cost.dtype, device=dev)
    c2 = c1.clone()
    best_b = d1.clone()
    for i in range(D - 1):
        xq = (xs - i).clamp(min=0).expand(H, W)
        b = d1 + xq - xs
        valid = i < d1
        v = cost[b.clamp(0, D - 1), yy, xq]
        if penalty_scale is not None:
            v = v + penalty_scale * (penalty_center - float(i)).abs()
        v = torch.where(valid, v, torch.inf)
        upd = v < c1
        c2 = torch.where(upd, c1, torch.minimum(c2, torch.where(v < c2, v, c2)))
        best_b = torch.where(upd, b, best_b)
        c1 = torch.where(upd, v, c1)
    return best_b.to(cost.dtype), (c2 - c1) / c2


def wta_argmin(cost: torch.Tensor) -> torch.Tensor:
    """Init_disparity (init_disparity.cl:725-742): argmin over d of a
    (D, H, W) volume, as cost's dtype.  torch.argmin returns the first
    minimum, so ties go to the lowest d."""
    return torch.argmin(cost, dim=0).to(cost.dtype)
