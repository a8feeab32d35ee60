"""Raw matching-cost volume: RGB sum of absolute differences (PyTorch port
of `stereo_matchin_tpu/ops/cost.py`; reference kernels/asw_aggr.cl:41-61).
"""

from __future__ import annotations

import torch


def shifted_columns(plane: torch.Tensor, num_disp: int, d0: int = 0) -> torch.Tensor:
    """(..., W) -> (num_disp, ..., W): out[d, ..., x] = plane[..., max(x - d0 - d, 0)].

    The reference's right-image read `max(0, x - d)` for every disparity
    plane, as one index gather (values are exact copies)."""
    W = plane.shape[-1]
    xs = torch.arange(W, device=plane.device)
    ds = torch.arange(num_disp, device=plane.device)[:, None]
    idx = (xs[None] - d0 - ds).clamp_(min=0)                 # (D, W)
    out = plane[..., idx]                                    # (..., D, W)
    return out.movedim(-2, 0)


def sad_cost_volume(left: torch.Tensor, right: torch.Tensor, num_disp: int,
                    scale: float = 1.0) -> torch.Tensor:
    """left/right: (H, W, 3) floats in [0, 1].  Returns (D, H, W):

    cost[d, y, x] = (|l0 - r0| + |l1 - r1|) + |l2 - r2| on the `scale`
    grid, with r read at (y, max(x - d, 0)) — the reference's channel
    order (.x + .y + .z)."""
    l = left.movedim(-1, 0) * scale                          # (3, H, W)
    r = right.movedim(-1, 0) * scale
    cost = None
    for c in range(3):
        term = (l[c][None] - shifted_columns(r[c], num_disp)).abs()
        cost = term if cost is None else cost + term
    return cost.contiguous()
