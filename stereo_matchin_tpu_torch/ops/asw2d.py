"""The vestigial non-separable 2-D ASW aggregation (PyTorch port of
`stereo_matchin_tpu/ops/asw2d.py`; design-history parity).

Reference: `kernels/asw_vcost.cl` / `kernels/asw_cost.cl` — the naive
O(T^2)-per-pixel aggregation the thesis author wrote first, created by the
host (main.cpp:232-233) but NEVER enqueued; it was superseded by the
separable v/h pass pair.  Kept as a quality-comparison tool for reference
sizes; the production path is ops.asw_aggregate and the kernels K1/K2.
Plain torch ops on the tensors' device: no pipeline calls it, and it has no
kernel.

Faithful to the .cl's idiosyncrasies (both files compute the same thing):
the vertical term sums the cost UNWEIGHTED and divides by T; the 2-D term
weights cost by ww_h*ww_v but normalises by sum(ww_h) alone; the h strips
are read at the visited row y+i; the result is their sum.  Support strips
and the disparity shift max(x-d, 0) match the separable path.  The order
of operations is the JAX function's, so the sums round alike.
"""

from __future__ import annotations

import torch

from .common import shift_axis
from .cost import shifted_columns


def asw_aggregate_2d(cost: torch.Tensor, wv_l: torch.Tensor,
                     wv_r: torch.Tensor, wh_l: torch.Tensor,
                     wh_r: torch.Tensor, radius: int) -> torch.Tensor:
    """cost: (D, H, W); w*: (T, H, W) support strips.  Returns (D, H, W).

    out[d,y,x] = (sum_i C[d, y+i, x]) / T
               + (sum_{i,j} wwv(i) * wwh(i,j) * C[d, y+i, x+j])
                 / (sum_{i,j} wwh(i,j))
    with clamp-to-edge neighbour reads and wwv/wwh the joint L*R weights
    (right strip read at max(x-d, 0)).  Holds two (T, D, H, W) stacks of
    shifted right strips: 0.89 GB each at 288x384, D=61, T=33.
    """
    D = cost.shape[0]
    T = 2 * radius + 1
    wv_r_d = shifted_columns(wv_r, D).movedim(1, 0)          # (T, D, H, W)
    wh_r_d = shifted_columns(wh_r, D).movedim(1, 0)

    num_v = torch.zeros_like(cost)
    num_h = torch.zeros_like(cost)
    den_h = torch.zeros_like(cost)
    for i in range(T):
        c_row = shift_axis(cost, i - radius, 1)              # C[d, y+i, x]
        num_v = num_v + c_row
        wwv = wv_l[i][None] * wv_r_d[i]                      # (D, H, W)
        for j in range(T):
            # h supports read at the VISITED row y+i (asw_vcost.cl inner).
            whl_n = shift_axis(wh_l[j], i - radius, 0)[None]
            whr_n = shift_axis(wh_r_d[j], i - radius, 1)
            wwh = whl_n * whr_n
            c_2d = shift_axis(c_row, j - radius, 2)          # C[d, y+i, x+j]
            num_h = num_h + wwh * wwv * c_2d
            den_h = den_h + wwh
    # T as a tensor on the device: PyTorch's CUDA division by a Python
    # number multiplies by its reciprocal, which can land one ulp off the
    # quotient that the CPU and XLA compute.
    t = torch.full((), T, dtype=cost.dtype, device=cost.device)
    return num_v / t + num_h / den_h
