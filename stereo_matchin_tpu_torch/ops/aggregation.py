"""Separable iterated ASW cost aggregation — the hot loop; PyTorch port of
`stereo_matchin_tpu/ops/aggregation.py` (reference
kernels/asw_vcost_aggregation.cl, asw_hcost_aggregation.cl, r=7 times).

Per (d, y, x), with nb(t) the clamped neighbour at offset t - R along the
pass axis and wR read at max(x - d0 - d, 0):

    ww_t = wL[t, y, x] * wR[t, y, max(x - d0 - d, 0)]
    den  = eps + sum_t ww_t
    num  = eps + sum_t ww_t * C[d, nb(t)]
    out  = num / den

`asw_den_plain`, `asw_pass_plain` and `asw_pass_win_plain` are the plain
versions of the CUDA kernels K1 and K2 (kernels/asw_aggregation.py): the
same operations in the same order, each rounded once (no fused
multiply-add), so the kernels built with --fmad=false equal them bit for
bit on the card.
"""

from __future__ import annotations

import torch

from .common import edge_pad
from .cost import shifted_columns


def asw_den_plain(w_left: torch.Tensor, w_right: torch.Tensor, eps: float,
                  d0: int = 0, num_disp: int = 1) -> torch.Tensor:
    """(T, H, W) strips -> (num_disp, H, W) denominator, taps in t order."""
    T, H, W = w_left.shape
    den = torch.full((num_disp, H, W), eps, dtype=w_left.dtype,
                     device=w_left.device)
    for t in range(T):
        den = den + w_left[t][None] * shifted_columns(w_right[t], num_disp, d0)
    return den.contiguous()


def asw_pass_plain(cost: torch.Tensor, w_left: torch.Tensor,
                   w_right: torch.Tensor, den: torch.Tensor, eps: float,
                   axis: int, d0: int = 0) -> torch.Tensor:
    """One pass over a (D, H, W) volume; axis 1 = vertical, 2 = horizontal.

    `den` is asw_den_plain of the same strips (hoisted out of the r-loop:
    it does not depend on the cost)."""
    T = w_left.shape[0]
    R = (T - 1) // 2
    D = cost.shape[0]
    n = cost.shape[axis]
    ext = edge_pad(cost, R, R, axis)
    num = torch.full_like(cost, eps)
    for t in range(T):
        ww = w_left[t][None] * shifted_columns(w_right[t], D, d0)
        num = num + ww * ext.narrow(axis, t, n)
    return (num / den).contiguous()


def asw_pass_win_plain(cost_win: torch.Tensor, w_left: torch.Tensor,
                       w_right: torch.Tensor, den: torch.Tensor, eps: float,
                       d0: int = 0) -> torch.Tensor:
    """The vertical pass over a window of real rows: cost_win is
    (D, H_out + T - 1, W), the strips and `den` cover the H_out output
    rows, and output row y reads cost_win rows y .. y + T - 1 (no clamp).
    On the same rows it equals asw_pass_plain(axis=1) bit for bit."""
    T, H_out = w_left.shape[:2]
    D = cost_win.shape[0]
    num = torch.full((D, H_out, w_left.shape[2]), eps, dtype=cost_win.dtype,
                     device=cost_win.device)
    for t in range(T):
        ww = w_left[t][None] * shifted_columns(w_right[t], D, d0)
        num = num + ww * cost_win.narrow(1, t, H_out)
    return (num / den).contiguous()


def asw_aggregate_pass(cost, w_left, w_right, axis: int, radius: int,
                       eps: float = 1e-5):
    """One separable pass; returns (out, den), both (D, H, W)."""
    if w_left.shape[0] != 2 * radius + 1:
        raise ValueError(f"strips have {w_left.shape[0]} taps, radius "
                         f"{radius} needs {2 * radius + 1}")
    den = asw_den_plain(w_left, w_right, eps, 0, cost.shape[0])
    return asw_pass_plain(cost, w_left, w_right, den, eps, axis), den


def _call(fn, *args):
    return fn(*args)


def asw_levels(cost, wv_left, wv_right, wh_left, wh_right, radius: int,
               r_iters: int, eps: float = 1e-5, kernels: str = "auto",
               d0: int = 0, run_v=None, run_h=None):
    """r_iters x (vertical pass -> horizontal pass), as main.cpp:492-515,
    yielding `cost` (level 0), then each level's output.

    Plane k of `cost` holds disparity d0 + k (a disparity chunk).  The two
    denominators are computed once (they depend only on the strips).
    kernels: "auto" runs the CUDA kernels on CUDA tensors and the plain
    ops on the CPU; "jnp" the plain ops anywhere; "pallas" demands the
    kernels.  run_v / run_h: callables run(fn, *args) through which each
    vertical / horizontal pass and its axis's denominator go (None calls
    fn directly)."""
    from ..kernels import use_kernels

    if wv_left.shape[0] != 2 * radius + 1:
        raise ValueError(f"strips have {wv_left.shape[0]} taps, radius "
                         f"{radius} needs {2 * radius + 1}")
    if use_kernels(kernels, cost):
        from ..kernels.asw_aggregation import asw_den, asw_pass
    else:
        asw_den, asw_pass = asw_den_plain, asw_pass_plain
    run_v, run_h = run_v or _call, run_h or _call
    D = cost.shape[0]
    den_v = run_v(asw_den, wv_left, wv_right, eps, d0, D)
    den_h = run_h(asw_den, wh_left, wh_right, eps, d0, D)
    c = cost
    del cost                 # a volume passed in dies after the first pass
    yield c
    for _ in range(r_iters):
        c = run_v(asw_pass, c, wv_left, wv_right, den_v, eps, 1, d0)
        c = run_h(asw_pass, c, wh_left, wh_right, den_h, eps, 2, d0)
        yield c


def asw_aggregate(cost, wv_left, wv_right, wh_left, wh_right, radius: int,
                  r_iters: int, eps: float = 1e-5, kernels: str = "auto",
                  d0: int = 0):
    """The last level of asw_levels (`cost` itself when r_iters is 0)."""
    for c in asw_levels(cost, wv_left, wv_right, wh_left, wh_right, radius,
                        r_iters, eps, kernels, d0):
        pass
    return c
