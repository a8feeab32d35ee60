"""Orthogonal-integral-image (OII) cross aggregation for the cross-based
method; PyTorch port of `stereo_matchin_tpu/ops/oii.py` (reference
kernels integral_h.cl, oii_hcross.cl, integral_v.cl, oii_vcross.cl).

Faithful quirks (all from the .cl sources, see the JAX module):
  * the window mean divides by ``plus - minus``, one less than the span;
  * the lower prefix index clamps as ``max(0, i + minus - 1)``, so pixel 0
    never enters a window sum (same vertically);
  * the upper index clamps to the last pixel;
  * the right image's arms are read at ``max(0, x - d)`` for the h AND the
    v planes.

`oii_pass_plain` (the "taps" form) is the plain version of the CUDA kernel
K7 (kernels/cross_oii.py `oii_pass`), whose sum order it shares.  Its
vertical pass takes `row0`/`h_glob` for a band of rows: the row quirks hold
on frame rows, as in the JAX package's `parallel/cross_sharded.py`
`_oii_vtaps_tiled`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cost import shifted_columns


def _positions(n: int, axis: int, device) -> torch.Tensor:
    shape = [1, 1, 1]
    shape[axis] = n
    return torch.arange(n, dtype=torch.int32, device=device).view(shape)


def _windowed_mean_from_prefix(prefix, minus_arm, plus_arm, axis: int):
    """(I[min(n-1, i+plus)] - I[max(0, i+minus-1)]) / (plus - minus)."""
    n = prefix.shape[axis]
    idx = _positions(n, axis, prefix.device)
    hi = torch.clamp(idx + plus_arm, max=n - 1).expand(prefix.shape)
    lo = torch.clamp(idx + minus_arm - 1, min=0).expand(prefix.shape)
    upper = torch.gather(prefix, axis, hi.long())
    lower = torch.gather(prefix, axis, lo.long())
    return (upper - lower) / (plus_arm - minus_arm).to(prefix.dtype)


def combined_arms(arms_l, arms_r, num_disp: int, plane_minus: int,
                  plane_plus: int, d0: int = 0):
    """Left arms combined with the right arms read at max(x - d0 - d, 0)
    (oii_hcross.cl:28-30): minus arms by max, plus arms by min.
    Returns (minus, plus), each (num_disp, H, W) int32."""
    minus = torch.maximum(shifted_columns(arms_r[plane_minus], num_disp, d0),
                          arms_l[plane_minus][None])
    plus = torch.minimum(shifted_columns(arms_r[plane_plus], num_disp, d0),
                         arms_l[plane_plus][None])
    return minus, plus


def _windowed_mean_taps(vol, minus_arm, plus_arm, arm_len: int, axis: int,
                        row0: int = 0, h_glob: int | None = None):
    """sum_{j=-L..L, minus<=j<=plus, 1<=g+j<=n-1} vol[i+j] / (plus - minus),
    as 2L+1 masked shifts added in j order (the JAX "taps" order).  g is
    the frame position of i: i itself, or row0 + i on axis 1, where n is
    h_glob; taps outside the volume read zeros."""
    n = vol.shape[axis]
    idx = _positions(n, axis, vol.device)
    pad = (arm_len, arm_len) if axis == 2 else (0, 0, arm_len, arm_len)
    ext = F.pad(vol, pad)
    if axis == 1:
        idx = idx + row0
        n_glob = n if h_glob is None else h_glob
    else:
        n_glob = n
    total = None
    for j in range(-arm_len, arm_len + 1):
        tap = ext.narrow(axis, arm_len + j, n)
        c = idx + j
        m = (j >= minus_arm) & (j <= plus_arm) & (c >= 1) & (c <= n_glob - 1)
        term = torch.where(m, tap, 0.0)
        total = term if total is None else total + term
    return total / (plus_arm - minus_arm).to(vol.dtype)


def _arm_planes(axis: int):
    if axis not in (1, 2):
        raise ValueError(f"axis must be 1 (vertical) or 2 (horizontal), got {axis}")
    return (0, 1) if axis == 2 else (2, 3)


def oii_pass_plain(vol: torch.Tensor, arms_l: torch.Tensor,
                   arms_r: torch.Tensor, arm_len: int, axis: int,
                   d0: int = 0, row0: int = 0,
                   h_glob: int | None = None) -> torch.Tensor:
    """One windowed-mean pass over a (D, H, W) volume whose plane k holds
    disparity d0 + k; axis 2 = horizontal (h arms), 1 = vertical (v arms).
    arms_l/arms_r: (4, H, W) int32 [h-, h+, v-, v+], minus negative.

    On axis 1 the volume's rows are frame rows row0 .. row0 + H - 1 of an
    h_glob-row frame (default: the whole frame): frame row 0 is dropped
    and rows past h_glob - 1 are left out, in frame coordinates."""
    minus, plus = combined_arms(arms_l, arms_r, vol.shape[0],
                                *_arm_planes(axis), d0)
    return _windowed_mean_taps(vol, minus, plus, arm_len, axis, row0,
                               h_glob).contiguous()


def cross_aggregate(cost: torch.Tensor, arms_l: torch.Tensor,
                    arms_r: torch.Tensor, arm_len: int = 25,
                    impl: str = "auto") -> torch.Tensor:
    """Full adaptive-cross aggregation: the horizontal pass, then the
    vertical pass over its result.

    impl (StereoConfig.oii_impl, see kernels.oii_route): "taps" = masked
    shifts in the kernels' sum order; "prefix" = cumsum + arm-indexed
    gathers, the reference's integral images (another float sum order);
    "pallas" = the CUDA kernel K7; "auto" = K7 on CUDA tensors, "taps"
    elsewhere."""
    from ..kernels import oii_route

    route = oii_route(impl, cost)
    if route == "prefix":
        # Integral_h / Integral_v: inclusive prefix sums along x, then y.
        D = cost.shape[0]
        hm, hp = combined_arms(arms_l, arms_r, D, 0, 1)
        temp = _windowed_mean_from_prefix(torch.cumsum(cost, dim=2), hm, hp,
                                          axis=2)
        vm, vp = combined_arms(arms_l, arms_r, D, 2, 3)
        return _windowed_mean_from_prefix(torch.cumsum(temp, dim=1), vm, vp,
                                          axis=1)
    if route == "kernels":
        from ..kernels.cross_oii import oii_pass
    else:
        oii_pass = oii_pass_plain
    temp = oii_pass(cost, arms_l, arms_r, arm_len, 2)
    return oii_pass(temp, arms_l, arms_r, arm_len, 1)
