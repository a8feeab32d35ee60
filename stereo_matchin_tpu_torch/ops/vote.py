"""Histogram-vote disparity refinement over the adaptive cross region;
PyTorch port of `stereo_matchin_tpu/ops/vote.py` (reference
kernels/disparity.cl `Disparity`).

For each pixel the vote walks its left-image vertical arms; on each
visited row it counts, within THAT row's horizontal arms, the quantised
initial disparities, and outputs the mode with ties to the highest d
(disparity.cl:39-42).  Reads go through a CLAMP_TO_EDGE sampler, so taps
beyond the border re-count the border pixel.

The two halves are the plain versions of the CUDA kernel K8
(kernels/cross_oii.py): `vote_counts_plain` of `vote_h` (per-row counts
rc[d, y, x], uint8) and `vote_mode_plain` of `vote_v` (the column sum of
rc over the anchor pixel's v arms, then the mode).
"""

from __future__ import annotations

import torch

from .common import disparity_to_image, edge_pad
from .oii import _positions


def vote_indices(disp_img: torch.Tensor, d_max: int) -> torch.Tensor:
    """floor(img * d_max) in f32 as int32 histogram bins (disparity.cl:31-32:
    the UNORM8 image read back, times 60, C-cast)."""
    return torch.floor(disp_img.to(torch.float32) * d_max).to(torch.int32)


def _clamped_window_taps(vol, minus_arm, plus_arm, arm_len: int, axis: int):
    """sum_{j=minus..plus} vol[clamp(i+j)] along `axis`, as 2L+1 masked
    shifts of an edge-padded copy (the border is re-counted)."""
    n = vol.shape[axis]
    ext = edge_pad(vol, arm_len, arm_len, axis)
    total = None
    for j in range(-arm_len, arm_len + 1):
        tap = ext.narrow(axis, arm_len + j, n)
        term = torch.where((j >= minus_arm) & (j <= plus_arm), tap, 0)
        total = term if total is None else total + term
    return total


def _clamped_window_sum(prefix, raw, minus_arm, plus_arm, axis: int):
    """The same window sum from an inclusive prefix sum of `raw`, plus the
    border re-counts of the taps that fall outside [0, n-1]."""
    n = raw.shape[axis]
    idx = _positions(n, axis, raw.device)
    border_lo = raw.narrow(axis, 0, 1)
    border_hi = raw.narrow(axis, n - 1, 1)
    lo = idx + minus_arm
    hi = idx + plus_arm
    hi_c = torch.clamp(hi, max=n - 1).expand(prefix.shape)
    lo_c = torch.clamp(lo, min=0)
    upper = torch.gather(prefix, axis, hi_c.long())
    lower = torch.gather(prefix, axis,
                         torch.clamp(lo_c - 1, min=0).expand(prefix.shape).long())
    lower = torch.where((lo_c > 0).expand(lower.shape), lower, 0)
    extra_lo = torch.clamp(-lo, min=0).to(raw.dtype) * border_lo
    extra_hi = torch.clamp(hi - (n - 1), min=0).to(raw.dtype) * border_hi
    return (upper - lower) + extra_lo + extra_hi


def _check_arm_len(arm_len: int) -> None:
    if not 1 <= arm_len <= 127:
        raise ValueError(f"vote counts are uint8 (at most 2*arm_len + 1 taps): "
                         f"need 1 <= arm_len <= 127, got {arm_len}")


def _indicator(idx: torch.Tensor, num_disp: int) -> torch.Tensor:
    ds = torch.arange(num_disp, dtype=torch.int32, device=idx.device)
    return (idx[None] == ds[:, None, None]).to(torch.int32)


def _mode(tab: torch.Tensor) -> torch.Tensor:
    """argmax over d with ties to the highest d, int32."""
    D = tab.shape[0]
    return (D - 1) - torch.argmax(tab.flip(0), dim=0).to(torch.int32)


def vote_counts_plain(idx: torch.Tensor, arms_l: torch.Tensor, num_disp: int,
                      arm_len: int) -> torch.Tensor:
    """rc[d, y, x] = #{j in [hm, hp] ∩ [-L, L] : idx[y, clamp(x + j)] == d}
    with (hm, hp) = the h arms of (y, x).  idx: (H, W) int32 bins.
    Returns (num_disp, H, W) uint8."""
    _check_arm_len(arm_len)
    rc = _clamped_window_taps(_indicator(idx, num_disp), arms_l[0][None],
                              arms_l[1][None], arm_len, axis=2)
    return rc.to(torch.uint8)


def vote_mode_plain(rc: torch.Tensor, arms_l: torch.Tensor,
                    arm_len: int) -> torch.Tensor:
    """tab[d, y, x] = sum of rc[d, clamp(y + i), x] over i in [vm, vp] ∩
    [-L, L], with (vm, vp) the v arms of the ANCHOR pixel (y, x); returns
    the (H, W) int32 mode, ties to the highest d."""
    tab = _clamped_window_taps(rc.to(torch.int32), arms_l[2][None],
                               arms_l[3][None], arm_len, axis=1)
    return _mode(tab)


def histogram_vote(disp_img: torch.Tensor, arms_l: torch.Tensor, d_max: int,
                   quantize: bool = True, arm_len: int = 25,
                   impl: str = "auto") -> torch.Tensor:
    """`Disparity`: the mode of the initial disparity over the cross.

    disp_img: (H, W) stored image value in [0, 1]; arms_l: (4, H, W) int32
    left-image arms.  impl (StereoConfig.oii_impl, see kernels.oii_route):
    "taps" = masked shifts, "prefix" = cumsum + gathers with the border
    re-counts (integer-identical), "pallas" = the CUDA kernel K8, "auto" =
    K8 on CUDA tensors and "taps" elsewhere.  Returns the refined map as a
    stored image value in [0, 1]."""
    from ..kernels import oii_route

    route = oii_route(impl, disp_img)
    num_disp = d_max + 1
    idx = vote_indices(disp_img, d_max)
    if route == "kernels":
        from ..kernels.cross_oii import vote_h, vote_v

        mode = vote_v(vote_h(idx, arms_l, num_disp, arm_len), arms_l, arm_len)
    elif route == "taps":
        mode = vote_mode_plain(vote_counts_plain(idx, arms_l, num_disp,
                                                 arm_len), arms_l, arm_len)
    else:
        ind = _indicator(idx, num_disp)
        rc = _clamped_window_sum(torch.cumsum(ind, dim=2), ind,
                                 arms_l[0][None], arms_l[1][None], axis=2)
        tab = _clamped_window_sum(torch.cumsum(rc, dim=1), rc,
                                  arms_l[2][None], arms_l[3][None], axis=1)
        mode = _mode(tab)
    return disparity_to_image(mode, d_max, quantize)
