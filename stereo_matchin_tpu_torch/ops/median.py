"""3x3 median filter (clamp-to-edge), per channel; PyTorch port of
`stereo_matchin_tpu/ops/median.py` (reference kernels/median.cl, whose
float4 min/max sorting network equals a per-channel 3x3 median).

`median3x3` routes by its `kernels` keyword (kernels.use_kernels): "auto"
launches the CUDA kernel K12 (kernels/median.py) on a CUDA tensor, "jnp"
runs `median3x3_plain`, its plain version, everywhere.
"""

from __future__ import annotations

import torch

from .common import edge_pad

# The 19-exchange 9-element median selection network: after these ordered
# min/max exchanges slot 4 holds the median.
_MED9_NET = [
    (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5), (7, 8),
    (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7), (4, 2), (6, 4),
    (4, 2),
]


def median3x3(img: torch.Tensor, kernels: str = "auto") -> torch.Tensor:
    """img: (H, W) or (H, W, C) float with finite values. Returns the same
    shape, contiguous: K12 or `median3x3_plain` (kernels.use_kernels)."""
    from ..kernels import use_kernels

    if use_kernels(kernels, img):
        from ..kernels.median import median3x3 as median_kernel

        return median_kernel(img)
    return median3x3_plain(img)


def median3x3_plain(img: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel K12: the selection network over nine
    slices of the edge-padded channel-first image."""
    chan = img.dim() == 3
    x = img.movedim(-1, 0) if chan else img[None]            # (C, H, W)
    H, W = x.shape[1], x.shape[2]
    ext = edge_pad(edge_pad(x, 1, 1, 1), 1, 1, 2)
    taps = [ext[:, dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)]
    for i, j in _MED9_NET:
        taps[i], taps[j] = (torch.minimum(taps[i], taps[j]),
                            torch.maximum(taps[i], taps[j]))
    med = taps[4]
    return (med.movedim(0, -1) if chan else med[0]).contiguous()


def median_dispatch_truncate(out: torch.Tensor) -> torch.Tensor:
    """Zero the bottom H mod 3 rows and right W mod 3 columns that the
    reference's Median dispatches never write (main.cpp:193, floor in the
    work-group count); a no-op when both dimensions divide by 3."""
    H, W = out.shape[0], out.shape[1]
    Hq, Wq = (H // 3) * 3, (W // 3) * 3
    if Hq == H and Wq == W:
        return out
    keep = torch.zeros((H, W), dtype=torch.bool, device=out.device)
    keep[:Hq, :Wq] = True
    return torch.where(keep[(...,) + (None,) * (out.dim() - 2)], out, 0.0)
