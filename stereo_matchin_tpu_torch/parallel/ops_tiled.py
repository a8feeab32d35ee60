"""Tile-aware ops of the sharded pipelines; the port of
`stereo_matchin_tpu/parallel/ops_tiled.py`.

A row shard runs the plain ops on its halo-padded tile (parallel/halo.py):
vertical neighbours are rows of the tile (no clamp: the padding holds the
global clamp-to-edge), and the support weights' distance term uses
GLOBAL rows, so the reference's clamped-distance quirk lands on the frame
border, not on the tile border.  Each JAX function is a port op that
takes the shard's offsets as arguments:

  stack_shift_x_offset  -> ops.shifted_columns(plane, n_local, d0)
  sad_cost_volume_shard -> ops.sad_cost(l, r, n_local, scale, d0, kernels)
                           (K6 on CUDA tensors)
  support_weights_tiled -> support_weights_tiled below:
                           ops.support_weights anchored at the tile's
                           frame rows (row0, h_glob), centre rows kept
                           (K9 on CUDA tensors, writing only those rows)
  asw_vpass_tiled       -> ops.asw_den_plain + ops.asw_pass_win_plain on
                           the (Dl, H_loc + 2R, W) tile (K1 and the
                           windowed K2 on CUDA tensors)
  asw_hpass             -> ops.asw_pass_plain(axis=2, d0) (K2 h)
  refine_vpass_tiled    -> ops.refine_pass_v_win on the padded maps (K10
                           win on CUDA tensors)
  median3x3_tiled       -> median3x3_tiled below (K12 on CUDA tensors)
"""

from __future__ import annotations

import torch

from ..ops.median import median3x3
from ..ops.support import support_weights


def support_weights_tiled(img_padded: torch.Tensor, radius: int,
                          gamma_c: float, gamma_p: float, row_start: int,
                          h_global: int, halo: int,
                          kernels: str = "auto") -> torch.Tensor:
    """Vertical support weights for the CENTRE rows of a halo-padded tile
    (H_loc + 2*halo, W, 3), halo >= radius; row_start: the global row of
    the first centre row.  Returns (T, H_loc, W), equal to the whole
    frame's weights on those rows.  kernels (kernels.use_kernels): K9
    writes the centre rows alone, the plain ops compute the whole tile's
    strip and slice it."""
    from ..kernels import use_kernels

    if halo < radius:
        raise ValueError(f"a halo of {halo} rows cannot serve radius {radius}")
    rows = img_padded.shape[0] - 2 * halo
    if use_kernels(kernels, img_padded):
        from ..kernels.asw_refine import support_w
        return support_w(img_padded, radius, gamma_c, gamma_p, 0,
                         row_start - halo, h_global, (halo, rows))
    w = support_weights(img_padded, radius, gamma_c, gamma_p, 0,
                        row_start - halo, h_global, kernels="jnp")
    return w[:, halo:halo + rows].contiguous()


def median3x3_tiled(img_padded: torch.Tensor,
                    kernels: str = "auto") -> torch.Tensor:
    """3x3 median of the centre rows of a 1-row halo-padded tile: the
    median of the tile (K12 or the plain ops, kernels.use_kernels) without
    its first and last rows (whose clamped reads never reach a centre
    row)."""
    return median3x3(img_padded, kernels)[1:-1].contiguous()
