"""ASW support weights (Yoon-Kweon joint colour + proximity weights);
PyTorch port of `stereo_matchin_tpu/ops/support.py` (reference
kernels/asw_vsupport.cl, asw_hsupport.cl).

    w[t, y, x] = exp(-SAD255(p, nb) / gamma_c - dist(p, nb) / gamma_p)

nb is the clamped neighbour at offset t - R along the axis and dist the
distance to the *clamped* coordinate, so edge taps get smaller spatial
penalties.

The divisions are written as multiplies by fl32(1/gamma): XLA rewrites a
division by a constant into exactly that, and PyTorch's CUDA division by
a Python scalar does the same, so the explicit form gives the same bits
on the CPU and on the card.  `exp` still differs between XLA, PyTorch's
CPU kernels and CUDA by a few ulp, so these weights match the JAX
package's only to a stated bound (tests/test_torch_ops.py); the pipeline
tests carry the JAX weights across (convert.weights_from_jax) where they
need equal inputs.

kernels="auto" (kernels.use_kernels) computes a strip with the CUDA
kernel K9 (kernels/asw_refine.py support_w) on a CUDA tensor: the fusion
of this chain that XLA makes of the JAX function, bit-equal to it.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import edge_pad


def weight_scales(gamma_c: float, gamma_p: float) -> tuple:
    """(inv_c, inv_p): fl32(1 / gamma_c) and fl32(1 / gamma_p), as floats."""
    return (float(np.float32(1.0) / np.float32(gamma_c)),
            float(np.float32(1.0) / np.float32(gamma_p)))


def support_weights(img: torch.Tensor, radius: int, gamma_c: float,
                    gamma_p: float, axis: int, row0: int = 0,
                    h_glob: int | None = None,
                    kernels: str = "auto") -> torch.Tensor:
    """img: (H, W, 3) in [0, 1].  axis=0 -> vertical taps, 1 -> horizontal.

    Returns (T, H, W) float32, T = 2*radius + 1, tap t at offset t - radius.
    On axis 0, img may hold frame rows row0 .. row0 + H - 1 of an
    h_glob-row frame (default: the whole frame): the distance term clamps
    the neighbour's FRAME row, so a row shard's weights equal the whole
    frame's where its taps stay inside img.  kernels: K9 or these ops
    (kernels.use_kernels)."""
    from ..kernels import use_kernels

    if use_kernels(kernels, img):
        from ..kernels.asw_refine import support_w
        return support_w(img, radius, gamma_c, gamma_p, axis, row0, h_glob)
    inv_c, inv_p = weight_scales(gamma_c, gamma_p)
    p = img.movedim(-1, 0) * 255.0                           # (3, H, W)
    n = p.shape[1 + axis]
    ext = edge_pad(p, radius, radius, 1 + axis)
    if axis == 0:
        coords = torch.arange(n, device=img.device) + row0
        last = (n if h_glob is None else h_glob) - 1
    else:
        coords, last = torch.arange(n, device=img.device), n - 1
    weights = []
    for t in range(2 * radius + 1):
        q = ext.narrow(1 + axis, t, n)
        a = (p - q).abs()
        c_diff = ((a[0] + a[1]) + a[2]) * inv_c
        clamped = (coords + (t - radius)).clamp(0, last)
        dist = (coords - clamped).abs().to(torch.float32) * inv_p
        dist2d = dist[:, None] if axis == 0 else dist[None, :]
        weights.append(torch.exp(-c_diff - dist2d))
    return torch.stack(weights, dim=0)
