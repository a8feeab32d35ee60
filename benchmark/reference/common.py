"""Plain PyTorch helpers shared by the two reference pipelines.

A frozen copy of the port's plain ops (`stereo_matchin_tpu_torch/ops/`
common.py, cost.py, median.py, consistency.py), written again here so
that the benchmark's reference imports nothing of the program: the same
operations in the same order, each rounded once, so that on float32
inputs they give the kernels' bits.  `dt` parameters let the control run
the arithmetic in a lower precision; the UNORM8 conversions always run on
float32 maps of integer disparities, where they are exact.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# k/255 for every 8-bit code, correctly rounded to f32 (computed in f64).
_UNORM8_LEVELS = (np.arange(256, dtype=np.float64) / 255.0).astype(np.float32)

# The 19-exchange 9-element median selection network (slot 4 = median).
_MED9_NET = [
    (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5), (7, 8),
    (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7), (4, 2), (6, 4),
    (4, 2),
]


def edge_pad(x: torch.Tensor, before: int, after: int, axis: int):
    """out[..., j, ...] = x[..., clamp(j - before), ...] along `axis`."""
    n = x.shape[axis]
    idx = torch.arange(-before, n + after, device=x.device).clamp_(0, n - 1)
    return x.index_select(axis, idx)


def shifted_columns(plane: torch.Tensor, num_disp: int, d0: int = 0):
    """(..., W) -> (num_disp, ..., W): out[d, ..., x] = plane[..., max(x -
    d0 - d, 0)], the reference's right-image read."""
    W = plane.shape[-1]
    xs = torch.arange(W, device=plane.device)
    ds = torch.arange(num_disp, device=plane.device)[:, None]
    idx = (xs[None] - d0 - ds).clamp_(min=0)
    return plane[..., idx].movedim(-2, 0)


def sad_cost_volume(left, right, num_disp: int, scale: float = 1.0,
                    d0: int = 0):
    """(|l0 - r0| + |l1 - r1|) + |l2 - r2| on the `scale` grid, right read
    at (y, max(x - d0 - d, 0)); (num_disp, H, W)."""
    l = left.movedim(-1, 0) * scale
    r = right.movedim(-1, 0) * scale
    cost = None
    for c in range(3):
        term = (l[c][None] - shifted_columns(r[c], num_disp, d0)).abs()
        cost = term if cost is None else cost + term
    return cost.contiguous()


def unorm8_level(k: torch.Tensor) -> torch.Tensor:
    """int32 code k in [0, 255] -> correctly rounded fl32(k / 255), in
    closed form: k * 65793 * 2^-24 is exact and one bit below it."""
    k = k.to(torch.int32)
    base = (k * 65793).to(torch.float32) * (2.0 ** -24)
    bits = base.view(torch.int32) + (k > 0).to(torch.int32)
    return bits.view(torch.float32)


def unorm8_code(v: torch.Tensor) -> torch.Tensor:
    """[0, 1] float -> int32 code, round to nearest with ties toward zero."""
    t = v.to(torch.float32) * 255.0
    f = torch.floor(t)
    return (f + (t - f > 0.5).to(t.dtype)).clamp(0, 255).to(torch.int32)


def _golden_codes(d_max: int) -> np.ndarray:
    """The 8-bit code of each integer disparity: round-ties-toward-zero of
    fl32(fl32(d / d_max) * 255), IEEE division, on the host."""
    d = np.arange(d_max + 1, dtype=np.float32)
    t = (d / np.float32(d_max)) * np.float32(255.0)
    f = np.floor(t)
    return np.clip(f + (t - f > np.float32(0.5)), 0, 255).astype(np.int64)


@functools.cache
def _disp_code_params(d_max: int):
    """(A, B, S) with (A * d + B) >> S the golden code of every integer d
    in [0, d_max], checked here; None where no such triple exists."""
    k = _golden_codes(d_max)
    d = np.arange(d_max + 1, dtype=np.int64)
    step = np.float64(255) / np.float64(d_max)
    for S in range(14, 27):
        A0 = int(round(step * 2 ** S))
        for A in (A0 - 1, A0, A0 + 1):
            if A <= 0 or A * d_max >= 2 ** 31 - 2 ** S:
                continue
            b_lo = int(((k << S) - A * d).max())
            b_hi = int((((k + 1) << S) - A * d - 1).min())
            if b_lo <= b_hi and b_lo >= 0 and A * d_max + b_lo < 2 ** 31:
                if not (((A * d + b_lo) >> S) == k).all():
                    raise AssertionError((d_max, A, b_lo, S))
                return A, b_lo, S
    return None


def disparity_to_image(d: torch.Tensor, d_max: int,
                       quantize: bool = True) -> torch.Tensor:
    """An integer-valued disparity on [0, d_max] as the reference's stored
    UNORM8 image value (float32)."""
    if not quantize:
        return d.to(torch.float32) * float(np.float32(1.0 / np.float32(d_max)))
    di = torch.round(d) if d.is_floating_point() else d
    di = di.to(torch.int32).clamp(0, d_max)
    params = _disp_code_params(d_max)
    if params is None:
        table = torch.as_tensor(_UNORM8_LEVELS[_golden_codes(d_max)],
                                device=d.device)
        return table[di.long()]
    A, B, S = params
    return unorm8_level((di * A + B) >> S)


def image_from_q(q: torch.Tensor, d_max: int) -> torch.Tensor:
    """Exact UNORM8 image value of a disparity on the quantized grid."""
    c = float(np.float32(np.float32(255.0) / np.float32(d_max)))
    k = torch.round(q.to(torch.float32) * c).clamp(0, 255).to(torch.int32)
    return unorm8_level(k)


def to_unit(d: torch.Tensor, d_max: int) -> torch.Tensor:
    return d.to(torch.float32) * float(np.float32(np.float32(1.0)
                                                  / np.float32(d_max)))


def median3x3(img: torch.Tensor) -> torch.Tensor:
    """Clamp-to-edge 3x3 median per channel of an (H, W) or (H, W, C)
    image: the selection network over nine shifted views."""
    chan = img.dim() == 3
    x = img.movedim(-1, 0) if chan else img[None]
    H, W = x.shape[1], x.shape[2]
    ext = edge_pad(edge_pad(x, 1, 1, 1), 1, 1, 2)
    taps = [ext[:, dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)]
    for i, j in _MED9_NET:
        taps[i], taps[j] = (torch.minimum(taps[i], taps[j]),
                            torch.maximum(taps[i], taps[j]))
    med = taps[4]
    return (med.movedim(0, -1) if chan else med[0]).contiguous()


def median_dispatch_truncate(out: torch.Tensor) -> torch.Tensor:
    """Zero the bottom H mod 3 rows and right W mod 3 columns the
    reference's Median dispatch never writes."""
    H, W = out.shape[0], out.shape[1]
    Hq, Wq = (H // 3) * 3, (W // 3) * 3
    if Hq == H and Wq == W:
        return out
    keep = torch.zeros((H, W), dtype=torch.bool, device=out.device)
    keep[:Hq, :Wq] = True
    return torch.where(keep[(...,) + (None,) * (out.dim() - 2)], out, 0.0)


def consistency(d_ref, d_target, conf_ref, conf_target,
                threshold: float = 1.001):
    """(filled, conf_ref, conf_target, consistent): a pixel is consistent
    where |d_target - d_ref| < threshold on the [0, d_max] scale."""
    consistent = (d_target - d_ref).abs() < threshold
    return (torch.where(consistent, d_ref, d_target),
            torch.where(consistent, conf_ref, 0.0),
            torch.where(consistent, conf_target, 0.0), consistent)


def red_diagnostic(d_img, consistent):
    """(H, W, 3): the stored disparity where consistent, pure red where not."""
    r = torch.where(consistent, d_img, 1.0)
    g = torch.where(consistent, d_img, 0.0)
    return torch.stack([r, g, g], dim=-1)
