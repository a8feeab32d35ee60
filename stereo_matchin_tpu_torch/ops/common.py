"""Shared tensor helpers for the stereo ops (PyTorch port of
`stereo_matchin_tpu/ops/common.py`).

Clamp-to-edge neighbour reads (the reference's CLK_ADDRESS_CLAMP_TO_EDGE
sampler) and the UNORM8 image round trips.  Every disparity <-> image
conversion here is division-free and exact, so the CPU, the GPU and the
JAX package all produce the same bits: the 8-bit code comes from integer
arithmetic and the level k/255 from the closed-form bitcast
(`unorm8_level`).  The JAX module's docstrings (`unorm8`, `to_unit`) give
the full argument; no runtime `x / d_max` appears anywhere in the port.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# k/255 for every 8-bit code, correctly rounded to f32 (computed in f64).
_UNORM8_LEVELS = (np.arange(256, dtype=np.float64) / 255.0).astype(np.float32)


def shift_axis(x: torch.Tensor, shift: int, axis: int) -> torch.Tensor:
    """out[..., i, ...] = x[..., clamp(i + shift), ...] (clamp-to-edge)."""
    n = x.shape[axis]
    idx = (torch.arange(n, device=x.device) + shift).clamp_(0, n - 1)
    return x.index_select(axis, idx)


def edge_pad(x: torch.Tensor, before: int, after: int, axis: int) -> torch.Tensor:
    """Replicate-pad `x` along `axis`: out[..., j, ...] = x[..., clamp(j - before), ...]."""
    n = x.shape[axis]
    idx = torch.arange(-before, n + after, device=x.device).clamp_(0, n - 1)
    return x.index_select(axis, idx)


def unorm8_code(v: torch.Tensor) -> torch.Tensor:
    """[0,1] float -> int32 8-bit code, round to nearest with ties toward
    zero.  floor is exact and t - floor(t) is exact, so the compare
    carries no rounding."""
    t = v * 255.0
    f = torch.floor(t)
    return (f + (t - f > 0.5).to(t.dtype)).clamp(0, 255).to(torch.int32)


def unorm8_level(k: torch.Tensor) -> torch.Tensor:
    """int32 code k in [0, 255] -> correctly rounded fl32(k/255).

    k * 65793 / (2^24 - 1) == k / 255, so base = float(k * 65793) * 2^-24
    is exact and fl32(k/255) is exactly one integer-bitcast increment
    above it for every k >= 1."""
    k = k.to(torch.int32)
    base = (k * 65793).to(torch.float32) * (2.0 ** -24)
    bits = base.view(torch.int32) + (k > 0).to(torch.int32)
    return bits.view(torch.float32)


def to_unit(d: torch.Tensor, d_max: int) -> torch.Tensor:
    """d * fl32(1/d_max): one explicit constant multiply, for the
    non-quantized rescales only (never feed it into a UNORM8 path)."""
    return d * float(np.float32(np.float32(1.0) / np.float32(d_max)))


def _golden_codes(d_max: int) -> np.ndarray:
    """The 8-bit code of every integer disparity in the golden device's
    semantics: round-ties-toward-zero(fl32(fl32(d / d_max) * 255)) with a
    true IEEE division, computed on the host with numpy."""
    d = np.arange(d_max + 1, dtype=np.float32)
    v = d / np.float32(d_max)
    t = v * np.float32(255.0)
    f = np.floor(t)
    return np.clip(f + (t - f > np.float32(0.5)), 0, 255).astype(np.int64)


@functools.cache
def _disp_code_params(d_max: int):
    """Integer multiply-shift (A, B, S) with (A*d + B) >> S equal to
    _golden_codes(d_max)[d] for every integer d in [0, d_max], checked
    exhaustively here.  None if no triple exists (then callers gather
    from the level table)."""
    k = _golden_codes(d_max)
    d = np.arange(d_max + 1, dtype=np.int64)
    step = np.float64(255) / np.float64(d_max)       # host double: a search seed
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


@functools.cache
def _level_table(d_max: int, device: torch.device) -> torch.Tensor:
    """The UNORM8 level of every integer disparity 0 .. d_max, on `device`,
    built once: a host-to-device copy cannot run while a CUDA graph is
    being captured, so the warm-up builds it and the capture reuses it."""
    return torch.as_tensor(_UNORM8_LEVELS[_golden_codes(d_max)],
                           device=device)


def disparity_to_image(d: torch.Tensor, d_max: int,
                       quantize: bool = True) -> torch.Tensor:
    """Store an integer-valued disparity on [0, d_max] as the reference's
    UNORM8 image value: the code by exact int32 multiply-shift, the level
    in closed form.  quantize=False: the raw constant-multiply rescale."""
    if not quantize:
        return d * float(np.float32(1.0 / np.float32(d_max)))
    di = torch.round(d) if d.is_floating_point() else d
    di = di.to(torch.int32).clamp(0, d_max)
    params = _disp_code_params(d_max)
    if params is None:
        return _level_table(d_max, d.device)[di.long()]
    A, B, S = params
    return unorm8_level((di * A + B) >> S)


def image_from_q(q: torch.Tensor, d_max: int) -> torch.Tensor:
    """Exact UNORM8 image value from a disparity on the quantized
    [0, d_max] grid: |q * fl(255/d_max) - k| < 6e-5, so the round is never
    near a boundary; the level is then closed-form exact."""
    c = float(np.float32(np.float32(255.0) / np.float32(d_max)))
    k = torch.round(q * c).clamp(0, 255).to(torch.int32)
    return unorm8_level(k)
