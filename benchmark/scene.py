"""Seeded stereo pairs made on the device: the benchmark's scene generator.

The recipe is `stereo_matchin_tpu_torch/eval/synthetic.py`'s, written in
PyTorch so that a full-size Middlebury pair is made on the card in a few
calls instead of NumPy loops on the host:

  * the RIGHT view is a smooth texture: uniform noise blurred by a 5-tap
    box along each axis, stretched to [0, 1] and put on the UNORM8 grid
    (each value is fl32(k / 255) for an 8-bit code k, as a PNG decodes);
  * the LEFT view samples it at x - d(y, x) (left pixel x matches right
    pixel x - d, the reference's convention), d a layered map: a far
    background at 0 and LAYERS - 1 fronto-parallel rectangles at
    disparities spread evenly up to d_max, nearer layers painted last.

Every seed gets the same layer disparities and rectangle sizes, each
rectangle at least its disparity from the left edge; the seed moves the
rectangles and draws the texture.  So the work the kernels do (K4's
diagonal walk follows d, K5's arms and K7's windows follow the texture)
is alike from seed to seed while the answers differ.

Only elementwise ops, gathers and min/max reductions are used (no
convolution, whose algorithm may change between runs), so one seed gives
the same bits on one device type every time.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

LAYERS = 6
# Rectangle height and width as fractions of the frame, nearest last.
RECT_FRACTIONS = ((0.55, 0.45), (0.45, 0.40), (0.40, 0.30), (0.30, 0.25),
                  (0.20, 0.15))
BOX = 5

# k / 255 for every 8-bit code, correctly rounded to f32 as
# `codes / np.float32(255)` decodes a PNG.
UNORM8_LEVELS = (np.arange(256) / np.float32(255.0)).astype(np.float32)


class Pair(NamedTuple):
    left: torch.Tensor        # (H, W, 3) float32 on the UNORM8 grid
    right: torch.Tensor
    disparity: torch.Tensor   # (H, W) int32 ground truth of the left view


def layer_disparities(d_max: int) -> list:
    """The LAYERS disparities: 0, evenly spaced values, d_max."""
    return [round(i * d_max / (LAYERS - 1)) for i in range(LAYERS)]


def _box(x: torch.Tensor, dim: int) -> torch.Tensor:
    """5-tap box mean along `dim` with zeros past the edges
    (np.convolve(mode="same")), summed in tap order."""
    n = x.shape[dim]
    pad = [0, 0] * (x.dim() - 1 - dim) + [BOX // 2, BOX // 2]
    ext = torch.nn.functional.pad(x, pad)
    total = ext.narrow(dim, 0, n)
    for t in range(1, BOX):
        total = total + ext.narrow(dim, t, n)
    return total / BOX


def _disparity_map(gen: torch.Generator, H: int, W: int, d_max: int,
                   device) -> torch.Tensor:
    disp = torch.zeros((H, W), dtype=torch.int32, device=device)
    ys = torch.arange(H, device=device)[:, None]
    xs = torch.arange(W, device=device)[None, :]
    corners = torch.rand((len(RECT_FRACTIONS), 2), generator=gen,
                         device=device)
    for (fh, fw), d, c in zip(RECT_FRACTIONS, layer_disparities(d_max)[1:],
                              corners):
        h, w = max(1, int(fh * H)), max(1, int(fw * W))
        # x0 >= d where the frame allows: no left pixel of the rectangle
        # reads right of the frame's edge, so no seed gets runs of one
        # clamped colour, and the diagonal walk of each pixel (min(d, x))
        # is the same for every seed.
        lo = min(d, W - w)
        y0 = (c[0] * (H - h + 1)).floor().clamp(max=H - h).to(torch.int64)
        x0 = lo + (c[1] * (W - w - lo + 1)).floor().clamp(
            max=W - w - lo).to(torch.int64)
        inside = (ys >= y0) & (ys < y0 + h) & (xs >= x0) & (xs < x0 + w)
        disp = torch.where(inside, d, disp)
    return disp


def make_pair(gen: torch.Generator, H: int, W: int, d_max: int,
              device) -> Pair:
    """One pair from the generator's next draws."""
    noise = torch.rand((H, W + d_max, 3), generator=gen, device=device)
    tex = _box(_box(noise, 0), 1)
    lo, hi = tex.amin(), tex.amax()
    codes = torch.round((tex - lo) / (hi - lo) * 255.0).to(torch.int64)
    levels = torch.from_numpy(UNORM8_LEVELS).to(device)
    right = levels[codes[:, :W]].contiguous()
    disp = _disparity_map(gen, H, W, d_max, device)
    src = (torch.arange(W, device=device)[None, :] - disp).clamp(0, W - 1)
    rows = torch.arange(H, device=device)[:, None]
    left = right[rows, src].contiguous()
    return Pair(left, right, disp)


KINDS = {"layered": make_pair}


def make_pairs(seed: int, sizes, pairs_per_size: int, d_max: int,
               device, kind: str = "layered") -> list:
    """pairs_per_size pairs of every (H, W) in `sizes`, in the order
    sizes[0] pair 0, sizes[1] pair 0, ..., sizes[0] pair 1, ...: the
    order a stream that meets its sizes in turn sends them.  One
    generator on `device`, seeded with `seed`, draws them all; `kind`
    names the scene's recipe (KINDS)."""
    if kind not in KINDS:
        raise ValueError(f"no scene kind {kind!r}; have {sorted(KINDS)}")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return [KINDS[kind](gen, H, W, d_max, device)
            for _ in range(pairs_per_size) for H, W in sizes]
