"""Synthetic stereo scenes with a known ground-truth disparity: a textured
right view warped by a piecewise-constant disparity map (fronto-parallel
layers), plus a non-occlusion mask in the manner of Middlebury's
"nonocc" protocol."""

from __future__ import annotations

import numpy as np


def synthetic_scene(rng, H: int = 96, W: int = 160, d_max: int = 12):
    """(left, right, gt, mask): float32 views on the UNORM8 grid, the
    left-view ground-truth disparity in pixels, and the non-occluded
    valid mask.

    The RIGHT image is a smooth random texture; the LEFT view samples it
    at x - d(x, y) (left pixel x matches right pixel x - d, the
    reference's correspondence convention).
    """
    # Smooth texture: blurred noise, strong local gradients for matching.
    tex = rng.random((H, W + d_max, 3)).astype(np.float32)
    k = np.ones(5) / 5.0
    for ax in (0, 1):
        tex = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), ax, tex)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    tex = np.round(tex * 255.0) / 255.0  # UNORM8 grid

    # Piecewise-constant disparity: background + two nearer rectangles.
    gt = np.full((H, W), min(3, d_max), np.int32)
    gt[H // 5:H * 7 // 10, W // 5:W * 9 // 16] = (3 + d_max) // 2
    gt[H * 2 // 5:H * 17 // 20, W * 5 // 8:W * 15 // 16] = d_max
    xs = np.arange(W)[None, :]

    right = tex[:, :W].astype(np.float32)
    src = np.clip(xs - gt, 0, W - 1)
    left = right[np.arange(H)[:, None], src]

    # Occlusion mask (left view): pixels within a disparity jump of the
    # left edge of a nearer region, plus the left border (x < d has no
    # match).
    occ = xs < gt
    jump = np.zeros_like(occ)
    d_pad = np.pad(gt, [(0, 0), (0, 1)], mode="edge")
    rise = d_pad[:, 1:] - gt  # disparity of the pixel to our right - ours
    for shift in range(1, d_max + 1):
        jump |= np.roll(rise >= shift, -shift + 1, axis=1)
    mask = ~(occ | jump)
    return left, right, gt.astype(np.float32), mask
