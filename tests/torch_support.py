"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py).

Inputs are made with numpy and handed to both the JAX package and the
port as copies, so neither side sees the other's arrays; configurations
are built for each side from the same keywords (`config_pair`).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

# TINY_CONFIG's keywords (BASELINE.json config[0]), in both packages.
TINY = dict(d_max=15, radius=4, arm_len=6, r_iters=2, k_iters=2)


def config_pair(**kw):
    """(JAX StereoConfig, port StereoConfig) from one set of keywords: the
    JAX one for the JAX package, the port's own for the port."""
    from stereo_matchin_tpu.config import StereoConfig as JaxConfig
    from stereo_matchin_tpu_torch.config import StereoConfig

    return JaxConfig(**kw), StereoConfig(**kw)


def t(a) -> torch.Tensor:
    """A writable CPU tensor copy of a numpy or JAX array."""
    return torch.from_numpy(np.array(a))


def n(x) -> np.ndarray:
    """numpy view of a tensor or JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def max_ulp(a, b) -> int:
    """Largest distance in f32 units in the last place between two arrays."""
    def key(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    a, b = n(a), n(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(key(a) - key(b)).max()) if a.size else 0


def cuda_device() -> torch.device:
    """The card, or a skip: decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def outlier_d1(rng, D: int, H: int, W: int, head: int) -> np.ndarray:
    """A K4 disparity map whose diagonals mostly fit K4's first pass (d1 at
    most `head`) with about 3 outliers in [D // 3, D - 1] per 32 pixels:
    the map on which the second pass walks the outliers of sparse warps."""
    d1 = rng.integers(0, min(D, head + 1), H * W)
    out = rng.random(H * W) < 3 / 32
    d1[out] = rng.integers(D // 3, D, int(out.sum()))
    return d1.reshape(H, W).astype(np.int32)


def k4_queued(d1, D: int, head: int, sparse: int) -> np.ndarray:
    """The pixels (flat indices) whose diagonals K4's first pass leaves to
    its second: longer than `head` planes, in a warp (32 consecutive
    pixels) with at most `sparse` such lanes."""
    d1 = n(d1)
    H, W = d1.shape
    xs = np.arange(W)[None, :]
    longer = (np.minimum(d1, D - 1) - np.maximum(1, d1 - xs) + 1 > head)
    longer = np.concatenate([longer.ravel(), np.zeros(-H * W % 32, bool)])
    lanes = np.repeat(longer.reshape(-1, 32).sum(1), 32)
    return np.flatnonzero(longer & (lanes <= sparse))


def unorm8_pair(rng, H: int, W: int):
    """A random (H, W, 3) pair on the UNORM8 grid; the right view is the
    left one shifted by 2 columns so that matching has a true answer."""
    left = (rng.integers(0, 256, (H, W, 3)) / np.float32(255.0)).astype(
        np.float32)
    return left, np.ascontiguousarray(np.roll(left, -2, axis=1))
