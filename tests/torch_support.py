"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py).

Inputs are made with numpy and handed to both the JAX package and the
port as copies, so neither side sees the other's arrays.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch


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


def unorm8_pair(rng, H: int, W: int):
    """A random (H, W, 3) pair on the UNORM8 grid; the right view is the
    left one shifted by 2 columns so that matching has a true answer."""
    left = (rng.integers(0, 256, (H, W, 3)) / np.float32(255.0)).astype(
        np.float32)
    return left, np.ascontiguousarray(np.roll(left, -2, axis=1))
