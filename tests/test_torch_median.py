"""Kernel K12 (median3x3) of the port: `ops.median3x3`'s routes and its
plain version against the JAX package's median3x3
(stereo_matchin_tpu/ops/median.py), bit-equal, and a numpy walk of the
kernel's indexing (kernels/median.py, csrc/median.cu: one thread per
element of the (H, W, C) image in its own layout) against the plain
version at edge shapes.  The CUDA kernel is held to the plain version on
the card in tests/test_torch_cuda.py and chip_smoke.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_matchin_tpu.ops.median import median3x3 as jax_median
from stereo_matchin_tpu.parallel import ops_tiled as jtiled
from stereo_matchin_tpu_torch import kernels
from stereo_matchin_tpu_torch import ops as tops
from stereo_matchin_tpu_torch.kernels import median as km
from stereo_matchin_tpu_torch.ops.median import _MED9_NET
from stereo_matchin_tpu_torch.parallel import ops_tiled

from .torch_support import n, t

# (H, W, C; C = 0 for an (H, W) map): one pixel, one row, one column, 2x2,
# odd sizes, one channel kept as an axis, and a row past one block.
SHAPES = [(1, 1, 0), (1, 7, 3), (5, 1, 0), (2, 2, 3), (37, 53, 3),
          (37, 53, 0), (37, 53, 1), (3, 300, 0), (9, 11, 4)]


def _image(seed, H, W, C, levels=6):
    """Values on a few levels: many equal-value ties in every window."""
    rng = np.random.default_rng(seed)
    shape = (H, W, C) if C else (H, W)
    return (rng.integers(0, levels, shape) / np.float32(levels - 1)).astype(
        np.float32)


def walk_median(img: np.ndarray) -> np.ndarray:
    """K12 as csrc/median.cu indexes it: every thread of ceil(n / THREADS)
    blocks takes element e = block * THREADS + thread of the flat (H, W, C)
    image, e < n, reads its nine clamped taps at (y * W + x) * C + c and
    runs the exchanges in order."""
    H, W = img.shape[:2]
    C = img.shape[2] if img.ndim == 3 else 1
    flat = np.ascontiguousarray(img).reshape(-1)
    count = flat.size
    blocks = -(-count // km.THREADS)
    e = np.arange(blocks * km.THREADS)
    e = e[e < count]
    c, p = e % C, e // C
    x, y = p % W, p // W
    rows = [np.maximum(y - 1, 0) * W, y * W, np.minimum(y + 1, H - 1) * W]
    cols = [np.maximum(x - 1, 0), x, np.minimum(x + 1, W - 1)]
    taps = [flat[(rows[dy] + cols[dx]) * C + c] for dy in range(3)
            for dx in range(3)]
    for i, j in _MED9_NET:
        taps[i], taps[j] = (np.minimum(taps[i], taps[j]),
                            np.maximum(taps[i], taps[j]))
    out = np.empty(count, np.float32)
    out[e] = taps[4]
    return out.reshape(img.shape)


@pytest.mark.parametrize("H,W,C", SHAPES)
def test_routes_equal_the_jax_median(H, W, C):
    img = _image(H * 131 + W * 7 + C, H, W, C)
    want = np.asarray(jax_median(jnp.asarray(img)))
    before = dict(kernels.LAUNCHES)
    for mode in ("auto", "jnp"):
        got = tops.median3x3(t(img), kernels=mode)
        assert got.shape == img.shape and got.is_contiguous()
        np.testing.assert_array_equal(n(got), want)
    np.testing.assert_array_equal(n(tops.median3x3_plain(t(img))), want)
    np.testing.assert_array_equal(n(km.median3x3(t(img))), want)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("H,W,C", SHAPES)
def test_walk_of_the_kernel_equals_the_plain_version(H, W, C):
    img = _image(H * 17 + W + C, H, W, C, levels=4)
    np.testing.assert_array_equal(walk_median(img),
                                  n(tops.median3x3_plain(t(img))))


def test_walk_reads_a_channel_view_through_its_copy():
    """A non-contiguous (H, W) channel view: the wrapper hands the kernel
    a contiguous copy, whose walk equals the plain version of the view."""
    img = _image(3, 23, 31, 3)
    view = t(img)[..., 1]
    assert not view.is_contiguous()
    np.testing.assert_array_equal(walk_median(n(view.contiguous())),
                                  n(tops.median3x3_plain(view)))


def test_pallas_route_raises_on_the_cpu():
    img = t(_image(4, 6, 7, 3))
    with pytest.raises(ValueError):
        tops.median3x3(img, kernels="pallas")
    with pytest.raises(ValueError):
        tops.median3x3(img, kernels="xla")


def test_wrapper_refuses_bad_inputs():
    with pytest.raises(ValueError):
        km.median3x3(torch.zeros(2, 3, 4, 5))
    with pytest.raises(TypeError):
        km.median3x3(torch.zeros(4, 5, dtype=torch.float64))


@pytest.mark.parametrize("mode", ["auto", "jnp"])
def test_tiled_median_equals_the_jax_tiled_median(mode):
    img = _image(5, 14, 19, 0)
    got = ops_tiled.median3x3_tiled(t(img), mode)
    np.testing.assert_array_equal(
        n(got), np.asarray(jtiled.median3x3_tiled(jnp.asarray(img))))
