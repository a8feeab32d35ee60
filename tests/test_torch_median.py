"""Kernel K12 (median3x3) of the port: `ops.median3x3`'s routes and its
plain version against the JAX package's median3x3
(stereo_matchin_tpu/ops/median.py), bit-equal, and a numpy walk of the
kernel's tiles (csrc/median.cu's plan, tests/torch_support.py k12_tiles:
tiles of a row's elements by ty rows staged with their halo, each thread
sliding its sorted row triples down its column) against the plain version
at edge shapes, and against the network in its own order on signed
zeros.  The CUDA kernel is held to the plain version on
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

from .torch_support import k12_tiles, n, t

# (H, W, C; C = 0 for an (H, W) map): one pixel, one row, one column, 2x2,
# odd sizes, one channel kept as an axis, and a row past one block; K12's
# tiles: H off the tile and over one tile of 32 rows, W * C off the tile
# and over two, H = 1 and W = 1 with three and four channels.
SHAPES = [(1, 1, 0), (1, 7, 3), (5, 1, 0), (2, 2, 3), (37, 53, 3),
          (37, 53, 0), (37, 53, 1), (3, 300, 0), (9, 11, 4),
          (70, 45, 3), (67, 300, 1), (1, 90, 4), (33, 1, 3), (45, 1, 4),
          (2, 129, 0)]


def _image(seed, H, W, C, levels=6):
    """Values on a few levels: many equal-value ties in every window."""
    rng = np.random.default_rng(seed)
    shape = (H, W, C) if C else (H, W)
    return (rng.integers(0, levels, shape) / np.float32(levels - 1)).astype(
        np.float32)


def walk_median(img: np.ndarray, blocks: int | None = None,
                mn=np.minimum, mx=np.maximum) -> np.ndarray:
    """K12 as csrc/median.cu tiles the image (k12_tiles, the kernel's plan
    for `blocks` blocks, the kernel's where None): block (bx, by) stages
    rows y0 - 1 .. y0 + ty of its `threads` elements and their C-element
    halo, each element index e of a row clamped (e < 0 -> e + C, W * C <=
    e < (W + 1) * C -> e - C, past that W * C - 1, read by no output) and
    each row to [0, H - 1]; thread t (element e0 + t < W * C) sorts each
    staged row's triple (taps e - C, e, e + C) by the network's first nine
    exchanges, slides the three sorted triples down its column and runs
    the other ten exchanges in the network's order for each of its rows
    below H.  An exchange (a, b) becomes (mn(a, b), mx(a, b))."""
    H, W = img.shape[:2]
    C = img.shape[2] if img.ndim == 3 else 1
    WC = W * C
    flat = np.ascontiguousarray(img, np.float32).reshape(H, WC)
    out = np.full((H, WC), np.nan, np.float32)
    threads, ty, gx, gy = k12_tiles(H, W, C, blocks)
    first, rest = _MED9_NET[:9], _MED9_NET[9:]
    assert sorted(first) == sorted([(1, 2), (0, 1), (1, 2), (4, 5), (3, 4),
                                    (4, 5), (7, 8), (6, 7), (7, 8)])
    sw = threads + 2 * C

    def sort3(a, b, c):
        """(1, 2), (0, 1), (1, 2) on one row's slots, as in _MED9_NET."""
        for i, j in ((1, 2), (0, 1), (1, 2)):
            s = [a, b, c]
            s[i], s[j] = mn(s[i], s[j]), mx(s[i], s[j])
            a, b, c = s
        return [a, b, c]

    for bx, by in np.ndindex(gx, gy):
        e0, y0 = bx * threads, by * ty
        e = e0 - C + np.arange(sw)
        e = np.where(e < 0, e + C,
                     np.where(e >= WC, np.where(e < WC + C, e - C, WC - 1),
                              e))
        rows = np.clip(y0 - 1 + np.arange(ty + 2), 0, H - 1)
        tile = flat[rows][:, e]                         # (ty + 2, sw)
        t = np.arange(threads)
        t = t[e0 + t < WC]
        tri = [sort3(tile[r, t], tile[r, t + C], tile[r, t + 2 * C])
               for r in range(ty + 2)]
        for r in range(min(ty, H - y0)):
            taps = tri[r] + tri[r + 1] + tri[r + 2]
            for i, j in rest:
                taps[i], taps[j] = (mn(taps[i], taps[j]),
                                    mx(taps[i], taps[j]))
            out[y0 + r, e0 + t] = taps[4]
    assert not np.isnan(out).any()
    return out.reshape(img.shape)


def network_median(img: np.ndarray, mn, mx) -> np.ndarray:
    """ops/median.py median3x3_plain's order: the nine edge-clamped taps
    of every element, then _MED9_NET's 19 exchanges in order, each (a, b)
    -> (mn(a, b), mx(a, b))."""
    x = img if img.ndim == 3 else img[..., None]
    H, W = x.shape[:2]
    p = np.pad(x, ((1, 1), (1, 1), (0, 0)), mode="edge")
    taps = [p[dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)]
    for i, j in _MED9_NET:
        taps[i], taps[j] = mn(taps[i], taps[j]), mx(taps[i], taps[j])
    return taps[4].reshape(img.shape)


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


@pytest.mark.parametrize("tiles", ["plan", "tallest"])
@pytest.mark.parametrize("H,W,C", SHAPES)
def test_walk_of_the_kernel_equals_the_plain_version(H, W, C, tiles):
    """The plan's tiles (small frames: the shortest, so that the grid
    fills the card) and the tallest (for one block: kTyMaxK12 rows, as at
    config 3)."""
    blocks = 1 if tiles == "tallest" else None
    if tiles == "tallest":
        assert k12_tiles(H, W, max(C, 1), 1)[1] == 32
    img = _image(H * 17 + W + C, H, W, C, levels=4)
    np.testing.assert_array_equal(walk_median(img, blocks),
                                  n(tops.median3x3_plain(t(img))))


# Exchanges whose winner on equal values depends on the operands' order,
# as fminf / fmaxf may choose between +0 and -0: ties keep the first
# operand, or the second.
TIE_RULES = {
    "first": (lambda a, b: np.where(b < a, b, a),
              lambda a, b: np.where(b > a, b, a)),
    "second": (lambda a, b: np.where(a < b, a, b),
               lambda a, b: np.where(a > b, a, b)),
}


@pytest.mark.parametrize("rule", list(TIE_RULES))
@pytest.mark.parametrize("H,W,C", [(37, 53, 3), (70, 45, 3), (67, 300, 1),
                                   (9, 11, 4), (1, 90, 4)])
def test_walk_keeps_which_signed_zero_survives(H, W, C, rule):
    """An image of +0.0, -0.0 and a few levels: under a tie rule that
    tells the zeros apart by operand order, the kernel's regrouped network
    (each row's triple sorted once, slid down) leaves the bits the plain
    network's order leaves (on the card tests/test_torch_cuda.py checks
    the kernel itself against median3x3_plain on such an image)."""
    mn, mx = TIE_RULES[rule]
    img = _image(H * 5 + W + C, H, W, C, levels=3)
    rng = np.random.default_rng(H + W)
    img = np.where(img == 0, np.where(rng.random(img.shape) < 0.5,
                                      np.float32(-0.0), np.float32(0.0)),
                   img).astype(np.float32)
    assert np.signbit(img).any() and (~np.signbit(img) & (img == 0)).any()
    want = network_median(img, mn, mx)
    for blocks in (None, 1):
        got = walk_median(img, blocks, mn, mx)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    # The tie rule matters: the two rules leave different zeros.
    other = network_median(img, *TIE_RULES["second" if rule == "first"
                                           else "first"])
    assert (other.view(np.int32) != want.view(np.int32)).any()


@pytest.mark.parametrize("H,W,C,ty", [(1988, 2880, 3, 32), (1988, 2880, 1, 32),
                                      (288, 384, 3, 2), (288, 384, 1, 2),
                                      (300, 2000, 4, 16)])
def test_tiles_fill_the_card(H, W, C, ty):
    """The tallest tiles that still give kBlocksK12 blocks (config 3: 32
    rows); small frames take the shortest, two rows (the walk's plan,
    which tests/test_torch_cuda.py holds to the built kernel's)."""
    threads, got, gx, gy = k12_tiles(H, W, C)
    assert got == ty and gx == -(-W * C // threads)
    assert gy == -(-H // ty)
    assert gx * gy >= 1056 or ty == 2


def test_tiles_refuse_a_halo_past_shared_memory():
    with pytest.raises(ValueError, match="does not fit"):
        k12_tiles(4, 4, 2000)


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
