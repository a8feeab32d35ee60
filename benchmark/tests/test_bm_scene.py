"""The benchmark's scene generator: seeded, on the UNORM8 grid, layers
spanning [0, d_max], the left view the right one warped by them."""

import numpy as np
import pytest
import torch

from benchmark import scene

SIZES = [(40, 64), (37, 61)]


def pairs(seed, d_max=15, n=2):
    return scene.make_pairs(seed, SIZES, n, d_max, torch.device("cpu"))


def test_one_seed_repeats_bit_for_bit():
    a, b = pairs(2 ** 31 + 3), pairs(2 ** 31 + 3)
    for p, q in zip(a, b):
        for x, y in zip(p, q):
            assert torch.equal(x, y)


def test_two_seeds_differ():
    a, b = pairs(2 ** 31 + 3), pairs(2 ** 31 + 4)
    for p, q in zip(a, b):
        assert not torch.equal(p.right, q.right)
        assert not torch.equal(p.disparity, q.disparity)


def test_order_and_shapes():
    ps = pairs(5, n=3)
    assert [tuple(p.left.shape[:2]) for p in ps] == SIZES * 3
    for p in ps:
        assert p.left.dtype == p.right.dtype == torch.float32
        assert p.left.is_contiguous() and p.left.shape[2] == 3


@pytest.mark.parametrize("d_max", [15, 63, 279])
def test_unorm8_grid_and_layers(d_max):
    levels = torch.from_numpy(scene.UNORM8_LEVELS)
    for p in scene.make_pairs(2 ** 31 + 7, [(48, 400)], 2, d_max,
                              torch.device("cpu")):
        for img in (p.left, p.right):
            codes = torch.round(img * 255).long()
            assert torch.equal(levels[codes], img)
        assert int(p.right.min()) == 0 and float(p.right.max()) == 1.0
        d = p.disparity
        assert int(d.min()) == 0 and int(d.max()) == d_max
        assert set(d.unique().tolist()) <= set(scene.layer_disparities(d_max))
        src = (torch.arange(400)[None, :] - d).clamp(0, 399)
        assert torch.equal(p.left, p.right[torch.arange(48)[:, None], src])


def test_levels_decode_as_png_codes():
    codes = np.arange(256, dtype=np.uint8)
    assert np.array_equal(scene.UNORM8_LEVELS,
                          (codes / np.float32(255.0)).astype(np.float32))
    assert np.array_equal(scene.UNORM8_LEVELS, (np.arange(256, dtype=np.float64)
                                                / 255.0).astype(np.float32))


@pytest.mark.parametrize("hw,d_max", [((40, 64), 15), ((375, 1242), 191),
                                      ((64, 2880), 279)])
def test_no_left_pixel_reads_past_the_edge(hw, d_max):
    """Each rectangle lies at least its disparity from the left edge."""
    H, W = hw
    for seed in range(6):
        for p in scene.make_pairs(seed, [hw], 1, d_max, torch.device("cpu")):
            x = torch.arange(W)[None, :].expand(H, W)
            assert bool(((x - p.disparity) >= 0)[p.disparity > 0].all())
