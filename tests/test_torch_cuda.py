"""The port's CUDA kernels on the card: each against its plain PyTorch
version, bit for bit (the kernels are built with --fmad=false), and the
ASW slice through the kernels against the plain ops.

Every test here needs an NVIDIA GPU and skips elsewhere.  This file
imports no JAX, so it also runs where JAX is not installed; the
repository's conftest.py does, so on such a machine run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from stereo_matchin_tpu.config import TINY_CONFIG
from stereo_matchin_tpu_torch import kernels
from stereo_matchin_tpu_torch import ops as tops
from stereo_matchin_tpu_torch.kernels.asw_aggregation import asw_den, asw_pass
from stereo_matchin_tpu_torch.kernels.wta_gather import two_min, wta_diag
from stereo_matchin_tpu_torch.models import asw
from stereo_matchin_tpu_torch.ops.wta_fast import (_diag_two_min_plain,
                                                   _two_min_plain)

from .torch_support import cuda_device, max_ulp, n, unorm8_pair

pytestmark = pytest.mark.cuda
EPS, BIG = 1e-5, 1e5


def _pair(dev, H, W, seed=0):
    left, right = unorm8_pair(np.random.default_rng(seed), H, W)
    return torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev)


@pytest.mark.parametrize("H,W,R,D,d0", [(40, 70, 4, 7, 0), (40, 70, 4, 9, 5),
                                        (288, 384, 16, 61, 0),
                                        (375, 450, 16, 17, 3)])
def test_aggregation_kernels_bit_equal_to_plain(H, W, R, D, d0):
    dev = cuda_device()
    left, right = _pair(dev, H, W)
    cost = tops.sad_cost_volume(left, right, d0 + D, 255.0)[d0:].contiguous()
    for axis in (1, 2):
        wl = tops.support_weights(left, R, 30.91, 28.21, axis - 1)
        wr = tops.support_weights(right, R, 30.91, 28.21, axis - 1)
        before = dict(kernels.LAUNCHES)
        den = asw_den(wl, wr, EPS, d0, D)
        out = asw_pass(cost, wl, wr, den, EPS, axis, d0)
        torch.cuda.synchronize()
        key = "asw_pass_v" if axis == 1 else "asw_pass_h"
        assert kernels.LAUNCHES["asw_den"] == before["asw_den"] + 1
        assert kernels.LAUNCHES[key] == before[key] + 1
        assert max_ulp(den, tops.asw_den_plain(wl, wr, EPS, d0, D)) == 0
        assert max_ulp(out, tops.asw_pass_plain(cost, wl, wr, den, EPS, axis,
                                                d0)) == 0


@pytest.mark.parametrize("D,H,W", [(8, 16, 24), (11, 24, 20), (61, 288, 384)])
@pytest.mark.parametrize("with_penalty", [False, True])
def test_wta_kernels_bit_equal_to_plain(D, H, W, with_penalty):
    dev = cuda_device()
    rng = np.random.default_rng(D + H + W)
    cost = rng.integers(0, 30, (D, H, W)).astype(np.float32)   # exact ties
    cost[:, :2, :3] = 2e5
    cost = torch.from_numpy(cost).to(dev)
    pen = (None, None)
    if with_penalty:
        pen = tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in
                    (rng.random((H, W)), rng.random((H, W)) * D))
    before = dict(kernels.LAUNCHES)
    got = two_min(cost, *pen, big=BIG)
    want = _two_min_plain(cost, *pen, big=BIG)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))
    got = wta_diag(cost, want[2], *pen, big=BIG)
    for g, w in zip(got, _diag_two_min_plain(cost, want[2], *pen, big=BIG)):
        np.testing.assert_array_equal(n(g), n(w))
    assert kernels.LAUNCHES["two_min"] == before["two_min"] + 1
    assert kernels.LAUNCHES["wta_diag"] == before["wta_diag"] + 1


def test_slice_through_kernels_equals_plain_ops_and_counts_launches():
    dev = cuda_device()
    cfg = TINY_CONFIG
    left, right = _pair(dev, 48, 64, seed=1)
    kernels.reset_launches()
    got = asw.asw_pipeline(left, right, cfg)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {
        "asw_den": 2, "asw_pass_v": cfg.r_iters, "asw_pass_h": cfg.r_iters,
        "two_min": cfg.k_iters + 1, "wta_diag": cfg.k_iters + 1}
    want = asw.asw_pipeline(left, right, cfg.replace(kernels="jnp"))
    assert kernels.LAUNCHES["two_min"] == cfg.k_iters + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)

