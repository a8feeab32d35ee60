"""The SAD-volume kernel K6 (csrc/sad_volume.cu sad_volume_kernel) walked in
numpy exactly as the CUDA code indexes, under its plan
(kernels/sad_volume.py `sad_tiles`):

  - a block owns SAD_TX columns of one row (4 consecutive a thread) and a
    chunk of dc planes; it stages the chunk's right segment once, scaled,
    at columns max(c0 + s, 0), s in [0, SAD_TX + dc - 1) (only columns
    below W), into three channel planes with one pad word every 32;
  - each thread scales its 4 left pixels once, and walks the chunk's planes
    in ascending d with a window of 4 staged right colours that slides one
    position a plane (one new staged pixel a plane);
  - a plane's 4 outputs leave in one 16-byte store where W % 4 == 0 and the
    volume is aligned and all 4 lie in the frame, else in 4-byte stores of
    those that do.

Unstaged shared words hold NaN, so a read of one into a stored output shows
as a mismatch.  Each walk must equal the plain version (ops/cost.py
`sad_cost_volume`) bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from stereo_matchin_tpu_torch.kernels import sad_volume as ks
from stereo_matchin_tpu_torch.ops.cost import sad_cost_volume

from .torch_support import SAD_EDGES, n, sad_inputs, t


def check_plan(plan, D, H, W):
    assert plan.grid == (-(-W // ks.SAD_TX), H, plan.chunks)
    assert 1 <= plan.dc <= ks.SAD_DC
    assert plan.dc * (plan.chunks - 1) < D <= plan.dc * plan.chunks
    seg = ks.SAD_TX + plan.dc - 1
    assert (seg - 1) + ((seg - 1) >> 5) < plan.pitch
    assert plan.shared_bytes == 12 * plan.pitch


def pad(s):
    """csrc pad(): the staged word of segment position s."""
    return s + (s >> 5)


def walk(left, right, D, scale=1.0, d0=0, aligned=True, plan=None):
    """sad_volume_kernel's output: tile by tile and chunk by chunk, every
    row at once (the rows are independent blocks).  Returns the volume and
    the number of 16-byte stores."""
    H, W = left.shape[:2]
    plan = plan or ks.sad_tiles(D, H, W)
    check_plan(plan, D, H, W)
    gx, _, chunks = plan.grid
    dc, P = plan.dc, plan.pitch
    seg = ks.SAD_TX + dc - 1
    vec = W % 4 == 0 and aligned
    d0 = min(d0, W)                  # the entry point's clamp
    s32 = np.float32(scale)
    sl, sr = left * s32, right * s32                       # (H, W, 3) f32
    out = np.full((D, H, W), np.nan, np.float32)
    written = np.zeros((D, H, W), np.int32)
    wide = 0
    tid = np.arange(ks.SAD_THREADS)
    rows = np.arange(H)
    for bx in range(gx):
        x0 = ks.SAD_TX * bx
        x = x0 + 4 * tid                                   # [threads]
        act = x < W
        xe = np.minimum(x[:, None] + np.arange(4), W - 1)  # [threads, 4]
        lc = sl[:, xe, :]                                  # [H, threads, 4, 3]
        live = np.minimum(W - x, 4)
        for z in range(chunks):
            d_lo = dc * z
            c0 = x0 - d0 - d_lo - (dc - 1)
            stage = np.full((H, 3, P), np.nan, np.float32)
            s = np.arange(seg)
            c = np.maximum(c0 + s, 0)
            ok = c < W
            stage[:, :, pad(s[ok])] = sr[:, c[ok], :].transpose(0, 2, 1)
            s0 = 4 * tid + dc - 1
            assert (s0 + 3 < seg).all()
            r = np.full((H, len(tid), 4, 3), np.nan, np.float32)
            for e in range(3):
                r[:, :, e] = stage[:, :, pad(s0 + 1 + e)].transpose(0, 2, 1)
            for k in range(min(dc, D - d_lo)):
                r[:, :, 1:] = r[:, :, :3].copy()
                assert (s0 - k >= 0).all()
                r[:, :, 0] = stage[:, :, pad(s0 - k)].transpose(0, 2, 1)
                tc = np.abs(lc - r)                        # [H, threads, 4, 3]
                v = (tc[..., 0] + tc[..., 1]) + tc[..., 2]
                d = d_lo + k
                if vec:                                    # 16-byte stores
                    four = act & (live == 4)
                    flat = (d * H + rows[:, None]) * W + x[four]
                    assert (flat % 4 == 0).all()           # aligned
                    wide += H * int(four.sum())
                store = act[:, None] & (np.arange(4) < live[:, None])
                cols = (x[:, None] + np.arange(4))[store]
                out[d][:, cols] = v[:, store]
                written[d][:, cols] += 1
    assert (written == 1).all()
    return out, wide


def plain(left, right, D, scale=1.0, d0=0):
    return n(sad_cost_volume(t(left), t(right), D, scale, d0))


def bits_equal(got, want):
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("chunking", ["plan", "largest_chunks"])
@pytest.mark.parametrize("case", list(SAD_EDGES))
def test_sad_walks_equal_plain(case, chunking, monkeypatch):
    H, W, D, d0, scale = SAD_EDGES[case]
    if chunking == "largest_chunks":
        monkeypatch.setattr(ks, "SAD_BLOCKS", 1)
    plan = ks.sad_tiles(D, H, W)
    if case == "D45_off_chunk" and chunking == "largest_chunks":
        assert (plan.dc, plan.chunks) == (23, 2)
    left, right = sad_inputs(np.random.default_rng(H * W + D), H, W)
    got, wide = walk(left, right, D, scale, d0)
    bits_equal(got, plain(left, right, D, scale, d0))
    assert (wide > 0) == (W % 4 == 0)          # the 16-byte body


@pytest.mark.parametrize("aligned", [True, False])
def test_sad_walk_on_and_off_16_byte_stores(aligned):
    """W % 4 == 0: 16-byte stores on an aligned volume, 4-byte stores on one
    off 16 bytes; the same values either way."""
    H, W, D = 3, 72, 11
    left, right = sad_inputs(np.random.default_rng(5), H, W)
    got, wide = walk(left, right, D, 255.0, 1, aligned=aligned)
    bits_equal(got, plain(left, right, D, 255.0, 1))
    assert wide == (D * H * W // 4 if aligned else 0)


def test_sad_plans_at_the_main_path_shapes():
    """288x384 at REFERENCE_CONFIG (D = 61) and config 3's band and whole
    frame (D = 280): chunks of at most 32 planes, more where the grid is
    small; 6.5-6.7 KB of shared memory a block."""
    p = ks.sad_tiles(61, 288, 384)
    assert (p.dc, p.chunks, p.grid) == (16, 4, (1, 288, 4))
    assert p.shared_bytes == 12 * 544
    for H in (526, 1988):
        p = ks.sad_tiles(280, H, 2880)
        assert (p.dc, p.chunks, p.grid) == (32, 9, (6, H, 9))
        assert p.shared_bytes == 12 * 560


def test_sad_plans_that_do_not_fit_raise_and_the_wrapper_never_falls_back(
        monkeypatch):
    """No plan where the grid is too tall, a plane passes 2^31 - 1 pixels or
    a size is 0.  The wrapper given a tensor that is not on the CPU
    launches (here: refuses the meta device) and never takes the plain
    version."""
    with pytest.raises(ValueError, match="no K6 plan for 70000 rows"):
        ks.sad_tiles(5, 70_000, 8)
    assert ks.sad_tiles(5, 65_535, 8).grid[1] == 65_535
    with pytest.raises(ValueError, match="passes 2"):
        ks.sad_tiles(5, 65_536, 32_768)
    with pytest.raises(ValueError, match="no K6 plan for D=0"):
        ks.sad_tiles(0, 8, 8)

    def plain_route(*a, **k):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(ks, "sad_cost_volume", plain_route)
    img = torch.empty((8, 64, 3), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA kernel"):
        ks.sad_volume(img, img, 9)
