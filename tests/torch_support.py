"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py).

Inputs are made with numpy and handed to both the JAX package and the
port as copies, so neither side sees the other's arrays; configurations
are built for each side from the same keywords (`config_pair`).
"""

from __future__ import annotations

import contextlib
import functools
import pathlib
import re

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


# Edge shapes of K8's plans, (H, W, D, L) (kernels/cross_oii.py
# vote_h_tiles / vote_v_tiles): W off 16 and under a block of either
# kernel; W under one warp; W a multiple of 16 off both blocks (16-byte
# copies, a ragged last block); H under 2L + 1; L = 1 and L = 127; one
# plane; D = 301 (d_max 300); a D that forces vote_h's chunks; the main
# path's width; vote_v with two row warps and a ragged block row, plane
# groups left an odd plane, on W off 16 and on 16-byte copies; L = 127
# with its plane groups cut to fit shared memory.
VOTE_EDGES = {
    "W_off16_under_blocks": (11, 45, 9, 4),
    "W_under_warp": (6, 20, 7, 3),
    "W_multiple_of_16_ragged_block": (5, 176, 12, 6),
    "H_under_2L_plus_1": (5, 70, 13, 25),
    "L1": (9, 50, 10, 1),
    "L127": (7, 300, 6, 127),
    "D1": (8, 64, 1, 5),
    "D301": (3, 40, 301, 25),
    "D_chunks_700": (2, 48, 700, 25),
    "main_width": (3, 384, 61, 25),
    "row_warps_odd_planes": (37, 90, 11, 5),
    "row_warps_16_byte_copies": (40, 96, 9, 7),
    "L127_groups_cut": (40, 64, 8, 127),
}


def vote_inputs(rng, D: int, H: int, W: int, L: int):
    """K8 inputs (idx (H, W), arms (4, H, W), int32 numpy): bins in runs of
    three (as a disparity map has), a fifth of them one shared bin (ties),
    some below 0 and at D and above (never counted); arms of every length
    up to past L, with a few empty or inverted windows and v minus arms
    past L."""
    runs = rng.integers(-2, D + 2, (H, -(-W // 3)))
    idx = np.repeat(runs, 3, axis=1)[:, :W].astype(np.int32)
    idx[rng.random((H, W)) < 0.2] = rng.integers(0, D)
    a = np.stack([-rng.integers(0, L + 4, (H, W)), rng.integers(0, L + 4, (H, W)),
                  -rng.integers(0, L + 4, (H, W)), rng.integers(0, L + 4, (H, W))])
    m = rng.random((H, W)) < 0.05
    a[0][m], a[1][m] = 3, -2                  # hm > hp: no taps
    a[2][m], a[3][m] = 2, -1
    a[2][rng.random((H, W)) < 0.03] = L + 3   # vm > L: no rows
    return idx, a.astype(np.int32)


def unorm8_pair(rng, H: int, W: int):
    """A random (H, W, 3) pair on the UNORM8 grid; the right view is the
    left one shifted by 2 columns so that matching has a true answer."""
    left = (rng.integers(0, 256, (H, W, 3)) / np.float32(255.0)).astype(
        np.float32)
    return left, np.ascontiguousarray(np.roll(left, -2, axis=1))


# Edge shapes of K7's plans (kernels/cross_oii.py oii_tiles), name ->
# (D, H, W, L, d0, row0, h_glob, full): W off both axes' tiles; W = 450,
# which no 16-byte copy serves; H under a row tile of either axis; a 2L-row
# strip anchored inside a 375-row frame, as the cross wavefront carries;
# D = 45, off the plane chunk where a test forces chunks of 23; d0 = 5;
# full windows (2L + 1 taps, both arms past L; every case also has windows
# of one tap at its borders); L = 1, 3 and 25; the
# vertical pass anchored at row0 > 0 with rows past h_glob; anchored at
# row0 < 0 (a sharded tile of the first row shard: rows above the frame,
# none of them in any window), at L = 5 and at L = 25 with row0 = -(L + 2).
# The vertical pass takes (row0, h_glob), the horizontal one the whole
# frame.
OII_EDGES = {
    "W_off_tiles": (7, 37, 70, 4, 0, 0, None, False),
    "W450": (5, 20, 450, 6, 0, 0, None, False),
    "H_under_row_tile": (9, 5, 64, 3, 0, 0, None, False),
    "strip_2L_anchored": (6, 50, 96, 25, 0, 300, 375, False),
    "D45_chunks": (45, 9, 40, 2, 0, 0, None, False),
    "d0_5": (9, 30, 100, 4, 5, 0, None, False),
    "full_windows": (4, 60, 160, 25, 0, 0, None, True),
    "L1": (6, 19, 50, 1, 0, 0, None, False),
    "L3": (5, 40, 136, 3, 0, 0, None, False),
    "L25": (4, 70, 200, 25, 3, 0, None, False),
    "anchored_past_h_glob": (7, 40, 64, 5, 0, 350, 375, False),
    "above_frame": (6, 40, 64, 5, 3, -7, 40, False),
    "above_frame_L25": (4, 70, 96, 25, 0, -27, 300, False),
}


def oii_inputs(rng, D: int, H: int, W: int, L: int, full: bool = False):
    """K7 inputs (vol (D, H, W) f32 >= +0.0 with a tenth of it zero, arms_l
    and arms_r (4, H, W) int32, numpy): minus arms in [-(L + 3), -1] and
    plus arms in [1, L + 3], a tenth of them (-1, 1) (three taps, one at
    column 0 or frame row 0, where the window starts at 1), a twentieth
    inverted (3, -2: no tap); with `full`, every arm past L (2L + 1 taps).
    Combined arms then never meet: no divisor is 0."""
    vol = (rng.random((D, H, W)) * 2).astype(np.float32)
    vol[rng.random((D, H, W)) < 0.1] = 0.0

    def arms():
        if full:
            return np.stack([-rng.integers(L + 1, L + 3, (H, W)),
                             rng.integers(L + 1, L + 3, (H, W))] * 2)
        a = np.stack([-rng.integers(1, L + 4, (H, W)),
                      rng.integers(1, L + 4, (H, W))] * 2)
        for k in (0, 2):
            short = rng.random((H, W)) < 0.1
            a[k][short], a[k + 1][short] = -1, 1
            inv = rng.random((H, W)) < 0.05
            a[k][inv], a[k + 1][inv] = 3, -2
        return a

    return vol, arms().astype(np.int32), arms().astype(np.int32)


# Edge shapes of K6's plan (kernels/sad_volume.py sad_tiles), name -> (H, W,
# D, d0, scale): W under 4; W off 4 (4-byte stores); W under one tile;
# d0 + D > W with d0 >= W, so every read clamps to column 0; one plane; D
# off the plane chunk where a test forces the largest chunks (23 + 22); one
# row, two tiles, the second ragged; three tiles with W off 4; the main
# path's width and depth at config 3.  Scale 1.0 (the cross path) and 255.0.
SAD_EDGES = {
    "W_under_4": (5, 3, 4, 0, 1.0),
    "W_off_4": (7, 37, 9, 0, 255.0),
    "W_under_tile": (6, 100, 7, 2, 1.0),
    "every_read_clamps": (4, 20, 9, 30, 1.0),
    "D1": (9, 64, 1, 0, 255.0),
    "D45_off_chunk": (3, 40, 45, 0, 1.0),
    "H1_ragged_tile": (1, 600, 13, 3, 1.0),
    "tiles_W_off_4": (2, 1030, 40, 5, 255.0),
    "config3_width": (2, 2880, 280, 0, 1.0),
}


def sad_inputs(rng, H: int, W: int):
    """A K6 pair (H, W, 3) f32 in [0, 1] on the UNORM8 grid, with a fifth of
    the values off it (any f32: the scale's rounding shows)."""
    left, right = (rng.integers(0, 256, (2, H, W, 3)) / np.float32(255.0)).astype(
        np.float32)
    for img in (left, right):
        off = rng.random((H, W, 3)) < 0.2
        img[off] = rng.random(int(off.sum()), dtype=np.float32)
    return left, right


# Edge shapes of K5's plan (kernels/cross_oii.py arms_tiles), name -> (H, W,
# L, row0, h_glob, kind): H under L; W under L; a flat image (every arm
# reaches L where the frame allows, and walks the whole halo); a noise image
# (every arm 1); rows anchored at row0 > 0 with rows past h_glob, as the
# cross wavefront's last band has; a 2L-row strip anchored inside a 375-row
# frame; L = 1 (no step); ragged tiles of both axes with H odd; the main
# path's width; rows starting above the frame (row0 = -(L + 2), a sharded
# tile of the first row shard), at L = 6 and L = 25.  Each runs with the
# legacy quirk on and off.
ARMS_EDGES = {
    "H_under_L": (10, 80, 25, 0, None, "scene"),
    "W_under_L": (40, 12, 25, 0, None, "scene"),
    "flat": (70, 90, 25, 0, None, "flat"),
    "noise": (30, 40, 5, 0, None, "noise"),
    "anchored_past_h_glob": (40, 64, 5, 350, 375, "scene"),
    "strip_2L_anchored": (50, 96, 25, 300, 375, "scene"),
    "L1": (9, 50, 1, 0, None, "scene"),
    "ragged_tiles": (33, 300, 6, 0, None, "scene"),
    "main_width": (20, 384, 25, 0, None, "scene"),
    "above_frame": (40, 64, 6, -8, 40, "scene"),
    "above_frame_L25": (70, 96, 25, -27, 300, "scene"),
}


def arms_image(rng, H: int, W: int, kind: str) -> np.ndarray:
    """A K5 input (H, W, 3) f32.  "scene": runs of random length up to 2L
    along both axes, each of one of 16 random colours (arms of every length,
    some colours within tau of each other); "flat": one colour; "noise":
    channel 0 steps 0.15 a pixel along x + y (mod 4), so no test at a
    distance of 2 or 3 passes and every arm is 1, the other channels
    random."""
    if kind == "flat":
        return np.full((H, W, 3), 0.4, np.float32)
    if kind == "noise":
        img = rng.random((H, W, 3), dtype=np.float32)
        img[..., 0] = 0.15 * ((np.arange(H)[:, None] + np.arange(W)) % 4)
        return img
    palette = rng.random((16, 3), dtype=np.float32)
    seg_y = np.cumsum(rng.random(H) < 0.08)
    seg_x = np.cumsum(rng.random(W) < 0.06)
    img = palette[(seg_x[None, :] + 7 * seg_y[:, None]) % 16]
    spots = rng.random((H, W)) < 0.03
    img[spots] = rng.random((int(spots.sum()), 3), dtype=np.float32)
    return np.ascontiguousarray(img, dtype=np.float32)


CSRC = pathlib.Path(__file__).resolve().parents[1] / (
    "stereo_matchin_tpu_torch/csrc")


@functools.cache
def csrc_constants(source: str) -> dict:
    """The `constexpr int kName = expression;` constants of csrc/<source>,
    evaluated in order: the kernels' plans, for the numpy walks of their
    schedules (the card's tests hold these walks' plans to the ones the
    built kernels report)."""
    consts = {}
    text = (CSRC / source).read_text()
    for name, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);", text):
        consts[name] = int(eval(expr, {"__builtins__": {}}, consts))
    return consts


def k13_plan(W: int, n_local: int, total_disp: int) -> dict:
    """csrc/wta_shard.cu epipolar_segment_plan for the numpy walk, with the
    keys of kernels/wta_shard.py segment_plan, and "unroll" and
    "unroll_pixel" (loads in flight a lane in the segment walk's queue and
    in the pixel walk).  Raises ValueError where the block does not
    fit."""
    k = csrc_constants("wta_shard.cu")
    n_seg = -(-W // k["kSegK13"])
    seg = -(-W // n_seg)
    span = min(W, seg + max(total_disp - 2, 0))
    slot = (span + 6) // 4 * 4
    smem = (k["kRingK13"] * slot + 4 * seg + n_local + 11) * 4
    if smem > k["kSmemMaxK13"] or n_seg > 65535:
        raise ValueError(f"epipolar_segment: {smem} bytes does not fit")
    return {"threads": k["kThreadsK13"], "pix": k["kPixK13"],
            "ring": k["kRingK13"], "share": k["kShareK13"], "n_seg": n_seg,
            "seg": seg, "slot": slot, "smem": smem,
            "min_grid": k["kMinGridK13"], "unroll": k["kUnrollK13"],
            "unroll_pixel": k["kUnrollPixK13"]}


def k12_tiles(H: int, W: int, C: int, blocks: int | None = None):
    """csrc/median.cu median3x3_plan for the numpy walk: (threads, ty, gx,
    gy), ty the tallest of kTyMaxK12, kTyMaxK12 / 2, ..., kTyMinK12 that
    gives the grid `blocks` blocks (the kernel's kBlocksK12) and a tile
    that fits.  Raises ValueError where none fits."""
    k = csrc_constants("median.cu")
    threads = k["kThreadsK12"]
    blocks = k["kBlocksK12"] if blocks is None else blocks
    row = (threads + 2 * C) * 4
    gx = -(-W * C // threads)
    ty = k["kTyMaxK12"]
    while ty > k["kTyMinK12"] and (gx * -(-H // ty) < blocks
                                   or (ty + 2) * row > k["kSmemMaxK12"]):
        ty //= 2
    if (ty + 2) * row > k["kSmemMaxK12"]:
        raise ValueError(f"median3x3: a tile of {C} channels does not fit")
    return threads, ty, gx, -(-H // ty)


# Edge shapes of the sharded WTA's kernels K13 (epipolar_segment) and K14
# (shard_merge), name -> (D, shards, H, W, d1): D real planes padded with
# `big` planes up to a multiple of the shards (the pad planes of the last
# shard or shards, as parallel/asw_sharded.py pins them); d1 the target
# scan's: "argmin" (the merged reference's, as the pipeline hands it on),
# "zero", "last" (D - 1), "random" (uniform in [0, D)), "outliers" (D - 6
# with about 1 in 11 pixels at D - 1 and 1 in 13 at 2), "sparse" (3 with
# about 1 in 5 pixels in [D // 2, D); shard_wta_d1).  One
# shard; two, three and five shards with pad planes; one plane a shard
# (Dl = 1), also with a last shard of pad planes only; d1 = 0; d1 = D - 1
# on a frame narrower than D (every pixel has x < d1: long clamped tails,
# diagonals that miss the first shards), also on one shard (every pixel
# walks a tail); a row past one block of K14 with H * W odd; a row wider
# than one K13 segment (csrc/wta_shard.cu kSegK13) with a ragged last
# segment; a band of d1 on a frame narrower than it, whose few outliers
# walk planes above and below K13's staged range; d1 = 3 with 1 in 5
# pixels in the second of two shards ("sparse"), whose blocks stage no
# plane there and buffer their queues in the free ring, one row's past
# what the ring holds.
SHARD_WTA_EDGES = {
    "one_shard": (13, 1, 6, 40, "argmin"),
    "two_shards_padded": (13, 2, 6, 40, "argmin"),
    "three_shards_random": (20, 3, 5, 33, "random"),
    "five_shards": (23, 5, 4, 50, "random"),
    "Dl1": (5, 5, 6, 17, "random"),
    "Dl1_pad_shard": (4, 5, 5, 12, "last"),
    "d1_zero": (13, 2, 5, 30, "zero"),
    "d1_last_narrow": (31, 3, 4, 9, "last"),
    "wide_ragged": (9, 2, 3, 301, "argmin"),
    "all_tail": (64, 1, 3, 20, "last"),
    "row_past_a_segment": (9, 2, 2, 3101, "random"),
    "outliers_above_and_below": (40, 1, 4, 30, "outliers"),
    "outliers_two_shards": (40, 2, 3, 70, "outliers"),
    "sparse_second_shard": (356, 2, 3, 80, "sparse"),
}


def shard_wta_d1(kind: str, D: int, rand: np.ndarray):
    """The target scan's d1 of a SHARD_WTA_EDGES kind, as a function of the
    merged reference's d (a torch int32 tensor): that d ("argmin"), or a
    map on its device made from the case's uniform `rand`."""
    rand = np.asarray(rand)
    fixed = {"zero": np.zeros_like(rand), "last": np.full_like(rand, D - 1),
             "random": rand,
             "outliers": np.where(rand % 11 == 0, D - 1,
                                  np.where(rand % 13 == 1, 2, D - 6)),
             "sparse": np.where(rand % 5 == 0, D // 2 + rand % (D - D // 2),
                                3)}
    if kind == "argmin":
        return lambda d: d
    arr = np.ascontiguousarray(fixed[kind], dtype=np.int32)
    return lambda d: torch.from_numpy(arr).to(d.device)


def structured_d1(H: int, W: int, D: int, seed: int, device) -> torch.Tensor:
    """A structured target-scan d1 on `device`: a smooth surface in [0, 40)
    with about 3 in 32 pixels at outliers uniform in [D // 3, D - 1], as
    chip_smoke.py wta_edge_inputs' "outliers" are for K4."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ys = torch.arange(H, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(W, device=device, dtype=torch.float32)[None, :]
    smooth = (19.5 + 19.5 * torch.sin(xs / 211.0 + ys / 157.0)).floor()
    smooth = smooth.clamp(0, 39).to(torch.int32)
    out = torch.rand((H, W), generator=gen, device=device) < 3 / 32
    high = torch.randint(D // 3, D, (H, W), generator=gen, device=device,
                         dtype=torch.int32)
    return torch.where(out, high, smooth)


def shifted_d1(H: int, W: int, D: int, seed: int, device,
               shift: int = 37) -> torch.Tensor:
    """The target-scan d1 of a pair shifted by `shift` columns (chip_smoke.py
    config3_pair) on `device`: `shift` with about 3 in 100 pixels uniform
    in [0, D), so that a disp shard past the shift sees only those few
    pixels' walks."""
    gen = torch.Generator(device=device).manual_seed(seed)
    stray = torch.rand((H, W), generator=gen, device=device) < 0.03
    rand = torch.randint(0, D, (H, W), generator=gen, device=device,
                         dtype=torch.int32)
    return torch.where(stray, rand, torch.full_like(rand, shift))


def shard_wta_inputs(rng, D: int, shards: int, H: int, W: int,
                     big: float = 1e5):
    """The sharded WTA's inputs on one frame, numpy: the (d_pad, H, W)
    volume (integer costs in [0, 30): exact ties; a corner at and above
    big; a row of zeros on every plane, so that the confidences of 0 / 0
    show; the disp padding at big), the WTA_REF's maps (ref_value,
    ref_denom, ref_value_t, ref_denom_t; values on integers and
    half-integers, where penalties tie) and a uniform d1 in [0, D)."""
    d_pad = -(-D // shards) * shards
    cost = rng.integers(0, 30, (d_pad, H, W)).astype(np.float32)
    cost[:, :2, :3] = big
    cost[: D // 2, :1, 3:6] = 2 * big
    cost[:, H - 1, W // 2:] = 0.0
    cost[D:] = big

    def value():
        return (rng.integers(0, D, (H, W))
                + 0.5 * rng.integers(0, 2, (H, W))).astype(np.float32)

    def denom():
        return rng.uniform(0, 3, (H, W)).astype(np.float32)

    maps = (value(), denom(), value(), denom())
    return cost, maps, rng.integers(0, D, (H, W)).astype(np.int32)


# --- utils/graphs.py's memory rules on the CPU, the card's calls faked -------

class FakePool:
    """A torch.cuda.MemPool as utils/graphs.py's memory rules see it: its
    `reserved` bytes, `free` of them."""

    count = 0

    def __init__(self, reserved=0, free=None):
        FakePool.count += 1
        self.id = (0, FakePool.count)
        self.reserved = reserved
        self.free = reserved if free is None else free


class FakeGraph:
    """A captured graph as the families see it: a call returns its output
    and counts itself."""

    def __init__(self, inputs, output, stats):
        self.inputs, self.output, self.stats = inputs, output, stats
        self.done, self.calls = None, 0

    def __call__(self, tensors):
        self.calls += 1
        return self.output


class FakeCard:
    """The card's memory calls faked for utils/graphs.py: a card of `total`
    bytes with `other` in use besides the pools of the graph families,
    whose globals (CACHE, STAGES) become fresh families.  A warm-up (of
    `peak` bytes and a result of `output` bytes) grows its pool to the peak
    and leaves it free, or raises OutOfMemoryError where the card cannot
    hold the growth, or while `oom` says so; a capture runs fn on its
    inputs where `run` is set.  `events` records ("warm_up" or "capture",
    the pool, the stream, the card's free bytes) and ("drop", family) in
    order."""

    def __init__(self, monkeypatch, total, other=0, peak=0, output=0,
                 run=False):
        from stereo_matchin_tpu_torch.utils import graphs

        self.graphs = graphs
        self.total, self.other, self.peak, self.output = (total, other, peak,
                                                          output)
        self.run, self.oom, self.events = run, lambda: False, []
        frames, stages = graphs.GraphCache(), graphs.StageGraphs()
        for name, family in (("frames", frames), ("stages", stages)):
            clear = family.clear
            monkeypatch.setattr(family, "clear", functools.partial(
                self._clear, name, clear))
        monkeypatch.setattr(graphs, "CACHE", frames)
        monkeypatch.setattr(graphs, "STAGES", stages)
        monkeypatch.setattr(torch.cuda, "MemPool", FakePool)
        monkeypatch.setattr(torch.cuda, "Stream", lambda dev=None: "stream")
        monkeypatch.setattr(torch.cuda, "Event", lambda: "event")
        monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
        monkeypatch.setattr(torch.cuda, "device",
                            lambda dev: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "mem_get_info", self.mem_get_info)
        monkeypatch.setattr(graphs, "pool_state", lambda p: (0, 0) if p is None
                            else (p.reserved, p.free))
        monkeypatch.setattr(graphs, "warm_up", self.warm_up)
        monkeypatch.setattr(graphs, "capture", self.capture)

    def _clear(self, name, clear):
        if self.families()[name].graphs:
            self.events.append(("drop", name))
        clear()

    def families(self) -> dict:
        return {"frames": self.graphs.CACHE, "stages": self.graphs.STAGES}

    def free(self) -> int:
        return self.mem_get_info()[0]

    def mem_get_info(self, device=None):
        held = sum(p.reserved for f in self.families().values()
                   for p in f.pools.values())
        return self.total - self.other - held, self.total

    def warm_up(self, fn, inputs, statics, dev, pool, stream):
        self.events.append(("warm_up", pool, stream, self.free()))
        grow = max(0, self.peak - pool.free)
        if self.oom() or grow > self.free():
            raise torch.cuda.OutOfMemoryError("out of memory")
        pool.reserved += grow
        pool.free += grow
        return {"warmup_peak_bytes": self.peak, "output_bytes": self.output,
                "launches": {}, "warmup_s": 0.5}

    def capture(self, fn, inputs, statics, dev, warm, pool, stream):
        self.events.append(("capture", pool, stream, self.free()))
        out = fn(*inputs, *statics) if self.run else "output"
        return FakeGraph(inputs, out, {"warmup_s": warm["warmup_s"],
                                       "capture_s": 0.25})

    def held(self, name: str, graphs: int, reserved: int, dev="dev",
             resident=False) -> None:
        """Give family `name` `graphs` graphs in a pool of `reserved` bytes,
        all free (a captured family's outputs are borrowed)."""
        family = self.families()[name]
        family.pools[dev, resident] = FakePool(reserved)
        for k in range(graphs):
            family.graphs[f"{name} {k}"] = FakeGraph((), "output", {
                "warmup_s": 0.5, "capture_s": 0.25})
