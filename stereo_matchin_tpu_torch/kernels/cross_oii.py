"""Wrappers of the CUDA cross-method kernels in csrc/cross_oii.cu: K5
(`cross_arms`), K7 (`oii_pass`) and K8 (`vote_h`, `vote_v`).

They replace cross_arms_pallas, oii_hpass_pallas / oii_hpass_pallas_t /
oii_vpass_pallas and histogram_vote_pallas
(stereo_matchin_tpu/kernels/cross_oii.py).  The plain versions are
ops/cross.py `cross_arms`, ops/oii.py `oii_pass_plain` and ops/vote.py
`vote_counts_plain` / `vote_mode_plain`: a CPU tensor takes them, a CUDA
tensor launches the kernel or raises.

K5's tile plan is `arms_tiles`: one launch runs v tiles (32 columns x
ty_v rows, with R = first + L - 2 rows past each side) and then h tiles
(ARMS_HX columns of one row, with R columns past each side); each thread
walks its pixel's two arms of its tile's axis in shared memory.  K7's tile plan is `oii_tiles`: a block owns a tile of pixels (axis 1: 32
columns x 32 rows, 4 rows a thread; axis 2: 8 rows x 64 columns, 2
columns a thread) and a chunk of planes, stages the chunk's right arms
once and each plane's volume tile with its halo of L rows or columns, and
each thread walks the union of its outputs' windows once, adding every
staged value it reads to each output whose window holds it.  K8's plans
are `vote_h_tiles` and `vote_v_tiles`.  The wrappers pass the plans to the
CUDA entry points, which refuse one off their compiled layout;
tests/test_torch_arms_tiles.py, tests/test_torch_oii_tiles.py and
tests/test_torch_vote_tiles.py walk them in numpy as the CUDA code indexes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import LAUNCHES, check_tensor, raise_on_error, require_cuda
from ._build import library
from ..ops.cross import cross_arms as cross_arms_plain
from ..ops.oii import oii_pass_plain
from ..ops.vote import _check_arm_len, vote_counts_plain, vote_mode_plain

# K8's shapes, compiled into csrc/cross_oii.cu (kSharedLimit, kVoteH*,
# kVoteV*), and the shared budget of vote_h's plan.
SHARED_LIMIT = 232_448          # 227 KB: the most shared memory of a block
VOTE_H_TX = 128                 # vote_h: pixels of one row per block
VOTE_H_PITCH = VOTE_H_TX + 32   # a histogram tile row, bytes
VOTE_H_SHARED = 49_152          # vote_h: a chunk's planes fit this
VOTE_V_TX = 32                  # vote_v: columns per block (a warp's lanes)
VOTE_V_TY = (16, 8, 4, 2, 1)    # vote_v: output rows per warp, compiled in
VOTE_V_ROW_WARPS = 2            # vote_v: row warps sharing a plane's staging
VOTE_V_GROUPS = 4               # vote_v: plane groups (ranges of planes)
VOTE_V_ROWS = 257               # vote_v: TY + 2L at most: a 16-bit column
                                # prefix holds 255 * 257 = 65535
GRID_YZ = 65_535                # the most blocks along grid y and z
# K7's shapes, compiled into csrc/cross_oii.cu (kOiiThreads, kOiiRows,
# kOiiCols), and the plan's chunking.
OII_WARPS = 8                   # warps a block (256 threads), both axes
OII_ROWS = 4                    # axis 1: output rows a thread
OII_COLS = 2                    # axis 2: output columns a thread
OII_DC = 32                     # planes a chunk at most (its staged arms)
OII_BLOCKS = 1056               # blocks the plan aims at: 8 per SM of 132


# K5's shapes, compiled into csrc/cross_oii.cu (kArmsThreads, kArmsHx,
# kArmsHy, kArmsVx), and the plan's choice of v tile rows.
ARMS_WARPS = 8                  # warps a block (256 threads), both axes
ARMS_HX = 256                   # h tiles: columns of one row, a pixel a
                                # thread
ARMS_VX = 32                    # v tiles: columns (a warp's lanes)
ARMS_V_ROWS = (32, 16, 8)       # v tiles: rows, a multiple of ARMS_WARPS
ARMS_V_BLOCKS = 1056            # v tiles the plan aims at: 8 per SM of 132


class ArmsPlan(NamedTuple):
    halo: int          # R = first + L - 2: staged rows or columns past each
                       # side of a tile, the longest distance walked
    ty_v: int          # rows of a v tile (warp w walks rows w, w + 8, ...)
    blocks_v: int      # v tiles, the grid's first blocks
    blocks_h: int      # h tiles (ARMS_HX columns of one row), after them
    shared_bytes: int  # the larger staging: v [ty_v + 2R][3 * 32] f32,
                       # h [ARMS_HX + 2R] float4


class VoteHPlan(NamedTuple):
    dc: int            # planes per chunk (the histogram tile's rows)
    chunks: int        # chunks of planes along grid z
    grid: tuple        # (blocks along x, rows, chunks)
    shared_bytes: int  # tile [dc][VOTE_H_PITCH] + bins [VOTE_H_TX + 2L] int32


class VoteVPlan(NamedTuple):
    ty: int            # output rows per warp (pixels per lane)
    g: int             # row warps of a plane group (the block's rows: g * ty)
    p: int             # plane groups, each over a contiguous range of planes
    rows: int          # a warp's prefix rows, ty + 2L
    stage_bytes: int   # a plane group's two stages of two planes,
                       # [2][2][g * ty + 2L][32] uint8
    region: int        # a warp's prefix [rows + 1][32] uint32 (two planes),
                       # then its results [2][ty][32] int32
    grid: tuple        # (blocks along x, blocks along y)
    shared_bytes: int  # p * stage_bytes + g * p * region


class OiiPlan(NamedTuple):
    axis: int          # 1 = vertical (v arms), 2 = horizontal (h arms)
    tx: int            # a block's columns: 32 (axis 1), 32 * OII_COLS (axis 2)
    ty: int            # a block's rows: OII_WARPS * OII_ROWS (axis 1),
                       # OII_WARPS (axis 2)
    halo: int          # staged positions past each side of the tile: L
                       # (axis 1, rows), L rounded up to 4 (axis 2, columns)
    dc: int            # planes a chunk
    chunks: int        # chunks of planes along grid z
    stage_bytes: int   # one plane's staged volume: [ty + 2L][32] f32 (axis
                       # 1), [ty][tx + 2 * halo] f32 (axis 2)
    arm_bytes: int     # the chunk's right arms [ty][tx + dc - 1] int2
    grid: tuple        # (blocks along x, along y, chunks)
    shared_bytes: int  # two stages, then the arms


def oii_tiles(D: int, H: int, W: int, L: int, axis: int) -> OiiPlan:
    """The plan of one K7 launch: a block owns a tile of ty x tx pixels
    and a chunk of dc planes.  Chunks hold at most OII_DC planes (the
    staged right arms widen with them) and are as many more as bring the
    grid to OII_BLOCKS blocks, and equal; dc is then halved until the block
    fits SHARED_LIMIT.  Raises ValueError where even one plane does not fit
    (a long L), the grid is too tall, or a plane passes 2^31 - 1 pixels:
    the kernel has no other route."""
    if axis not in (1, 2):
        raise ValueError(f"axis must be 1 (vertical) or 2 (horizontal), got {axis}")
    if D < 1 or L < 0:
        raise ValueError(f"no K7 plan for D={D}, L={L}")
    if H * W > 2**31 - 1:
        raise ValueError(f"no K7 plan for {H}x{W}: a plane passes 2^31 - 1 "
                         f"pixels")
    if axis == 1:
        tx, ty, halo = 32, OII_WARPS * OII_ROWS, L
        stage = 4 * 32 * (ty + 2 * L)
    else:
        tx, ty, halo = 32 * OII_COLS, OII_WARPS, -(-L // 4) * 4
        stage = 4 * ty * (tx + 2 * halo)
    gx, gy = -(-W // tx), -(-H // ty)
    chunks = max(-(-D // OII_DC), min(D, -(-OII_BLOCKS // max(1, gx * gy))))
    dc = -(-D // chunks)
    arms = lambda dc: 8 * ty * (tx + dc - 1)
    while 2 * stage + arms(dc) > SHARED_LIMIT and dc > 1:
        dc = -(-dc // 2)
    if 2 * stage + arms(dc) > SHARED_LIMIT:
        raise ValueError(f"no K7 plan for L={L} on axis {axis}: one plane "
                         f"needs {2 * stage + arms(1)} shared bytes of "
                         f"{SHARED_LIMIT}")
    chunks = -(-D // dc)
    if gy > GRID_YZ or chunks > GRID_YZ:
        raise ValueError(f"no K7 plan for {H} rows in {chunks} chunks: the "
                         f"grid holds {GRID_YZ} along y and z")
    return OiiPlan(axis, tx, ty, halo, dc, chunks, stage, arms(dc),
                   (gx, gy, chunks), 2 * stage + arms(dc))


def arms_tiles(H: int, W: int, L: int, first: int) -> ArmsPlan:
    """The plan of one K5 launch (first: the first distance walked, 3 with
    the legacy quirk, else 2): v tiles of ty_v rows, the largest of
    ARMS_V_ROWS that still gives ARMS_V_BLOCKS v tiles (else the smallest),
    and h tiles of one row, all with a halo of R = first + L - 2.  Raises ValueError
    where even ty_v = 8 does not fit SHARED_LIMIT (a long L), or a plane
    passes 2^31 - 1 pixels: the kernel has no other route."""
    if H < 1 or W < 1 or L < 1 or first < 1:
        raise ValueError(f"no K5 plan for {H}x{W}, L={L}, first={first}")
    if H * W > 2**31 - 1:
        raise ValueError(f"no K5 plan for {H}x{W}: a plane passes 2^31 - 1 "
                         f"pixels")
    R = first + L - 2
    size = lambda ty: max(12 * ARMS_VX * (ty + 2 * R), 16 * (ARMS_HX + 2 * R))
    gx_v = -(-W // ARMS_VX)
    fit = [ty for ty in ARMS_V_ROWS if size(ty) <= SHARED_LIMIT]
    if not fit:
        raise ValueError(f"no K5 plan for L={L}: a v tile of "
                         f"{ARMS_V_ROWS[-1]} rows needs "
                         f"{size(ARMS_V_ROWS[-1])} shared bytes of "
                         f"{SHARED_LIMIT}")
    ty = next((ty for ty in fit if gx_v * -(-H // ty) >= ARMS_V_BLOCKS),
              fit[-1])
    return ArmsPlan(R, ty, gx_v * -(-H // ty), -(-W // ARMS_HX) * H, size(ty))


def vote_h_tiles(D: int, H: int, W: int, L: int) -> VoteHPlan:
    """The plan of one vote_h launch: a block owns VOTE_H_TX pixels of one
    row and the planes of one chunk; the chunks are as few as let a tile
    of a chunk's planes and the staged bins fit VOTE_H_SHARED bytes, and
    equal.  Raises ValueError where no chunk of one plane fits, or the grid
    is too tall: the kernel has no other route."""
    stage = 4 * (VOTE_H_TX + 2 * L)
    most = (VOTE_H_SHARED - stage) // VOTE_H_PITCH
    if D < 1 or most < 1:
        raise ValueError(f"no vote_h plan for D={D}, L={L}: a plane's tile "
                         f"row and the bins need {VOTE_H_PITCH + stage} "
                         f"shared bytes of {VOTE_H_SHARED}")
    chunks = -(-D // most)
    dc = -(-D // chunks)
    if H > GRID_YZ or chunks > GRID_YZ:
        raise ValueError(f"no vote_h plan for {H} rows in {chunks} chunks: "
                         f"the grid holds {GRID_YZ} along y and z")
    return VoteHPlan(dc, chunks, (-(-W // VOTE_H_TX), H, chunks),
                     dc * VOTE_H_PITCH + stage)


def vote_v_tiles(D: int, H: int, W: int, L: int) -> VoteVPlan:
    """The plan of one vote_v launch: a block owns VOTE_V_TX columns and
    g * TY output rows, TY the largest of VOTE_V_TY with TY + 2L <=
    VOTE_V_ROWS; its warps are g = VOTE_V_ROW_WARPS row warps (at most the
    frame's TY-row tiles) times p = VOTE_V_GROUPS plane groups (at most D),
    each group summing two planes per step; then p, and then g, are cut
    until the block fits SHARED_LIMIT.  Raises ValueError where even TY = 1
    does not hold (L > 128) or the grid is too tall: the kernel has no
    other route."""
    ty = next((t for t in VOTE_V_TY if t + 2 * L <= VOTE_V_ROWS), None)
    if ty is None:
        raise ValueError(f"no vote_v plan for L={L}: a column prefix of "
                         f"1 + 2L = {1 + 2 * L} uint8 rows may pass 65535 "
                         f"(at most {VOTE_V_ROWS} rows)")
    rows = ty + 2 * L
    region = max(128 * (rows + 1), 256 * ty)
    g = max(1, min(VOTE_V_ROW_WARPS, -(-H // ty)))
    p = max(1, min(VOTE_V_GROUPS, D))
    size = lambda g, p: p * 128 * (g * ty + 2 * L) + g * p * region
    while size(g, p) > SHARED_LIMIT and p > 1:
        p -= 1
    while size(g, p) > SHARED_LIMIT and g > 1:
        g -= 1
    if size(g, p) > SHARED_LIMIT:
        raise ValueError(f"no vote_v plan for L={L}: one warp needs "
                         f"{size(1, 1)} shared bytes of {SHARED_LIMIT}")
    grid = (-(-W // VOTE_V_TX), -(-H // (g * ty)))
    if grid[1] > GRID_YZ:
        raise ValueError(f"no vote_v plan for {H} rows: {grid[1]} blocks of "
                         f"{g * ty} rows pass the grid's {GRID_YZ}")
    return VoteVPlan(ty, g, p, rows, 128 * (g * ty + 2 * L), region, grid,
                     size(g, p))


@functools.cache
def _lib():
    lib = library()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cross_arms_f32.argtypes = [p, p, i, i, i, i, f, i, i, i, i, i, i, i,
                                   p]
    lib.oii_pass_f32.argtypes = [p, p, p, p] + [i] * 13 + [p]
    lib.vote_h_u8.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.vote_v_i32.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, i, p]
    for fn in (lib.cross_arms_f32, lib.oii_pass_f32, lib.vote_h_u8,
               lib.vote_v_i32):
        fn.restype = i
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_arms(name: str, arms: torch.Tensor, H: int, W: int, device):
    check_tensor(name, arms, (4, H, W), dtype=torch.int32, device=device)


def _frame_rows(h_glob, H: int) -> int:
    """The frame's row count: h_glob, or the input's H rows by default."""
    h_glob = H if h_glob is None else h_glob
    if h_glob < 1:
        raise ValueError(f"need h_glob >= 1, got {h_glob}")
    return h_glob


def cross_arms(img: torch.Tensor, arm_len: int = 25, tau: float = 0.10,
               legacy_quirk: bool = True, row0: int = 0,
               h_glob: int | None = None) -> torch.Tensor:
    """K5: img (H, W, 3) f32 -> (4, H, W) int32 arms [h-, h+, v-, v+],
    minus arms negative; |nb - p| < tau compared in f32.  img holds frame
    rows row0 .. row0 + H - 1 of an h_glob-row frame (default: the whole
    frame); see ops/cross.py cross_arms."""
    if img.dim() != 3 or img.shape[2] != 3:
        raise ValueError(f"image must be (H, W, 3), got {tuple(img.shape)}")
    check_tensor("img", img, img.shape)
    if arm_len < 1:
        raise ValueError(f"need arm_len >= 1, got {arm_len}")
    H, W = img.shape[:2]
    h_glob = _frame_rows(h_glob, H)
    if img.device.type == "cpu":
        return cross_arms_plain(img, arm_len, tau, legacy_quirk, row0, h_glob)
    require_cuda(img)
    first = 3 if legacy_quirk else 2
    plan = arms_tiles(H, W, arm_len, first)
    arms = torch.empty((4, H, W), dtype=torch.int32, device=img.device)
    with torch.cuda.device(img.device):
        rc = _lib().cross_arms_f32(img.data_ptr(), arms.data_ptr(), H, W,
                                   arm_len, first, float(np.float32(tau)),
                                   row0, h_glob, plan.halo, plan.ty_v,
                                   plan.blocks_v, plan.blocks_h,
                                   plan.shared_bytes, _stream(img))
    raise_on_error(rc, "cross_arms")
    LAUNCHES["cross_arms"] += 1
    return arms


def oii_pass(vol: torch.Tensor, arms_l: torch.Tensor, arms_r: torch.Tensor,
             arm_len: int, axis: int, d0: int = 0, row0: int = 0,
             h_glob: int | None = None) -> torch.Tensor:
    """K7: one OII windowed mean over vol (D, H, W) f32, plane k holding
    disparity d0 + k; axis 2 = horizontal (h arms), 1 = vertical (v arms).
    arms_l, arms_r: (4, H, W) int32.  On axis 1 the rows are frame rows
    row0 .. row0 + H - 1 of an h_glob-row frame (default: the whole frame;
    see ops/oii.py oii_pass_plain).  Returns (D, H, W) f32."""
    if vol.dim() != 3:
        raise ValueError(f"vol must be (D, H, W), got {tuple(vol.shape)}")
    check_tensor("vol", vol, vol.shape)
    D, H, W = vol.shape
    _check_arms("arms_l", arms_l, H, W, vol.device)
    _check_arms("arms_r", arms_r, H, W, vol.device)
    if axis not in (1, 2):
        raise ValueError(f"axis must be 1 (vertical) or 2 (horizontal), got {axis}")
    if d0 < 0 or arm_len < 1:
        raise ValueError(f"need d0 >= 0 and arm_len >= 1, got {d0}, {arm_len}")
    if axis == 2 and (row0 != 0 or h_glob is not None):
        raise ValueError("row0/h_glob anchor the vertical pass (axis 1) only")
    h_glob = _frame_rows(h_glob, H)
    if vol.device.type == "cpu":
        return oii_pass_plain(vol, arms_l, arms_r, arm_len, axis, d0, row0,
                              h_glob)
    require_cuda(vol, arms_l, arms_r)
    plan = oii_tiles(D, H, W, arm_len, axis)
    out = torch.empty_like(vol)
    with torch.cuda.device(vol.device):
        rc = _lib().oii_pass_f32(vol.data_ptr(), arms_l.data_ptr(),
                                 arms_r.data_ptr(), out.data_ptr(), D, H, W,
                                 arm_len, d0, axis, row0, h_glob, plan.dc,
                                 plan.chunks, plan.stage_bytes,
                                 plan.arm_bytes, plan.shared_bytes,
                                 _stream(vol))
    raise_on_error(rc, "oii_pass")
    LAUNCHES["oii_pass_h" if axis == 2 else "oii_pass_v"] += 1
    return out


def vote_h(idx: torch.Tensor, arms_l: torch.Tensor, num_disp: int,
           arm_len: int) -> torch.Tensor:
    """K8, counts: rc[d, y, x] = #{j in [hm, hp] ∩ [-L, L] :
    idx[y, clamp(x + j)] == d}.  idx: (H, W) int32 bins (ops.vote_indices).
    Returns (num_disp, H, W) uint8."""
    if idx.dim() != 2:
        raise ValueError(f"idx must be (H, W), got {tuple(idx.shape)}")
    check_tensor("idx", idx, idx.shape, dtype=torch.int32)
    H, W = idx.shape
    _check_arms("arms_l", arms_l, H, W, idx.device)
    _check_arm_len(arm_len)
    if num_disp < 1:
        raise ValueError(f"need num_disp >= 1, got {num_disp}")
    if idx.device.type == "cpu":
        return vote_counts_plain(idx, arms_l, num_disp, arm_len)
    require_cuda(idx, arms_l)
    plan = vote_h_tiles(num_disp, H, W, arm_len)
    rc = torch.empty((num_disp, H, W), dtype=torch.uint8, device=idx.device)
    with torch.cuda.device(idx.device):
        err = _lib().vote_h_u8(idx.data_ptr(), arms_l.data_ptr(), rc.data_ptr(),
                               num_disp, H, W, arm_len, plan.dc, plan.chunks,
                               plan.shared_bytes, _stream(idx))
    raise_on_error(err, "vote_h")
    LAUNCHES["vote_h"] += 1
    return rc


def vote_v(rc: torch.Tensor, arms_l: torch.Tensor, arm_len: int) -> torch.Tensor:
    """K8, mode: argmax over d of the sum of rc[d, clamp(y + i), x] over
    i in [vm, vp] ∩ [-L, L] (the anchor pixel's v arms), ties to the
    highest d.  rc: (D, H, W) uint8.  Returns (H, W) int32."""
    if rc.dim() != 3:
        raise ValueError(f"rc must be (D, H, W), got {tuple(rc.shape)}")
    check_tensor("rc", rc, rc.shape, dtype=torch.uint8)
    D, H, W = rc.shape
    _check_arms("arms_l", arms_l, H, W, rc.device)
    if arm_len < 1:
        raise ValueError(f"need arm_len >= 1, got {arm_len}")
    if rc.device.type == "cpu":
        return vote_mode_plain(rc, arms_l, arm_len)
    require_cuda(rc, arms_l)
    plan = vote_v_tiles(D, H, W, arm_len)
    mode = torch.empty((H, W), dtype=torch.int32, device=rc.device)
    with torch.cuda.device(rc.device):
        err = _lib().vote_v_i32(rc.data_ptr(), arms_l.data_ptr(),
                                mode.data_ptr(), D, H, W, arm_len, plan.ty,
                                plan.g, plan.p, plan.stage_bytes, plan.region,
                                plan.shared_bytes, _stream(rc))
    raise_on_error(err, "vote_v")
    LAUNCHES["vote_v"] += 1
    return mode
