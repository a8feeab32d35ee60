"""Wrappers of the CUDA aggregation kernels K1 (`asw_den`) and K2
(`asw_pass`, and its windowed form `asw_pass_win`) in
csrc/asw_aggregation.cu, and their tile plan (`aggregation_tiles`).

They replace the TPU kernels asw_den_dres, asw_vpass_dres,
asw_hpass_dres and asw_vpass_dres_win
(stereo_matchin_tpu/kernels/asw_aggregation_dres.py) in the port's
(D, H, W) layout; the disparity offset `d0` (any int >= 0) covers the TPU
package's d-chunked grid kernels asw_den_pallas, asw_vpass_pallas and
asw_hpass_pallas (kernels/asw_aggregation.py) as well.  The plain versions
are ops/aggregation.py `asw_den_plain` / `asw_pass_plain` /
`asw_pass_win_plain`: a CPU tensor takes them, a CUDA tensor launches the
kernel or raises.

Every index and bound the kernel uses is planned here, where the CPU
tests reach it (tests/test_torch_asw_tiles.py walks a plan block by block
in numpy, as the CUDA code indexes): a block owns a tile of `by` rows and
`bx` columns, reads its left weights once (into registers where T is
compiled in), stages the right-weight segment of each `span` of planes
once, and the cost taps of each `group` of planes with their halo.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import LAUNCHES, check_tensor, raise_on_error, require_cuda
from ._build import library
from ..ops.aggregation import asw_den_plain, asw_pass_plain, asw_pass_win_plain

# Kernel modes: K1, K2 vertical taps (rows clamped), K2 horizontal taps
# (columns clamped), K2 vertical taps over a window of real rows.
MODES = {"den": 0, "v": 1, "h": 2, "win": 3}
SHARED_LIMIT = 232_448          # 227 KB: the most shared memory of a block
# (bx, by, group) per mode: a row of 128 pixels where the taps run along
# the row (K1 needs no cost taps); 12 rows of 32 where they run down the
# columns, so that a staged cost row serves 12 output rows.
TILE_SHAPES = {0: (128, 1, 8), 1: (32, 12, 2), 2: (128, 1, 4), 3: (32, 12, 2)}
# The tap count compiled into its own kernels (the tap loop unrolls and
# the left weights stay in registers): the reference window, 2 * 16 + 1.
BAKED_TAPS = 33
# The group sizes the kernel is compiled for.
GROUPS = (2, 4, 8)
# Spans are cut so that a block stays under this many shared bytes (two
# blocks on an SM) where that leaves at least one plane per span.
SHARED_TARGET = 110 * 1024


class TilePlan(NamedTuple):
    mode: int
    bx: int            # block columns (threads along x), a multiple of 4
    by: int            # block rows (threads along y)
    span: int          # planes per staged right-weight segment
    group: int         # planes summed at once (registers per thread)
    baked: bool        # T compiled in (T == BAKED_TAPS)
    grid: tuple        # (blocks along x, blocks along y)
    shared_bytes: int  # dynamic shared memory of a block


class Layout(NamedTuple):
    """A block's shared memory, in floats (csrc/asw_aggregation.cu
    `layout`): left weights [T][by][bx] (none when T is compiled in) and 8
    floats of padding, right-weight segments [T][by][sw], two cost tiles
    [crows][crow][group]; every part starts on a 16-byte boundary."""
    sw: int
    crow: int
    crows: int
    sl: int
    sr: int
    sc: int

    @property
    def total(self) -> int:
        return self.sl + self.sr + self.sc


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def layout(mode: int, T: int, bx: int, by: int, span: int, group: int,
           baked: bool) -> Layout:
    sw = bx + _round4(span + 5)          # a segment staged from an aligned column
    crow = _round4(bx + T - 1) if mode == 2 else bx
    crows = by if mode == 2 else by + T - 1
    return Layout(sw, crow, crows, (0 if baked else T * by * bx) + 8,
                  T * by * sw, 0 if mode == 0 else 2 * group * crows * crow)


def aggregation_tiles(T: int, H: int, W: int, D: int, mode: str) -> TilePlan:
    """The tile plan of one K1/K2 launch over D planes of an (H, W) frame
    (H: output rows) with T taps; mode "den", "v", "h" or "win".  The tile
    is TILE_SHAPES' for the mode, its rows halved (down to one) while a
    span of one plane does not fit a block; T == BAKED_TAPS takes the
    kernels with the tap count compiled in.  The span is the widest (then
    evened out) whose block fits SHARED_TARGET shared bytes, or
    SHARED_LIMIT where one plane does not.  Raises ValueError where no span
    of one plane fits a block even with one row: the kernel has no other
    route."""
    m = MODES[mode]
    bx, by, group = TILE_SHAPES[m]
    baked = T == BAKED_TAPS
    if bx % 4 or bx * by > 1024 or group not in GROUPS:
        raise ValueError(f"a {bx}x{by} block of {group} planes: bx must be a "
                         f"multiple of 4, bx * by at most 1024, the group one "
                         f"of {GROUPS}")
    size = lambda span: 4 * layout(m, T, bx, by, span, group, baked).total
    while size(1) > SHARED_LIMIT and by > 1:
        by //= 2
    if size(1) > SHARED_LIMIT:
        raise ValueError(
            f"no tile plan for T={T} taps ({mode}): one plane needs "
            f"{size(1)} shared bytes in a row of {bx}, a block has "
            f"{SHARED_LIMIT}")
    limit = SHARED_TARGET if size(1) <= SHARED_TARGET else SHARED_LIMIT
    lo, hi = 1, max(D, 1)                  # the widest span that fits
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if size(mid) <= limit else (lo, mid - 1)
    spans = -(-max(D, 1) // lo)
    span = -(-max(D, 1) // spans)          # equal spans, none wider
    return TilePlan(m, bx, by, span, group, baked,
                    (-(-W // bx), -(-H // by)), size(span))


@functools.cache
def _lib():
    lib = library()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.asw_tiles_f32.argtypes = [i, p, p, p, p, p, i, i, i, i, i, f,
                                  i, i, i, i, i, i, i, i, p]
    lib.asw_tiles_f32.restype = i
    return lib


def _launch(plan: TilePlan, cost, wl, wr, den, out, D: int, d0: int,
            eps: float, what: str) -> None:
    T, H, W = wl.shape
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(wl.device):
        stream = torch.cuda.current_stream(wl.device).cuda_stream
        rc = _lib().asw_tiles_f32(
            plan.mode, ptr(cost), wl.data_ptr(), wr.data_ptr(), ptr(den),
            out.data_ptr(), T, H, W, D, d0, eps, plan.bx, plan.by, plan.span,
            plan.group, int(plan.baked), plan.grid[0], plan.grid[1],
            plan.shared_bytes, stream)
    raise_on_error(rc, what)


def _check_strips(wl, wr):
    if wl.dim() != 3 or wl.shape[0] % 2 != 1:
        raise ValueError(f"strips must be (T, H, W) with odd T, got "
                         f"{tuple(wl.shape)}")
    check_tensor("wl", wl, wl.shape)
    check_tensor("wr", wr, wl.shape, device=wl.device)


def asw_den(wl: torch.Tensor, wr: torch.Tensor, eps: float, d0: int = 0,
            num_disp: int = 1) -> torch.Tensor:
    """K1: den[d, y, x] = eps + sum_t wl[t, y, x] * wr[t, y, max(x-d0-d, 0)].

    wl, wr: (T, H, W) f32.  Returns (num_disp, H, W) f32."""
    _check_strips(wl, wr)
    if d0 < 0 or num_disp < 1:
        raise ValueError(f"need d0 >= 0 and num_disp >= 1, got {d0}, {num_disp}")
    if wl.device.type == "cpu":
        return asw_den_plain(wl, wr, eps, d0, num_disp)
    T, H, W = wl.shape
    plan = aggregation_tiles(T, H, W, num_disp, "den")
    require_cuda(wl, wr)
    out = torch.empty((num_disp, H, W), dtype=torch.float32, device=wl.device)
    _launch(plan, None, wl, wr, None, out, num_disp, d0, eps, "asw_den")
    LAUNCHES["asw_den"] += 1
    return out


def asw_pass(cost: torch.Tensor, wl: torch.Tensor, wr: torch.Tensor,
             den: torch.Tensor, eps: float, axis: int,
             d0: int = 0) -> torch.Tensor:
    """K2: one aggregation pass over cost (D, H, W); axis 1 = vertical taps,
    2 = horizontal.  den: asw_den of the same strips.  Returns (D, H, W)."""
    _check_strips(wl, wr)
    if axis not in (1, 2):
        raise ValueError(f"axis must be 1 (vertical) or 2 (horizontal), got {axis}")
    if d0 < 0:
        raise ValueError(f"need d0 >= 0, got {d0}")
    if cost.dim() != 3:
        raise ValueError(f"cost must be (D, H, W), got {tuple(cost.shape)}")
    T, H, W = wl.shape
    D = cost.shape[0]
    check_tensor("cost", cost, (D, H, W), device=wl.device)
    check_tensor("den", den, (D, H, W), device=wl.device)
    if cost.device.type == "cpu":
        return asw_pass_plain(cost, wl, wr, den, eps, axis, d0)
    plan = aggregation_tiles(T, H, W, D, "v" if axis == 1 else "h")
    require_cuda(cost, wl, wr, den)
    out = torch.empty_like(cost)
    _launch(plan, cost, wl, wr, den, out, D, d0, eps, "asw_pass")
    LAUNCHES["asw_pass_v" if axis == 1 else "asw_pass_h"] += 1
    return out


def asw_pass_win(cost_win: torch.Tensor, wl: torch.Tensor, wr: torch.Tensor,
                 den: torch.Tensor, eps: float, d0: int = 0) -> torch.Tensor:
    """K2, windowed vertical pass: cost_win (D, H_out + T - 1, W) holds real
    rows, the T - 1 margin rows included; wl, wr (T, H_out, W) and den
    (D, H_out, W) cover the output rows.  out[d, y, x] = (eps + sum_t
    (wl[t,y,x] * wr[t,y,max(x-d0-d,0)]) * cost_win[d, y+t, x]) / den[d,y,x].
    Returns (D, H_out, W)."""
    _check_strips(wl, wr)
    if d0 < 0:
        raise ValueError(f"need d0 >= 0, got {d0}")
    if cost_win.dim() != 3:
        raise ValueError(f"cost_win must be (D, H_out + T - 1, W), got "
                         f"{tuple(cost_win.shape)}")
    T, H, W = wl.shape
    D = cost_win.shape[0]
    check_tensor("cost_win", cost_win, (D, H + T - 1, W), device=wl.device)
    check_tensor("den", den, (D, H, W), device=wl.device)
    if cost_win.device.type == "cpu":
        return asw_pass_win_plain(cost_win, wl, wr, den, eps, d0)
    plan = aggregation_tiles(T, H, W, D, "win")
    require_cuda(cost_win, wl, wr, den)
    out = torch.empty((D, H, W), dtype=torch.float32, device=wl.device)
    _launch(plan, cost_win, wl, wr, den, out, D, d0, eps, "asw_pass_win")
    LAUNCHES["asw_pass_win"] += 1
    return out
