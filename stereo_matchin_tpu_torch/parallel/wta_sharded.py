"""Disparity-sharded winner-take-all with an exact two-min merge; the port
of `stereo_matchin_tpu/parallel/wta_sharded.py`.

The cost volume's planes are sharded over the mesh's disp group.  Each
shard runs the reference's sequential two-minimum tracker
(asw_wta.cl:33-47) over its own planes -- K3 (`two_min`, with the shard's
disparity offset d0 for the penalty) on a CUDA tensor -- and the
per-shard summaries (c1, c2, argmin) are all-gathered and merged in
global scan order by a tie-exact combine: ties go to the earlier
disparity, duplicate minima collapse the confidence to zero, values >=
`big` never update, all as the sequential scan does.

The target view's epipolar probe (the slope-1 bresenham, asw_wta.cl:55-67)
visits global plane b(i) = d1 + max(0, x-i) - x, which descends through
the shards as i grows, and the clamped tail (i > x) revisits one plane.
b(i) is monotone, so each shard's visits form one interval of i: each
shard replays its interval (K13 `epipolar_segment` on a CUDA tensor, the
masked sequential loop `epipolar_partial` elsewhere, as in the JAX
package) and the segments merge in descending shard order (= ascending
i).  Both merges run as K14 (`shard_merge`) on a CUDA tensor, the target
one with the WTA's maps; elsewhere their plain versions
(`merge_reference_gathered`, `merge_target_gathered` + `wta_result`).
The route follows `kernels` (cfg.kernels, kernels.use_kernels).

Each compute segment between two all-gathers runs as steps of a stage
runner `run(name, fn, *args)`: utils.replay_stage by default, which on
CUDA tensors replays each step from a CUDA graph (the JAX package jits
the whole shard program; the collectives stay eager here, between the
steps), or utils.call_stage, which calls it.  A scan is a local step (the
shard's summary, stacked), the all-gather, and a merge step that takes
the gathered (n, 3, H, W) tensor whole: the reference scan "wta_local"
and "wta_merge_reference", the target scan "wta_epipolar" and
"wta_merge_target", which returns the WTA's maps.  A penalty's
`penalty * den` is formed inside the steps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.wta import WTAResult
from ..ops.wta_fast import _two_min
from ..utils.graphs import replay_stage
from . import comm


class TwoMin(NamedTuple):
    c1: torch.Tensor
    c2: torch.Tensor
    d: torch.Tensor     # int32


def two_min_combine(a: TwoMin, b: TwoMin) -> TwoMin:
    """Merge two-min summaries; `a` is EARLIER in scan order (ties -> a)."""
    take_b = b.c1 < a.c1
    c1 = torch.where(take_b, b.c1, a.c1)
    d = torch.where(take_b, b.d, a.d)
    # Second-smallest of the merged multiset {c1a, c2a, c1b, c2b}.
    c2 = torch.minimum(torch.minimum(a.c2, b.c2), torch.maximum(a.c1, b.c1))
    return TwoMin(c1, c2, d)


def stack_two_min(s: TwoMin) -> torch.Tensor:
    """(3, H, W): c1, c2 and d's int32 bits in a float32 plane, as one
    all-gather sends a summary."""
    return torch.stack([s.c1, s.c2, s.d.view(torch.float32)])


def unstack_two_min(g: torch.Tensor) -> list:
    """The shards' summaries, in shard order, from their all-gathered
    (n, 3, H, W) stack."""
    return [TwoMin(x[0], x[1], x[2].contiguous().view(torch.int32))
            for x in g]


def _scaled(pen_scale, penalty):
    return pen_scale if penalty is None else penalty * pen_scale


def local_two_min(cost_local, pen_scale, pen_center, penalty, d0: int,
                  big: float, kernels: str) -> torch.Tensor:
    """The step before the reference all-gather: this shard's two-min
    (K3 at d0 on a CUDA tensor, d GLOBAL), stacked.  The penalty is
    penalty * pen_scale * |pen_center - d| (penalty None: pen_scale
    alone)."""
    c1, c2, dl = _two_min(cost_local, _scaled(pen_scale, penalty),
                          pen_center, big, kernels, d0)
    return stack_two_min(TwoMin(c1, c2, dl + d0))


def reference_scan_sharded(cost_local, d0: int, group, pen_scale=None,
                           pen_center=None, big: float = 1e5,
                           kernels: str = "auto", penalty=None,
                           run=replay_stage) -> TwoMin:
    """Global two-min over a disp-sharded volume.

    cost_local: (Dl, H, W), plane k holding global disparity d0 + k; the
    optional penalty is pen_scale * |pen_center - d| (K3's), times
    `penalty` where given.  Returns the global TwoMin, d the GLOBAL
    disparity."""
    s = run("wta_local", local_two_min, cost_local, pen_scale, pen_center,
            penalty, d0, big, kernels)
    return run("wta_merge_reference", merge_reference_step,
               comm.all_gather(s, group), big, kernels)


def merge_reference(parts: list, big: float = 1e5) -> TwoMin:
    """The shards' reference-scan summaries, in shard order, merged in
    ascending d (scan order)."""
    state = parts[0]
    for part in parts[1:]:
        state = two_min_combine(state, part)
    # No plane anywhere beat `big`: the sequential tracker leaves d = 0.
    return state._replace(d=torch.where(state.c1 < big, state.d, 0))


def merge_reference_gathered(g, big: float) -> TwoMin:
    """merge_reference over the all-gathered (n, 3, H, W) summaries."""
    return merge_reference(unstack_two_min(g), big)


def merge_reference_step(g, big: float, kernels: str = "auto") -> TwoMin:
    """The step after the reference all-gather: K14's reference mode on a
    CUDA tensor, merge_reference_gathered elsewhere."""
    from ..kernels import use_kernels

    if use_kernels(kernels, g):
        from ..kernels.wta_shard import shard_merge_reference
        return shard_merge_reference(g, big)
    return merge_reference_gathered(g, big)


def epipolar_partial(cost_local, d1, d0: int, n_local: int, total_disp: int,
                     penalty_scale=None, penalty_center=None,
                     big: float = 1e5) -> TwoMin:
    """One shard's contiguous segment of the epipolar target scan.

    Replays steps i in [0, total_disp - 1) masked to this shard's planes,
    keeping the visit order and the duplicate visits (asw_wta.cl:55-67 /
    asw_wta_ref.cl:40-51, with the penalty term |ref - i|).  d1: (H, W)
    int32 global disparities."""
    Dl, H, W = cost_local.shape
    dev = cost_local.device
    xs = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    rows = (torch.arange(H, device=dev) * W)[:, None]
    flat = cost_local.reshape(-1)
    c1 = torch.full((H, W), big, dtype=cost_local.dtype, device=dev)
    c2 = c1.clone()
    best_b = d1.clone()
    for i in range(total_disp - 1):
        xq = (xs - i).clamp(min=0)
        b = d1 + xq - xs                               # global plane
        bl = b - d0                                    # local plane
        valid = (i < d1) & (bl >= 0) & (bl < n_local)
        v = flat[bl.clamp(0, Dl - 1).long() * (H * W) + rows + xq]
        if penalty_scale is not None:
            v = v + penalty_scale * (penalty_center - float(i)).abs()
        v = torch.where(valid, v, torch.inf)
        upd = v < c1
        c2 = torch.where(upd, c1, torch.minimum(c2, v))
        best_b = torch.where(upd, b, best_b)
        c1 = torch.where(upd, v, c1)
    return TwoMin(c1, c2, best_b)


def epipolar_segment(cost_local, d1, d0: int, n_local: int,
                     total_disp: int, pen_scale, pen_center, penalty,
                     big: float, kernels: str = "auto") -> torch.Tensor:
    """The step before the target all-gather: this shard's segment (the
    penalty as local_two_min's), stacked: K13 on a CUDA tensor,
    epipolar_partial elsewhere."""
    from ..kernels import use_kernels

    sc = _scaled(pen_scale, penalty)
    if use_kernels(kernels, cost_local):
        from ..kernels.wta_shard import epipolar_segment as k13
        return k13(cost_local, d1, d0, n_local, total_disp, sc, pen_center,
                   big)
    return stack_two_min(epipolar_partial(cost_local, d1, d0, n_local,
                                          total_disp, sc, pen_center, big))


def target_scan_sharded(cost_local, ref: TwoMin, d0: int, n_local: int,
                        total_disp: int, group, penalty_scale=None,
                        penalty_center=None, big: float = 1e5, penalty=None,
                        kernels: str = "auto",
                        run=replay_stage) -> WTAResult:
    """The target scan from the merged reference `ref` (its d the scan's
    d1): the per-shard epipolar segments merged in ascending-i order, i.e.
    DESCENDING shard order, seeded with the sequential start (c = big,
    b = d1).  Returns the WTA's maps, the reference's and the target's,
    confidences (c2 - c1) / c2."""
    seg = run("wta_epipolar", epipolar_segment, cost_local, ref.d, d0,
              n_local, total_disp, penalty_scale, penalty_center, penalty,
              big, kernels)
    return run("wta_merge_target", merge_target_step,
               comm.all_gather(seg, group), ref.c1, ref.c2, ref.d, big,
               kernels)


def merge_target(parts: list, d1, big: float = 1e5):
    """The shards' epipolar segments, in shard order, merged in descending
    shard order (ascending i) from the sequential start (c = big, b = d1).
    Returns (d_target int32, conf_target)."""
    full = torch.full_like(parts[0].c1, big)
    state = TwoMin(full, full, d1)
    for part in reversed(parts):
        state = two_min_combine(state, part)
    return state.d, (state.c2 - state.c1) / state.c2


def merge_target_gathered(g, d1, big: float):
    """merge_target over the all-gathered (n, 3, H, W) segments."""
    return merge_target(unstack_two_min(g), d1, big)


def wta_result(c1, c2, d_ref, d_target, conf_target) -> WTAResult:
    """The WTA's maps from the two merged scans."""
    dt = c1.dtype
    return WTAResult(d_ref.to(dt), (c2 - c1) / c2, d_target.to(dt),
                     conf_target)


def merge_target_step(g, c1, c2, d_ref, big: float,
                      kernels: str = "auto") -> WTAResult:
    """The step after the target all-gather: K14's target mode on a CUDA
    tensor, merge_target_gathered + wta_result elsewhere; (c1, c2, d_ref)
    the merged reference scan."""
    from ..kernels import use_kernels

    if use_kernels(kernels, g):
        from ..kernels.wta_shard import shard_merge_target
        return shard_merge_target(g, c1, c2, d_ref, big)
    return wta_result(c1, c2, d_ref, *merge_target_gathered(g, d_ref, big))


def wta_sharded(cost_local, d0: int, n_local: int, total_disp: int, group,
                big: float = 1e5, kernels: str = "auto",
                run=replay_stage) -> WTAResult:
    """asw_WTA over a disp-sharded volume; every disp shard gets the same
    maps."""
    ref = reference_scan_sharded(cost_local, d0, group, big=big,
                                 kernels=kernels, run=run)
    return target_scan_sharded(cost_local, ref, d0, n_local, total_disp,
                               group, big=big, kernels=kernels, run=run)


def wta_refined_sharded(cost_local, d0: int, n_local: int, total_disp: int,
                        group, ref_value, ref_denom, ref_value_t, ref_denom_t,
                        penalty: float, big: float = 1e5,
                        kernels: str = "auto",
                        run=replay_stage) -> WTAResult:
    """asw_WTA_REF over a disp-sharded volume: the penalty
    (penalty * den) * |ref - d| on global d."""
    ref = reference_scan_sharded(cost_local, d0, group, ref_denom, ref_value,
                                 big, kernels, penalty, run)
    return target_scan_sharded(
        cost_local, ref, d0, n_local, total_disp, group,
        penalty_scale=ref_denom_t, penalty_center=ref_value_t, big=big,
        penalty=penalty, kernels=kernels, run=run)
