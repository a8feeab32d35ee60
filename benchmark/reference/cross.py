"""Plain PyTorch reference of the cross-based frame (Zhang, Lu and Lafruit
2009; the reference binary's main.cpp:219-411 and cross.cl).

A frozen copy of the port's plain "taps" route (`models/cross_based.py`
over ops/median.py, cross.py, cost.py, oii.py, wta.py, vote.py): median
of both views -> adaptive cross arms -> SAD cost -> horizontal then
vertical windowed means over the combined arms -> argmin -> histogram
vote over the left arms -> median.  It imports nothing of the program.

The cost, both passes and the argmin run chunk by chunk of disparity
planes, the vote's counts too, with the chunks' winners combined under
the whole volume's tie rules, so that a full-size frame fits; every value
is the one the whole volume gives.  `dt` runs the arithmetic in another
precision (the control); float32 is the configuration's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .common import (disparity_to_image, edge_pad, median3x3,
                     median_dispatch_truncate, sad_cost_volume,
                     shifted_columns)

COMPARED = ("initial", "final", "median_left")
PLANE_ELEMS = 1 << 28      # elements of a disparity chunk
# (dy, dx) per arm plane: h-, h+, v-, v+.
_DIRS = ((0, -1), (0, 1), (-1, 0), (1, 0))


def cross_arms(img, arm_len: int, tau: float, legacy_quirk: bool):
    """(4, H, W) int32 arms [h-, h+, v-, v+], minus arms negative: each arm
    grows while the neighbour stays within tau of the anchor on all three
    channels and inside the frame; the first failure stops it."""
    H, W = img.shape[0], img.shape[1]
    dev = img.device
    p = img.movedim(-1, 0)
    M = arm_len + 1
    ext = edge_pad(edge_pad(p, M, M, 1), M, M, 2)
    tau32 = float(np.float32(tau))
    ys = torch.arange(H, device=dev).clamp_(0, H - 1)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    first = 3 if legacy_quirk else 2
    arm = torch.ones((4, H, W), dtype=torch.int32, device=dev)
    alive = torch.ones((4, H, W), dtype=torch.bool, device=dev)
    for dist in range(first, first + arm_len - 1):
        for i, (dy, dx) in enumerate(_DIRS):
            oy, ox = M + dy * dist, M + dx * dist
            nb = ext[:, oy:oy + H, ox:ox + W]
            sim = ((nb - p).abs() < tau32).all(dim=0)
            ny, nx = ys + dy * dist, xs + dx * dist
            inb = (ny >= 0) & (ny <= H - 1) & (nx >= 0) & (nx <= W - 1)
            alive[i] &= sim & inb
            arm[i] += alive[i].to(torch.int32)
    sign = torch.arange(4, dtype=torch.int32, device=dev) % 2 * 2 - 1
    return sign[:, None, None] * arm


def _positions(n: int, axis: int, device):
    shape = [1, 1, 1]
    shape[axis] = n
    return torch.arange(n, dtype=torch.int32, device=device).view(shape)


def oii_pass(vol, arms_l, arms_r, arm_len: int, axis: int, d0: int):
    """One windowed mean over (n, H, W) planes d0 .. d0 + n - 1: the taps j
    in [minus, plus] of the combined arms with frame position in [1, n -
    1], added in j order, over plus - minus (the reference's quirks)."""
    pm, pp = (0, 1) if axis == 2 else (2, 3)
    D = vol.shape[0]
    minus = torch.maximum(shifted_columns(arms_r[pm], D, d0), arms_l[pm][None])
    plus = torch.minimum(shifted_columns(arms_r[pp], D, d0), arms_l[pp][None])
    n = vol.shape[axis]
    idx = _positions(n, axis, vol.device)
    pad = (arm_len, arm_len) if axis == 2 else (0, 0, arm_len, arm_len)
    ext = F.pad(vol, pad)
    total = None
    for j in range(-arm_len, arm_len + 1):
        tap = ext.narrow(axis, arm_len + j, n)
        c = idx + j
        m = (j >= minus) & (j <= plus) & (c >= 1) & (c <= n - 1)
        term = torch.where(m, tap, 0.0)
        total = term if total is None else total + term
    return (total / (plus - minus).to(vol.dtype)).contiguous()


def _window_taps(vol, minus, plus, arm_len: int, axis: int):
    """sum of vol[clamp(i + j)] over j in [minus, plus] along `axis`."""
    n = vol.shape[axis]
    ext = edge_pad(vol, arm_len, arm_len, axis)
    total = None
    for j in range(-arm_len, arm_len + 1):
        term = torch.where((j >= minus) & (j <= plus),
                           ext.narrow(axis, arm_len + j, n), 0)
        total = term if total is None else total + term
    return total


def initial_disparity(ml, mr, arms_l, arms_r, p, dt):
    """argmin over d of the aggregated volume (ties to the lowest d), chunk
    by chunk of planes, as float disparities."""
    D, (H, W) = p.d_max + 1, ml.shape[:2]
    planes = max(1, min(D, PLANE_ELEMS // (H * W)))
    best_v = best_d = None
    for d0 in range(0, D, planes):
        n = min(planes, D - d0)
        c = sad_cost_volume(ml, mr, n, 1.0, d0)
        c = oii_pass(c, arms_l, arms_r, p.arm_len, 2, d0)
        c = oii_pass(c, arms_l, arms_r, p.arm_len, 1, d0)
        j = torch.argmin(c, dim=0)
        v = torch.gather(c, 0, j[None])[0]
        if best_v is None:
            best_v, best_d = v, j + d0
        else:
            take = v < best_v
            best_v = torch.where(take, v, best_v)
            best_d = torch.where(take, j + d0, best_d)
        del c
    return best_d.to(dt)


def vote(initial_img, arms_l, p):
    """The mode of the initial disparity's bins over the left cross (the
    anchor's v arms over each row's h counts), ties to the highest d, as a
    stored image value."""
    D, (H, W) = p.d_max + 1, initial_img.shape
    L = p.arm_len
    if not 1 <= L <= 127:
        raise ValueError(f"vote counts are uint8: need 1 <= arm_len <= 127")
    idx = torch.floor(initial_img.to(torch.float32) * p.d_max).to(torch.int32)
    planes = max(1, min(D, PLANE_ELEMS // (H * W)))
    best_v = best_d = None
    for d0 in range(0, D, planes):
        n = min(planes, D - d0)
        ds = torch.arange(d0, d0 + n, dtype=torch.int32, device=idx.device)
        ind = (idx[None] == ds[:, None, None]).to(torch.int32)
        rc = _window_taps(ind, arms_l[0][None], arms_l[1][None], L, 2)
        tab = _window_taps(rc.to(torch.uint8).to(torch.int32),
                           arms_l[2][None], arms_l[3][None], L, 1)
        j = (n - 1) - torch.argmax(tab.flip(0), dim=0)
        v = torch.gather(tab, 0, j[None])[0]
        if best_v is None:
            best_v, best_d = v, j + d0
        else:
            take = v >= best_v        # a later chunk holds higher d
            best_v = torch.where(take, v, best_v)
            best_d = torch.where(take, j + d0, best_d)
        del ind, rc, tab
    return disparity_to_image(best_d.to(torch.int32), p.d_max,
                              p.quantize_maps)


def frame(left: torch.Tensor, right: torch.Tensor, p,
          dt=torch.float32) -> dict:
    """The compared maps of one frame: `initial` (the argmin's map),
    `final` (voted and median-filtered) and `median_left` (the filtered
    left view), as stored image values.

    left, right: (H, W, 3) float32 on the UNORM8 grid; p: the method's
    parameters (StereoConfig's field names)."""
    ml, mr = median3x3(left.to(dt)), median3x3(right.to(dt))
    if p.median_dispatch_quirk:
        ml, mr = median_dispatch_truncate(ml), median_dispatch_truncate(mr)
    arms_l = cross_arms(ml, p.arm_len, p.tau, p.legacy_cross_arm_quirk)
    arms_r = cross_arms(mr, p.arm_len, p.tau, p.legacy_cross_arm_quirk)
    initial = disparity_to_image(
        initial_disparity(ml, mr, arms_l, arms_r, p, dt), p.d_max,
        p.quantize_maps)
    final = median3x3(vote(initial, arms_l, p))
    if p.median_dispatch_quirk:
        final = median_dispatch_truncate(final)
    return {"initial": initial, "final": final, "median_left": ml}
