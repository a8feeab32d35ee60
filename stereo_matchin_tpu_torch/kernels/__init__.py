"""Hand-written CUDA kernels for the ASW and cross paths (Hopper, sm_90a).

  K1 asw_aggregation.asw_den   — aggregation denominator
  K2 asw_aggregation.asw_pass  — one vertical or horizontal aggregation pass
     asw_aggregation.asw_pass_win — its vertical form over a window of real
                                  rows (the wavefront band driver)
  K3 wta_gather.two_min        — reference-view two-min WTA
  K4 wta_gather.wta_diag       — target-view epipolar two-min WTA
  K5 cross_oii.cross_arms      — adaptive cross arms
  K6 sad_volume.sad_volume     — SAD cost volume
  K7 cross_oii.oii_pass        — one horizontal or vertical OII windowed mean
  K8 cross_oii.vote_h / vote_v — histogram vote: row counts, then the mode
  K9 asw_refine.support_w      — one support-weight strip (T, H, W)
  K10 asw_refine.refine_pass   — one refinement pass: vertical (rows
                                 clamped, or a window of real rows) or
                                 horizontal
  K11 wta_gather.wta_merge     — WTA epilogue: clamped tail, merge and
                                 both confidences
  K12 median.median3x3         — 3x3 median, per channel
  K13 wta_shard.epipolar_segment — one disp shard's segment of the
                                 epipolar target scan (the sharded WTA)
  K14 wta_shard.shard_merge_reference / shard_merge_target — the merges of
                                 the shards' all-gathered summaries, the
                                 target one with the WTA's maps

K1-K8 replace the JAX package's pallas_calls; K9-K14 replace none: they
are the fusions XLA makes of JAX functions' plain chains in its jitted
frames (ops/support.py support_weights, ops/refinement.py
refine_pass_v/_h, ops/wta_fast.py _tail_and_merge, ops/median.py
median3x3) and shard programs (parallel/wta_sharded.py epipolar_partial
and the two_min_combine folds).  Both methods launch K6 (the ASW SAD cost
at scale 255 and its chunk's d0, the cross cost at scale 1) and K12; K13
and K14 run on the sharded ASW path only.

Sources live in `csrc/`; `_build.library()` compiles them with nvcc at
first use.  Each wrapper takes its plain PyTorch version for a CPU tensor
and launches its kernel (or raises) for a CUDA tensor, and counts its
launches in `LAUNCHES`.  Nothing is built and the card is not touched
at import time.
"""

from __future__ import annotations

import torch

# Launch count per kernel, incremented only where the kernel is launched
# (never on the plain CPU route); asw_pass and oii_pass count their two
# axes apart, and the windowed vertical pass apart from both; K10 counts
# each of its three modes apart, K14 its two modes together.
# Kernels the two methods share (K6, K12) stand in both tuples.
ASW_KERNELS = ("asw_den", "asw_pass_v", "asw_pass_h", "asw_pass_win",
               "two_min", "wta_diag", "support_w", "refine_v", "refine_win",
               "refine_h", "sad_volume", "wta_merge", "median3x3",
               "epipolar_segment", "shard_merge")
CROSS_KERNELS = ("cross_arms", "sad_volume", "oii_pass_h", "oii_pass_v",
                 "vote_h", "vote_v", "median3x3")
LAUNCHES = dict.fromkeys(ASW_KERNELS + CROSS_KERNELS, 0)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def use_kernels(mode: str, tensor: torch.Tensor) -> bool:
    """Route for StereoConfig.kernels: "auto" -> the kernels on CUDA
    tensors, "jnp" -> the plain ops everywhere, "pallas" -> the kernels,
    which need CUDA tensors."""
    if mode == "jnp":
        return False
    if mode == "auto":
        return tensor.device.type == "cuda"
    if mode == "pallas":
        if tensor.device.type != "cuda":
            raise ValueError("kernels='pallas' demands the CUDA kernels, but "
                             f"the input lies on {tensor.device}")
        return True
    raise ValueError(f"kernels must be 'auto', 'jnp' or 'pallas', got {mode!r}")


def oii_route(impl: str, tensor: torch.Tensor) -> str:
    """Route for StereoConfig.oii_impl on the cross path: "taps" and
    "prefix" -> those plain ops everywhere; "auto" -> "kernels" on CUDA
    tensors and "taps" (the kernels' sum order) elsewhere; "pallas" ->
    "kernels", which need CUDA tensors."""
    if impl in ("taps", "prefix"):
        return impl
    if impl == "auto":
        return "kernels" if tensor.device.type == "cuda" else "taps"
    if impl == "pallas":
        if tensor.device.type != "cuda":
            raise ValueError("oii_impl='pallas' demands the CUDA kernels, "
                             f"but the input lies on {tensor.device}")
        return "kernels"
    raise ValueError("oii_impl must be 'auto', 'taps', 'prefix' or 'pallas', "
                     f"got {impl!r}")


def check_tensor(name: str, t: torch.Tensor, shape, dtype=torch.float32,
                 device=None) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")


def require_cuda(*tensors: torch.Tensor) -> None:
    """Refuse a launch on anything but contiguous CUDA tensors."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"CUDA kernel called on a {t.device} tensor")
        if not t.is_contiguous():
            raise ValueError("CUDA kernel inputs must be contiguous")


def raise_on_error(rc: int, what: str) -> None:
    """A refused launch never runs and a later synchronize does not report
    it, so every launch's cudaGetLastError() is checked here."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
