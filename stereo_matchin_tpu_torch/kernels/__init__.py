"""Hand-written CUDA kernels for the ASW path (Hopper, sm_90a).

  K1 asw_aggregation.asw_den   — aggregation denominator
  K2 asw_aggregation.asw_pass  — one vertical or horizontal aggregation pass
  K3 wta_gather.two_min        — reference-view two-min WTA
  K4 wta_gather.wta_diag       — target-view epipolar two-min WTA

Sources live in `csrc/`; `_build.library()` compiles them with nvcc at
first use.  Each wrapper takes its plain PyTorch version for a CPU tensor
and launches its kernel (or raises) for a CUDA tensor, and counts its
launches in `LAUNCHES`.  Nothing is built and the card is not touched
at import time.
"""

from __future__ import annotations

import torch

# Launch count per kernel, incremented only where the kernel is launched
# (never on the plain CPU route); asw_pass counts its two axes apart.
LAUNCHES = {"asw_den": 0, "asw_pass_v": 0, "asw_pass_h": 0, "two_min": 0,
            "wta_diag": 0}


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
