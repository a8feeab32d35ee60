"""Carry the JAX package's weight strips into the port.

The ASW pipeline has no learned parameters: the state both sides must
share to compute the same thing is the eight support-weight strips.  The
port computes them itself (models.asw.asw_weights), but `exp` rounds
differently in XLA and in PyTorch, so a test that holds the port to the
JAX package bit for bit hands it the JAX strips through here.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .models.asw import ASWWeights


def weights_from_jax(strips: Mapping[str, np.ndarray],
                     device: str | torch.device = "cpu") -> ASWWeights:
    """strips: numpy arrays keyed by the ASWWeights field names — the
    outputs of `stereo_matchin_tpu.ops.support_weights` (wv_*, wh_*) and
    `ops.refinement_weights` (rv_*, rh_*), each (T, H, W) float32.

    Returns ASWWeights on `device`, values copied bit for bit."""
    missing = set(ASWWeights._fields) - set(strips)
    extra = set(strips) - set(ASWWeights._fields)
    if missing or extra:
        raise KeyError(f"strips: missing {sorted(missing)}, unexpected "
                       f"{sorted(extra)}")
    shape = np.shape(strips["wv_l"])
    out = {}
    for name in ASWWeights._fields:
        a = np.asarray(strips[name])
        if a.dtype != np.float32 or a.ndim != 3 or a.shape != shape:
            raise ValueError(f"{name}: expected float32 {shape}, got "
                             f"{a.dtype} {a.shape}")
        if shape[0] % 2 != 1:
            raise ValueError(f"{name}: tap count {shape[0]} is not odd")
        out[name] = torch.from_numpy(np.array(a, copy=True)).to(device)
    return ASWWeights(**out)
