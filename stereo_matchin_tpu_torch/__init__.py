"""stereo_matchin_tpu_torch — the PyTorch + CUDA port of `stereo_matchin_tpu`.

The JAX package beside it is the reference this port is tested against.
The port shares its JAX-free modules (`stereo_matchin_tpu.config`, `.io`,
`.eval`) and never imports jax.

Layering, module for module as in the JAX package:
  ops       — plain PyTorch ops, (D, H, W) / (T, H, W) layouts
  kernels   — hand-written CUDA kernels for Hopper (csrc/*.cu), built by
              nvcc at first use and bound with ctypes
  models    — the ASW and cross-based pipelines end to end
              (models.asw, models.cross_based)
  convert   — carries the JAX package's weight strips into the port
"""

from stereo_matchin_tpu.config import REFERENCE_CONFIG, StereoConfig, TINY_CONFIG

__all__ = ["REFERENCE_CONFIG", "StereoConfig", "TINY_CONFIG"]
