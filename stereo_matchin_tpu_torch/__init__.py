"""stereo_matchin_tpu_torch — the PyTorch + CUDA port of `stereo_matchin_tpu`.

The JAX package beside it is the reference this port is tested against;
the port imports neither jax nor anything of that package.  It keeps its
own configuration (`config`), PNG I/O and pair registry (`io`) and
synthetic scenes (`eval`), held equal to the JAX package's by the tests.

Layering, module for module as in the JAX package:
  ops       — plain PyTorch ops, (D, H, W) / (T, H, W) layouts
  kernels   — hand-written CUDA kernels for Hopper (csrc/*.cu), built by
              nvcc at first use and bound with ctypes
  models    — the ASW and cross-based pipelines end to end
              (models.asw, models.cross_based)
  parallel  — meshes, halo exchange and the sharded pipelines over
              torch.distributed (one process per shard)
  convert   — carries the JAX package's weight strips into the port
  config, io, eval — StereoConfig / MeshConfig, PNG I/O and pics.txt,
              synthetic scenes
"""

from .config import MeshConfig, REFERENCE_CONFIG, StereoConfig, TINY_CONFIG

__all__ = ["MeshConfig", "REFERENCE_CONFIG", "StereoConfig", "TINY_CONFIG"]
