"""Configuration of the port's pipelines and of its device mesh.

The same fields, defaults and checks as the JAX package's
`stereo_matchin_tpu.config.StereoConfig` and `MeshConfig`, kept here so that the port
stands alone; a tier-1 test holds the copies equal.  The defaults reproduce
the reference (main.cpp:176-177, 202-205): 61 disparity hypotheses, a
33-tap support window, cross arms of length 25, tau 0.1, r = 7
aggregation and k = 6 refinement iterations.

`kernels` and `oii_impl` keep the JAX package's values so that a test
builds both configurations from one set of keywords; in the port
"pallas" demands the CUDA kernels and "jnp" takes the plain PyTorch ops
(kernels.use_kernels, kernels.oii_route).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class StereoConfig:
    """Parameters shared by both matching pipelines."""

    # Disparity hypotheses d in [0, d_max]  (main.cpp:251 -> 61 planes).
    d_max: int = 60
    # ASW support window radius: 33 taps = 2*16+1 (main.cpp:413).
    radius: int = 16
    # Cross arm maximum length L (cross.cl: 25 unrolled checks).
    arm_len: int = 25
    # Cross color-similarity threshold on [0,1] RGB (cross.cl check 0.10f).
    tau: float = 0.10
    # ASW aggregation support-weight gammas (asw_vsupport.cl:173-175).
    gamma_c: float = 30.91
    gamma_p: float = 28.21
    # Refinement support-weight gammas (asw_refinement_v.cl supp_v).
    ref_gamma_c: float = 10.94
    ref_gamma_p: float = 118.78
    # Regularized re-WTA penalty weight (asw_wta_ref.cl:26: 0.085f).
    penalty: float = 0.085
    # ASW iteration counts (main.cpp:176-177: r=7 aggregation, k=6 refinement).
    r_iters: int = 7
    k_iters: int = 6
    # Epsilon initialising weighted sums (asw_vcost_aggregation.cl:24-25).
    eps: float = 1e-5
    # Sentinel "infinite cost" used by the WTA scans (asw_wta.cl: 100000).
    big: float = 1e5

    # --- fidelity switches -------------------------------------------------
    # Round-trip every disparity map through a UNORM8 image, as the
    # reference does (write_imagef to CL_UNORM_INT8, read back *60).
    quantize_maps: bool = True
    # asw_wta_ref.cl:63-66 writes the target confidence into the reference
    # confidence buffer: True replicates that bug.
    wta_ref_conf_bug: bool = True
    # cross.cl's check_all starts the running arm at 1, so the distance-2
    # similarity test is a no-op: True replicates it.
    legacy_cross_arm_quirk: bool = True
    # main.cpp:193 never writes the bottom H mod 3 rows / right W mod 3
    # columns of the median outputs (they read back as zero): True
    # replicates the zeroed rows and columns.
    median_dispatch_quirk: bool = False

    # --- backend selection -------------------------------------------------
    # "auto": the CUDA kernels on CUDA tensors, the plain ops elsewhere;
    # "jnp" the plain ops anywhere; "pallas" demands the kernels.
    kernels: str = "auto"
    # Cross aggregation and vote: "prefix" (integral images), "taps"
    # (translation-invariant, the kernels' sum order), "auto" (kernels on
    # CUDA tensors, taps elsewhere), "pallas" (demand the kernels).
    oii_impl: str = "auto"
    # ASW aggregation in this many disparity chunks (0 = the whole volume
    # at once); chunks are ceil(num_disp / n) planes.
    aggr_d_chunks: int = 0
    # The JAX package's choice of aggregation kernel family; kept for
    # equal configurations, the port has one family.
    aggr_kernels: str = "auto"

    def __post_init__(self):
        if self.d_max < 1:
            raise ValueError(f"d_max must be >= 1, got {self.d_max}")
        if self.radius < 1:
            raise ValueError(f"radius must be >= 1, got {self.radius}")
        if self.arm_len < 2:
            raise ValueError(f"arm_len must be >= 2, got {self.arm_len}")
        if self.aggr_d_chunks < 0 or self.aggr_d_chunks > self.d_max + 1:
            raise ValueError(
                f"aggr_d_chunks ({self.aggr_d_chunks}) must be in "
                f"[0, num_disp={self.d_max + 1}]")
        if self.aggr_kernels not in ("auto", "dres", "grid"):
            raise ValueError(
                f"aggr_kernels must be 'auto', 'dres' or 'grid', "
                f"got {self.aggr_kernels!r}")

    @property
    def num_disp(self) -> int:
        return self.d_max + 1

    @property
    def window(self) -> int:
        return 2 * self.radius + 1

    def replace(self, **kw) -> "StereoConfig":
        return dataclasses.replace(self, **kw)


# The configuration wired into the reference binary.
REFERENCE_CONFIG = StereoConfig()

# Small CPU-runnable configuration (BASELINE.json config[0]).
TINY_CONFIG = StereoConfig(d_max=15, radius=4, arm_len=6, r_iters=2, k_iters=2)


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for the sharded pipelines (parallel/).

    Axes:
      batch — data parallelism over independent stereo pairs (frames).
      row   — spatial tiling of the image height with halo exchange
              (the sequence-parallel analogue).
      disp  — sharding of the disparity axis of the cost volume with a
              top-2 argmin reduction at WTA (the tensor-parallel analogue).
    """

    batch: int = 1
    row: int = 1
    disp: int = 1

    @property
    def num_devices(self) -> int:
        return self.batch * self.row * self.disp

    def axis_names(self):
        return ("batch", "row", "disp")
