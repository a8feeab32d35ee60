"""Generate tests/data/cross_torch_fixture.npz: the JAX package's
cross-based output on the ASW fixture's scene, for the PyTorch port to be
held against where JAX is not installed (chip_smoke.py) and regenerated
bit for bit by a tier-1 test.

    python tests/data/gen_cross_torch_fixture.py      # from the repo root

Input: the pair of tests/data/asw_torch_fixture.npz
(eval.synthetic_scene(default_rng(0), 288, 384, 60), as uint8 codes).
Contents, all from `stereo_matchin_tpu` on the CPU at REFERENCE_CONFIG with
oii_impl="taps" (the sum order of the port's kernels):
  initial, final     (288, 384) uint8 codes of the CrossResult maps
  median_left        (288, 384, 3) uint8 codes of the median-filtered left
"""

from __future__ import annotations

import importlib.util
import os
import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
FIXTURE = HERE / "cross_torch_fixture.npz"
FIELDS = ("initial", "final", "median_left")


def _load_asw_generator():
    spec = importlib.util.spec_from_file_location(
        "gen_asw_torch_fixture", HERE / "gen_asw_torch_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


asw_gen = _load_asw_generator()


def run_jax(left_codes, right_codes):
    """JAX cross_pipeline at REFERENCE_CONFIG, oii_impl="taps", on the CPU
    (numpy out)."""
    import jax
    import jax.numpy as jnp

    from stereo_matchin_tpu import REFERENCE_CONFIG
    from stereo_matchin_tpu.models import cross_based

    jax.config.update("jax_platforms", "cpu")
    res = cross_based.cross_pipeline(
        jnp.asarray(asw_gen.from_codes(left_codes)),
        jnp.asarray(asw_gen.from_codes(right_codes)),
        REFERENCE_CONFIG.replace(oii_impl="taps"))
    return type(res)(*(np.asarray(a) for a in res))


def fixture_from_result(res) -> dict:
    return {f: asw_gen.to_codes(getattr(res, f)) for f in FIELDS}


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(HERE.parents[1]))
    lc, rc = asw_gen.scene_codes()
    np.savez_compressed(FIXTURE, **fixture_from_result(run_jax(lc, rc)))
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
