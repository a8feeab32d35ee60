"""Generate tests/data/asw_torch_fixture.npz: the JAX package's ASW output
on a synthetic pair, for the PyTorch port to be held against where JAX is
not installed (chip_smoke.py) and regenerated bit for bit by a tier-1 test.

    python tests/data/gen_asw_torch_fixture.py        # from the repo root

Contents, all from `stereo_matchin_tpu` on the CPU at REFERENCE_CONFIG:
  left, right                  (288, 384, 3) uint8 codes of
                               eval.synthetic_scene(default_rng(0), 288, 384, 60)
  disparity, filled,
  wta_left, wta_right          (288, 384) uint8 codes of the ASWResult maps
  red_pre, red_post            (288, 384) bool: the pixels the consistency
                               diagnostics mark red (inconsistent)
"""

from __future__ import annotations

import os
import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
FIXTURE = HERE / "asw_torch_fixture.npz"
SEED, H, W, D_MAX = 0, 288, 384, 60
MAP_FIELDS = ("disparity", "filled", "wta_left", "wta_right")


def to_codes(img01: np.ndarray) -> np.ndarray:
    """[0, 1] values on the UNORM8 grid -> their uint8 codes (exact)."""
    codes = np.rint(np.asarray(img01, np.float64) * 255.0)
    if np.abs(codes / 255.0 - img01).max() > 1e-6:
        raise ValueError("values are not on the UNORM8 grid")
    return codes.astype(np.uint8)


def from_codes(codes: np.ndarray) -> np.ndarray:
    """uint8 codes -> float32 [0, 1] values, as io.png.read_rgb decodes them."""
    return (codes / np.float32(255.0)).astype(np.float32)


def red_mask(red_img: np.ndarray) -> np.ndarray:
    """Pixels a red diagnostic marks inconsistent: (1, 0, 0).  A consistent
    pixel is grey (d, d, d), so it never reads as pure red."""
    r = np.asarray(red_img)
    return (r[..., 0] == 1.0) & (r[..., 1] == 0.0) & (r[..., 2] == 0.0)


def scene_codes():
    from stereo_matchin_tpu.eval import synthetic_scene

    left, right, _, _ = synthetic_scene(np.random.default_rng(SEED), H, W,
                                        D_MAX)
    lc, rc = to_codes(left), to_codes(right)
    for f, c in ((left, lc), (right, rc)):
        if not np.array_equal(from_codes(c), np.asarray(f, np.float32)):
            raise ValueError("synthetic scene does not round-trip its codes")
    return lc, rc


def run_jax(left_codes, right_codes):
    """JAX asw_pipeline at REFERENCE_CONFIG on the CPU (numpy out)."""
    import jax
    import jax.numpy as jnp

    from stereo_matchin_tpu import REFERENCE_CONFIG
    from stereo_matchin_tpu.models import asw

    jax.config.update("jax_platforms", "cpu")
    res = asw.asw_pipeline(jnp.asarray(from_codes(left_codes)),
                           jnp.asarray(from_codes(right_codes)),
                           REFERENCE_CONFIG)
    return type(res)(*(np.asarray(a) for a in res))


def fixture_from_result(left_codes, right_codes, res) -> dict:
    out = {"left": left_codes, "right": right_codes}
    for f in MAP_FIELDS:
        out[f] = to_codes(getattr(res, f))
    out["red_pre"] = red_mask(res.consistency_pre)
    out["red_post"] = red_mask(res.consistency_post)
    return out


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(HERE.parents[1]))
    lc, rc = scene_codes()
    np.savez_compressed(FIXTURE, **fixture_from_result(lc, rc, run_jax(lc, rc)))
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
