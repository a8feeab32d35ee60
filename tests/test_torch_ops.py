"""The port's plain ops (stereo_matchin_tpu_torch.ops) against the JAX
package's, on the same numpy inputs, on the CPU.

Tolerances, and why:
  * UNORM8 helpers, cost, consistency, median, the sequential WTA oracle:
    bit-equal.  Both sides round every operation once.
  * Ops with a mul+add (cost's `l*255 - r*255`, refinement sums): XLA:CPU
    contracts a*b + c into one fused multiply-add inside a jitted program
    (measured: `jit(lambda a, b, c: a*b + c)` differs from numpy on 12% of
    random f32 inputs), while the port and JAX's op-by-op (eager) mode
    round twice.  So these are bit-equal to eager JAX and held to jitted
    JAX by a stated bound.
  * support_weights: XLA's `exp` and PyTorch's differ by a few ulp, and
    the jitted argument is FMA-contracted: up to 64 ulp, 4e-6 relative
    (measured at 288x384, radius 16), so rtol 1e-5.
"""

from __future__ import annotations

import ast
import io
import pathlib
import re
import subprocess
import sys
import tokenize

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_matchin_tpu import ops as jops
from stereo_matchin_tpu.ops import common as jcommon
from stereo_matchin_tpu_torch import ops as tops
from stereo_matchin_tpu_torch.ops import common as tcommon

from . import oracle
from .torch_support import n, t, unorm8_pair

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "stereo_matchin_tpu_torch"
D_MAXES = [15, 23, 59, 60, 255, 280, 299]


# --- UNORM8 helpers ---------------------------------------------------------

def test_unorm8_level_all_256_codes():
    k = np.arange(256, dtype=np.int32)
    want = np.asarray(jops.unorm8_level(jnp.asarray(k)))
    got = n(tops.unorm8_level(t(k)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got, jcommon._UNORM8_LEVELS)


def test_unorm8_code_matches_jax_on_grid_and_ties():
    rng = np.random.default_rng(5)
    levels = jcommon._UNORM8_LEVELS
    # every level, its f32 neighbours (the rounding boundary lives there),
    # the exact half-code points, and random values in [0, 1]
    v = np.concatenate([
        levels, np.nextafter(levels, np.float32(2)),
        np.nextafter(levels, np.float32(-1)),
        ((np.arange(255) + 0.5) / 255).astype(np.float32),
        rng.random(100_000, dtype=np.float32)]).astype(np.float32)
    want = np.asarray(jax.jit(jops.unorm8_code)(jnp.asarray(v)))
    np.testing.assert_array_equal(n(tops.unorm8_code(t(v))), want)
    np.testing.assert_array_equal(n(tops.unorm8_code(t(levels))),
                                  np.arange(256))


def test_disp_code_params_equal_jax_for_every_d_max_to_2048():
    for d_max in range(1, 2049):
        np.testing.assert_array_equal(tcommon._golden_codes(d_max),
                                      jcommon._golden_codes(d_max))
        assert tcommon._disp_code_params(d_max) == \
            jcommon._disp_code_params(d_max), d_max


@pytest.mark.parametrize("d_max", D_MAXES)
def test_disparity_to_image_matches_jax(d_max):
    d = np.arange(d_max + 1, dtype=np.float32)
    want = np.asarray(jax.jit(lambda v: jops.disparity_to_image(v, d_max))(
        jnp.asarray(d)))
    np.testing.assert_array_equal(n(tops.disparity_to_image(t(d), d_max)), want)
    np.testing.assert_array_equal(
        n(tops.disparity_to_image(t(d.astype(np.int32)), d_max)), want)
    raw = np.asarray(jops.disparity_to_image(jnp.asarray(d), d_max, False))
    np.testing.assert_array_equal(
        n(tops.disparity_to_image(t(d), d_max, quantize=False)), raw)


def test_disparity_to_image_pins_the_golden_tie():
    """d_max=60 stores byte 110 at d=26: fl(fl(26/60)*255) = 110.5 exactly,
    ties toward zero."""
    img = n(tops.disparity_to_image(t(np.arange(61, dtype=np.float32)), 60))
    assert round(float(img[26]) * 255) == 110


def test_disparity_to_image_table_fallback(monkeypatch):
    """The level-table route (no exact multiply-shift) gives the same bits."""
    d = np.arange(61, dtype=np.float32)
    want = n(tops.disparity_to_image(t(d), 60))
    monkeypatch.setattr(tcommon, "_disp_code_params", lambda d_max: None)
    np.testing.assert_array_equal(n(tops.disparity_to_image(t(d), 60)), want)


@pytest.mark.parametrize("d_max", D_MAXES)
def test_image_from_q_and_to_unit_match_jax(d_max):
    q = (jcommon._UNORM8_LEVELS * np.float32(d_max)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jops.image_from_q(v, d_max))(
        jnp.asarray(q)))
    np.testing.assert_array_equal(n(tops.image_from_q(t(q), d_max)), want)
    np.testing.assert_array_equal(want, jcommon._UNORM8_LEVELS)
    x = np.random.default_rng(d_max).random(512, dtype=np.float32) * d_max
    np.testing.assert_array_equal(
        n(tops.to_unit(t(x), d_max)),
        np.asarray(jax.jit(lambda v: jops.to_unit(v, d_max))(jnp.asarray(x))))


@pytest.mark.parametrize("shift", [-5, -1, 0, 2, 7])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_shift_axis_matches_jax(shift, axis):
    x = np.random.default_rng(1).random((4, 6, 5), dtype=np.float32)
    np.testing.assert_array_equal(
        n(tops.shift_axis(t(x), shift, axis)),
        np.asarray(jops.shift_axis(jnp.asarray(x), shift, axis)))


# --- structure: no jax, no division by d_max --------------------------------

_DIV_RE = re.compile(r"/\s*\(?\s*(cfg\s*\.\s*)?d_max\b")
# Roots the port may not import: jax, and the JAX package itself (the port
# keeps its own copies of its config, io and eval modules).
_FORBIDDEN = ("jax", "jaxlib", "stereo_matchin_tpu")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax_and_divides_by_no_d_max():
    """No `import jax` / `from jax`, no import of the JAX package at all,
    and (comments and strings stripped) no `/ d_max`."""
    offenders = []
    for path in _port_sources():
        src = path.read_text()
        rel = path.relative_to(REPO)
        for node in ast.walk(ast.parse(src)):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                if name.split(".")[0] in _FORBIDDEN:
                    offenders.append(f"{rel}:{node.lineno}: imports {name}")
        lines = {}
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type not in (tokenize.STRING, tokenize.COMMENT) and \
                    tok.start[0] == tok.end[0]:
                lines.setdefault(tok.start[0], []).append(tok.string)
        for ln, toks in sorted(lines.items()):
            code = " ".join(toks)
            if _DIV_RE.search(code):
                offenders.append(f"{rel}:{ln}: {code}")
    assert not offenders, "\n".join(offenders)


def test_importing_the_port_loads_no_jax():
    mods = ["stereo_matchin_tpu_torch", "stereo_matchin_tpu_torch.models.asw",
            "stereo_matchin_tpu_torch.models.cross_based",
            "stereo_matchin_tpu_torch.convert",
            "stereo_matchin_tpu_torch.__main__",
            "stereo_matchin_tpu_torch.kernels.asw_aggregation",
            "stereo_matchin_tpu_torch.kernels.wta_gather",
            "stereo_matchin_tpu_torch.kernels.cross_oii",
            "stereo_matchin_tpu_torch.kernels.sad_volume",
            "stereo_matchin_tpu_torch.io", "stereo_matchin_tpu_torch.eval",
            "stereo_matchin_tpu_torch.models.tiled",
            "stereo_matchin_tpu_torch.bench",
            "stereo_matchin_tpu_torch.eval.metrics",
            "stereo_matchin_tpu_torch.io.groundtruth",
            "stereo_matchin_tpu_torch.utils", "chip_smoke"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'stereo_matchin_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


# --- front ops --------------------------------------------------------------

def test_sad_cost_volume_bit_equal():
    rng = np.random.default_rng(2)
    left, right = unorm8_pair(rng, 24, 40)
    right = rng.permutation(right.reshape(-1, 3)).reshape(right.shape)
    for D in (1, 9, 17):
        got = n(tops.sad_cost_volume(t(left), t(right), D, 255.0))
        np.testing.assert_array_equal(got, np.asarray(jops.sad_cost_volume(
            jnp.asarray(left), jnp.asarray(right), D, 255.0)))
    small = oracle.sad_cost_volume(left[:6, :9], right[:6, :9], 5, 255.0)
    np.testing.assert_array_equal(
        n(tops.sad_cost_volume(t(left[:6, :9]), t(right[:6, :9]), 5, 255.0)),
        small)


def test_sad_cost_volume_within_fma_residual_of_jitted_jax():
    """Jitted, XLA:CPU computes |l*255 - r*255| as one FMA, which leaves the
    rounding residual of r*255 (<= half an ulp below 256: 2^-17) in each
    channel term where the port's difference is exact; with the rounding of
    the channel sum (<= 2^-15 below 1024) no element moves by 2^-14."""
    left, right = unorm8_pair(np.random.default_rng(3), 24, 40)
    got = n(tops.sad_cost_volume(t(left), t(right), 9, 255.0))
    want = np.asarray(jax.jit(lambda a, b: jops.sad_cost_volume(
        a, b, 9, 255.0))(jnp.asarray(left), jnp.asarray(right)))
    assert np.abs(got - want).max() <= 2.0 ** -14


@pytest.mark.parametrize("axis", [0, 1])
def test_support_weights_within_stated_bound(axis):
    left, _ = unorm8_pair(np.random.default_rng(4), 40, 56)
    for radius, gc, gp in ((4, 30.91, 28.21), (16, 10.94, 118.78)):
        got = n(tops.support_weights(t(left), radius, gc, gp, axis))
        for f in (jops.support_weights,
                  jax.jit(jops.support_weights, static_argnums=(1, 2, 3, 4))):
            want = np.asarray(f(jnp.asarray(left), radius, gc, gp, axis))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_support_weights_equal_oracle_form():
    """Same value as the per-pixel oracle within the same exp bound."""
    left, _ = unorm8_pair(np.random.default_rng(6), 7, 9)
    for axis in (0, 1):
        got = n(tops.support_weights(t(left), 2, 30.91, 28.21, axis))
        want = oracle.support_weights(left, 2, 30.91, 28.21, axis)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("axis", [1, 2])
def test_aggregate_pass_bit_equal_to_oracle(axis):
    rng = np.random.default_rng(8)
    cost = rng.uniform(0, 700, (5, 7, 9)).astype(np.float32)
    wl, wr = (rng.random((5, 7, 9), dtype=np.float32) for _ in range(2))
    out, den = tops.asw_aggregate_pass(t(cost), t(wl), t(wr), axis, 2)
    want_out, want_den = oracle.asw_aggregate_pass(cost, wl, wr, axis, 2)
    np.testing.assert_array_equal(n(den), want_den)
    np.testing.assert_array_equal(n(out), want_out)


# --- tail ops ---------------------------------------------------------------

def test_consistency_and_red_diagnostic_bit_equal():
    rng = np.random.default_rng(9)
    d_ref = (rng.integers(0, 61, (30, 40)) * np.float32(60 / 255.)).astype(
        np.float32)
    d_tar = d_ref + rng.choice(np.float32([0, 0.99, 1.0009, 1.0011, 3]),
                               d_ref.shape).astype(np.float32)
    c_ref, c_tar = (rng.random((30, 40), dtype=np.float32) for _ in range(2))
    got = tops.consistency(t(d_ref), t(d_tar), t(c_ref), t(c_tar))
    want = jops.consistency(*map(jnp.asarray, (d_ref, d_tar, c_ref, c_tar)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), np.asarray(w))
    img = rng.random((30, 40), dtype=np.float32)
    np.testing.assert_array_equal(
        n(tops.red_diagnostic(t(img), got.consistent)),
        np.asarray(jops.red_diagnostic(jnp.asarray(img), want.consistent)))


@pytest.mark.parametrize("shape", [(17, 23), (18, 24, 3), (5, 4)])
def test_median3x3_bit_equal(shape):
    x = np.random.default_rng(10).random(shape, dtype=np.float32)
    x = np.round(x * 8) / np.float32(8)               # many equal neighbours
    np.testing.assert_array_equal(n(tops.median3x3(t(x))),
                                  np.asarray(jops.median3x3(jnp.asarray(x))))
    np.testing.assert_array_equal(
        n(tops.median_dispatch_truncate(t(x))),
        np.asarray(jops.median_dispatch_truncate(jnp.asarray(x))))


def test_refine_view_on_jax_weights():
    """Injected JAX weights: bit-equal to eager JAX, and to jitted JAX up to
    its FMA-contracted sums (rtol 1e-5)."""
    rng = np.random.default_rng(11)
    left, _ = unorm8_pair(rng, 36, 48)
    R = 4
    wv, wh = (np.asarray(w) for w in jops.refinement_weights(
        jnp.asarray(left), R, 10.94, 118.78))
    d_est = (rng.integers(0, 61, (36, 48)) * np.float32(60 / 255.)).astype(
        np.float32)
    conf = rng.random((36, 48), dtype=np.float32)
    conf[rng.random((36, 48)) < 0.2] = 0.0
    got = tops.refine_view(t(wv), t(wh), t(d_est), t(conf), R)
    args = (jnp.asarray(wv), jnp.asarray(wh), jnp.asarray(d_est),
            jnp.asarray(conf))
    eager = jops.refine_view(*args, R)
    jitted = jax.jit(jops.refine_view, static_argnums=4)(*args, R)
    for g, e, j in zip(got, eager, jitted):
        np.testing.assert_array_equal(n(g), np.asarray(e))
        np.testing.assert_allclose(n(g), np.asarray(j), rtol=1e-5, atol=0)


@pytest.mark.parametrize("penalty", [False, True])
def test_epipolar_target_scan_matches_jax(penalty):
    rng = np.random.default_rng(12)
    D, H, W = 9, 10, 21
    cost = rng.integers(0, 40, (D, H, W)).astype(np.float32)   # many ties
    cost[:, :2, :3] = 2e5
    d1 = rng.integers(0, D, (H, W)).astype(np.int32)
    sc = ct = None
    if penalty:
        # dyadic scale, integer centre: every penalty product is exact, so
        # an FMA and two roundings agree and the comparison can be exact
        sc = (rng.integers(0, 64, (H, W)) / np.float32(64)).astype(np.float32)
        ct = rng.integers(0, D, (H, W)).astype(np.float32)
    want = jops.epipolar_target_scan(
        jnp.asarray(cost), jnp.asarray(d1),
        None if sc is None else jnp.asarray(sc),
        None if ct is None else jnp.asarray(ct))
    got = tops.epipolar_target_scan(t(cost), t(d1),
                                    None if sc is None else t(sc),
                                    None if ct is None else t(ct))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), np.asarray(w))
