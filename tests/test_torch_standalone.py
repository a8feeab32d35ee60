"""The port's own copies of the JAX package's JAX-free modules (config,
PNG I/O, the pair registry and pics.txt, synthetic scenes, ground-truth
readers, quality metrics) against the originals: the port imports nothing
of the JAX package, so these tests hold the copies equal."""

from __future__ import annotations

import dataclasses
import os
import pathlib

import numpy as np
import pytest

from stereo_matchin_tpu import config as jconfig
from stereo_matchin_tpu.eval import metrics as jmetrics
from stereo_matchin_tpu.eval import synthetic_scene as jax_scene
from stereo_matchin_tpu.io import datasets as jdatasets
from stereo_matchin_tpu.io import groundtruth as jgt
from stereo_matchin_tpu.io import png as jpng
from stereo_matchin_tpu_torch import config as tconfig
from stereo_matchin_tpu_torch.eval import metrics as tmetrics
from stereo_matchin_tpu_torch.eval import synthetic_scene as port_scene
from stereo_matchin_tpu_torch.io import datasets as tdatasets
from stereo_matchin_tpu_torch.io import groundtruth as tgt
from stereo_matchin_tpu_torch.io import png as tpng

from .torch_support import config_pair

_DERIVED = ("num_disp", "window")
_BAD = [dict(d_max=0), dict(radius=0), dict(arm_len=1), dict(aggr_d_chunks=-1),
        dict(d_max=3, aggr_d_chunks=5), dict(aggr_kernels="tiles")]


def _config_equal(jcfg, cfg):
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for prop in _DERIVED:
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert dataclasses.asdict(cfg.replace(d_max=9)) == dataclasses.asdict(
        jcfg.replace(d_max=9))


def _check_reference():
    _config_equal(jconfig.REFERENCE_CONFIG, tconfig.REFERENCE_CONFIG)


def _check_tiny():
    _config_equal(jconfig.TINY_CONFIG, tconfig.TINY_CONFIG)


def _check_config3():
    """BASELINE config 3: REFERENCE_CONFIG with d_max 279."""
    _config_equal(jconfig.REFERENCE_CONFIG.replace(d_max=279),
                  tconfig.REFERENCE_CONFIG.replace(d_max=279))
    _config_equal(*config_pair(d_max=279, aggr_d_chunks=4))


def _check_refusals():
    assert [f.name for f in dataclasses.fields(tconfig.StereoConfig)] == [
        f.name for f in dataclasses.fields(jconfig.StereoConfig)]
    for kw in _BAD:
        with pytest.raises(ValueError) as want:
            jconfig.StereoConfig(**kw)
        with pytest.raises(ValueError) as got:
            tconfig.StereoConfig(**kw)
        assert str(got.value) == str(want.value), kw


def _check_mesh_config():
    """MeshConfig: fields, defaults, device count and axis names, and the
    package's export, as the JAX package's."""
    assert [(f.name, f.default) for f in dataclasses.fields(
        tconfig.MeshConfig)] == [(f.name, f.default) for f in
                                 dataclasses.fields(jconfig.MeshConfig)]
    for kw in ({}, dict(batch=2, row=2, disp=2), dict(row=4), dict(disp=3)):
        jm, tm = jconfig.MeshConfig(**kw), tconfig.MeshConfig(**kw)
        assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
        assert tm.num_devices == jm.num_devices
        assert tm.axis_names() == jm.axis_names()
    import stereo_matchin_tpu_torch as port

    assert port.MeshConfig is tconfig.MeshConfig


def _check_registry(tmp_path):
    """The JAX registry's names and files; the port resolves them under
    STEREO_REFERENCE_ROOT only, and refuses a lookup without it."""
    assert list(tdatasets.REGISTRY) == list(jdatasets.REGISTRY)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv(tdatasets.ROOT_VARIABLE, raising=False)
        with pytest.raises(LookupError, match=tdatasets.ROOT_VARIABLE):
            tdatasets.REGISTRY["tsukuba"]
        root = tmp_path / "reference"
        mp.setenv(tdatasets.ROOT_VARIABLE, str(root))
        assert tdatasets.reference_root() == str(root)
        for name, pair in tdatasets.REGISTRY.items():
            want = jdatasets.REGISTRY[name]
            assert pair.name == want.name == name
            assert pair.golden_dir == str(root / name)
            assert os.path.basename(want.golden_dir) == name
            for f in ("left", "right"):
                got = pathlib.Path(getattr(pair, f))
                assert got.parent == root / name, (name, f)
                assert got.name == os.path.basename(getattr(want, f)), (name, f)


def _check_bench_pairs():
    """The pairs the reference benchmarks, in its order, each registered."""
    from stereo_matchin_tpu import io as jio
    from stereo_matchin_tpu_torch import io as tio

    assert tdatasets.BENCH_PAIRS == jdatasets.BENCH_PAIRS
    assert tio.BENCH_PAIRS == jio.BENCH_PAIRS
    assert all(name in tdatasets.REGISTRY for name in tdatasets.BENCH_PAIRS)


def _check_pics_txt(tmp_path):
    lines = ["tsukuba/im1.png", "tsukuba/im5.png", "../l.png", "../r.png",
             "a/b/art/view1.png", "a/b/art/view5.png", "l.png", "r.png",
             "odd.png"]
    path = tmp_path / "pics.txt"
    path.write_text("\n".join(lines) + "\n\n")
    assert tdatasets.parse_pics_txt(str(path)) == [
        tdatasets.StereoPair(*dataclasses.astuple(p))
        for p in jdatasets.parse_pics_txt(str(path))]
    for name in ("", ".", "..", "a/..", "x/y/", "tsukuba"):
        assert tdatasets.safe_pair_name(name) == jdatasets.safe_pair_name(name)


def _check_png(tmp_path):
    rng = np.random.default_rng(12)
    rgb = rng.integers(0, 256, (17, 23, 3), dtype=np.uint8)
    gray = rng.random((17, 23)).astype(np.float32)
    for writer in (jpng, tpng):
        rgb_path = tmp_path / f"{writer.__name__}_rgb.png"
        gray_path = tmp_path / f"{writer.__name__}_gray.png"
        writer.write_rgb(rgb_path, rgb)
        writer.write_gray(gray_path, gray)
        for path in (rgb_path, gray_path):
            want, got = jpng.read_rgb(path), tpng.read_rgb(path)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(tpng.read_gray(path),
                                          jpng.read_gray(path))
        np.testing.assert_array_equal(
            np.rint(tpng.read_rgb(rgb_path) * 255).astype(np.uint8), rgb)
    np.testing.assert_array_equal(tpng.read_rgb(tmp_path / "stereo_matchin_tpu"
                                                ".io.png_gray.png"),
                                  tpng.read_rgb(tmp_path / "stereo_matchin_tpu"
                                                "_torch.io.png_gray.png"))


def _check_scenes():
    for seed, (H, W, d_max) in zip((0, 5, 9), ((40, 56, 15), (31, 45, 7),
                                               (64, 96, 23))):
        want = jax_scene(np.random.default_rng(seed), H, W, d_max)
        got = port_scene(np.random.default_rng(seed), H, W, d_max)
        for g, w, name in zip(got, want, ("left", "right", "gt", "mask")):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=f"seed {seed} {name}")


def _same_readings(path, **kw):
    """The port's and the JAX reader give the same (values, mask)."""
    want, got = jgt.read_groundtruth(path, **kw), tgt.read_groundtruth(path, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    return got


def _check_pfm(tmp_path):
    """PFM round trip with an unknown mask, each side's writer read by both
    readers; the files themselves are equal."""
    rng = np.random.default_rng(21)
    disp = (rng.random((37, 53)) * 280).astype(np.float32)
    invalid = rng.random((37, 53)) < 0.1
    tgt.write_pfm(tmp_path / "port.pfm", disp, invalid_mask=invalid)
    jgt.write_pfm(tmp_path / "jax.pfm", disp, invalid_mask=invalid)
    assert (tmp_path / "port.pfm").read_bytes() == (
        tmp_path / "jax.pfm").read_bytes()
    got, valid = _same_readings(tmp_path / "port.pfm")
    np.testing.assert_array_equal(valid, ~invalid)
    np.testing.assert_array_equal(got[valid], disp[~invalid])
    assert (got[~valid] == 0).all()
    _same_readings(tmp_path / "port.pfm", scale=4.0)
    with pytest.raises(ValueError, match="expects an"):
        tgt.write_pfm(tmp_path / "bad.pfm", disp[None])


def _check_pfm_big_endian_colour(tmp_path):
    disp = np.arange(12, dtype=np.float32).reshape(3, 4)
    path = tmp_path / "be.pfm"
    with open(path, "wb") as f:
        f.write(b"PF\n# comment\n4 3\n2.0\n")   # big-endian, 3 channels
        rgb = np.stack([disp, disp * 0, disp * 0], axis=-1)
        f.write(rgb[::-1].astype(">f4").tobytes())
    got, valid = _same_readings(path)
    np.testing.assert_array_equal(got, disp * 2)
    assert valid.all()
    for bad in (b"P6\n4 3\n1.0\n", b"Pf\nfour 3\n1.0\n", b"Pf\n4 3\n-1.0\n"):
        path.write_bytes(bad)
        with pytest.raises(ValueError) as want:
            jgt.read_pfm(path)
        with pytest.raises(ValueError) as got:
            tgt.read_pfm(path)
        assert str(got.value) == str(want.value)


def _check_pgm(tmp_path):
    """PGM raw (8- and 16-bit) and ASCII, Middlebury 2001 convention."""
    stored = np.array([[0, 16, 32], [240, 160, 8]], np.uint8)
    p5 = tmp_path / "truedisp.pgm"
    p5.write_bytes(b"P5\n# comment\n3 2\n255\n" + stored.tobytes())
    disp, valid = _same_readings(p5)
    np.testing.assert_allclose(disp, stored / 16.0)
    np.testing.assert_array_equal(valid, stored > 0)
    wide = tmp_path / "wide.pgm"
    wide.write_bytes(b"P5\n3 2\n4095\n" +
                     (stored.astype(">u2") * 16).tobytes())
    _same_readings(wide)
    _same_readings(wide, scale=256.0)
    p2 = tmp_path / "ascii.pgm"
    p2.write_text("P2\n3 2\n255\n" + " ".join(str(v) for v in stored.ravel()))
    disp2, valid2 = _same_readings(p2)
    np.testing.assert_array_equal(disp2, disp)
    np.testing.assert_array_equal(valid2, valid)


def _check_gt_png_and_dispatch(tmp_path):
    """Middlebury 2003 PNG (disparity * 4), the scale override, and the
    dispatcher's refusal of an unknown extension."""
    disp = np.array([[0.0, 2.0], [15.0, 60.0]])
    tpng.write_gray(tmp_path / "disp2.png", disp * 4 / 255.0)
    got, valid = _same_readings(tmp_path / "disp2.png")
    np.testing.assert_allclose(got, disp, atol=1 / 8.0)
    np.testing.assert_array_equal(valid, disp > 0)
    np.testing.assert_array_equal(
        tgt.read_gt_png(tmp_path / "disp2.png", 8.0)[0],
        jgt.read_gt_png(tmp_path / "disp2.png", 8.0)[0])
    _same_readings(tmp_path / "disp2.png", scale=8.0)
    for mod in (jgt, tgt):
        with pytest.raises(ValueError, match="unrecognized"):
            mod.read_groundtruth(tmp_path / "disp2.bmp")


def _check_metrics():
    """compare_maps (with and without a mask), bad_pixel_pct and
    MapComparison's text, on the same seeded maps."""
    rng = np.random.default_rng(33)
    ref = rng.integers(0, 256, (30, 40)) / 255.0
    got = np.clip(ref + rng.integers(-3, 4, (30, 40)) / 255.0, 0, 1)
    mask = rng.random((30, 40)) < 0.7
    for kw in (dict(), dict(mask=mask), dict(d_max=1), dict(d_max=279)):
        want = jmetrics.compare_maps(got, ref, **kw)
        have = tmetrics.compare_maps(got, ref, **kw)
        assert tuple(vars(have).values()) == tuple(vars(want).values()), kw
        assert str(have) == str(want)
    d_got, d_gt = got * 60, ref * 60
    for thr in (0.5, 1.0, 2.0):
        for m in (None, mask):
            assert tmetrics.bad_pixel_pct(d_got, d_gt, thr, m) == \
                jmetrics.bad_pixel_pct(d_got, d_gt, thr, m)
    c = tmetrics.MapComparison(99.8125, 0.5, 0.125, 0.0625)
    assert str(c) == str(jmetrics.MapComparison(99.8125, 0.5, 0.125, 0.0625))
    assert str(c) == "exact=99.81% bad1=0.50% bad2=0.12% meanabs=0.062"


def _check_goldens(tmp_path):
    """Goldens and pairs by name resolve under STEREO_REFERENCE_ROOT only:
    golden_path names the artifact of the registered pair's directory,
    compare_to_golden reads it, load_pair reads the pair's files; without
    the variable each raises a LookupError that names it."""
    root = tmp_path / "reference"
    (root / "tsukuba").mkdir(parents=True)
    rng = np.random.default_rng(4)
    gold = rng.integers(0, 256, (6, 9)) / 255.0
    tpng.write_gray(root / "tsukuba" / "asw_disparity.png", gold)
    rgb = rng.integers(0, 256, (6, 9, 3), dtype=np.uint8)
    for f in ("im1.png", "im5.png"):
        tpng.write_rgb(root / "tsukuba" / f, rgb)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv(tdatasets.ROOT_VARIABLE, raising=False)
        for call in (lambda: tmetrics.golden_path("tsukuba", "a.png"),
                     lambda: tdatasets.load_pair("tsukuba")):
            with pytest.raises(LookupError, match=tdatasets.ROOT_VARIABLE):
                call()
        mp.setenv(tdatasets.ROOT_VARIABLE, str(root))
        assert tmetrics.golden_path("teddy", "asw_disparity.png") == str(
            root / "teddy" / "asw_disparity.png")
        with pytest.raises(KeyError):
            tmetrics.golden_path("nowhere", "asw_disparity.png")
        c = tmetrics.compare_to_golden(gold, "tsukuba", "asw_disparity.png")
        assert (c.exact_pct, c.bad2_pct) == (100.0, 0.0)
        assert tdatasets.get_pair("tsukuba") == tdatasets.REGISTRY["tsukuba"]
        for pair in ("tsukuba", tdatasets.get_pair("tsukuba")):
            left, right = tdatasets.load_pair(pair)
            np.testing.assert_array_equal(left, tpng.read_rgb(
                root / "tsukuba" / "im1.png"))
            np.testing.assert_array_equal(right, left)


CASES = {"config_reference": _check_reference, "config_tiny": _check_tiny,
         "config_3": _check_config3, "config_refusals": _check_refusals,
         "mesh_config": _check_mesh_config,
         "registry": _check_registry, "bench_pairs": _check_bench_pairs,
         "pics_txt": _check_pics_txt,
         "png_round_trip": _check_png, "synthetic_scene": _check_scenes,
         "pfm_round_trip": _check_pfm,
         "pfm_big_endian_colour": _check_pfm_big_endian_colour,
         "pgm_raw_ascii": _check_pgm,
         "gt_png_and_dispatch": _check_gt_png_and_dispatch,
         "metrics": _check_metrics, "goldens_and_pairs": _check_goldens}


@pytest.mark.parametrize("case", list(CASES))
def test_copy_equals_the_jax_original(case, tmp_path):
    fn = CASES[case]
    if fn.__code__.co_argcount:
        fn(tmp_path)
    else:
        fn()
