"""The port's own copies of the JAX package's JAX-free modules (config,
PNG I/O, the pair registry and pics.txt, synthetic scenes) against the
originals: the port imports nothing of the JAX package, so these tests
hold the copies equal."""

from __future__ import annotations

import dataclasses
import os
import pathlib

import numpy as np
import pytest

from stereo_matchin_tpu import config as jconfig
from stereo_matchin_tpu.eval import synthetic_scene as jax_scene
from stereo_matchin_tpu.io import datasets as jdatasets
from stereo_matchin_tpu.io import png as jpng
from stereo_matchin_tpu_torch import config as tconfig
from stereo_matchin_tpu_torch.eval import synthetic_scene as port_scene
from stereo_matchin_tpu_torch.io import datasets as tdatasets
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


CASES = {"config_reference": _check_reference, "config_tiny": _check_tiny,
         "config_3": _check_config3, "config_refusals": _check_refusals,
         "registry": _check_registry, "pics_txt": _check_pics_txt,
         "png_round_trip": _check_png, "synthetic_scene": _check_scenes}


@pytest.mark.parametrize("case", list(CASES))
def test_copy_equals_the_jax_original(case, tmp_path):
    fn = CASES[case]
    if fn.__code__.co_argcount:
        fn(tmp_path)
    else:
        fn()
