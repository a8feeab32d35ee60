"""The port's `run` CLI on the CPU (asked for with --device cpu), its
refusal to fall back to the CPU without a card, and chip_smoke.py's
refusal to report a result without a card."""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from stereo_matchin_tpu_torch import StereoConfig, TINY_CONFIG
from stereo_matchin_tpu_torch import ops as tops
from stereo_matchin_tpu_torch.eval import synthetic_scene
from stereo_matchin_tpu_torch.io import png
from stereo_matchin_tpu_torch.__main__ import main
from stereo_matchin_tpu_torch.models import asw, cross_based

REPO = pathlib.Path(__file__).resolve().parents[1]
OK_LINE = '"ok": true'
SMALL = ["--d_max", "15", "--radius", "3", "--r_iters", "1", "--k_iters", "1",
         "--device", "cpu"]


@pytest.fixture
def pics(tmp_path):
    left, right, _, _ = synthetic_scene(np.random.default_rng(9), 40, 56, 15)
    pair = tmp_path / "synthpair"
    pair.mkdir()
    png.write_rgb(pair / "l.png", left)
    png.write_rgb(pair / "r.png", right)
    path = tmp_path / "pics.txt"
    path.write_text(f"{pair / 'l.png'}\n{pair / 'r.png'}\n")
    return path


def test_run_writes_the_asw_artifacts(tmp_path, pics):
    out = tmp_path / "out"
    assert main(["run", "--pics", str(pics), "--out", str(out),
                 "--method", "asw"] + SMALL) == 0
    files = sorted(p.name for p in (out / "synthpair").iterdir())
    assert files == ["asw_consistency_post-reff.png",
                     "asw_consistency_pre-reff.png", "asw_disparity.png"]
    cfg = TINY_CONFIG.replace(radius=3, r_iters=1, k_iters=1)
    left = torch.from_numpy(png.read_rgb(str(tmp_path / "synthpair" / "l.png")))
    right = torch.from_numpy(png.read_rgb(str(tmp_path / "synthpair" / "r.png")))
    res = asw.asw_pipeline(left, right, cfg)
    got = png.read_gray(str(out / "synthpair" / "asw_disparity.png"))
    np.testing.assert_array_equal(np.rint(got * 255).astype(np.int32),
                                  tops.unorm8_code(res.disparity).numpy())
    pre = png.read_rgb(str(out / "synthpair" / "asw_consistency_pre-reff.png"))
    np.testing.assert_array_equal(pre, res.consistency_pre.numpy())


def test_run_writes_the_cross_artifacts(tmp_path, pics):
    out = tmp_path / "out"
    assert main(["run", "--pics", str(pics), "--out", str(out),
                 "--method", "cross", "--oii_impl", "taps"] + SMALL) == 0
    pair = out / "synthpair"
    assert sorted(p.name for p in pair.iterdir()) == [
        "cross_based_disparity.png", "cross_based_initial.png", "median.png"]
    cfg = StereoConfig(d_max=15, radius=3, r_iters=1, k_iters=1)
    left = torch.from_numpy(png.read_rgb(str(tmp_path / "synthpair" / "l.png")))
    right = torch.from_numpy(png.read_rgb(str(tmp_path / "synthpair" / "r.png")))
    res = cross_based.cross_pipeline(left, right, cfg)
    for name, img in (("cross_based_initial.png", res.initial),
                      ("cross_based_disparity.png", res.final)):
        got = png.read_gray(str(pair / name))
        np.testing.assert_array_equal(np.rint(got * 255).astype(np.int32),
                                      tops.unorm8_code(img).numpy(),
                                      err_msg=name)
    np.testing.assert_array_equal(png.read_rgb(str(pair / "median.png")),
                                  res.median_left.numpy())


def test_run_bands_writes_the_maps_of_the_whole_frame(tmp_path, pics, capsys):
    """--bands 3 runs the band drivers (the wavefront at --arm_len 3) and
    writes the disparity maps only, equal to the whole frame's; --bands 0
    picks one band on the CPU."""
    out = tmp_path / "out"
    args = ["run", "--pics", str(pics), "--oii_impl", "taps", "--arm_len",
            "3", "--aggr_d_chunks", "2"] + SMALL
    assert main(args + ["--out", str(out), "--bands", "3"]) == 0
    pair = out / "synthpair"
    assert sorted(p.name for p in pair.iterdir()) == [
        "asw_disparity.png", "cross_based_disparity.png",
        "cross_based_initial.png"]
    cfg = StereoConfig(d_max=15, radius=3, arm_len=3, r_iters=1, k_iters=1)
    left = torch.from_numpy(png.read_rgb(str(tmp_path / "synthpair" / "l.png")))
    right = torch.from_numpy(png.read_rgb(str(tmp_path / "synthpair" / "r.png")))
    cross = cross_based.cross_pipeline(left, right, cfg)
    for name, img in (("cross_based_initial.png", cross.initial),
                      ("cross_based_disparity.png", cross.final),
                      ("asw_disparity.png",
                       asw.asw_pipeline(left, right, cfg).disparity)):
        got = png.read_gray(str(pair / name))
        np.testing.assert_array_equal(np.rint(got * 255).astype(np.int32),
                                      tops.unorm8_code(img).numpy(),
                                      err_msg=name)
    assert main(args + ["--out", str(tmp_path / "auto"), "--bands", "0"]) == 0
    assert "auto bands -> 1" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="bands"):
        main(args + ["--out", str(out), "--bands", "-1"])


def test_run_without_a_card_fails_unless_the_cpu_is_asked_for(
        tmp_path, pics, monkeypatch):
    """No --device means the card: without one, `run` exits with an error
    and writes nothing; it never computes on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    args = ["run", "--pics", str(pics), "--out", str(out), "--method", "asw",
            "--d_max", "15", "--radius", "3", "--r_iters", "1", "--k_iters",
            "1"]
    with pytest.raises(SystemExit, match="--device cpu"):
        main(args)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(args + ["--device", "cuda:0"])
    assert not out.exists()
    assert main(args + ["--device", "cpu"]) == 0
    assert (out / "synthpair" / "asw_disparity.png").exists()


def test_run_pairs_resolve_under_the_reference_root(tmp_path, pics,
                                                   monkeypatch):
    """--pairs reads the registered pairs under STEREO_REFERENCE_ROOT;
    without it `run` exits with an error naming the variable."""
    out = tmp_path / "out"
    args = ["run", "--pairs", "tsukuba", "--out", str(out), "--method",
            "asw"] + SMALL
    monkeypatch.delenv("STEREO_REFERENCE_ROOT", raising=False)
    with pytest.raises(SystemExit, match="STEREO_REFERENCE_ROOT"):
        main(args)
    with pytest.raises(SystemExit, match="unknown pairs"):
        main(args[:2] + ["nowhere"] + args[3:])
    root = tmp_path / "reference"
    (root / "tsukuba").mkdir(parents=True)
    for src, dst in (("l.png", "im1.png"), ("r.png", "im5.png")):
        shutil.copy(tmp_path / "synthpair" / src, root / "tsukuba" / dst)
    monkeypatch.setenv("STEREO_REFERENCE_ROOT", str(root))
    assert main(args) == 0
    assert (out / "tsukuba" / "asw_disparity.png").exists()


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert OK_LINE not in proc.stdout
    assert "cuda" in (proc.stdout + proc.stderr).lower()


def test_chip_smoke_fails_without_the_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert OK_LINE not in proc.stdout
