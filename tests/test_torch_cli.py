"""The port's CLI on the CPU (asked for with --device cpu): `run`,
`bench`, `eval` and `synth`, their refusal to fall back to the CPU without
a card, and chip_smoke.py's refusal to report a result without a card."""

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
from stereo_matchin_tpu_torch.bench import ASW_COLUMNS, CROSS_COLUMNS
from stereo_matchin_tpu_torch.eval import bad_pixel_pct
from stereo_matchin_tpu_torch.io import png
from stereo_matchin_tpu_torch.io.groundtruth import read_groundtruth, write_pfm
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


def _reference_root(tmp_path, monkeypatch, names=("tsukuba",)):
    """A reference root holding the synthetic pair under registered names."""
    root = tmp_path / "reference"
    for name, files in (("tsukuba", ("im1.png", "im5.png")),
                        ("teddy", ("im2.png", "im6.png"))):
        if name in names:
            (root / name).mkdir(parents=True)
            for src, dst in zip(("l.png", "r.png"), files):
                shutil.copy(tmp_path / "synthpair" / src, root / name / dst)
    monkeypatch.setenv("STEREO_REFERENCE_ROOT", str(root))
    return root


def test_bench_writes_one_tsv(tmp_path, pics, capsys):
    """bench over --pics: one TSV named after the device, both methods'
    columns and totals, one row per run."""
    out = tmp_path / "bench"
    assert main(["bench", "--pics", str(pics), "--runs", "2", "--out",
                 str(out), "--arm_len", "3"] + SMALL) == 0
    tsvs = list(out.glob("*.tsv"))
    assert [p.name for p in tsvs] == ["cpu.tsv"]
    body = tsvs[0].read_text()
    assert "cross method total" in body and "total WTA method" in body
    assert "cpu - synthpair" in body
    assert "Run 1" in body and "Run 2" in body and "Run 3" not in body
    header = next(ln for ln in body.split("\n") if ln.startswith("id\t"))
    assert header == "\t".join(["id"] + CROSS_COLUMNS + ["", ""] + ASW_COLUMNS)
    assert f"per-stage report: {tsvs[0]}" in capsys.readouterr().out


def test_eval_scores_against_ground_truth(tmp_path, pics, monkeypatch,
                                         capsys):
    """eval --gt prints bad-pixel rates for the final maps of a pics.txt
    pair (no goldens: it is not registered); a bare --gt with two pairs
    returns 2."""
    gt = tmp_path / "gt.pfm"
    write_pfm(gt, np.full((40, 56), 2.0, np.float32))
    rc = main(["eval", "--pics", str(pics), "--gt", str(gt)] + SMALL)
    out = capsys.readouterr().out
    assert rc == 0
    assert "synthpair/asw_disparity vs GT: bad1=" in out
    assert "synthpair/cross_based_disparity vs GT: bad1=" in out
    assert "exact=" not in out
    _reference_root(tmp_path, monkeypatch, names=())
    rc = main(["eval", "--pairs", "tsukuba", "teddy", "--gt", str(gt)] + SMALL)
    assert rc == 2
    assert "exactly one" in capsys.readouterr().err


def test_synth_run_eval_loop(tmp_path, capsys):
    """synth -> run --pics -> eval --pics --gt: the quality loop with no
    data on disk, at the JAX CLI test's configuration."""
    out = tmp_path / "scene"
    assert main(["synth", "--out", str(out), "--width", "96", "--height",
                 "64", "--disp", "8", "--seed", "7"]) == 0
    gt, valid = read_groundtruth(out / "gt.pfm")
    assert gt.shape == (64, 96) and valid.any() and not valid.all()
    cfg = ["--d_max", "8", "--radius", "4", "--r_iters", "2", "--k_iters", "1",
           "--device", "cpu"]
    assert main(["run", "--pics", str(out / "pics.txt"), "--method", "asw",
                 "--out", str(out / "maps")] + cfg) == 0
    got = png.read_gray(str(next((out / "maps").rglob("asw_disparity.png"))))
    bad2 = bad_pixel_pct(got * 8, gt, threshold=2.0, mask=valid)
    assert bad2 < 10.0, bad2
    capsys.readouterr()
    assert main(["eval", "--pics", str(out / "pics.txt"), "--method", "asw",
                 "--gt", str(out / "gt.pfm")] + cfg) == 0
    line = next(ln for ln in capsys.readouterr().out.split("\n")
                if "asw_disparity vs GT" in ln)
    assert f"bad2={bad2:.2f}%" in line


def test_eval_goldens_under_the_reference_root(tmp_path, pics, monkeypatch,
                                              capsys):
    """eval --pairs compares each map with the golden stored under
    STEREO_REFERENCE_ROOT: 0 where they agree, 1 where a map's bad2 passes
    1%; without the variable it exits with an error naming it."""
    args = ["eval", "--pairs", "tsukuba"] + SMALL
    monkeypatch.delenv("STEREO_REFERENCE_ROOT", raising=False)
    with pytest.raises(SystemExit, match="STEREO_REFERENCE_ROOT"):
        main(args)
    root = _reference_root(tmp_path, monkeypatch)
    out = tmp_path / "maps"
    assert main(["run", "--pairs", "tsukuba", "--out", str(out)] + SMALL) == 0
    for name in ("asw_disparity.png", "cross_based_initial.png",
                 "cross_based_disparity.png"):
        shutil.copy(out / "tsukuba" / name, root / "tsukuba" / name)
    capsys.readouterr()
    assert main(args) == 0
    text = capsys.readouterr().out
    assert text.count("exact=100.00% bad1=0.00% bad2=0.00%") == 3, text
    png.write_gray(str(root / "tsukuba" / "asw_disparity.png"),
                   np.zeros((40, 56), np.float32))
    assert main(args) == 1
    assert main(args[:3] + ["--method", "cross"] + SMALL) == 0


@pytest.mark.parametrize("cmd", ["bench", "eval"])
def test_bench_and_eval_without_a_card_fail_unless_the_cpu_is_asked_for(
        cmd, tmp_path, pics, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    args = [cmd, "--pics", str(pics)] + SMALL[:-2]
    if cmd == "bench":
        args += ["--runs", "1", "--out", str(out)]
    with pytest.raises(SystemExit, match="--device cpu"):
        main(args)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(args + ["--device", "cuda:0"])
    assert not out.exists()
    assert main(args + ["--device", "cpu"]) == 0


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
