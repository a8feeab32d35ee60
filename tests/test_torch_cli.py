"""The port's `run` CLI on the CPU, and chip_smoke.py's refusal to report
a result without a card."""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from stereo_matchin_tpu import TINY_CONFIG
from stereo_matchin_tpu.eval import synthetic_scene
from stereo_matchin_tpu.io import png
from stereo_matchin_tpu_torch import ops as tops
from stereo_matchin_tpu_torch.__main__ import main
from stereo_matchin_tpu_torch.models import asw

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
    assert main(["run", "--pics", str(pics), "--out", str(out)] + SMALL) == 0
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


def test_run_refuses_the_unported_cross_method(tmp_path, pics):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(["run", "--pics", str(pics), "--out", str(tmp_path),
              "--method", "cross"] + SMALL)


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
