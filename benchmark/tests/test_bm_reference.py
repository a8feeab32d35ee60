"""The plain reference against the JAX package's maps committed under
tests/data (read as NumPy; nothing of JAX is imported) on the fixtures'
own 288x384 pair at REFERENCE_CONFIG."""

import json
import types

import numpy as np
import pytest
import torch

from benchmark.reference import asw, common, cross
from benchmark.tests.support import REPO

DATA = REPO / "tests" / "data"


def params(config: str, d_max: int = 60):
    body = json.loads((REPO / "benchmark" / "configs"
                       / f"{config}.json").read_text())
    return types.SimpleNamespace(**body["params"], d_max=d_max,
                                 aggr_d_chunks=0)


def load(name):
    with np.load(DATA / name) as f:
        return {k: f[k] for k in f.files}


def pair():
    f = load("asw_torch_fixture.npz")
    return tuple(torch.from_numpy((f[k] / np.float32(255.0))
                                  .astype(np.float32)) for k in ("left", "right"))


def codes(img):
    return common.unorm8_code(img).numpy().astype(np.uint8)


def red(img):
    r = img.numpy()
    return (r[..., 0] == 1.0) & (r[..., 1] == 0.0) & (r[..., 2] == 0.0)


def test_cross_reproduces_the_fixture():
    want = load("cross_torch_fixture.npz")
    got = cross.frame(*pair(), params("cross-ref"))
    for k in ("initial", "final", "median_left"):
        np.testing.assert_array_equal(codes(got[k]), want[k], err_msg=k)


@pytest.fixture(scope="module")
def asw_maps():
    return asw.frame(*pair(), params("asw-ref"))


def test_asw_reproduces_the_fixture(asw_maps):
    """On the CPU torch.exp and XLA's exp differ by a few ulp, so the
    weights and a few argmin ties do (tests/test_torch_pipeline_asw.py
    holds the port to 99.5% equal codes on its own weights); on the card
    the kernels' expf equals torch.exp and the check is exact."""
    want = load("asw_torch_fixture.npz")
    same = (codes(asw_maps["disparity"]) == want["disparity"]).mean()
    assert same >= 0.995
    for k, key in (("consistency_pre", "red_pre"),
                   ("consistency_post", "red_post")):
        assert (red(asw_maps[k]) == want[key]).mean() >= 0.995


def test_asw_maps_are_images(asw_maps):
    assert asw_maps["disparity"].shape == (288, 384)
    assert asw_maps["consistency_pre"].shape == (288, 384, 3)
    levels = torch.from_numpy(common._UNORM8_LEVELS)
    d = asw_maps["disparity"]
    assert torch.equal(levels[codes(d).astype(np.int64)], d)


def test_chunked_steps_equal_the_whole_volume(monkeypatch):
    """Chunks of planes and blocks of rows change no value."""
    left, right = (t[:48, :96] for t in pair())
    p = params("asw-ref", 23)
    whole = asw.frame(left, right, p)
    monkeypatch.setattr(asw, "PLANE_ELEMS", 5 * 48 * 96)
    monkeypatch.setattr(asw, "ROW_ELEMS", 24 * 7 * 96)
    parts = asw.frame(left, right, p)
    for k in whole:
        assert torch.equal(whole[k], parts[k]), k
    p = params("cross-ref", 23)
    whole = cross.frame(left, right, p)
    monkeypatch.setattr(cross, "PLANE_ELEMS", 5 * 48 * 96)
    parts = cross.frame(left, right, p)
    for k in whole:
        assert torch.equal(whole[k], parts[k]), k
