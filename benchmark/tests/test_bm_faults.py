"""A run on the CPU (the harness's look for a chip skipped), with the timed
path sound and then broken underneath, sees `correct` come out true and
then false: an answer altered where it is produced, half of the frame's
rows left out, a stale answer (the previous frame's)."""

import json

import pytest

from benchmark.tests import faults
from benchmark.tests.support import cpu_run, small_root

CELLS = {"asw": "asw-ref.kitti", "cross": "cross-ref.mb2014f"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("bench"))


def broken(root, method: str, how: str):
    """The cell's configuration with its entry replaced by a fault."""
    config = root / "benchmark" / "configs" / f"{method}-ref.json"
    body = json.loads(config.read_text())
    body["entry"] = f"benchmark.tests.faults:{method}_{how}"
    config.write_text(json.dumps(body))


@pytest.fixture()
def fresh_root(tmp_path):
    return small_root(tmp_path)


@pytest.mark.parametrize("method", sorted(CELLS))
def test_sound_run_is_correct(root, method):
    out = cpu_run(root, CELLS[method])
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert out["frames_checked"] >= 1 and out["attempted"] >= 2


@pytest.mark.parametrize("how", ["altered", "half", "stale"])
@pytest.mark.parametrize("method", sorted(CELLS))
def test_broken_run_is_not_correct(fresh_root, method, how):
    broken(fresh_root, method, how)
    out = cpu_run(fresh_root, CELLS[method])
    assert not out["correct"], out["checks"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
    assert callable(getattr(faults, f"{method}_{how}"))
