"""The control: the plain reference in bfloat16 put in the program's place
comes out as not correct at the cells' traffic cut to CPU sizes (on the
card at the cells' own sizes: `benchmark/control.py`, PERF.md)."""

import pytest
import torch

from benchmark import control, harness
from benchmark.tests.support import SEED, small_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("bench"), d_max=31)


@pytest.mark.parametrize("cell", ["asw-ref.kitti", "cross-ref.mb2014f"])
def test_bfloat16_control_fails(root, cell):
    c = harness.load_cell(cell, root=root)
    for _, checks, _ in control.control(c, SEED, torch.bfloat16,
                                        torch.device("cpu")):
        assert any(n > lim for n, lim in checks.values()), checks


def test_float32_in_the_program_place_passes(root):
    c = harness.load_cell("asw-ref.kitti", root=root)
    for _, checks, _ in control.control(c, SEED, torch.float32,
                                        torch.device("cpu")):
        assert all(n == 0 for n, _ in checks.values()), checks
