"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's);
the reference imports nothing of the program either."""

import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "stereo_matchin_tpu"}
PROGRAM = "stereo_matchin_tpu_torch"


def imported_top_levels(path: pathlib.Path) -> set:
    """Top-level names of every module `path` imports; a relative import
    stays inside the benchmark."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


MODULES = sorted(BENCH.rglob("*.py"))


def test_the_benchmark_has_modules():
    assert len(MODULES) > 20


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not imported_top_levels(path) & JAX_SIDE


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported_top_levels(path)
    assert PROGRAM not in names
    assert names <= {"__future__", "functools", "numpy", "torch"}


def test_whole_name_compare(tmp_path):
    """The port's own name is not the JAX package's."""
    probe = tmp_path / "probe.py"
    probe.write_text("import stereo_matchin_tpu_torch.models\n"
                     "from stereo_matchin_tpu_torch import ops\n")
    assert imported_top_levels(probe) == {PROGRAM}
    probe.write_text("import stereo_matchin_tpu.models\n")
    assert imported_top_levels(probe) & JAX_SIDE == {"stereo_matchin_tpu"}


def test_run_refuses_a_process_that_holds_jax():
    from benchmark import harness

    assert harness.forbidden_modules(
        ["stereo_matchin_tpu_torch", "stereo_matchin_tpu_torch.ops",
         "torch", "jaxtyping"]) == []
    assert harness.forbidden_modules(
        ["stereo_matchin_tpu_torch", "stereo_matchin_tpu.models",
         "jax.numpy", "flax"]) == ["flax", "jax", "stereo_matchin_tpu"]
