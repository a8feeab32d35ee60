"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds, the files each entry names, and which cells report what."""

import json
import re

import pytest

from benchmark import harness
from benchmark.tests.support import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
M = json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (REPO / p).is_dir()
    assert 1 <= len(M["command"]) <= 32
    for word in M["command"]:
        assert TEXT.match(word) and not word.startswith("/") and ".." not in word
    assert M["command"][1].startswith(tuple(p + "/" for p in M["paths"]))


def test_names_and_units():
    names = [e["name"] for group in ("configs", "workloads", "end_to_end",
                                     "per_layer") for e in M[group]]
    metrics = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in M[group]}) == len(M[group])
    for n in names:
        assert NAME.match(n), n
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "_roofline" in m["name"]:
            assert m["unit"] == "%"


def test_configs():
    files = set()
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in M["paths"]))
        assert (REPO / c["file"]).is_file() and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in M["workloads"])
        body = json.loads((REPO / c["file"]).read_text())
        for key in ("entry", "config_class", "release", "map", "reference",
                    "precision", "check", "params"):
            assert key in body, (c["name"], key)
        assert (REPO / "benchmark" / "reference"
                / f"{body['reference']}.py").is_file()


def test_workloads():
    pairs = set()
    configs = {c["name"] for c in M["configs"]}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads((REPO / "benchmark" / "traffic"
                              / f"{w['traffic']}.json").read_text())
        for key in ("scene", "sizes", "d_max", "pairs_per_size",
                    "check_frames"):
            assert key in traffic, (w["traffic"], key)
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(
        1, len(M["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"] for m in M["end_to_end"]}
    cells = {w["name"] for w in M["workloads"]}
    assert "setup_s" in e2e
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"]) and m["moves"] in e2e
    for m in M["end_to_end"] + M["per_layer"]:
        assert callable(harness.load_reader(REPO, m["name"]))


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_each_cell_reports_what_it_must(cell):
    e2e = [m["name"] for m in harness.reported_metrics(M, cell, False)]
    layer = harness.reported_metrics(M, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])


def test_layers_are_named_alike():
    """Metrics of one layer give it letter for letter."""
    layers = {m["layer"] for m in M["per_layer"]}
    assert len({x.lower() for x in layers}) == len(layers)
