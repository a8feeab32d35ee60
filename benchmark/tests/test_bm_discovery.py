"""A configuration, a traffic mix, a cell and a metric added as files and
BENCHMARK.json entries in a copy of the benchmark run without an edit to
any of its code."""

import json

from benchmark import harness
from benchmark.tests.support import cpu_run, small_root

METRIC = '''"""frames_per_s (1/s): frames completed over the window."""


def read(run):
    return len(run.frames) / run.window_s
'''


def test_added_files_are_found(tmp_path):
    root = small_root(tmp_path)
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "asw-ref.json").read_text())
    cfg["params"].update(radius=3, r_iters=2, k_iters=1)
    cfg["map"] = "filled"
    (bench / "configs" / "asw-small.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "kitti.json").read_text())
    traffic.update(sizes=[[24, 40], [20, 36]], d_max=7, pairs_per_size=3,
                   check_frames=2)
    (bench / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "frames_per_s.py").write_text(METRIC)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({
        "name": "asw-small", "source": "a test", "reduced": ["radius"],
        "file": "benchmark/configs/asw-small.json", "why": "a test"})
    manifest["workloads"].append({
        "name": "asw-small.tiny", "config": "asw-small", "traffic": "tiny",
        "chips": 1, "why": "a test"})
    manifest["end_to_end"].append({
        "name": "frames_per_s", "unit": "1/s", "better": "higher",
        "bound": 0.05, "source": "host_clock", "workloads": ["asw-small.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = harness.load_cell("asw-small.tiny", root=root)
    assert cell.config["params"]["radius"] == 3
    assert cell.traffic["sizes"] == [[24, 40], [20, 36]]
    out = cpu_run(root, "asw-small.tiny")
    assert out["correct"], out["checks"]
    # peak_reserved_gb reads nothing on the CPU.
    assert set(out["metrics"]) == {"throughput", "setup_s", "frames_per_s"}
    assert out["metrics"]["frames_per_s"]["unit"] == "1/s"
    assert out["frames_checked"] == 4       # two frames of each size
    # The other cells report nothing new.
    assert "frames_per_s" not in cpu_run(root, "asw-ref.kitti")["metrics"]
