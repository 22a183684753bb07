"""Each cell of BENCHMARK.json end to end on the CPU at a tiny size (the
kernels' plain versions), its result line, a cell added from new files
alone, and a run with each fault the cell can have planted in the timed
path, which the check has to find."""

from __future__ import annotations

import json

import pytest

from benchmark import harness, readings, run

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
REQUIRED = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_and_is_correct(tiny_root, workload, trace):
    cell = harness.load_cell(workload, tiny_root)
    out, line = run.run_cell(cell, 2 ** 31 + 17, 0.5, bool(trace), "cpu")
    assert set(REQUIRED) <= set(line) and list(line)[-1] == "checks"
    assert set(line) - set(REQUIRED) <= {"breakdown", "checks"}
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu" and line["device"]["count"] == 1
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        names = {m["name"] for m in harness.per_layer(cell)}
        assert set(line["metrics"]) <= names and line["metrics"]
    else:
        names = {m["name"] for m in harness.end_to_end(cell)}
        assert set(line["metrics"]) == names
        assert all(m["value"] > 0 for k, m in line["metrics"].items() if k != "peak_mem_gib")
    json.dumps(line)


def test_a_cell_from_new_files_alone(tiny_root, tmp_path):
    """A new configuration, traffic mix, limits and per-layer metric are
    files of their own, found by the names in BENCHMARK.json."""
    import shutil

    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark/configs/mipnerf360_outdoor_4.json").read_text())
    cfg["name"] = "dummy_scene"
    cfg["scene"]["gaussians"] = 1500
    (root / "benchmark/configs/dummy_scene.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "benchmark/traffic/train_late.json").read_text())
    tr["warmup_steps"] = 1
    (root / "benchmark/traffic/train_short.json").write_text(json.dumps(tr))
    (root / "benchmark/limits/dummy_scene.train_short.json").write_text(
        (root / "benchmark/limits/mipnerf360_outdoor_4.train_late.json").read_text())
    (root / "benchmark/metrics/steps_traced.train.py").write_text(
        "def read(trace, cell):\n    return trace.steps\n")
    spec["configs"].append({"name": "dummy_scene", "source": "test", "why": "test",
                            "file": "benchmark/configs/dummy_scene.json", "reduced": []})
    spec["workloads"].append({"name": "dummy_scene.train_short", "config": "dummy_scene",
                              "traffic": "train_short", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "steps_traced.train", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "step",
                              "moves": "train_steps_per_s",
                              "workloads": ["dummy_scene.train_short"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and "mipnerf360_outdoor_4.train_late" in m["workloads"]:
            m["workloads"].append("dummy_scene.train_short")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("dummy_scene.train_short", root)
    _, line = run.run_cell(cell, 5, 0.3, True, "cpu")
    assert line["correct"], line["checks"]
    assert line["metrics"]["steps_traced.train"]["value"] == tr["trace_steps"]


@pytest.mark.parametrize("workload,name", [
    ("mipnerf360_outdoor_4.train_late", "unchanged"),
    ("mipnerf360_outdoor_4.train_late", "half_batch"),
    ("mipnerf360_outdoor_4.serve_4viewers", "altered"),
])
def test_a_fault_in_the_timed_path_fails_the_check(tiny_root, workload, name):
    cell = harness.load_cell(workload, tiny_root)
    with readings.fault(name):
        _, line = run.run_cell(cell, 99, 0.3, False, "cpu")
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_limits_and_the_program_meets_them(tiny_root, workload):
    """The reference in bfloat16 in the program's place fails a limit of the
    cell; the program meets every one."""
    cell = harness.load_cell(workload, tiny_root)
    read = readings.train_readings if cell.kind == "train" else readings.serve_readings
    got = read(cell, 3, "cpu", ())
    assert all(v <= cell.limits[k] for k, v in got["program"].items()), got["program"]
    assert any(v > cell.limits[k] for k, v in got["control"].items()), got["control"]


@pytest.mark.cuda
def test_a_cell_on_the_card(tiny_root, cuda_device):
    cell = harness.load_cell("mipnerf360_outdoor_4.train_late", tiny_root)
    _, line = run.run_cell(cell, 7, 0.5, True, cuda_device)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0


def test_a_traffic_kind_is_a_loop_module_found_by_name(tiny_root, monkeypatch, tmp_path):
    """A mix of a new kind runs ``benchmark/<kind>_loop.py``'s ``run``: a
    new kind is a new file, and run.py is not edited."""
    import shutil
    import sys
    import types

    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    (root / "benchmark/traffic/idle.json").write_text(json.dumps({"kind": "idle"}))
    (root / "benchmark/limits/mipnerf360_outdoor_4.idle.json").write_text("{}")
    spec["workloads"].append({"name": "mipnerf360_outdoor_4.idle",
                              "config": "mipnerf360_outdoor_4", "traffic": "idle", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    loop = types.ModuleType("benchmark.idle_loop")
    loop.run = lambda cell, seed, seconds, trace_on, device: harness.Outcome(
        metrics={m["name"]: 1.0 for m in harness.end_to_end(cell)}, checks=[("gap", 0.0, 0.0)],
        attempted=1, failed=0, memory_peak_bytes=0)
    monkeypatch.setitem(sys.modules, "benchmark.idle_loop", loop)
    cell = harness.load_cell("mipnerf360_outdoor_4.idle", root)
    _, line = run.run_cell(cell, 1, 0.1, False, "cpu")
    assert line["correct"] and line["attempted"] == 1


def test_k1_bound_reads_only_the_records_a_tile_replays():
    """K1 stops reading a tile's records once its pixels stop: its bytes
    follow the replayed records, not the pairs, so a deep scene's share of
    the bound cannot pass 100% through pairs that are never read."""
    from benchmark import counts
    from benchmark.reference import TileWork

    cfg = {"tile": 16, "image_width": 1237, "image_height": 822}
    shallow = TileWork(pairs=2 * 10 ** 6, pixel_records=10 ** 6, replayed=2 * 10 ** 6)
    deep = shallow._replace(pairs=64 * 10 ** 6)
    assert counts.k1_bound_s(cfg, deep) == counts.k1_bound_s(cfg, shallow)
    more = shallow._replace(replayed=64 * 10 ** 6)
    assert counts.k1_bound_s(cfg, more) > counts.k1_bound_s(cfg, shallow)
