"""A cell, a configuration and a per-layer metric are added by new files
and new entries alone: in a copy of BENCHMARK.json and the benchmark's
folder, a new configuration file, a new cell's workload file and a new
metric's reader run through the harness with no existing file edited."""

import json
import shutil

import pytest

from benchmark import harness
from benchmark.tests.tiny import dry_run


def test_new_cell_config_and_metric_by_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}

    config = json.loads((root / "benchmark/configs/KS22.json").read_text())
    config["nx"], config["sensor_step"] = 96, 12  # a coarser grid: a new configuration
    (root / "benchmark/configs/KS22_96.json").write_text(json.dumps(config))
    wl = json.loads((root / "benchmark/workloads/ks22-train-b16384.json").read_text())
    wl["n_envs"] = 512
    (root / "benchmark/workloads/ks22_96-train-b512.json").write_text(json.dumps(wl))
    (root / "benchmark/metrics/traced_steps.train.py").write_text(
        "def read(view):\n    return float(view['steps'])\n")

    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "KS22_96", "source": "test", "why": "test",
                             "file": "benchmark/configs/KS22_96.json", "reduced": ["nx"]})
    bench["workloads"].append({"name": "ks22_96-train-b512", "config": "KS22_96",
                               "traffic": "train-b512", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_env_steps_per_s":
            m["workloads"].append("ks22_96-train-b512")
    bench["per_layer"].append({"name": "traced_steps.train", "unit": "steps", "better": "higher",
                               "source": "device_trace", "layer": "test",
                               "moves": "train_env_steps_per_s",
                               "workloads": ["ks22_96-train-b512"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    res = dry_run("ks22_96-train-b512", root=root)
    assert res["correct"] and res["metrics"]["train_env_steps_per_s"]["value"] > 0
    traced = dry_run("ks22_96-train-b512", trace=True, root=root)
    assert traced["metrics"]["traced_steps.train"]["value"] == 2 * 5
    after = {p: p.read_bytes() for p in before}
    assert after == before


@pytest.mark.parametrize("name,config", [("ks22-train-b16384", "KS22"),
                                         ("fluid16_256-train-b1", "Fluid_16_256")])
def test_defined_cells_come_back_by_entries_alone(tmp_path, name, config):
    """The two train cells whose workload files are kept out of
    BENCHMARK.json (their host-bound runs spread too widely for a bound,
    PERF.md) run from an entry alone."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    assert name not in [w["name"] for w in bench["workloads"]]
    bench["workloads"].append({"name": name, "config": config, "traffic": name.split("-", 1)[1],
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_env_steps_per_s":
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = dry_run(name, root=root)
    assert res["correct"], res["checks"]
    assert res["metrics"]["train_env_steps_per_s"]["value"] > 0
