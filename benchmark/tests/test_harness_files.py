"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration and per-layer metric found by name from its files."""

import dataclasses
import json
import re

import pytest

from benchmark import harness
from benchmark.tests.tiny import cell_names

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    cells = len(BENCH["workloads"])
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, cells // 4)


def test_entries_have_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [c["why"] for c in BENCH["configs"] + BENCH["workloads"]] + \
            [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_cell_reports_setup_a_rate_and_a_layer():
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for name in cell_names():
        cell = harness.find_cell(name)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and cell.workload["rate_metric"] in reported
        assert len(reported) >= 2 and cell.per_layer
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert harness.reports(e2e[m["moves"]], cell), (m["name"], cell)


@pytest.mark.parametrize("name", cell_names())
def test_cell_found_by_name(name):
    cell = harness.find_cell(name)
    driver = harness.load_module(harness.ROOT / "benchmark" / "drivers" / f"{cell.workload['driver']}.py")
    for fn in ("setup", "window", "shape", "kernel_names", "check"):
        assert callable(getattr(driver, fn))
    assert set(cell.workload["limits"]) and all(v > 0 for v in cell.workload["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_found_by_name(metric):
    reader = harness.load_module(harness.ROOT / "benchmark" / "metrics" / f"{metric}.py")
    assert callable(reader.read)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_preset_as_run(config):
    """The file holds every field of the port's preset at its value: the
    configuration is not cut (`reduced` is empty)."""
    from distributedconvrl_pde_control_torch.configs.fluid import PRESETS as FLUID
    from distributedconvrl_pde_control_torch.configs.ks import PRESETS as KS

    path = harness.ROOT / config["file"]
    assert path.relative_to(harness.ROOT / "benchmark")
    data = json.loads(path.read_text())
    assert data["source"] == config["source"] and config["reduced"] == []
    preset = {**KS, **FLUID}[config["name"]]
    for f in dataclasses.fields(preset):
        assert data[f.name] == getattr(preset, f.name), f.name
    assert (harness.ROOT / data["reference"]).is_file()
