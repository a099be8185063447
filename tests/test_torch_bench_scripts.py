"""bench_decomp_torch.py and bench_population_torch.py, the port's twins of
bench_decomp.py and bench_population.py: each prints its JAX twin's labels
in the same order and format, and a JSON line with every rate; each refuses
to run without a card unless asked for the CPU. Rehearsed here on the CPU at
a toy size (their rates are CPU times, checked only to be positive)."""

import json
import re
from pathlib import Path

import pytest
import torch

import bench_decomp_torch
import bench_population_torch

ROOT = Path(__file__).resolve().parents[1]
RATE = re.compile(r"^(.*): +(\d+\.\d\d)M env steps/s$")


def _labels(out: str) -> list:
    """The printed labels, in order: rate lines and the lines without a twin."""
    labels = []
    for line in out.splitlines():
        m = RATE.match(line)
        if m:
            labels.append(m.group(1))
        elif ": no twin" in line:
            labels.append(line.split(": no twin")[0])
    return labels


def test_bench_decomp_torch_prints_the_jax_labels(capsys):
    assert bench_decomp_torch.main(["--cpu", "--n-envs", "8", "--chunks", "1", "--chunk-len", "3",
                                    "--driver-chunks", "2"]) == 0
    out = capsys.readouterr().out
    labels = _labels(out)
    jax_src = (ROOT / "bench_decomp.py").read_text()
    # every label, padding included, as the JAX script writes it, and in its order
    positions = [jax_src.index(f'"{label}') for label in labels]
    assert positions == sorted(positions) and len(labels) == 11
    line = json.loads(out.strip().splitlines()[-1])
    assert line["device"] == "cpu" and line["n_envs"] == 8
    assert set(line["env_steps_per_s"]) == {lb.strip() for lb in labels
                                           if lb not in bench_decomp_torch.FLAT_LAYOUTS}
    assert all(r > 0 for r in line["env_steps_per_s"].values())


def test_bench_population_torch_prints_the_jax_labels(capsys):
    assert bench_population_torch.main(["--cpu", "--scale", "128", "--chunks", "1",
                                        "--chunk-len", "2"]) == 0
    out = capsys.readouterr().out
    jax_src = (ROOT / "bench_population.py").read_text()
    labels = [re.sub(r"P=\d+( +)$", r"P={P}\1", re.sub(r"^B=\d+", "B={B}", lb))
              for lb in _labels(out)]
    assert all(lb in jax_src for lb in labels[:-1])  # the f-strings' text
    assert labels[-1].replace("B={B}", "B=2048") in jax_src  # the traced rates' line
    assert len(labels) == 2 + 4 + 1 and "study speedup over 8 serial runs" in out
    line = json.loads(out.strip().splitlines()[-1])
    assert line["scale"] == 128 and line["device"] == "cpu"
    assert set(line["study_speedup"]) == {"B=2 P=8", "B=16 P=2", "B=16 P=4", "B=16 P=8"}
    assert all(r > 0 for r in line["env_steps_per_s"].values())


@pytest.mark.parametrize("script", [bench_decomp_torch, bench_population_torch])
def test_bench_scripts_need_a_card(script, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert script.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
