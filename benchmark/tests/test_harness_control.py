"""The control comes out not correct: the reference put in the program's
place with its matrix products in TF32 (the precision below the float32
that both configurations state) fails at least one of the cell's limits, on
three seeds. On the CPU at the tiny sizes (TF32's rounding is emulated, so
it runs anywhere); on the card at the cell's own size under the `gpu`
marker."""

import time

import pytest
import torch

from benchmark import calibrate, harness
from benchmark.tests.tiny import SEED, cell_names, tiny_cell

SEEDS = (SEED, SEED + 1, SEED + 2)


def _control_fails(cell, device, seconds):
    driver = harness.load_module(cell.root / "benchmark" / "drivers" / f"{cell.workload['driver']}.py")
    limits = cell.workload["limits"]
    for seed in SEEDS:
        ctx = harness.Ctx(cell=cell, seed=seed, seconds=seconds, trace=False, device=device,
                          t_start=time.perf_counter())
        readings = (calibrate.control_readings if cell.workload["driver"].startswith("control")
                    else calibrate.train_readings)(driver, ctx)
        assert all(readings["program"][k] <= v for k, v in limits.items()), readings["program"]
        assert any(readings["control"][k] > v for k, v in limits.items()), readings["control"]
        if "half_batch" in readings:
            assert any(readings["half_batch"][k] > v for k, v in limits.items())


@pytest.mark.parametrize("name", cell_names())
def test_control_fails_on_the_cpu(name):
    _control_fails(tiny_cell(name), "cpu", 0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("name", cell_names())
def test_control_fails_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _control_fails(harness.find_cell(name), "cuda", 10.0)
