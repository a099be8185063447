"""Sizes at which the CPU tests run a cell: every width of the
configuration as it stands, fewer envs, shorter chunks and episodes, and
for the fluid a 32 x 32 grid (the plain versions of K1 and K2 run on the
CPU)."""

from __future__ import annotations

import time

from benchmark import harness

SEED = 2 ** 31 + 77  # larger than 32 signed bits hold, as the driver's seeds are

WORKLOAD = {
    "train_ks": {"n_envs": 4, "learner_batch": 16, "chunk_len": 5, "trace_length": 2},
    "train_fluid": {"chunk_len": 3, "trace_length": 1},
    "control_ks": {"episode_steps": 30, "sample_stride": 7, "start_steps": 5, "trace_length": 20},
}
CONFIG = {"train_fluid": {"nx": 32}}


def cell_names(root=harness.ROOT) -> list[str]:
    return [w["name"] for w in harness.load_json(root / "BENCHMARK.json")["workloads"]]


def tiny_cell(name: str, root=harness.ROOT) -> harness.Cell:
    driver = harness.find_cell(name, root=root).workload["driver"]
    over = dict(WORKLOAD[driver])
    if driver == "train_fluid":
        n = harness.find_cell(name, root=root).workload["n_envs"]
        over["n_envs"] = min(n, 2)
    return harness.find_cell(name, root=root, overrides=over, config_overrides=CONFIG.get(driver))


def dry_run(name: str, trace: bool = False, seed: int = SEED, root=harness.ROOT) -> dict:
    """One run of the cell on the CPU at the tiny sizes: the harness's
    whole run but its look for a card."""
    cell = tiny_cell(name, root)
    return harness.run_cell(harness.Ctx(cell=cell, seed=seed, seconds=0.5, trace=trace,
                                        device="cpu", t_start=time.perf_counter()))
