"""The port's Keller-Segel training step against the benchmark's plain
reference, the solver's route counters and its capture span, on the CPU.

The chunk is the sharded trainer's at 1x1, the path of `run.py
KellerSegel10_16 --train --mesh 1x1`, at 4 envs and the configuration's own
widths (100 points, 50 RK4 substeps); the reference
(`benchmark/reference/keller_segel.py`) imports nothing of the port. The
card's routes are reached here through stubs that run the eager step: K3
(the route at the preset's 100 points) through a stubbed launcher, and the
captured CUDA graph (the route above K3's 256 points) through a stubbed
capture, pinned by `keller_segel._route`.
"""

import dataclasses
import json
import time

import pytest
import torch

from benchmark import harness
from distributedconvrl_pde_control_torch.configs.keller_segel import KELLER_SEGEL_10_16
from distributedconvrl_pde_control_torch.ops import keller_segel as ks_ops
from distributedconvrl_pde_control_torch.parallel.multichip import ShardedTrainConfig
from distributedconvrl_pde_control_torch.parallel.multichip_keller_segel import (
    ShardedKellerSegelTrainer,
)
from distributedconvrl_pde_control_torch.utils import profiling

CELL = "kellersegel10_16-train-b16384"
SEED = 2 ** 31 + 20


def _driver(cell):
    return harness.load_module(cell.root / "benchmark" / "drivers" / f"{cell.workload['driver']}.py")


def test_chunk_matches_the_plain_reference():
    """Three steps that each learn (4 envs push 64 columns, past
    update_after * 16) from seeded glorot weights: losses, first gradients,
    the leaves' change, rewards and fields agree with the reference to
    float32 round-off. 1e-5: the port and the reference order their sums
    differently, and three Adam steps carry that into the leaves."""
    cell = harness.find_cell(CELL, overrides={"n_envs": 4, "pool_size": 3})
    assert cell.config["nx"] == 100 and cell.config["oversampling"] == 50
    driver = _driver(cell)
    ctx = harness.Ctx(cell=cell, seed=SEED, seconds=0.0, trace=False, device="cpu",
                      t_start=time.perf_counter())
    _, _, inputs, prog, _ = driver.build(ctx)
    assert len(prog["losses"]) == 3
    gaps = driver.gaps(prog, driver.reference(cell.config, cell.workload, inputs))
    assert all(v <= 1e-5 for v in gaps.values()), gaps


def test_config_file_is_the_preset():
    """The benchmark's configuration file holds every field of the
    published preset at its value, uncut."""
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "KellerSegel10_16")
    data = json.loads((harness.ROOT / entry["file"]).read_text())
    assert entry["reduced"] == [] and data["source"] == entry["source"]
    for f in dataclasses.fields(KELLER_SEGEL_10_16):
        assert data[f.name] == getattr(KELLER_SEGEL_10_16, f.name), f.name
    assert (harness.ROOT / data["reference"]).is_file()


class _StubCapture:
    """A capture that keeps the function and runs it at each replay."""

    def __init__(self, fn, y, forcing):
        self.fn = fn
        fn(y, forcing)

    def __call__(self, y, forcing):
        return self.fn(y, forcing)


@pytest.fixture
def card_route(monkeypatch):
    """The graph route, pinned at any nx."""
    monkeypatch.setattr(ks_ops, "_on_card", lambda y: True)
    monkeypatch.setattr(ks_ops, "_route", lambda y, nx: "graph")
    monkeypatch.setattr(ks_ops, "_CapturedStep", _StubCapture)


class _StubLauncher:
    """K3's launcher, running the eager step, with the arguments it got."""

    def __init__(self):
        self.calls = []

    def __call__(self, y, forcing, dt, oversampling, dx, chi):
        self.calls.append((tuple(y.shape), dt, oversampling, dx, chi))
        return ks_ops.KellerSegelSolver(nx=y.shape[-1], lx=dx * y.shape[-1])._rk4(
            y, forcing, dt, oversampling)


@pytest.fixture
def kernel_route(monkeypatch):
    """The card's route at K3's sizes, through a stubbed launcher."""
    launcher = _StubLauncher()
    monkeypatch.setattr(ks_ops, "_on_card", lambda y: True)
    monkeypatch.setattr(ks_ops.keller_segel_kernel, "KELLER_SEGEL_RK4", launcher)
    return launcher


def _counts():
    return dict(vars(ks_ops.KELLER_SEGEL_STEPS))


def _delta(before):
    return {k: v - before[k] for k, v in _counts().items()}


def _fields(n=2):
    gen = torch.Generator().manual_seed(5)
    return 1.0 + 0.3 * torch.randn((n, 2, 100), generator=gen), torch.randn((n, 100), generator=gen)


def test_counters_stay_still_on_the_cpu_path():
    solver = ks_ops.KellerSegelSolver(nx=100, lx=10.0)
    y, f = _fields()
    before = _counts()
    a = solver.step(y, f, 0.006, 5)
    b = solver.step_eager(y, f, 0.006, 5)
    assert torch.equal(a, b) and not solver.graphs
    assert _delta(before) == {"kernel_steps": 0, "captures": 0, "replays": 0, "eager_steps": 0}


def test_counters_through_a_stubbed_capture(card_route):
    """One capture per shape, a replay per step, and an eager step only
    where `step_eager` is called on the card."""
    solver = ks_ops.KellerSegelSolver(nx=100, lx=10.0)
    y, f = _fields()
    before = _counts()
    out = [solver.step(y, f, 0.006, 5) for _ in range(3)]
    assert _delta(before) == {"kernel_steps": 0, "captures": 1, "replays": 3, "eager_steps": 0}
    solver.step(*_fields(3), 0.006, 5)
    eager = solver.step_eager(y, f, 0.006, 5)
    assert _delta(before) == {"kernel_steps": 0, "captures": 2, "replays": 4, "eager_steps": 1}
    assert all(torch.equal(o, eager) for o in out) and len(solver.graphs) == 2


def test_capture_span_in_a_traced_chunk(card_route, tmp_path):
    """`solver.capture` is a span of `SPANS`; a chunk's first step, traced
    by `profiling.trace`, shows it once, inside that step's `env.solve`."""
    assert "solver.capture" in profiling.SPANS
    tr = ShardedKellerSegelTrainer(KELLER_SEGEL_10_16, (1, 1),
                                   ShardedTrainConfig(n_envs=2, batch_size=8, capacity_per_dp=1024,
                                                      y0_pool_size=2), device="cpu")
    st = tr.init(torch.Generator().manual_seed(0), seed=1)
    chunk = tr.make_chunk_fn(2)
    with profiling.trace(str(tmp_path / "profile")):
        chunk(st)
    events = json.loads((tmp_path / "profile" / profiling.TRACE_FILE).read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    capture = [e for e in spans if e["name"] == "solver.capture"]
    solves = [e for e in spans if e["name"] == "env.solve"]
    assert len(capture) == 1 and len(solves) == 2
    c = capture[0]
    assert any(s["ts"] <= c["ts"] and c["ts"] + c["dur"] <= s["ts"] + s["dur"] for s in solves)


def test_route_from_the_tensor_and_nx(monkeypatch):
    """Eager on the CPU; on the card K3 up to its 256 points, the graph above."""
    y = torch.zeros((1, 2, 100))
    assert ks_ops._route(y, 100) == "eager"
    monkeypatch.setattr(ks_ops, "_on_card", lambda y: True)
    assert ks_ops.keller_segel_kernel.MAX_NX == 256
    assert [ks_ops._route(y, nx) for nx in (1, 3, 100, 256, 257, 1000)] == [
        "kernel"] * 4 + ["graph"] * 2


def test_kernel_route_counts_each_step(kernel_route):
    """Every step of the preset's 100 points is one launch of K3, counted in
    `kernel_steps`; nothing is captured or replayed, no graph is kept (so
    the benchmark's `graph` check reads 0), and the launcher gets the
    solver's dx and chi."""
    solver = ks_ops.KellerSegelSolver(nx=100, lx=10.0)
    y, f = _fields()
    before = _counts()
    out = [solver.step(y, f, 0.006, 5) for _ in range(3)]
    solver.step(*_fields(3), 0.006, 5)
    assert _delta(before) == {"kernel_steps": 4, "captures": 0, "replays": 0, "eager_steps": 0}
    assert not solver.graphs
    assert kernel_route.calls[0] == ((2, 2, 100), 0.006, 5, solver.dx, solver.chi)
    eager = solver.step_eager(y, f, 0.006, 5)
    assert all(torch.equal(o, eager) for o in out)


def test_kernel_route_on_the_train_chunk(kernel_route):
    """The main path, the sharded trainer at 1x1 with the preset: each
    `env.solve` of a chunk is one K3 step and no capture."""
    tr = ShardedKellerSegelTrainer(KELLER_SEGEL_10_16, (1, 1),
                                   ShardedTrainConfig(n_envs=2, batch_size=8, capacity_per_dp=1024,
                                                      y0_pool_size=2), device="cpu")
    st = tr.init(torch.Generator().manual_seed(0), seed=1)
    chunk = tr.make_chunk_fn(3)
    before = _counts()
    chunk(st)
    assert _delta(before) == {"kernel_steps": 3, "captures": 0, "replays": 0, "eager_steps": 0}
    assert len(kernel_route.calls) == 3 and not tr.solver.graphs
