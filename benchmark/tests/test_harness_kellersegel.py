"""The Keller-Segel train cell on the CPU at a tiny size (4 envs at the
configuration's own widths: 100 points, 50 substeps): its whole run, its
planted faults, its scaled loss gap, its control, and its readers and counts
on a trace written by hand."""

import json
import time

import pytest

from benchmark import calibrate_gaps, counts, counts_keller_segel, harness
from benchmark import readers_keller_segel as readers
from benchmark import tracing
from benchmark.tests.tiny import SEED
from distributedconvrl_pde_control_torch.agents.ddpg import DDPGAgent
from distributedconvrl_pde_control_torch.ops import keller_segel as ks_ops
from distributedconvrl_pde_control_torch.parallel.multichip_keller_segel import (
    ShardedKellerSegelTrainer,
)

CELL = "kellersegel10_16-train-b16384"
TINY = {"n_envs": 4, "pool_size": 3, "chunk_len": 3, "trace_length": 1, "warmup_seconds": 0}


def _cell():
    return harness.find_cell(CELL, overrides=TINY)


def _driver(cell):
    return harness.load_module(cell.root / "benchmark" / "drivers" / f"{cell.workload['driver']}.py")


def _run(trace=False, seed=SEED):
    return harness.run_cell(harness.Ctx(cell=_cell(), seed=seed, seconds=0.5, trace=trace,
                                        device="cpu", t_start=time.perf_counter()))


def test_cell_runs_end_to_end():
    """Untraced: correct, the rate and set-up reported, every check within
    1e-5 (graph 0: the CPU steps eagerly, which is not the card's route);
    traced: the device readers find no device operations and report
    nothing."""
    res = _run()
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"loss", "grad", "change", "reward", "field", "graph"}
    assert all(c["value"] <= 1e-5 for c in res["checks"].values()), res["checks"]
    assert res["checks"]["graph"]["value"] == 0.0
    assert res["metrics"]["train_env_steps_per_s"]["value"] > 0
    assert res["attempted"] > 0 and res["failed"] == 0
    traced = _run(trace=True)
    assert traced["correct"] and traced["metrics"] == {}
    json.dumps(traced)


def _half_batch(original):
    def sample(self, replay, batch_size, generator=None, offs=None):
        s, a, r, t, sn = original(self, replay, batch_size, generator, offs)
        h = r.shape[0] // 2
        return s[:, :h], a[:, :h], r[:h], t[:h], sn[:, :h]
    return sample


def _field_unchanged(original):
    def solve(self, w, f):
        original(self, w, f)
        return w.clone()
    return solve


def _eager_counted(original):
    def solve(self, w, f):
        ks_ops.KELLER_SEGEL_STEPS.eager_steps += 1
        return original(self, w, f)
    return solve


@pytest.mark.parametrize("cls,attr,make,check", [
    (DDPGAgent, "sample", _half_batch, "grad"),
    (ShardedKellerSegelTrainer, "_solver_step", _field_unchanged, "field"),
    (ShardedKellerSegelTrainer, "_solver_step", _eager_counted, "graph"),
], ids=["half_batch", "field_unchanged", "eager_step_in_window"])
def test_planted_fault_is_not_correct(monkeypatch, cls, attr, make, check):
    monkeypatch.setattr(cls, attr, make(getattr(cls, attr)))
    res = _run()
    assert not res["correct"] and res["checks"][check]["value"] > res["checks"][check]["limit"]


@pytest.mark.parametrize("ref_actor,prog_actor,bounded", [
    (0.0, 1e-9, True),  # a reference actor loss of 0 with round-off beside it
    (0.0, 1e-3, False),  # a gap of 1e-3 of the Q values' size
    (-0.5, -0.5 + 1e-3, False),
])
def test_scaled_loss_gap(ref_actor, prog_actor, bounded):
    """The actor loss gap is over the batch's mean |Q|, which stays 1 here
    while the reference actor loss is 0: round-off reads small, a gap of
    1e-3 reads 1e-3. The critic loss 1e-4 with |Q| 1 is taken over
    sqrt(1e-4) * 1 = 1e-2."""
    driver = _driver(_cell())
    ref = {"losses": [(1e-4, ref_actor)], "q_scale": [(1.0, 1.0)]}
    prog = {"losses": [(1e-4 + 1e-9, prog_actor)]}
    gap = driver.loss_gap(prog, ref)
    limit = _cell().workload["limits"]["loss"]
    assert (gap <= limit) == bounded and gap < 1.0
    assert driver.loss_gap({"losses": [(1e-4 + 1e-5, ref_actor)]}, ref) == pytest.approx(1e-3)


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_control_and_half_batch_fail(seed):
    """The program within the limits; the TF32 control out of `grad` or
    `change`, and the half-batch learner out of a limit."""
    cell = _cell()
    ctx = harness.Ctx(cell=cell, seed=seed, seconds=0.0, trace=False, device="cpu",
                      t_start=time.perf_counter())
    readings = calibrate_gaps.train_readings(_driver(cell), ctx)
    limits = cell.workload["limits"]
    assert all(readings["program"][k] <= limits[k] for k in readings["program"])
    assert any(readings["control"][k] > limits[k] for k in ("grad", "change"))
    assert any(readings["half_batch"][k] > limits[k] for k in readings["half_batch"])


# ---------------------------------------------------------------- readers
def _ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": 1, "args": args}


def _trace(with_solve=True):
    """Two steps in 1000 us: each an env.solve whose graph replay launched
    two kernels, and a learner kernel outside it."""
    events = [_ev(tracing.WINDOW, "user_annotation", 0.0, 1000.0)]
    for k, t0 in enumerate((100.0, 600.0)):
        if with_solve:
            events.append(_ev("env.solve", "user_annotation", t0, 100.0))
        c = 10 * (k + 1)
        events += [_ev("cudaGraphLaunch", "cuda_runtime", t0 + 10, 5.0, correlation=c),
                   _ev("rhs_a", "kernel", t0 + 20, 30.0, correlation=c),
                   _ev("rhs_b", "kernel", t0 + 50, 20.0, correlation=c),
                   _ev("cudaLaunchKernel", "cuda_runtime", t0 + 200, 5.0, correlation=c + 1),
                   _ev("gemm", "kernel", t0 + 210, 40.0, correlation=c + 1)]
    return tracing.Trace(events)


def _shape(rows=4096):
    return {"family": "keller_segel", "rows": rows, "nx": 100, "substeps": 50, "n_actuators": 16,
            "n_sensors": 20, "actor": [12, 20, 1], "critic": [13, 340, 1], "batch": 32,
            "updates": 1}


def test_readers_on_a_written_trace():
    view = {"trace": _trace(), "steps": 2, "shape": _shape()}
    assert readers.solve_ops_per_step(view) == 2.0
    bound = counts_keller_segel.step_bound_s(100, 50, 4096)
    assert readers.solve_roofline(view) == pytest.approx(100 * bound * 2 / 100e-6)
    flops = counts_keller_segel.train_step_flops(_shape()) * 2
    assert readers.mfu(view) == pytest.approx(100 * flops / (1e-3 * counts.PEAK_FLOPS_FP32))
    bare = {**view, "trace": _trace(with_solve=False)}
    assert readers.solve_ops_per_step(bare) is None and readers.solve_roofline(bare) is None


def test_counts_of_a_step():
    # 120 operations a point and substep: 4 x 24 for the right-hand sides, 24 for RK4's sums
    assert counts_keller_segel.step_flops(100, 50, 4096) == 120 * 100 * 50 * 4096
    assert counts_keller_segel.step_min_bytes(100, 4096) == 4 * 4096 * 500
    # bound by operations: 2.4576e9 at 67 TFLOP/s, 36.7 us; the bytes 2.4 us
    assert counts_keller_segel.step_bound_s(100, 50, 4096) == pytest.approx(3.668e-5, rel=1e-3)
    assert counts_keller_segel.train_step_flops(_shape()) > counts_keller_segel.step_flops(
        100, 50, 4096)
