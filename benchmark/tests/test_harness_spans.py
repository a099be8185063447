"""The readers of the program's spans (`spans.py`), on a trace written by
hand; on the CPU, a traced run of the control cell at the tiny sizes; on
the card (`gpu` marker), the spans on the device trace's clock."""

import time

import pytest
import torch

from benchmark import harness, spans, tracing
from benchmark.tests.tiny import SEED, dry_run


def _ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "args": args}


def _span(name, ts, dur):
    return _ev(name, "user_annotation", ts, dur)


def _op(name, launch_ts, corr, ts, dur, tid=1, cat="kernel"):
    return [_ev("cudaLaunchKernel", "cuda_runtime", launch_ts, 2.0, tid=tid, correlation=corr),
            _ev(name, cat, ts, dur, tid=7, correlation=corr)]


def _trace(with_spans=True):
    """Two control steps and one learner update in a 1000 us window: act,
    env.step with a nested env.solve, then replay.sample and agent.learn,
    whose backward kernel is launched from autograd's thread (tid 2)."""
    events = [_ev(tracing.WINDOW, "user_annotation", 0.0, 1000.0),
              _ev(tracing.RANGE_PREFIX + "ks_step", "user_annotation", 105.0, 90.0)]
    if with_spans:
        events += [_span("agent.act", 10.0, 50.0), _span("env.step", 70.0, 230.0),
                   _span("env.solve", 100.0, 100.0),
                   _span("agent.act", 500.0, 40.0), _span("env.step", 550.0, 250.0),
                   _span("env.solve", 600.0, 50.0),
                   _span("replay.sample", 820.0, 20.0), _span("agent.learn", 850.0, 100.0)]
    events += (_op("mm", 20.0, 1, 30.0, 10.0)  # the actor's product
               + _op("ks_cnab2", 110.0, 2, 120.0, 60.0)  # K1, inside the first env.solve
               + _op("Memcpy DtoH", 310.0, 3, 320.0, 10.0, cat="gpu_memcpy")  # the caller's read
               + _op("index_select", 825.0, 4, 830.0, 5.0)  # the replay gather
               + _op("mm_backward", 900.0, 5, 905.0, 20.0, tid=2))  # launched by autograd
    return tracing.Trace(events)


def _view(tr, steps=2):
    return {"trace": tr, "steps": steps, "shape": {}}


def test_host_readers_subtract_the_nested_solve():
    view = _view(_trace())
    assert spans.act_host_us(view) == pytest.approx((50 + 40) / 2)
    assert spans.solve_host_us(view) == pytest.approx((100 + 50) / 2)
    # env.step less its env.solve: (230 - 100) + (250 - 50)
    assert spans.env_host_us(view) == pytest.approx((130 + 200) / 2)


def test_learn_counts_a_kernel_launched_from_another_thread():
    """The backward kernel's launch call is on autograd's thread but inside
    `agent.learn` by time: it counts, as does the gather launched inside
    `replay.sample`; nothing launched outside them does."""
    view = _view(_trace())
    assert spans.learn_ms_per_step(view) == pytest.approx((20 + 5) * 1e-3 / 2)
    assert spans.device_s(view["trace"], ["env.solve"]) == pytest.approx(60e-6)
    assert spans.device_s(view["trace"], ["env.solve"]) == \
        pytest.approx(view["trace"].range_device_s("ks_step"))


def test_idle_outside_spans_counts_a_gap_half_inside_a_span():
    """The device is idle from 925 us (the backward kernel's end) to the
    window's end; the host is inside `agent.learn` until 950 us, so only
    the last 50 us of that gap count, beside the other uncovered stretches
    (0-10, 60-70, 300-320, 330-500, 540-550, 800-820, 840-850)."""
    view = _view(_trace())
    covered = 50 + 230 + 10 + 40 + 250 + 20 + 100  # the spans, and the read at 320-330
    assert spans.idle_outside_spans(view) == pytest.approx(100.0 * (1000 - covered) / 1000)
    assert 100.0 - spans.idle_outside_spans(view) == pytest.approx(70.0)


def test_no_spans_reads_none():
    view = _view(_trace(with_spans=False))
    for reader in (spans.learn_ms_per_step, spans.act_host_us, spans.env_host_us,
                   spans.solve_host_us, spans.idle_outside_spans):
        assert reader(view) is None


def test_names_are_the_programs():
    from distributedconvrl_pde_control_torch.utils.profiling import SPANS

    assert set(spans.PROGRAM_SPANS) == set(SPANS)


def test_control_cell_traced_on_the_cpu():
    """A traced run of the control cell at the tiny sizes reports the three
    host readers (the CPU has no device operations for the other two)."""
    res = dry_run("ks22-control-b1", trace=True)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["act_host_us.eval"] > 0 and m["env_host_us.eval"] > 0 and m["solve_host_us.eval"] > 0
    assert "idle_outside_spans.eval" not in m and res["correct"]


@pytest.mark.gpu
def test_spans_on_the_device_clock():
    """On the card, in a traced control window of 50 steps: the device
    seconds launched inside `env.solve` are those of the benchmark's own
    range around the solver entry (within 1 %), and every K1 kernel starts
    after the start of the `env.solve` that launched it (one clock). A
    profiler session can lose records, so a window whose trace holds fewer
    K1 kernels than the library counted is traced again (up to 3 times)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from distributedconvrl_pde_control_torch.ops.kernels.ks_kernel import KS_CNAB2

    cell = harness.find_cell("ks22-control-b1")
    driver = harness.load_module(cell.root / "benchmark" / "drivers" / "control_ks.py")
    ctx = harness.Ctx(cell=cell, seed=SEED, seconds=1.0, trace=True, device="cuda",
                      t_start=time.perf_counter())
    state = driver.setup(ctx)
    try:
        for _ in range(3):
            sink, before = {}, KS_CNAB2.launches
            with tracing.profiled(sink):
                driver.window(state, chunks=50)
            tr, launched = sink["trace"], KS_CNAB2.launches - before
            k1 = [e for e in tr.device if "ks_cnab2" in e.get("name", "")]
            if len(k1) == launched:
                break
    finally:
        state.restore()
    solve = spans.device_s(tr, ["env.solve"])
    assert solve > 0 and solve == pytest.approx(tr.range_device_s("ks_step"), rel=0.01)
    starts = sorted(spans.intervals(tr, ["env.solve"]))
    assert len(k1) == launched >= 50 and len(starts) >= 50, (len(k1), launched, len(starts))
    for e in k1:
        launch = tr._launch_ts(e)
        owner = [a for a, b in starts if a <= launch <= b]
        assert owner and float(e["ts"]) >= owner[-1], (e, launch, owner)
