"""The traced run's reading of a trace, on a trace written by hand."""

import pytest

from benchmark import readers, tracing


def _ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": 1, "args": args}


def _trace():
    return tracing.Trace([
        _ev(tracing.WINDOW, "user_annotation", 0.0, 1000.0),
        _ev(tracing.RANGE_PREFIX + "ks_step", "user_annotation", 100.0, 50.0),
        _ev(tracing.RANGE_PREFIX + "ks_step", "user_annotation", 600.0, 50.0),
        _ev("aten::mm", "cpu_op", 300.0, 20.0),
        _ev("cudaLaunchKernel", "cuda_runtime", 110.0, 5.0, correlation=10),
        _ev("cudaLaunchKernel", "cuda_runtime", 305.0, 5.0, correlation=12),
        _ev("cudaLaunchKernel", "cuda_runtime", 610.0, 5.0, correlation=20),
        _ev("cudaMemcpyAsync", "cuda_runtime", 700.0, 5.0, correlation=30),
        # launched inside the first range; 11's launch call is not in the trace
        _ev("ks_cnab2_kernel", "kernel", 120.0, 40.0, correlation=10),
        _ev("fft_helper", "kernel", 170.0, 10.0, correlation=11),
        _ev("gemv", "kernel", 320.0, 30.0, correlation=12),
        _ev("ks_cnab2_kernel", "kernel", 620.0, 40.0, correlation=20),
        _ev("Memcpy DtoH", "gpu_memcpy", 710.0, 20.0, correlation=30),
        _ev("outside", "kernel", 2000.0, 10.0, correlation=40),
    ])


def test_window_busy_launches():
    tr = _trace()
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx((40 + 10 + 30 + 40 + 20) * 1e-6)
    assert tr.launches == 3 and tr.device_ops == 5


def test_range_attribution_and_names():
    tr = _trace()
    assert tr.range_calls("ks_step") == 2
    assert tr.range_device_s("ks_step") == pytest.approx((40 + 10 + 40) * 1e-6)
    assert tr.kernel_s(["ks_cnab2"]) == pytest.approx(80e-6)


def test_breakdown_and_readers():
    tr = _trace()
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["ks_cnab2_kernel", pytest.approx(80e-6)]
    assert sum(v for _, v in bd["idle_gaps"]) == pytest.approx(1e-3 - tr.busy_s)
    view = {"trace": tr, "steps": 2, "shape": {"family": "ks", "rows": 1, "nx": 192,
                                                "oversampling": 30, "n_actuators": 8,
                                                "actor": [1, 6, 1], "critic": [2, 140, 1],
                                                "updates": 0, "range": "ks_step"}}
    assert readers.idle_share(view) == pytest.approx(100 * (1 - 140e-3))
    assert readers.launches_per_step(view) == 1.5
    assert 0 < readers.k1_roofline(view) < 100 and 0 < readers.mfu(view) < 100
    assert readers.k2_roofline({**view, "shape": {**view["shape"], "range": "ns_step"}}) is None
