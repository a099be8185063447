"""The readers that per-layer metric files under `metrics/` bind: each takes
the traced run's view (`trace`: a `tracing.Trace`, `steps`: the steps of the
traced window, `shape`: the driver's shape of the cell) and returns a number,
or None where the trace holds nothing to read."""

from __future__ import annotations

from benchmark import counts


def idle_share(view):
    """% of the traced window in which no device operation ran."""
    tr = view["trace"]
    if tr.window_s <= 0 or tr.device_ops == 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def launches_per_step(view):
    """Host launch calls (kernels, cooperative kernels, graphs) per step."""
    tr = view["trace"]
    if not view["steps"] or not tr.launches:
        return None
    return tr.launches / view["steps"]


def _roofline(view, bound_s_per_call):
    tr, shape = view["trace"], view["shape"]
    calls, dev = tr.range_calls(shape["range"]), tr.range_device_s(shape["range"])
    if calls == 0 or dev <= 0:
        return None
    return 100.0 * bound_s_per_call(shape) * calls / dev


def k1_roofline(view):
    """% of the KS step's least time (its operations at the float32 peak)
    over the device time of everything launched inside the solver entry."""
    return _roofline(view, lambda s: counts.ks_step_bound_s(s["nx"], s["oversampling"], s["rows"]))


def k2_roofline(view):
    """% of the fluid step's least time (4 advection evaluations per RK4
    substep, each bound by its bytes or its operations) over the device time
    of everything launched inside the solver entry."""
    return _roofline(view, lambda s: counts.ns_step_bound_s(s["n"], s["rows"], s["substeps"]))


def mfu(view):
    """% of the float32 peak that the operations of the traced steps take
    over the traced window."""
    tr, shape = view["trace"], view["shape"]
    if not view["steps"] or tr.window_s <= 0 or tr.device_ops == 0:
        return None
    per_step = (counts.ks_step_flops if shape["family"] == "ks" else counts.fluid_step_flops)(shape)
    return 100.0 * per_step * view["steps"] / (tr.window_s * counts.PEAK_FLOPS_FP32)
