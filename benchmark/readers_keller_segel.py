"""Readers of the Keller-Segel train cell's per-layer metrics, from the
traced run's view (`readers.py` describes it). The solver's device work is
what the program launches inside its `env.solve` span (a graph replay's
kernels carry the replay's launch call), found as `spans.device_s` finds
it; a trace without that span or without device operations reads None."""

from __future__ import annotations

import bisect

from benchmark import counts, counts_keller_segel
from benchmark.spans import device_s, intervals
from benchmark.tracing import _union

SOLVE = "env.solve"


def solve_ops(tr) -> int:
    """Device operations whose launch call lies inside an `env.solve`."""
    merged = _union(intervals(tr, [SOLVE]))
    starts = [a for a, _ in merged]
    n = 0
    for e in tr.device:
        ts = tr._launch_ts(e)
        if ts is None:
            continue
        i = bisect.bisect_right(starts, ts) - 1
        n += i >= 0 and ts <= merged[i][1]
    return n


def solve_roofline(view):
    """% of the env steps' least time (`counts_keller_segel.step_bound_s`
    per `env.solve` call) over the device time launched inside `env.solve`."""
    tr, shape = view["trace"], view["shape"]
    calls = len(intervals(tr, [SOLVE]))
    dev = device_s(tr, [SOLVE])
    if not calls or not dev:
        return None
    bound = counts_keller_segel.step_bound_s(shape["nx"], shape["substeps"], shape["rows"])
    return 100.0 * bound * calls / dev


def solve_ops_per_step(view):
    """Device operations launched inside `env.solve` per traced step."""
    tr = view["trace"]
    if not view["steps"] or tr.device_ops == 0 or not intervals(tr, [SOLVE]):
        return None
    return solve_ops(tr) / view["steps"]


def mfu(view):
    """% of the float32 peak that the traced steps' operations
    (`counts_keller_segel.train_step_flops`) take over the traced window."""
    tr = view["trace"]
    if not view["steps"] or tr.window_s <= 0 or tr.device_ops == 0:
        return None
    flops = counts_keller_segel.train_step_flops(view["shape"]) * view["steps"]
    return 100.0 * flops / (tr.window_s * counts.PEAK_FLOPS_FP32)
