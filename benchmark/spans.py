"""Readers of the program's own spans in the traced run's trace.

The port names its layers' entries with spans
(`distributedconvrl_pde_control_torch/utils/profiling.py::SPANS`): while the
traced window's profiler records, each is a `user_annotation` event on the
host thread, in the same timeline and on the same clock as the device's
operations. Host time inside a span is read from the span's own events.
Device time is claimed by a span when the operation's launch call lies inside
one of its instances, found by correlation id as `Trace.range_device_s` finds
it: by the call's time, not its thread, so that the backward kernels that
autograd's device thread launches while the caller waits inside
`agent.learn` count there. A program that opens none of these spans (an
older checkout) gives every reader None.
"""

from __future__ import annotations

import bisect

from benchmark.tracing import _union

# the port's span names (its `SPANS`), copied so that a reading does not move
# with the program's list
PROGRAM_SPANS = ("agent.act", "agent.learn", "replay.sample", "env.step", "env.solve")


def intervals(tr, names) -> list:
    """The instances of the spans `names` on the host thread, clipped to
    the traced window, as [start, end] in the trace's microseconds."""
    names = set(names)
    out = []
    for e in tr.host:
        if e["name"] in names:
            a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
            a, b = max(a, tr.t0), min(b, tr.t1)
            if b > a:
                out.append([a, b])
    return out


def _measure(merged) -> float:
    return sum(b - a for a, b in merged)


def host_us(tr, name: str, minus: str | None = None):
    """Host microseconds inside the span `name`, less those inside `minus`
    that lie within it; None where the trace has no `name`."""
    own = intervals(tr, [name])
    if not own:
        return None
    if minus is None:
        return _measure(_union(own))
    # the part of `own` outside `minus`: |own or minus| - |minus|
    inner = _union(intervals(tr, [minus]))
    return _measure(_union(own + inner)) - _measure(inner)


def device_s(tr, names):
    """Device seconds of the operations whose launch call lies inside one
    of the spans `names`; None where the trace has none of them."""
    merged = _union(intervals(tr, names))
    if not merged:
        return None
    starts = [a for a, _ in merged]
    total = 0.0
    for e in tr.device:
        ts = tr._launch_ts(e)
        if ts is None:
            continue
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= merged[i][1]:
            total += float(e.get("dur", 0))
    return total * 1e-6


def per_step(view, value, scale: float):
    if value is None or not view["steps"]:
        return None
    return value * scale / view["steps"]


def learn_ms_per_step(view):
    """Device ms per step of what the learner launched: the operations
    launched inside `replay.sample` or `agent.learn`."""
    if view["trace"].device_ops == 0:
        return None
    return per_step(view, device_s(view["trace"], ("replay.sample", "agent.learn")), 1e3)


def act_host_us(view):
    """Host us per step inside `agent.act`."""
    return per_step(view, host_us(view["trace"], "agent.act"), 1.0)


def env_host_us(view):
    """Host us per step inside `env.step` and outside its `env.solve`: the
    env's own forcing, observation, reward and done."""
    return per_step(view, host_us(view["trace"], "env.step", minus="env.solve"), 1.0)


def solve_host_us(view):
    """Host us per step inside `env.solve`."""
    return per_step(view, host_us(view["trace"], "env.solve"), 1.0)


def idle_outside_spans(view):
    """% of the traced window in which no device operation runs and the
    host is inside none of the program's spans: the caller's loop, its
    reads, and Python between the calls."""
    tr = view["trace"]
    inside = intervals(tr, PROGRAM_SPANS)
    if not inside or tr.device_ops == 0 or tr.window_s <= 0:
        return None
    covered = _union(inside + tr._busy_intervals())
    return 100.0 * (1.0 - _measure(covered) * 1e-6 / tr.window_s)
