"""The traced run: a `torch.profiler` session around the traced window, and
what the per-layer readers take from its trace.

The trace is the profiler's chrome-trace export, read back as JSON. Device
operations are its kernel, memcpy and memset events; launches are the host's
runtime and driver launch calls. A range that the benchmark opens around a
solver entry (`wrap_entry`) claims every device operation whose launching
call lies inside one of its instances: the call is found by the operation's
correlation id, and an operation whose call the trace lacks (a library that
bypasses the traced runtime) is placed at the launch call with the next
lower correlation id, which precedes it on the host.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import json
import os
import tempfile
from collections import defaultdict

import torch

WINDOW = "bench.window"
RANGE_PREFIX = "bench.range."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
API_CATS = ("cuda_runtime", "cuda_driver")
LAUNCHES = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
    "cudaLaunchCooperativeKernel", "cudaLaunchCooperativeKernelMultiDevice",
    "cuLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch",
})


def wrap_entry(cls, attr: str, label: str):
    """Replace `cls.attr` by a wrapper that opens the profiler range
    `bench.range.<label>` around each call; returns the function that puts
    the original back. Wrap before the program binds the method."""
    original = getattr(cls, attr)

    @functools.wraps(original)
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(RANGE_PREFIX + label):
            return original(*args, **kwargs)

    setattr(cls, attr, wrapped)
    return lambda: setattr(cls, attr, original)


@contextlib.contextmanager
def profiled(sink: dict):
    """Profile the block as the traced window; `sink["trace"]` gets the
    parsed `Trace` when it ends."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            sink["trace"] = Trace(json.load(f).get("traceEvents", []))
    finally:
        os.unlink(path)


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The events of one traced window (times in the trace's microseconds,
    results in seconds)."""

    def __init__(self, events: list):
        win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
               and e.get("cat") in ("user_annotation", "cpu_op")]
        if not win:
            raise RuntimeError(f"the trace has no {WINDOW!r} range")
        w = max(win, key=lambda e: e.get("dur", 0))
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.host_tid = w.get("tid")
        inside = [e for e in events if e.get("ph") == "X" and "ts" in e]
        self.device = [e for e in inside if e.get("cat") in DEVICE_CATS
                       and float(e["ts"]) + float(e.get("dur", 0)) > self.t0
                       and float(e["ts"]) < self.t1]
        self.api = sorted((e for e in inside if e.get("cat") in API_CATS),
                          key=lambda e: float(e["ts"]))
        self.host = sorted((e for e in inside if e.get("cat") in ("cpu_op", "user_annotation")
                            and e.get("tid") == self.host_tid and e.get("name") != WINDOW),
                           key=lambda e: float(e["ts"]))
        self.ranges = defaultdict(list)
        for e in self.host:
            if e["name"].startswith(RANGE_PREFIX):
                self.ranges[e["name"][len(RANGE_PREFIX):]].append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        corr = {}
        for e in self.api:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                corr[int(c)] = float(e["ts"])
        self._corr_keys = sorted(corr)
        self._corr_ts = [corr[k] for k in self._corr_keys]
        self._corr = corr

    # ------------------------------------------------------------- window
    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _busy_intervals(self) -> list:
        return _union((max(float(e["ts"]), self.t0), min(float(e["ts"]) + float(e.get("dur", 0)),
                                                           self.t1)) for e in self.device)

    @property
    def busy_s(self) -> float:
        """Seconds in which some device operation ran, within the window."""
        return sum(b - a for a, b in self._busy_intervals()) * 1e-6

    @property
    def launches(self) -> int:
        """Host launch calls (kernels, cooperative kernels, graphs) in the
        window."""
        return sum(1 for e in self.api if e["name"] in LAUNCHES and self.t0 <= float(e["ts"]) <= self.t1)

    @property
    def device_ops(self) -> int:
        return len(self.device)

    # ------------------------------------------------------------- ranges
    def _launch_ts(self, e):
        c = e.get("args", {}).get("correlation")
        if c is None:
            return None
        c = int(c)
        if c in self._corr:
            return self._corr[c]
        i = bisect.bisect_left(self._corr_keys, c) - 1
        return self._corr_ts[i] if i >= 0 else None

    def range_calls(self, label: str) -> int:
        return sum(1 for a, b in self.ranges.get(label, ()) if self.t0 <= a and b <= self.t1)

    def range_device_s(self, label: str) -> float:
        """Device seconds of the operations launched inside the range."""
        spans = sorted(self.ranges.get(label, ()))
        if not spans:
            return 0.0
        starts = [a for a, _ in spans]
        total = 0.0
        for e in self.device:
            ts = self._launch_ts(e)
            if ts is None:
                continue
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= spans[i][1]:
                total += float(e.get("dur", 0))
        return total * 1e-6

    def kernel_s(self, substrings) -> float:
        """Device seconds of the kernels whose name holds one of
        `substrings` (the cross-check of a range by kernel names)."""
        return sum(float(e.get("dur", 0)) for e in self.device
                   if any(s in e.get("name", "") for s in substrings)) * 1e-6

    # ---------------------------------------------------------- breakdown
    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps summed by the innermost host operation running at their
        middle."""
        ops = defaultdict(float)
        for e in self.device:
            ops[e.get("name", "?")[:160]] += float(e.get("dur", 0)) * 1e-6
        gaps = []
        prev = self.t0
        for a, b in self._busy_intervals() + [[self.t1, self.t1]]:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        starts = [float(e["ts"]) for e in self.host]
        idle = defaultdict(float)
        for a, b in gaps:
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid) - 1
            best = None
            for j in range(i, max(-1, i - 400), -1):
                e = self.host[j]
                end = float(e["ts"]) + float(e["dur"])
                if end >= mid and (best is None or e["dur"] < best["dur"]):
                    best = e
            idle[best["name"][:160] if best else "(host outside any operation)"] += (b - a) * 1e-6
        return {"device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda x: -x[1])[:top],
                "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda x: -x[1])[:top]}
