"""Tracing and per-phase timing.

Counterpart of ``distributedconvrl_pde_control_tpu/utils/profiling.py``:
`trace()` records the enclosed block with `torch.profiler` (the host's
operators and, on a CUDA device, its kernels) and writes a Chrome trace JSON
into a directory (open it in Perfetto or chrome://tracing); `StepTimer`
collects per-phase wall-clock totals the way the training drivers report
loop timings; `annotate` names a function's span in the trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block and write `log_dir`/trace.json. CUDA
    activity is recorded when a CUDA device is present."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _synchronize(tree) -> None:
    """Wait for the device of the first CUDA tensor found in `tree` (a
    tensor, or nested lists, tuples and dicts of them)."""
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
                return
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)


class StepTimer:
    """Accumulates wall-clock per named phase; with `block_on` the clock is
    read after the device that holds it has finished, so that asynchronous
    launches do not hide work in the wrong bucket."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name:24s} {tot:9.3f}s  x{n:<6d} {tot / max(n, 1) * 1e3:9.3f} ms/call")
        return "\n".join(lines)


def annotate(name: str):
    """Decorator naming a function's span in profiler timelines."""

    def deco(fn):
        def wrapped(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)

        wrapped.__name__ = getattr(fn, "__name__", name)
        return wrapped

    return deco
