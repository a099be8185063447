"""Tracing, named spans at the port's layer boundaries, and per-phase timing.

Counterpart of ``distributedconvrl_pde_control_tpu/utils/profiling.py``:

  * `trace()` records the enclosed block with `torch.profiler` (the host's
    operators and, on a CUDA device, its kernels, copies and launch calls)
    and writes a Chrome trace JSON into a directory (open it in Perfetto or
    chrome://tracing). `run.py --train --profile` writes its first loop so,
    and the trace carries the spans below beside the kernels;
  * `span(name)` names a block of the program in that trace, and `annotate`
    is its decorator form. With no profiler recording a span is one check
    of a flag and a shared null context (on an 8-core Xeon host, with
    torch 2.13 for the CPU: 0.9 us a span, the check 0.1 us of it, against
    17 us for an unguarded `torch.profiler.record_function`), so the spans
    stay in the hot path.
    While a profiler session records, a span is a `record_function`: it
    lands in the same kineto timeline as the device's kernel, memcpy and
    launch events, on the same clock, and is written out with them when
    the session ends (`trace()`, or any other `torch.profiler` session such
    as the benchmark's traced run). Spans nest by time on the host thread;
    the span that caused a device operation is the innermost one open when
    its launch call ran (backward kernels launch from autograd's own
    thread while the calling thread waits inside the span);
  * `SPANS` lists every span the program opens, with its meaning; each is
    opened at one layer's entry, under one name on every path;
  * `StepTimer` collects per-phase wall-clock totals, which `--profile`
    prints after its trace. Kept beside the spans: it is the host clock's
    view of whole phases (a loop, the steady loops), which a trace of one
    loop does not give.

The kernels' launch counters (`ops/kernels/*.launches`) and the
Keller-Segel step's routes (`ops/keller_segel.py::KELLER_SEGEL_STEPS`: K3
steps, graph captures and replays, eager steps on the card) are counters of
the program; they are not spans.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

TRACE_FILE = "trace.json"

SPANS = {
    "agent.act": "DDPGAgent.act: the policy forward, exploration noise and clamp",
    "agent.learn": "DDPGAgent.learn_batch: one DDPG update, both Adam steps and the Polyak "
                   "averaging",
    "replay.sample": "replay_sample: the learner batch's gather (DDPGAgent.sample, learn_many)",
    "env.step": "PDEEnv.step, or the fluid trainer's inline env block: forcing, solve, "
                "observation, reward and done",
    "env.solve": "the PDE solver entry inside env.step (K1 / K2 and their boundary transforms)",
    "solver.capture": "KellerSegelSolver.step's first call at a shape, inside env.solve: the "
                      "step's warm-up and CUDA graph capture",
}

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager naming the enclosed block `name` (a key of
    `SPANS`) in the profiler's timeline; with no profiler recording it is a
    shared null context, and nothing is recorded or allocated."""
    if not _profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def annotate(name: str):
    """Decorator form of `span`: the whole call of the function is the
    span `name`."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            with span(name):
                return fn(*a, **k)

        return wrapped

    return deco


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
