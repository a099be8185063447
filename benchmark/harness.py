"""One run of one cell: set-up, the measured (or traced) window, the check
against the plain reference, and the result line.

Everything that belongs to one cell, configuration or per-layer metric is a
file of its own, found by name: `BENCHMARK.json` at the root lists them,
`benchmark/workloads/<cell>.json` holds a cell's traffic and its limits and
names its driver (`benchmark/drivers/<driver>.py`), the configuration's
`file` holds its sizes, and `benchmark/metrics/<metric>.py` reads one
per-layer metric from the traced run.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "distributedconvrl_pde_control_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark found by its file, imported under a name
    made from its path."""
    name = "bench_" + "_".join(path.resolve().with_suffix("").parts[1:]).replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict  # the cell's entry in BENCHMARK.json
    workload: dict  # benchmark/workloads/<name>.json
    config: dict  # the configuration's file
    end_to_end: list  # the BENCHMARK.json metrics this cell reports
    per_layer: list
    root: Path = ROOT  # the checkout whose benchmark/ holds the cell's files

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT, overrides: dict | None = None,
              config_overrides: dict | None = None) -> Cell:
    """The cell `name` of `root`'s BENCHMARK.json with its files;
    `overrides` and `config_overrides` replace keys of its workload and
    configuration files (the CPU tests' sizes)."""
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    workload = load_json(root / "benchmark" / "workloads" / f"{name}.json")
    workload.update(overrides or {})
    config = load_json(root / configs[entry["config"]]["file"])
    config.update(config_overrides or {})
    return Cell(name=name, entry=entry, workload=workload, config=config,
                end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if reports(m, name)], root=root)


@dataclasses.dataclass
class Ctx:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float


def device_info(device: str, chips: int) -> dict:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i) for i in range(chips)))}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(ctx: Ctx) -> dict:
    """Set-up, window, check; returns the result object (without printing)."""
    import torch

    cell = ctx.cell
    driver = load_module(cell.root / "benchmark" / "drivers" / f"{cell.workload['driver']}.py")
    state = driver.setup(ctx)
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t_start
    metrics, notes, extra = {}, [], {}
    if not ctx.trace:
        win = driver.window(state, seconds=ctx.seconds)
        rate_name = cell.workload["rate_metric"]
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] == rate_name:
                metrics[rate_name] = {"value": win["work"] / win["seconds"], "unit": m["unit"]}
        notes.append(f"window: {win['steps']} steps, {win['work']} env steps in {win['seconds']!r} s")
        if "pace" in win:
            notes.append(win["pace"])
    else:
        from benchmark import tracing

        sink = {}
        with tracing.profiled(sink):
            win = driver.window(state, chunks=int(cell.workload["trace_length"]))
        tr = sink["trace"]
        view = {"trace": tr, "steps": win["steps"], "shape": driver.shape(state)}
        for m in cell.per_layer:
            reader = load_module(cell.root / "benchmark" / "metrics" / f"{m['name']}.py")
            value = reader.read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        for label, names in driver.kernel_names().items():
            notes.append(f"range {label}: {tr.range_calls(label)} calls, "
                         f"{tr.range_device_s(label)!r} device s; kernels named {names}: "
                         f"{tr.kernel_s(names)!r} s")
        notes.append(f"traced: {win['steps']} steps, {tr.launches} launch calls, "
                     f"{tr.device_ops} device operations, busy {tr.busy_s!r} of {tr.window_s!r} s")
        extra["breakdown"] = tr.breakdown()
    device = device_info(ctx.device, cell.chips)
    if ctx.trace:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
    gaps = driver.check(state)
    limits = cell.workload["limits"]
    checks = {k: {"value": gaps[k], "limit": limits[k]} for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return {"correct": correct, "attempted": win["attempted"], "failed": win["failed"],
            "metrics": metrics, "device": device, **extra, "notes": notes, "checks": checks}


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = find_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s), have {have}", file=sys.stderr)
        return 2
    res = run_cell(Ctx(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                       device="cuda", t_start=t_start))
    bad = forbidden_modules()
    if bad:
        print(f"modules that the benchmark may not load were loaded: {bad}", file=sys.stderr)
        return 3
    for note in res.pop("notes"):
        print(note, file=sys.stderr)
    print(f"card: {power_limit()}", file=sys.stderr)
    checks = res.pop("checks")
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    res["checks"] = checks
    print(json.dumps(res))
    return 0
