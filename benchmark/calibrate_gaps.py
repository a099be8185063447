#!/usr/bin/env python3
"""`calibrate.py`'s readings of a train cell whose driver decides `correct`
with gaps of its own (`driver.gaps(prog, ref)`, as the Keller-Segel driver's
scaled `loss`): over a list of seeds, the gaps of the program's compared
steps, of the control (the reference with its matrix products in TF32) and
of the half-batch learner, each against the float32 reference. One JSON
line per seed; the largest program reading and the smallest control and
fault readings last.

    python3 benchmark/calibrate_gaps.py --workload <cell> --seeds 1,2,3
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def train_readings(driver, ctx) -> dict:
    cfg, wl = ctx.cell.config, ctx.cell.workload
    trainer, st, inputs, prog, _ = driver.build(ctx)
    del trainer, st
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    ref = driver.reference(cfg, wl, inputs)
    return {"program": driver.gaps(prog, ref),
            "control": driver.gaps(driver.reference(cfg, wl, inputs, "tf32"), ref),
            "half_batch": driver.gaps(driver.reference(cfg, wl, inputs, fault="half_batch"), ref)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload)
    driver = harness.load_module(cell.root / "benchmark" / "drivers" / f"{cell.workload['driver']}.py")
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Ctx(cell=cell, seed=seed, seconds=0.0, trace=False, device="cuda",
                          t_start=time.perf_counter())
        t0 = time.perf_counter()
        rows.append(train_readings(driver, ctx))
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t0, **rows[-1]}), flush=True)
    summary = {"cell": cell.name, "seeds": len(rows), "card": harness.power_limit()}
    for kind, pick in (("program", max), ("control", min), ("half_batch", min)):
        summary[kind] = {k: pick(r[kind][k] for r in rows) for k in rows[0][kind]}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
