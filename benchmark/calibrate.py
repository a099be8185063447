#!/usr/bin/env python3
"""The readings that a cell's limits are set from: over a list of seeds, the
gaps of the program (sound runs), of the control (the reference put in the
program's place with its matrix products in TF32, the precision below the
configuration's float32) and, in the train cells, of a planted fault (the
reference's learner taking the mean over half of each batch), each against
the float32 reference. One JSON line per seed; the largest program reading
and the smallest control and fault readings last.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds S]

Train cells run set-up's compared steps alone; the control cell runs its
window for --seconds at the cell's own load, as a run does. The functions
run on the CPU too (`tests/test_harness_control.py`, at tiny sizes).
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

from benchmark import compare, harness  # noqa: E402


def train_readings(driver, ctx) -> dict:
    cfg, wl = ctx.cell.config, ctx.cell.workload
    trainer, st, inputs, prog, _ = driver.build(ctx)
    del trainer, st
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    ref = driver.reference(cfg, wl, inputs)
    out = {"program": compare.train_gaps(prog, ref)}
    out["control"] = compare.train_gaps(driver.reference(cfg, wl, inputs, "tf32"), ref)
    out["half_batch"] = compare.train_gaps(driver.reference(cfg, wl, inputs, fault="half_batch"),
                                           ref)
    return out


def control_readings(driver, ctx) -> dict:
    state = driver.setup(ctx)
    driver.window(state, seconds=ctx.seconds)
    samples, prog_start, y0, inputs = state.samples, state.prog_start, state.y0, state.inputs
    out = {"program": driver.check(state), "samples": len(samples)}
    cfg = ctx.cell.config
    n = len(prog_start["action"])
    ref_steps, ref_start = driver.reference(cfg, inputs, samples, y0, n)
    tf_steps, tf_start = driver.reference(cfg, inputs, samples, y0, n, "tf32")
    out["control"] = compare.control_gaps(tf_steps, ref_steps, tf_start, ref_start)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload)
    driver = harness.load_module(cell.root / "benchmark" / "drivers" / f"{cell.workload['driver']}.py")
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Ctx(cell=cell, seed=seed, seconds=args.seconds, trace=False, device="cuda",
                          t_start=time.perf_counter())
        t0 = time.perf_counter()
        reading = (control_readings if cell.workload["driver"].startswith("control")
                   else train_readings)(driver, ctx)
        rows.append(reading)
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t0, **reading}), flush=True)
    summary = {"cell": cell.name, "seeds": len(rows), "card": harness.power_limit()}
    for kind, pick in (("program", max), ("control", min), ("half_batch", min)):
        if kind in rows[0]:
            summary[kind] = {k: pick(r[kind][k] for r in rows) for k in rows[0][kind]}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
