"""Control-loop serving probe: deploy a trained controller and measure its
closed-loop latency.

Counterpart of ``distributedconvrl_pde_control_tpu/experiments/serve.py``.
The deployment of a PDE controller is a real-time loop: sensors in, actuator
commands out, every dt (0.1 s for KS, 20 ms for the fluid rig). This probe
loads a checkpoint, builds the minimal `obs -> action` program (featurize +
shared-MLP actor, no exploration), steps it `--steps` times, each step timed
to the end of its device work, and prints one JSON line: the latency's p50
and p99 in ms, the control interval and the headroom (interval / p99).

    python -m distributedconvrl_pde_control_torch.experiments.serve KS22 \\
        --load-from artifacts/KS22 [--cpu]
    python -m distributedconvrl_pde_control_torch.experiments.serve KS22 \\
        --from-export build/ks22_ctrl [--cpu]

With `--from-export` it times the exported program
(`experiments/export_controller.py`) instead of the checkpoint's: only the
program and its manifest are read, and zero inputs of the manifest's shapes
drive it. The checkpoint path applies the run directory's
config_overrides.json, as every `run.py` mode that takes --load-from does.
It runs on the card unless --cpu is given.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def control_step_from_checkpoint(preset: str, load_from: str, device: str):
    """(control_step, y, obs, dt) of the checkpoint in `load_from`: the
    preset's setup (the run's config overrides applied), its best actor else
    its current one, and the env's reset state."""
    import dataclasses

    from distributedconvrl_pde_control_torch.experiments.export_controller import (
        build_control_step,
    )
    from distributedconvrl_pde_control_torch.experiments.run import build_setup, preset_config
    from distributedconvrl_pde_control_torch.train import checkpoint

    cfg = preset_config(preset)
    overrides = checkpoint.load_config_overrides(load_from)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    setup = build_setup(cfg, device=device)
    actor = checkpoint.load_actor(load_from, setup.agent, device=device)
    est = setup.env.reset()
    return build_control_step(setup, actor), est.y, est.obs, setup.env.dt


def probe(control_step, y, obs, steps: int) -> np.ndarray:
    """Latencies in ms of `steps` control steps after one warm-up call, each
    read after the device has finished it."""
    sync = torch.cuda.synchronize if y.is_cuda else (lambda: None)
    with torch.no_grad():
        control_step(y, obs)
        sync()
        lat = []
        for _ in range(steps):
            t0 = time.perf_counter()
            _, obs = control_step(y, obs)
            sync()
            lat.append(time.perf_counter() - t0)
    return np.asarray(lat) * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("preset")
    ap.add_argument("--load-from", help="run directory of the checkpoint to serve")
    ap.add_argument("--from-export", metavar="DIR",
                    help="serve an exported controller (export_controller.py): only the program "
                         "and its manifest are read")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    args = ap.parse_args(argv)
    if not (args.load_from or args.from_export):
        ap.error("one of --load-from / --from-export is required")
    device = "cpu" if args.cpu else "cuda"

    if args.from_export:
        from distributedconvrl_pde_control_torch.experiments.export_controller import (
            load_exported,
        )

        control_step, manifest = load_exported(args.from_export, device=device)
        y, obs = (torch.zeros(a["shape"], dtype=getattr(torch, a["dtype"]), device=device)
                  for a in manifest["args"])
        dt = manifest["control_interval_s"]
    else:
        control_step, y, obs, dt = control_step_from_checkpoint(args.preset, args.load_from,
                                                                device)
    lat = probe(control_step, y, obs, args.steps)
    p99 = float(np.percentile(lat, 99))
    print(json.dumps({
        "preset": args.preset,
        "latency_ms_p50": round(float(np.percentile(lat, 50)), 3),
        "latency_ms_p99": round(p99, 3),
        "control_interval_ms": dt * 1e3,
        "headroom_x": round(dt * 1e3 / p99, 1),
    }))


if __name__ == "__main__":
    main()
