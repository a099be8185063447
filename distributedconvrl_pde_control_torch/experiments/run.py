"""Command-line entry point: evaluate a trained controller.

Counterpart of two `--eval` branches of
``distributedconvrl_pde_control_tpu/experiments/run.py``.

KS presets (the plot_heat protocol, without plots):

    python -m distributedconvrl_pde_control_torch.experiments.run KS22 --eval \\
        --load-from artifacts/KS22 --p-te 200 --p-t-action 100 [--cpu]

loads the best actor of the run in --load-from, rolls it on the preset's env
from the standard initial field, and prints one JSON line with the mean |y|
over the last 100 uncontrolled steps, over the last tenth of the run, and
their ratio.

Fluid presets on the 2/3-rule solver (`run_sharded`, the sharded testrun):

    python -m distributedconvrl_pde_control_torch.experiments.run Fluid_16_256 --eval \\
        --mesh 1x1 --load-from artifacts/Fluid_16_256 [--p-te 2] [--n-envs 1] [--cpu]

rolls the best actor and a no-action baseline from the preset's evaluation
field and prints one JSON line with the mesh, the grid and the two mean
energies sum|omega|/n^2 over the active steps.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

# suffix tiers derivable from any fluid base preset:
#   _fast      = integrating-factor RK4 throughput tier
#   _tp        = _fast + the reference's bf16 transform tiers (named here so that the
#                CLI can say they are not ported; it refuses them)
#   _fixedstep = the reference's do_step fixed-step RK4 (FluidSetup.jl:163-172;
#                the single-grid presets default to the adaptive do_step2)
#   _eval      = evaluation protocol (nx=256, seed 76; FluidSetup.jl:32-37)
_FLUID_TIERS = {
    "_fast": dict(adaptive=False, stepper="ifrk4"),
    "_tp": dict(adaptive=False, stepper="ifrk4", fft_mode="matmul_hi",
                nl_fft_mode="matmul_fast"),
    "_fixedstep": dict(adaptive=False),
    "_eval": dict(evaluation=True),
}


def fluid_config_for(name: str):
    """The FluidConfig behind a fluid preset name - base presets plus any
    `_fast`/`_tp`/`_fixedstep`/`_eval` tier of them; None for other names."""
    from distributedconvrl_pde_control_torch.configs.fluid import PRESETS

    if name in PRESETS:
        return PRESETS[name]
    for suffix, over in _FLUID_TIERS.items():
        if name.endswith(suffix) and name[: -len(suffix)] in PRESETS:
            return dataclasses.replace(PRESETS[name[: -len(suffix)]], name=name, **over)
    return None


def run_sharded(args, cfg, device: str) -> None:
    """`--mesh DPxSP` path: the fluid preset evaluates on the 2/3-rule
    solver (parallel.multichip) - trained policy vs no action, mean energies
    over the active steps."""
    from distributedconvrl_pde_control_torch.parallel.multichip import (
        ShardedFluidTrainer,
        ShardedTrainConfig,
        load_actor_for_eval,
    )

    if args.nx:
        cfg = dataclasses.replace(cfg, nx=args.nx)
    if args.horizon:
        cfg = dataclasses.replace(cfg, te=args.horizon)
    try:
        dp, sp = (int(x) for x in args.mesh.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh wants DPxSP (e.g. 1x1), got {args.mesh!r}")
    if (dp, sp) != (1, 1):
        raise SystemExit(f"--mesh {dp}x{sp}: the port runs --mesh 1x1 only; meshes of several "
                         "devices are not ported yet (ROADMAP.md queue 1 item 15)")
    trainer = ShardedFluidTrainer(cfg, (dp, sp), ShardedTrainConfig(n_envs=args.n_envs or dp),
                                  device=device)
    actor = load_actor_for_eval(args.load_from, trainer)
    n_steps = int(round((args.p_te or cfg.te) / cfg.dt))
    t_act = int(round((args.p_t_action or 0.0) / cfg.dt))
    w0 = trainer.eval_w0()
    energies = {}
    for label, ta in [("trained", t_act), ("no action", n_steps)]:
        recs = trainer.make_eval_fn(n_steps, t_action_steps=ta)(actor, w0)
        e, m = recs["energy"], recs["active"]
        energies[label] = float(e[m].mean()) if m.any() else float("nan")
    print(json.dumps({"mesh": f"{dp}x{sp}", "grid": cfg.grid_nx, **energies}))


def run_ks(args, cfg, device: str) -> None:
    from distributedconvrl_pde_control_torch.configs.ks import build_ks
    from distributedconvrl_pde_control_torch.train.checkpoint import actor_from_jax, load_best_actor
    from distributedconvrl_pde_control_torch.train.eval import actor_policy, rollout

    p_te = 200.0 if args.p_te is None else args.p_te
    t_action = p_te / 2.0 if args.p_t_action is None else args.p_t_action
    setup = build_ks(cfg, device=device)
    actor = actor_from_jax(load_best_actor(args.load_from)).to(device)
    traces = rollout(setup.env, actor_policy(setup.agent, actor), te=p_te, t_action=t_action)
    y = traces["y"]
    n_steps = y.shape[0]
    act_start = int(round(t_action / setup.env.dt))
    pre = float(np.abs(y[max(0, act_start - 100):act_start]).mean())
    post = float(np.abs(y[-max(1, n_steps // 10):]).mean())
    print(json.dumps({"pre_control_mean_abs_dev": pre, "post_control_mean_abs_dev": post,
                      "suppression": post / pre if pre else None}))


def main(argv=None):
    from distributedconvrl_pde_control_torch.configs.fluid import PRESETS as FLUID_PRESETS
    from distributedconvrl_pde_control_torch.configs.ks import PRESETS as KS_PRESETS

    fluid_names = sorted(FLUID_PRESETS) + sorted(b + s for b in FLUID_PRESETS for s in _FLUID_TIERS)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("preset", choices=sorted(KS_PRESETS) + fluid_names, metavar="preset",
                    help="a KS preset (%s) or a fluid preset (%s, each with an optional "
                         "_fast/_fixedstep/_eval tier)" % (", ".join(sorted(KS_PRESETS)),
                                                           ", ".join(sorted(FLUID_PRESETS))))
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--eval", action="store_true", help="evaluate a trained actor")
    mode.add_argument("--train", action="store_true", help="(training is not ported yet)")
    ap.add_argument("--load-from", required=True, help="run directory holding saves/hook.npz")
    ap.add_argument("--p-te", type=float, default=None,
                    help="eval horizon (default 200 for KS presets, the preset's te for fluid)")
    ap.add_argument("--p-t-action", type=float, default=None,
                    help="actuation start time (default p_te/2 for KS presets, 0 for fluid)")
    ap.add_argument("--mesh", default=None,
                    help="evaluate a fluid preset on the 2/3-rule solver over a DPxSP mesh; "
                         "only 1x1 so far")
    ap.add_argument("--n-envs", type=int, default=None,
                    help="env batch for --mesh runs (default: dp)")
    ap.add_argument("--nx", type=int, default=None,
                    help="override the fluid grid size for --mesh runs")
    ap.add_argument("--horizon", type=float, default=None,
                    help="override the episode horizon te for --mesh runs")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    if args.train:
        raise SystemExit("--train: training is not ported yet (ROADMAP.md queue 1 items 7-8; "
                         "sharded fluid training is item 15); the port evaluates with --eval")
    fluid_cfg = fluid_config_for(args.preset)
    if fluid_cfg is not None:
        if fluid_cfg.fft_mode != "auto" or fluid_cfg.nl_fft_mode is not None:
            raise SystemExit(f"{args.preset}: the reduced-precision transform tiers are not "
                             "ported yet (ROADMAP.md queue 1 item 16); the port runs the "
                             "float32 tiers (the base presets, _fast, _fixedstep, _eval)")
        if not args.mesh:
            raise SystemExit(
                f"{args.preset} without --mesh needs the single-device fluid env (NSSolver, "
                "ROADMAP.md queue 1 item 13), which is not ported yet; pass --mesh 1x1 for "
                "the 2/3-rule solver")
        return run_sharded(args, fluid_cfg, device)
    if args.mesh:
        raise SystemExit(f"--mesh supports fluid presets, not {args.preset}")
    return run_ks(args, KS_PRESETS[args.preset], device)


if __name__ == "__main__":
    main()
