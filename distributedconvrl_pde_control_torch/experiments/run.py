"""Command-line entry point: evaluate a trained KS controller.

Counterpart of the KS DDPG `--eval` branch of
``distributedconvrl_pde_control_tpu/experiments/run.py`` (the plot_heat
protocol, without plots):

    python -m distributedconvrl_pde_control_torch.experiments.run KS22 --eval \\
        --load-from artifacts/KS22 --p-te 200 --p-t-action 100 [--cpu]

Loads the best actor of the run in --load-from, rolls it on the preset's env
from the standard initial field, and prints one JSON line with
the mean |y| over the last 100 uncontrolled steps, over the last tenth of
the run, and their ratio.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None):
    from distributedconvrl_pde_control_torch.configs.ks import PRESETS, build_ks
    from distributedconvrl_pde_control_torch.train.checkpoint import actor_from_jax, load_best_actor
    from distributedconvrl_pde_control_torch.train.eval import actor_policy, rollout

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("preset", choices=sorted(PRESETS))
    ap.add_argument("--eval", action="store_true", required=True,
                    help="evaluate a trained actor (the only mode ported so far)")
    ap.add_argument("--load-from", required=True, help="run directory holding saves/hook.npz")
    ap.add_argument("--p-te", type=float, default=200.0, help="eval horizon (plot_heat p_te)")
    ap.add_argument("--p-t-action", type=float, default=None,
                    help="actuation start time (default p_te/2)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    args = ap.parse_args(argv)
    t_action = args.p_te / 2.0 if args.p_t_action is None else args.p_t_action
    device = "cpu" if args.cpu else "cuda"

    cfg = PRESETS[args.preset]
    setup = build_ks(cfg, device=device)
    actor = actor_from_jax(load_best_actor(args.load_from)).to(device)
    traces = rollout(setup.env, actor_policy(setup.agent, actor), te=args.p_te,
                     t_action=t_action)
    y = traces["y"]
    n_steps = y.shape[0]
    act_start = int(round(t_action / setup.env.dt))
    pre = float(np.abs(y[max(0, act_start - 100):act_start]).mean())
    post = float(np.abs(y[-max(1, n_steps // 10):]).mean())
    print(json.dumps({"pre_control_mean_abs_dev": pre, "post_control_mean_abs_dev": post,
                      "suppression": post / pre if pre else None}))


if __name__ == "__main__":
    main()
