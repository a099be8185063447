#!/usr/bin/env python3
"""Evaluate a fluid population's members on the standard energy protocol, in
the PyTorch port.

    python eval_fluid_pop_torch.py [--cpu] [pop_dir] [preset] [n_members]

defaults: artifacts/Fluid_8_tp_pop8 Fluid_8 8. The counterpart of
eval_fluid_pop.py: one te=6 rollout per member on the preset's standard
single-device env (adaptive RK4 on the 3/2-rule solver) from its initial
field, reporting the mean energy sum|omega|/(nx*ny) over the te=2 / te=3 /
te=6 prefixes of the active steps and the mean step reward, then the
corrected-opposition and no-action baselines from the same field; one JSON
line each with eval_fluid_pop.py's keys, rounded as it rounds them. The
members and the baselines roll as one batch of envs, each with its own policy
(`train.eval.per_env_policy`) and its own adaptive step control, as it would
alone. It runs on the card unless --cpu is given.
"""

import argparse
import json

TE = 6.0
PREFIXES = (2.0, 3.0, 6.0)


def prefix_means(energy, active, dt: float, tes=PREFIXES) -> dict:
    """Mean energy over the active steps of each te prefix, unrounded (None
    when a prefix has no active step)."""
    import numpy as np

    e, m = np.asarray(energy), np.asarray(active, bool)
    out = {}
    for te in tes:
        n = min(int(round(te / dt)), len(e))
        out[f"te{te:g}"] = float(e[:n][m[:n]].mean()) if m[:n].any() else None
    return out


def evaluate(pop_dir: str, preset: str, n: int, device: str = "cuda", te: float = TE,
             tes=PREFIXES, config_overrides=None) -> list:
    """[(label, row)] of the first `n` members of the population in `pop_dir`
    and of the two baselines: row = the prefix means and, for members, the
    mean step reward over the active steps, unrounded. `config_overrides`
    replace fields of the preset's config (a smaller grid, say)."""
    import dataclasses

    import numpy as np
    import torch

    from distributedconvrl_pde_control_torch.agents.policies import (
        NegatePolicy,
        ZeroPolicy,
        negate_center_row,
    )
    from distributedconvrl_pde_control_torch.experiments.run import build_setup, preset_config
    from distributedconvrl_pde_control_torch.train import checkpoint
    from distributedconvrl_pde_control_torch.train.eval import (
        actor_policy,
        energy_trace,
        per_env_policy,
        rollouts,
    )

    setup = build_setup(dataclasses.replace(preset_config(preset), **(config_overrides or {})),
                        device=device)
    env = setup.env
    policies = [actor_policy(setup.agent, checkpoint.load_actor(f"{pop_dir}/member_{i:02d}",
                                                                setup.agent, device=device))
                for i in range(n)]
    policies += [NegatePolicy(env.action_shape, center_row=negate_center_row(env.featurize)),
                 ZeroPolicy(env.action_shape)]
    labels = [("member", i) for i in range(n)] + [("baseline", "negate"),
                                                   ("baseline", "no_action")]
    y0s = env.y0[None].expand((len(policies),) + tuple(env.y0.shape)).contiguous()
    tr = rollouts(env, per_env_policy(policies), y0s, te=te)
    rows = []
    for i, label in enumerate(labels):
        active = tr["active"][:, i]
        row = prefix_means(energy_trace(tr["y"][:, i]), active, env.dt, tes)
        if label[0] == "member":
            row["mean_step_reward"] = float(np.asarray(tr["reward"][:, i])[active].mean())
        rows.append((label, row))
    return rows


def printed_row(label: tuple, row: dict) -> dict:
    """eval_fluid_pop.py's line: prefix means to 3 digits, the mean step
    reward to 5."""
    out = {label[0]: label[1]}
    for k, v in row.items():
        out[k] = None if v is None else round(v, 5 if k == "mean_step_reward" else 3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("pop_dir", nargs="?", default="artifacts/Fluid_8_tp_pop8")
    ap.add_argument("preset", nargs="?", default="Fluid_8")
    ap.add_argument("n_members", nargs="?", type=int, default=8)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    args = ap.parse_args(argv)
    for label, row in evaluate(args.pop_dir, args.preset, args.n_members,
                               "cpu" if args.cpu else "cuda"):
        print(json.dumps(printed_row(label, row)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
