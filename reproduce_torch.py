#!/usr/bin/env python3
"""The KS rows of reproduce.py, run by the PyTorch port.

    python reproduce_torch.py [--cpu] [--te 200 --t-action 100]

Each row loads a shipped artifact as reproduce.py's row does (the checkpoint
read by `checkpoint.load`, its best actor else its current one,
`config_overrides.json` applied on the rows where reproduce.py applies it),
rolls the actor on the row's env (the plot_heat protocol: te=200, actuation
from t=100) and prints one JSON line with reproduce.py's keys: row, pre,
post, suppression, rounded as reproduce.py rounds them. On a CUDA device the
KS env steps through kernel K1; `--cpu` runs its plain version.
"""

import argparse
import dataclasses
import json
from pathlib import Path

ARTIFACTS = Path(__file__).resolve().parent / "artifacts"


def load_actor(preset_builder, path, device: str = "cuda"):
    """(setup, actor) as reproduce.py's `load_actor`: the checkpoint in
    `path`, its best actor else its current one."""
    from distributedconvrl_pde_control_torch.train import checkpoint

    setup = preset_builder()
    ts, hook = checkpoint.load(str(path), setup.agent, device=device)
    actor = (checkpoint.actor_from_jax(hook.best_actor).to(device) if hook.best_actor is not None
             else ts.agent.actor)
    return setup, actor


def suppression(setup, actor, te: float, t_action: float, ndigits=4) -> dict:
    """reproduce.py's `suppression`: mean |y| over the last 100 steps before
    actuation and over the last tenth of the run, and their ratio (the
    CLI's `suppression_of`), rounded to `ndigits` (None keeps them whole)."""
    from distributedconvrl_pde_control_torch.experiments.run import suppression_of
    from distributedconvrl_pde_control_torch.train.eval import actor_policy, rollout

    traces = rollout(setup.env, actor_policy(setup.agent, actor), te=te, t_action=t_action)
    s = suppression_of(traces["y"], t_action, setup.env.dt)
    out = {"pre": s["pre_control_mean_abs_dev"], "post": s["post_control_mean_abs_dev"],
           "suppression": s["suppression"]}
    return out if ndigits is None else {k: round(v, ndigits) for k, v in out.items()}


def ks_rows(device: str = "cuda"):
    """(row, setup, actor) of every KS row of reproduce.py, in its order;
    each artifact is loaded when its row comes."""
    from distributedconvrl_pde_control_torch.configs import ks as C
    from distributedconvrl_pde_control_torch.experiments.run import ks_setup
    from distributedconvrl_pde_control_torch.train.checkpoint import load_config_overrides

    def ks(cfg):
        """The setup builder of a KS config, mono or distributed as the CLI's
        preset table says."""
        return lambda: ks_setup(cfg, device=device)

    def art(name):
        return ARTIFACTS / name

    for row, name in (
        ("KS22 stabilization", "KS22"),
        ("KS22_tp (throughput-tier-trained) stabilization", "KS22_tp"),
        ("KS22_tp_lh (spectral-carry-tier-trained) stabilization", "KS22_tp_lh"),
        ("KS22_sf_lh (spectral-featurize-tier-trained) stabilization", "KS22_sf_lh"),
        ("KS22_tp_pop8 member 0 (fused 8-member study) stabilization", "KS22_tp_pop8/member_00"),
        ("KS22_popsearch winner (fused schedule search) stabilization", "KS22_popsearch"),
        ("KS22_batched_lh stabilization", "KS22_batched_lh"),
    ):
        yield (row, *load_actor(ks(C.KS22), art(name), device))

    yield ("KS22_global (mono, hand-tuned) stabilization",
           *load_actor(ks(C.KS22_GLOBAL), art("KS22_global"), device))
    wcfg = dataclasses.replace(C.KS22_GLOBAL,
                               **load_config_overrides(str(art("KS22_global_hyperopt"))))
    yield ("KS22_global (mono, hyperopt winner) stabilization",
           *load_actor(ks(wcfg), art("KS22_global_hyperopt"), device))
    dwcfg = dataclasses.replace(C.KS22, **load_config_overrides(str(art("KS22_hyperopt"))))
    yield ("KS22 (distributed, hyperopt winner) stabilization",
           *load_actor(ks(dwcfg), art("KS22_hyperopt"), device))

    _, actor200 = load_actor(ks(C.KS200), art("KS200"), device)
    s500 = ks(C.KS500)()
    sdist = ks(C.KS200_DISTURBED)()
    yield "KS200 -> KS500 transfer", s500, actor200
    yield "KS200 -> mu=0.02 disturbed", sdist, actor200
    _, actor200b = load_actor(ks(C.KS200), art("KS200_batched"), device)
    yield "KS200_batched -> KS500 transfer", s500, actor200b

    s200, actor200lh = load_actor(ks(C.KS200), art("KS200_batched_lh"), device)
    yield "KS200_batched_lh stabilization", s200, actor200lh
    yield "KS200_batched_lh -> KS500 transfer", s500, actor200lh
    yield "KS200_batched_lh -> mu=0.02 disturbed", sdist, actor200lh

    _, actor200p = load_actor(ks(C.KS200), art("KS200_pop8/member_00"), device)
    yield "KS200_pop8 member 0 stabilization", s200, actor200p
    yield "KS200_pop8 member 0 -> KS500 transfer", s500, actor200p
    yield "KS200_pop8 member 0 -> mu=0.02 disturbed", sdist, actor200p

    hw200cfg = dataclasses.replace(C.KS200, **load_config_overrides(str(art("KS200_hyperopt"))))
    yield ("KS200 (hyperopt winner) stabilization",
           *load_actor(ks(hw200cfg), art("KS200_hyperopt"), device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    ap.add_argument("--te", type=float, default=200.0, help="rollout horizon")
    ap.add_argument("--t-action", type=float, default=100.0, help="actuation start time")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    for row, setup, actor in ks_rows(device):
        print(json.dumps({"row": row, **suppression(setup, actor, args.te, args.t_action)}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
