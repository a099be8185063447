#!/usr/bin/env python3
"""Evaluate a Keller-Segel population's members on the unseen-init protocol,
in the PyTorch port.

    python eval_kss_pop_torch.py [--cpu] [pop_dir] [n_members] [seeds...]

defaults: artifacts/KellerSegel_popsearch_pop8 8 7 8 9 10. The counterpart of
eval_kss_pop.py: each member's best actor (else its current one) rolled on
the KellerSegel10_16_fast env for te=12 with actuation from t=4, from the
JAX package's `random_init(PRNGKey(seed))` fields (keys 7-10 ship as data:
`configs.keller_segel.keller_segel_y0_key`); one JSON line per member with
eval_kss_pop.py's keys: the post-control mean |u - 1| over the last tenth
(`seed{s}`) and its ratio to the 100 steps before actuation
(`seed{s}_supp`), rounded as eval_kss_pop.py rounds them. A member's seeds
roll as one batch of envs (`train.eval.rollouts`), each env as it would
alone. It runs on the card unless --cpu is given.
"""

import argparse
import json

KELLER_SEGEL_TE, KELLER_SEGEL_T_ACTION = 12.0, 4.0


def member_row(setup, actor, seeds, te: float = KELLER_SEGEL_TE,
               t_action: float = KELLER_SEGEL_T_ACTION) -> dict:
    """{seed: {"pre", "post"}} of one member: the mean |u - 1| over the 100
    steps before actuation and over the last tenth, unrounded."""
    import numpy as np
    import torch

    from distributedconvrl_pde_control_torch.configs.keller_segel import keller_segel_y0_key
    from distributedconvrl_pde_control_torch.train.eval import actor_policy, regulation_of, rollouts

    device = setup.env.y0.device
    y0s = torch.as_tensor(np.stack([keller_segel_y0_key(s) for s in seeds]), device=device)
    traces = rollouts(setup.env, actor_policy(setup.agent, actor), y0s, te=te, t_action=t_action)
    return {s: regulation_of(traces["y"][:, i], t_action, setup.env.dt)
            for i, s in enumerate(seeds)}


def evaluate(pop_dir: str, n: int, seeds, device: str = "cuda"):
    """(member, {seed: {"pre", "post"}}) of the first `n` members of the
    population in `pop_dir`, in order."""
    from distributedconvrl_pde_control_torch.configs.keller_segel import (
        KELLER_SEGEL_10_16_FAST,
        build_keller_segel,
    )
    from distributedconvrl_pde_control_torch.train import checkpoint

    setup = build_keller_segel(KELLER_SEGEL_10_16_FAST, device=device)
    for i in range(n):
        actor = checkpoint.load_actor(f"{pop_dir}/member_{i:02d}", setup.agent, device=device)
        yield i, member_row(setup, actor, seeds)


def printed_row(member: int, row: dict) -> dict:
    """eval_kss_pop.py's line of a member."""
    out = {"member": member}
    for s, r in row.items():
        out[f"seed{s}"] = round(r["post"], 4)
        out[f"seed{s}_supp"] = round(r["post"] / r["pre"], 4) if r["pre"] else None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("pop_dir", nargs="?", default="artifacts/KellerSegel_popsearch_pop8")
    ap.add_argument("n_members", nargs="?", type=int, default=8)
    ap.add_argument("seeds", nargs="*", type=int, default=[7, 8, 9, 10])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    args = ap.parse_args(argv)
    for i, row in evaluate(args.pop_dir, args.n_members, args.seeds or [7, 8, 9, 10],
                           "cpu" if args.cpu else "cuda"):
        print(json.dumps(printed_row(i, row)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
