#!/usr/bin/env python3
"""The KS, Keller-Segel and fluid rows of reproduce.py, run by the PyTorch port.

    python reproduce_torch.py [--cpu] [--te 200 --t-action 100] [--full]

Each row loads a shipped artifact as reproduce.py's row does (the checkpoint
read by `checkpoint.load`, its best actor else its current one,
`config_overrides.json` applied on the rows where reproduce.py applies it),
rolls the actor on the row's env and prints one JSON line with
reproduce.py's keys, rounded as reproduce.py rounds them, beside the JAX
package's value ("jax") and whether the row keeps its limit ("ok"):

  * the 20 KS rows: the plot_heat protocol (te=200, actuation from t=100;
    `--te`/`--t-action` change it), suppression within max(0.1 JAX, 0.0005);
  * the 5 Keller-Segel DDPG rows: te=12, actuation from t=4, from the JAX
    package's `random_init(PRNGKey(8))` field (shipped as data); |u - 1|
    before actuation within 1e-3 and over the last tenth within
    max(0.1 JAX, 0.0005);
  * the Keller-Segel PPO row: the shipped PPO controller's best params (the
    clipped mean action), te=12, actuation from t=6, from the JAX package's
    `random_init(PRNGKey(7))` field (shipped as data); the same limits;
  * with `--full`, the 5 fluid energy rows: te=2, the trained actor,
    corrected opposition control and no action, each mean energy within 2 %.

On a CUDA device the KS env steps through kernel K1; `--cpu` runs its plain
version. The Keller-Segel and fluid envs run no hand-written kernel.
"""

import argparse
import dataclasses
import json
from pathlib import Path

ARTIFACTS = Path(__file__).resolve().parent / "artifacts"

# The JAX package's values: `python reproduce.py --full` on the CPU (JAX 0.9.0, threefry
# keys), as it prints them (rounded to 4 digits, the fluid energies to 3).
JAX_KS_ROWS = {  # suppression
    "KS22 stabilization": 0.0158,
    "KS22_tp (throughput-tier-trained) stabilization": 0.0058,
    "KS22_tp_lh (spectral-carry-tier-trained) stabilization": 0.0024,
    "KS22_sf_lh (spectral-featurize-tier-trained) stabilization": 0.0024,
    "KS22_tp_pop8 member 0 (fused 8-member study) stabilization": 0.0024,
    "KS22_popsearch winner (fused schedule search) stabilization": 0.0024,
    "KS22_batched_lh stabilization": 0.0024,
    "KS22_global (mono, hand-tuned) stabilization": 1.0435,
    "KS22_global (mono, hyperopt winner) stabilization": 0.0967,
    "KS22 (distributed, hyperopt winner) stabilization": 0.0217,
    "KS200 -> KS500 transfer": 0.0777,
    "KS200 -> mu=0.02 disturbed": 0.0484,
    "KS200_batched -> KS500 transfer": 0.0083,
    "KS200_batched_lh stabilization": 0.0034,
    "KS200_batched_lh -> KS500 transfer": 0.0032,
    "KS200_batched_lh -> mu=0.02 disturbed": 0.0035,
    "KS200_pop8 member 0 stabilization": 0.0021,
    "KS200_pop8 member 0 -> KS500 transfer": 0.0011,
    "KS200_pop8 member 0 -> mu=0.02 disturbed": 0.0022,
    "KS200 (hyperopt winner) stabilization": 0.0212,
}
JAX_KELLER_SEGEL_ROWS = {  # mean |u - 1| before actuation and over the last tenth
    "KellerSegel10_16_fast regulation": {"pre": 0.4964, "post": 0.0256},
    "KellerSegel_pop8 member 3 regulation": {"pre": 0.4964, "post": 0.0077},
    "KellerSegel_popsearch_pop8 member 0 regulation": {"pre": 0.4964, "post": 0.0064},
    "KellerSegel_oodmin_pop8 member 0 regulation": {"pre": 0.4964, "post": 0.0064},
    "KellerSegel_oodpool_pop8 member 0 regulation": {"pre": 0.4964, "post": 0.007},
}
JAX_FLUID_ROWS = {  # mean energies over te=2
    "Fluid_8 energy": {"trained": 7.883, "corrected_negate": 7.613, "no_action": 8.731},
    "Fluid_8_batched energy": {"trained": 7.908, "corrected_negate": 7.613, "no_action": 8.731},
    "Fluid_8_tp energy": {"trained": 7.889, "corrected_negate": 7.613, "no_action": 8.731},
    "Fluid_16 energy": {"trained": 3.976, "corrected_negate": 5.357, "no_action": 7.84},
    "Fluid_32 energy": {"trained": 1.921, "corrected_negate": 4.577, "no_action": 8.843},
}
JAX_PPO_ROWS = {  # the same numbers of the PPO controller (reproduce.py:240-261)
    "KellerSegel10_16_ppo regulation": {"pre": 0.4903, "post": 0.2693},
}
KELLER_SEGEL_TE, KELLER_SEGEL_T_ACTION = 12.0, 4.0
PPO_T_ACTION = 6.0
FLUID_TE = 2.0


def ks_ok(got: float, want: float) -> bool:
    """A KS row's limit: |port - JAX| <= max(0.1 JAX, 0.0005) in suppression."""
    return abs(got - want) <= max(0.1 * want, 0.0005)


def keller_segel_ok(got: dict, want: dict) -> bool:
    """A Keller-Segel row's limits: pre within 1e-3, post within
    max(0.1 JAX, 0.0005)."""
    return (abs(got["pre"] - want["pre"]) <= 1e-3
            and abs(got["post"] - want["post"]) <= max(0.1 * want["post"], 0.0005))


def fluid_ok(got: dict, want: dict) -> bool:
    """A fluid row's limit: each of the three energies within 2 % of JAX's."""
    return all(abs(got[k] - want[k]) <= 0.02 * abs(want[k]) for k in want)


def load_actor(preset_builder, path, device: str = "cuda"):
    """(setup, actor) as reproduce.py's `load_actor`: the checkpoint in
    `path`, its best actor else its current one."""
    from distributedconvrl_pde_control_torch.train import checkpoint

    setup = preset_builder()
    return setup, checkpoint.load_actor(str(path), setup.agent, device=device)


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


def keller_segel_rows(device: str = "cuda"):
    """(row, setup, actor) of the Keller-Segel DDPG rows of reproduce.py, in
    its order, all on the KellerSegel10_16_fast env."""
    from distributedconvrl_pde_control_torch.configs.keller_segel import (
        KELLER_SEGEL_10_16_FAST,
        build_keller_segel,
    )

    setup = build_keller_segel(KELLER_SEGEL_10_16_FAST, device=device)
    for row, name in (
        ("KellerSegel10_16_fast regulation", "KellerSegel10_16_fast"),
        ("KellerSegel_pop8 member 3 regulation", "KellerSegel_pop8/member_03"),
        ("KellerSegel_popsearch_pop8 member 0 regulation", "KellerSegel_popsearch_pop8/member_00"),
        ("KellerSegel_oodmin_pop8 member 0 regulation", "KellerSegel_oodmin_pop8/member_00"),
        ("KellerSegel_oodpool_pop8 member 0 regulation", "KellerSegel_oodpool_pop8/member_00"),
    ):
        yield (row, *load_actor(lambda: setup, ARTIFACTS / name, device))


def regulation(setup, actor, te: float = KELLER_SEGEL_TE, t_action: float = KELLER_SEGEL_T_ACTION,
               ndigits=4) -> dict:
    """reproduce.py's Keller-Segel score: the actor rolled from the JAX
    package's `random_init(PRNGKey(8))` field, mean |u - 1| over the 100
    steps before actuation and over the last tenth (`eval.regulation_of`)."""
    import torch

    from distributedconvrl_pde_control_torch.configs.keller_segel import keller_segel_y0_key8
    from distributedconvrl_pde_control_torch.train.eval import actor_policy, regulation_of, rollout

    y0 = torch.as_tensor(keller_segel_y0_key8(), device=setup.env.y0.device)
    traces = rollout(setup.env, actor_policy(setup.agent, actor), y0=y0, te=te, t_action=t_action)
    out = regulation_of(traces["y"], t_action, setup.env.dt)
    return out if ndigits is None else {k: round(v, ndigits) for k, v in out.items()}


def load_ppo_policy(setup, path, device: str = "cuda"):
    """The deterministic policy of the PPO checkpoint in `path` as the CLI's
    `--eval --ppo` builds it: its best params, else its current ones."""
    from distributedconvrl_pde_control_torch.agents.ppo import (
        PPOAgent,
        params_from_numpy,
        ppo_policy,
        tuned_config,
    )
    from distributedconvrl_pde_control_torch.train import checkpoint

    acfg = setup.agent.cfg
    agent = PPOAgent(tuned_config(acfg.ns, acfg.na_rows))
    pstate, info = checkpoint.load_ppo(str(path), agent, device=device)
    params = (params_from_numpy(info["best_params"], device) if info.get("best_params")
              else agent._params(pstate))
    return ppo_policy(agent, params)


def ppo_rows(device: str = "cuda"):
    """(row, setup, policy) of reproduce.py's PPO row: the KellerSegel10_16_ppo
    controller on the KellerSegel10_16_fast env."""
    from distributedconvrl_pde_control_torch.configs.keller_segel import (
        KELLER_SEGEL_10_16_FAST,
        build_keller_segel,
    )

    setup = build_keller_segel(KELLER_SEGEL_10_16_FAST, device=device)
    yield ("KellerSegel10_16_ppo regulation", setup,
           load_ppo_policy(setup, ARTIFACTS / "KellerSegel10_16_ppo", device))


def ppo_regulation(setup, policy, te: float = KELLER_SEGEL_TE, t_action: float = PPO_T_ACTION,
                   ndigits=4) -> dict:
    """reproduce.py's PPO row: the policy rolled from the JAX package's
    `random_init(PRNGKey(7))` field, mean |u - 1| over the 100 steps before
    actuation and over the last tenth."""
    import torch

    from distributedconvrl_pde_control_torch.configs.keller_segel import keller_segel_y0_key7
    from distributedconvrl_pde_control_torch.train.eval import regulation_of, rollout

    y0 = torch.as_tensor(keller_segel_y0_key7(), device=setup.env.y0.device)
    traces = rollout(setup.env, policy, y0=y0, te=te, t_action=t_action)
    out = regulation_of(traces["y"], t_action, setup.env.dt)
    return out if ndigits is None else {k: round(v, ndigits) for k, v in out.items()}


def fluid_rows(device: str = "cuda"):
    """(row, setup, actor) of the fluid energy rows of reproduce.py --full:
    every artifact on its preset's single-device env (128^2, adaptive RK4)."""
    from distributedconvrl_pde_control_torch.configs import fluid as F

    for name, cfg in (("Fluid_8", F.FLUID_8), ("Fluid_8_batched", F.FLUID_8),
                      ("Fluid_8_tp", F.FLUID_8), ("Fluid_16", F.FLUID_16),
                      ("Fluid_32", F.FLUID_32)):
        yield (f"{name} energy",
               *load_actor(lambda cfg=cfg: F.build_fluid(cfg, device=device), ARTIFACTS / name,
                           device))


def fluid_energies(setup, actor, te: float = FLUID_TE, ndigits=3) -> dict:
    """reproduce.py's fluid row: the masked mean energies of the trained
    actor, corrected opposition control and no action over te."""
    from distributedconvrl_pde_control_torch.agents.policies import (
        NegatePolicy,
        ZeroPolicy,
        negate_center_row,
    )
    from distributedconvrl_pde_control_torch.train.eval import actor_policy, energy_eval

    env = setup.env
    out = {"trained": energy_eval(env, actor_policy(setup.agent, actor), te=te)["mean_energy"],
           "corrected_negate": energy_eval(env, NegatePolicy(
               env.action_shape, center_row=negate_center_row(env.featurize)), te=te)["mean_energy"],
           "no_action": energy_eval(env, ZeroPolicy(env.action_shape), te=te)["mean_energy"]}
    return out if ndigits is None else {k: round(v, ndigits) for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    ap.add_argument("--te", type=float, default=200.0, help="rollout horizon of the KS rows")
    ap.add_argument("--t-action", type=float, default=100.0,
                    help="actuation start time of the KS rows")
    ap.add_argument("--full", action="store_true", help="add the fluid energy rows")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    for row, setup, actor in ks_rows(device):
        got = suppression(setup, actor, args.te, args.t_action)
        want = JAX_KS_ROWS[row]
        print(json.dumps({"row": row, **got, "jax": want, "ok": ks_ok(got["suppression"], want)}),
              flush=True)
    for row, setup, actor in keller_segel_rows(device):
        got, want = regulation(setup, actor), JAX_KELLER_SEGEL_ROWS[row]
        print(json.dumps({"row": row, **got, "jax": want, "ok": keller_segel_ok(got, want)}),
              flush=True)
    for row, setup, policy in ppo_rows(device):
        got, want = ppo_regulation(setup, policy), JAX_PPO_ROWS[row]
        print(json.dumps({"row": row, **got, "jax": want, "ok": keller_segel_ok(got, want)}),
              flush=True)
    if args.full:
        for row, setup, actor in fluid_rows(device):
            got, want = fluid_energies(setup, actor), JAX_FLUID_ROWS[row]
            print(json.dumps({"row": row, **got, "jax": want, "ok": fluid_ok(got, want)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
