#!/usr/bin/env python3
"""Ops the port dispatches per unit of work, counted on the CPU.

    python launch_counts.py

On the card nearly every dispatched op that is not a view is one kernel
launch, and the port's train steps are bound by the host's launch rate
(PERF.md), so these counts, made without a card, predict the card's launches
and, at a given time per launch, its step times. K1's plain version stands in
for the kernel on the CPU and counts as one op. Prints one JSON line: the ops
of one PPO iteration on KS22 at 8 envs (the tuned and the reference config;
and the rollout with GAE alone), of one deterministic PPO eval step, and of
one train step of the sf tier, solo and as a population of 8 members (the
counts do not depend on the env width). On the CPU the solo step's Adam is
torch's unfused form, which the card replaces by one fused launch per
optimizer.
"""

import dataclasses
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from distributedconvrl_pde_control_torch.agents.ppo import (
    PPOAgent,
    PPOConfig,
    PPOTrainer,
    tuned_config,
)
from distributedconvrl_pde_control_torch.configs.ks import KS22, build_ks
from distributedconvrl_pde_control_torch.train.batched import BatchedTrainer, BatchedTrainerConfig
from distributedconvrl_pde_control_torch.train.population import PopulationTrainer

VIEWS = {"view", "_unsafe_view", "permute", "t", "transpose", "expand", "slice", "select",
         "unsqueeze", "squeeze", "as_strided", "detach", "alias", "reshape", "unbind", "split",
         "split_with_sizes", "lift_fresh", "_reshape_alias", "view_as_real", "view_as_complex"}
SF = dict(stepper="etdrk4", spectral_carry=True, spectral_featurize=True)


class OpCount(TorchDispatchMode):
    """Counts the non-view ops dispatched while `on`."""

    def __init__(self):
        super().__init__()
        self.n, self.on = 0, True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.on and func.__name__.split(".")[0] not in VIEWS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def k1_as_one(env, count: OpCount):
    """The env with its solver step counted as one op (K1's one launch)."""
    step = env.step_fn

    def step_fn(y, forcing):
        count.on = False
        try:
            return step(y, forcing)
        finally:
            count.on, count.n = True, count.n + 1

    return dataclasses.replace(env, step_fn=step_fn)


def ppo_counts(pcfg_fn) -> dict:
    setup = build_ks(KS22, device="cpu")
    agent = PPOAgent(pcfg_fn(setup.agent.cfg.ns))
    gen = torch.Generator().manual_seed(0)
    state = agent.init_state(gen, "cpu")
    out = {}
    for label, skip_update in (("iteration", False), ("rollout_and_gae", True)):
        count = OpCount()
        trainer = PPOTrainer(k1_as_one(setup.env, count), agent, n_envs=8,
                             random_init=setup.random_init)
        update = agent.update
        if skip_update:
            def quiet_update(*a, **k):
                count.on = False
                try:
                    return update(*a, **k)
                finally:
                    count.on = True

            agent.update = quiet_update
        with count:
            trainer.make_train_iter()(state, gen)
        agent.update = update
        out[label] = count.n
    count = OpCount()
    trainer = PPOTrainer(k1_as_one(setup.env, count), agent, n_envs=8,
                         random_init=setup.random_init)
    with count:
        trainer.eval_mean_reward(agent._params(state), 20)
    out["eval_step"] = count.n / 20
    return out


def train_step_counts() -> dict:
    sf = build_ks(dataclasses.replace(KS22, **SF), device="cpu")
    pool = sf.random_init(torch.Generator().manual_seed(1), 32)
    out = {}
    for label, trainer in (
            ("solo", BatchedTrainer(sf.env, sf.agent, BatchedTrainerConfig(n_envs=16), y0_pool=pool)),
            ("population_of_8", PopulationTrainer(sf.env, sf.agent, BatchedTrainerConfig(n_envs=2),
                                                  8, y0_pool=pool))):
        ts = trainer.init(torch.Generator().manual_seed(2))
        ts, _ = trainer.make_chunk_fn(10)(ts)  # past the warmup and the learn gate
        count = OpCount()
        with count:
            trainer.make_chunk_fn(5)(ts)
        out[label] = count.n / 5
    return out


def main() -> int:
    print(json.dumps({"ppo_tuned": ppo_counts(lambda ns: tuned_config(ns, 1)),
                      "ppo_reference": ppo_counts(lambda ns: PPOConfig(ns=ns, na=1)),
                      "sf_train_step": train_step_counts()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
