"""A run whose timed path is broken underneath comes out not correct: for
each fault the cell can have, the program is patched and the rest of the
run (set-up, window, check against the reference) goes as usual."""

import pytest
import torch

from benchmark.tests.tiny import cell_names, dry_run
from benchmark import harness
from distributedconvrl_pde_control_torch.agents.ddpg import DDPGAgent
from distributedconvrl_pde_control_torch.envs.pde_env import PDEEnv
from distributedconvrl_pde_control_torch.parallel.multichip import ShardedFluidTrainer


def _unchanged(self, astate, batch, dp_group=None):
    """A learner step that returns its state unchanged."""
    return astate


def _half_batch(original):
    def sample(self, replay, batch_size, generator=None, offs=None):
        s, a, r, t, sn = original(self, replay, batch_size, generator, offs)
        h = r.shape[0] // 2
        return s[:, :h], a[:, :h], r[:h], t[:h], sn[:, :h]
    return sample


def _reward_altered(original):
    def step(self, state, action):
        new = original(self, state, action)
        new.reward = new.reward * (1.0 + 1e-3)
        return new
    return step


def _fluid_reward_altered(original):
    def reward(self, dots, actions, delta):
        return original(self, dots, actions, delta) * (1.0 + 1e-3)
    return reward


def _action_altered(original):
    def act(self, *args, **kwargs):
        return original(self, *args, **kwargs) + 1e-3
    return act


def _state_unchanged(original):
    def step(self, state, action):
        new = original(self, state, action)
        new.y = state.y
        return new
    return step


def faults(driver):
    common = [("unchanged_state", DDPGAgent, "learn_batch", lambda o: _unchanged),
              ("half_batch", DDPGAgent, "sample", _half_batch)]
    if driver == "train_ks":
        return common + [("reward_altered", PDEEnv, "step", _reward_altered)]
    if driver == "train_fluid":
        return common + [("reward_altered", ShardedFluidTrainer, "_reward", _fluid_reward_altered)]
    return [("action_altered", DDPGAgent, "act", _action_altered),
            ("state_unchanged", PDEEnv, "step", _state_unchanged)]


CASES = [(name, f) for name in cell_names()
         for f in faults(harness.find_cell(name).workload["driver"])]


@pytest.mark.parametrize("name,fault", CASES, ids=[f"{n}-{f[0]}" for n, f in CASES])
def test_broken_path_is_not_correct(name, fault, monkeypatch):
    _, cls, attr, make = fault
    monkeypatch.setattr(cls, attr, make(getattr(cls, attr)))
    res = dry_run(name)
    assert not res["correct"], res["checks"]
    assert torch.isfinite(torch.tensor([c["value"] for c in res["checks"].values()])).all()
