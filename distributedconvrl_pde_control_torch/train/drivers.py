"""Training drivers: the experiment-layer entry points.

Counterpart of ``distributedconvrl_pde_control_tpu/train/drivers.py``, the
rebuild of the reference's per-setup `train` / `train_multi` /
`StopAfterEpisodeWithMinSteps` flow (KSSetup.jl:304-363, StopCondition.jl):
noise-decay outer loops, a min-steps-then-finish-episode stop condition, an
endless multi-experiment restart driver with numbered checkpoints, and the
hyperparameter-search objectives (KSglobalSetup.jl:405-426).

Randomness. Every draw of a run comes from the train state's
`torch.Generator`: the networks at init, then per episode its initial field
(`setup.random_init`) and every step's noise and replay offsets. The JAX
package splits one key into a stream for the initial fields and one for the
episodes; the port's generator shares no stream with `jax.random` in any
case, and `draws` (one `EpisodeDraws` per episode) replaces the draws where
a parity test passes in JAX's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from distributedconvrl_pde_control_torch.agents.ddpg import DDPGAgent
from distributedconvrl_pde_control_torch.envs.pde_env import PDEEnv
from distributedconvrl_pde_control_torch.models.mlp import Chain
from distributedconvrl_pde_control_torch.train.batched import StepDraws
from distributedconvrl_pde_control_torch.train.eval import actor_policy, rollout
from distributedconvrl_pde_control_torch.train.hooks import PDEHook
from distributedconvrl_pde_control_torch.train.loop import (
    TrainState,
    init_train_state,
    make_episode_fn,
    resume_seed,
)


@dataclasses.dataclass
class Setup:
    """A fully assembled experiment: env + agent + training protocol.

    Plays the role of a reference setup file's module-level globals + the
    `initialize_setup()` call (e.g. KSSetup.jl:249-300).
    """

    name: str
    env: PDEEnv
    agent: DDPGAgent
    seed: int = 0
    random_init: Optional[Callable] = None  # (generator, n) -> (n, nx) y0 batch
    loops: int = 8
    no_steps: int = 800
    noise_decay: float = 0.2
    min_best_episode: int = 1
    record: bool = True
    use_random_init: bool = True
    reward_clamp: float = -3000.0
    error_detection: Optional[Callable] = None

    def make_hook(self) -> PDEHook:
        return PDEHook(
            min_best_episode=self.min_best_episode,
            collect_best_trace=self.record,
            error_detection=self.error_detection,
        )


@dataclasses.dataclass
class EpisodeDraws:
    """Draws of one episode made outside it: the initial field `y0` (nx,)
    and one `StepDraws` per step. A field left None is drawn as usual."""

    y0: Optional[torch.Tensor] = None
    steps: Optional[Sequence[StepDraws]] = None


def _device(setup: Setup) -> torch.device:
    return setup.env.y0.device


def _episode(episode_fn, ts: TrainState, setup: Setup, draws: Optional[Iterator[EpisodeDraws]]):
    """One episode from a fresh initial field: `random_init` when
    `use_random_init`, else the env's y0."""
    d = next(draws) if draws is not None else EpisodeDraws()
    y0 = d.y0
    if y0 is None and setup.use_random_init and setup.random_init is not None:
        y0 = setup.random_init(ts.generator, 1)[0]
    return episode_fn(ts, y0, d.steps)


def run_min_steps(episode_fn, ts: TrainState, hook: PDEHook, setup: Setup, min_steps: int,
                  draws: Optional[Iterator[EpisodeDraws]] = None) -> TrainState:
    """`run(agent, env, StopAfterEpisodeWithMinSteps(n), hook)`: whole
    episodes until the step count reaches `min_steps` (StopCondition.jl:32-37:
    budget reached AND episode finished)."""
    steps = 0
    while steps < min_steps:
        ts, result = _episode(episode_fn, ts, setup, draws)
        hook.on_episode(result, ts.agent)
        steps += result.steps
    return ts


def train(setup: Setup, loops: Optional[int] = None, no_steps: Optional[int] = None,
          seed: Optional[int] = None, verbose: bool = True, ts: Optional[TrainState] = None,
          hook: Optional[PDEHook] = None, draws: Optional[Iterator[EpisodeDraws]] = None):
    """The per-setup `train()` (KSSetup.jl:304-319): `loops` rounds of
    min-steps training, act_noise decayed each round and the hook's rewards
    clamped to [reward_clamp, 0]. A fresh state is drawn from a generator on
    the env's device seeded `seed` (default the setup's). A resumed state
    `ts` goes on with its generator, re-seeded with `resume_seed(seed,
    hook.ep)` when `seed` is given: the JAX `train` draws a resumed run's
    initial fields from `seed` too."""
    loops = loops if loops is not None else setup.loops
    no_steps = no_steps if no_steps is not None else setup.no_steps
    episode_fn = make_episode_fn(setup.env, setup.agent, learning=True, record=setup.record)
    if hook is None:
        hook = setup.make_hook()
    if ts is None:
        ts = init_train_state(setup.env, setup.agent, torch.Generator(device=_device(setup))
                              .manual_seed(setup.seed if seed is None else seed))
    elif seed is not None:
        ts.generator.manual_seed(resume_seed(seed, hook.ep))

    noise = setup.agent.cfg.act_noise
    for i in range(loops):
        ts.agent.act_noise = noise
        t0 = time.time()
        ts = run_min_steps(episode_fn, ts, hook, setup, no_steps, draws)
        if verbose:
            print(f"[{setup.name}] loop {i + 1}/{loops} noise={noise:.4f} "
                  f"best={hook.bestreward:.4f} ep={hook.ep - 1} ({time.time() - t0:.1f}s)",
                  flush=True)
        noise *= setup.noise_decay
        hook.clamp_rewards(setup.reward_clamp, 0.0)
    return ts, hook


def train_multi(setup: Setup, no_episodes: int = 2800, n_experiments: int = 2,
                inner_episodes: int = 50, inner_loops: int = 14, restart_noise: float = 0.15,
                inner_decay: float = 0.9, save_fn: Optional[Callable] = None,
                verbose: bool = True) -> list:
    """Multi-experiment restart driver (KSSetup.jl:321-363): per experiment
    a fresh state, episode-count loops with their own noise schedule, the
    best reward collected and, through `save_fn(n_experiment, ts, hook)`,
    a numbered checkpoint. Experiment n draws from a generator seeded
    `setup.seed + 7919 n`, as the fluid restart driver does.

    `n_experiments <= 0` restarts endlessly, the reference's `while true`
    (KSSetup.jl:322; each experiment's checkpoint is saved when it ends).
    """
    best_rewards = []
    n_exp = 0
    while n_experiments <= 0 or n_exp < n_experiments:
        n_exp += 1
        gen = torch.Generator(device=_device(setup)).manual_seed(setup.seed + 7919 * n_exp)
        episode_fn = make_episode_fn(setup.env, setup.agent, learning=True, record=setup.record)
        ts = init_train_state(setup.env, setup.agent, gen)
        hook = setup.make_hook()
        if verbose:
            print(f"--------- STARTING EXPERIMENT # {n_exp} ---------", flush=True)
        n = 0
        while n < no_episodes:
            noise = restart_noise
            for _ in range(inner_loops):
                if n >= no_episodes:
                    break
                ts.agent.act_noise = noise
                for _ in range(inner_episodes):
                    ts, result = _episode(episode_fn, ts, setup, None)
                    hook.on_episode(result, ts.agent)
                n += inner_episodes
                noise *= inner_decay
                hook.clamp_rewards(setup.reward_clamp, 0.0)
        best_rewards.append(hook.bestreward)
        if save_fn is not None:
            save_fn(n_exp, ts, hook)
        if verbose:
            print(f"--------- BEST REWARD: {hook.bestreward} ---------", flush=True)
    return best_rewards


def run_episodes(setup: Setup, n_episodes: int, ts: Optional[TrainState] = None,
                 hook: Optional[PDEHook] = None, episode_fn=None,
                 draws: Optional[Iterator[EpisodeDraws]] = None):
    """`run(agent, env, StopAfterEpisode(n), hook)`: a plain episode-count
    stop condition (the hyperopt objectives). A fresh state is drawn from a
    generator seeded with the setup's seed. Returns (ts, hook)."""
    if episode_fn is None:
        episode_fn = make_episode_fn(setup.env, setup.agent, learning=True, record=setup.record)
    if ts is None:
        ts = init_train_state(setup.env, setup.agent,
                              torch.Generator(device=_device(setup)).manual_seed(setup.seed))
    if hook is None:
        hook = setup.make_hook()
    for _ in range(n_episodes):
        ts, result = _episode(episode_fn, ts, setup, draws)
        hook.on_episode(result, ts.agent)
    return ts, hook


def hyperopt_cost(rewards: Sequence[float], n_episodes: int) -> float:
    """The `test_setup` cost over the tail half of the episode rewards
    (KSglobalSetup.jl:405-426): -mean(tail) - sum over the tail of
    (r > -0.1) * (r + 0.1). Lower is better."""
    tail = np.asarray(rewards[-max(1, int(n_episodes * 0.5)):], dtype=np.float64)
    bonus = np.sum((tail > -0.1) * (tail + 0.1))
    return float(-tail.mean() - bonus)


def hyperopt_objective(setup: Setup, n_episodes: int = 100) -> float:
    """The `test_setup` hyperparameter-search objective: `n_episodes` with
    the setup's seed, scored by `hyperopt_cost`. Build `setup` with the
    candidate hyperparameters."""
    _, hook = run_episodes(setup, n_episodes)
    return hyperopt_cost(hook.rewards, n_episodes)


def hyperopt_objective_robust(setup: Setup, n_episodes: int = 30, n_eval_inits: int = 4,
                              eval_seed0: int = 10_000,
                              eval_y0s: Optional[Sequence[torch.Tensor]] = None) -> float:
    """OOD-robust search objective (an extension of the JAX package; no
    reference equivalent): train the candidate as `hyperopt_objective` does,
    then score the trained policy (the best actor, else the current one) by
    deterministic rollouts from `n_eval_inits` held-out random initial
    fields. Cost: the mean over inits of -mean step reward, with the steps
    after an early blow-up termination filled at -max_value, so that a
    diverging policy ranks last. Init i is `random_init` of a CPU generator
    seeded `eval_seed0 + i` (the env's y0 without `random_init`); `eval_y0s`
    replaces them."""
    ts, hook = run_episodes(setup, n_episodes)
    best = hook.best_actor
    actor = (Chain([p["w"] for p in best], [p["b"] for p in best]).to(_device(setup))
             if best is not None else ts.agent.actor)
    policy = actor_policy(setup.agent, actor, setup.agent.cfg.act_limit)
    penalty = -float(setup.env.max_value)
    if eval_y0s is None:
        eval_y0s = [None if setup.random_init is None else
                    setup.random_init(torch.Generator().manual_seed(eval_seed0 + i), 1)[0]
                    for i in range(n_eval_inits)]
    costs = []
    for y0 in eval_y0s:
        tr = rollout(setup.env, policy, y0=None if y0 is None else y0.to(_device(setup)))
        r = np.asarray(tr["reward"], np.float64)
        r = r.reshape(r.shape[0], -1).mean(axis=1)  # mean over actuators
        active = np.asarray(tr["active"], bool)
        r = np.where(active & np.isfinite(r), r, penalty)
        costs.append(-float(r.mean()))
    return float(np.mean(costs))
