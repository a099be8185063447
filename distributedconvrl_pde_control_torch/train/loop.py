"""The single-env rollout + learning loop (the fidelity loop).

Counterpart of ``distributedconvrl_pde_control_tpu/train/loop.py``. The JAX
package compiles one whole episode into one program (`lax.scan` over the
steps, `lax.cond` on `active`); here the episode is a host loop over one env
of the batched `PDEEnv` (a batch of one), and the stage order of every step
is the reference's (SURVEY.md §3.2), exactly as the JAX package keeps it:

  1. update_step += 1 on active steps (policy call, PDEagent.jl:177);
  2. action = warmup ? start_policy : actor(obs) + noise (:180-204), then
     zero while step < t_action_steps;
  3. the PreAct learning gate (replay.size > update_after * interleave,
     update_step % update_freq == 0, the step active) -> `learn_many`:
     update_loops sampled SGD steps excluding the newest `interleave` rows
     (:342-361);
  4. the env step (PDEenv.jl:195-241), K1 on CNAB2 presets;
  5. the per-actuator replay push (:254-289).
Episode end: update_step is reset when reset_stage == "post_episode"
(:215-224).

Early termination. Where JAX freezes the state with `lax.cond`, the loop
reads the env's `done` flag back after each env step and stops: that read is
the only device-to-host transfer of a step, and it decides nothing else. The
counters that gate pushing and learning (update_step, the replay's ptr and
size) are host integers, so the learner and the push never read the device.
After `done` no push, no learning and no count happens, as in JAX; recorded
traces repeat the frozen final state up to `max_steps`, as JAX's scan emits
it, and the step rewards are zero there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from distributedconvrl_pde_control_torch.agents.ddpg import DDPGAgent, DDPGState
from distributedconvrl_pde_control_torch.agents.replay import (
    Replay,
    replay_init,
    replay_push_columns,
)
from distributedconvrl_pde_control_torch.envs.pde_env import PDEEnv
from distributedconvrl_pde_control_torch.train.batched import StepDraws


@dataclasses.dataclass
class TrainState:
    """Agent, replay and the stream the loop draws from. `key` holds the
    uint32 words of the JAX key a checkpoint carried (written back unchanged
    by `checkpoint.save`); None means `PRNGKey` of the generator's seed."""

    agent: DDPGState
    replay: Optional[Replay]  # None for a light state (agent and key only)
    generator: Optional[torch.Generator]
    key: Optional[np.ndarray] = None


@dataclasses.dataclass
class EpisodeResult:
    """Per-episode outputs consumed by the hook (host side)."""

    reward_sum: torch.Tensor  # sum over steps of the mean per-actuator reward
    steps: int  # env steps taken (early termination aware)
    completed: bool  # reached time >= te (not a blow-up stop)
    step_rewards: torch.Tensor  # (max_steps,) mean rewards, zero after done
    actor_loss: torch.Tensor
    critic_loss: torch.Tensor
    final_y: torch.Tensor  # terminal field (error detection, PDEhook.jl:78-82)
    # traces (max_steps, ...) when record=True, else None
    y_trace: Optional[torch.Tensor] = None
    action_trace: Optional[torch.Tensor] = None
    forcing_trace: Optional[torch.Tensor] = None
    reward_trace: Optional[torch.Tensor] = None


def resume_seed(seed: int, episodes: int) -> int:
    """The generator seed of a run that resumes from `seed` after `episodes`
    (the hook's episode counter): both mixed by numpy's `SeedSequence`, so a
    resumed run, and each resume of it, draws a stream the run before it did
    not draw."""
    return int(np.random.SeedSequence([seed, episodes]).generate_state(1, np.uint64)[0])


def init_train_state(env: PDEEnv, agent: DDPGAgent, generator: torch.Generator) -> TrainState:
    """Fresh networks from `generator` and an empty replay, on the env's
    device; the loop goes on drawing from the same generator."""
    device = env.y0.device
    cfg = agent.cfg
    return TrainState(agent=agent.init_state(generator, device),
                      replay=replay_init(cfg.capacity, cfg.ns, cfg.na_rows, device),
                      generator=generator)


def _pad_frozen(rows: list, n_steps: int) -> torch.Tensor:
    """(steps, ...) -> (n_steps, ...), the last row repeated: the frozen
    state JAX's scan emits after termination."""
    trace = torch.stack(rows)
    if trace.shape[0] < n_steps:
        tail = trace[-1:].expand((n_steps - trace.shape[0],) + tuple(trace.shape[1:]))
        trace = torch.cat([trace, tail])
    return trace


def make_episode_fn(env: PDEEnv, agent: DDPGAgent, learning: bool = True, record: bool = False,
                    max_steps: Optional[int] = None, t_action_steps: int = 0):
    """The episode function `episode(ts, y0=None, draws=None) -> (ts, result)`.

    learning=False gives the evaluation rollout (no noise, no warmup gate, no
    replay or learning: the `plot_heat` path, src/plotting.jl:7-31).
    `t_action_steps` forces zero actions for the first N steps. record=True
    returns the y / action / forcing / reward traces that the hook keeps as
    the best trace (PDEhook.jl:54-62). `y0`, of the env's field shape,
    defaults to the env's y0.
    `draws`, one `StepDraws` per step (noise, start, offs), replaces the
    draws from `ts.generator`; the parity tests pass the JAX package's.
    The state is updated in place and returned.
    """
    cfg = agent.cfg
    n_steps = max_steps if max_steps is not None else env.max_steps

    def episode(ts: TrainState, y0: Optional[torch.Tensor] = None,
                draws: Optional[Sequence[StepDraws]] = None):
        with torch.no_grad():
            estate = env.reset(None if y0 is None else y0.reshape((1,) + tuple(env.y0.shape)))
        astate, replay, gen = ts.agent, ts.replay, ts.generator
        rewards, outs = [], {k: [] for k in ("y", "action", "forcing", "reward")}
        for step_idx in range(n_steps):
            d = draws[step_idx] if draws is not None else StepDraws()
            if learning:
                astate.update_step += 1
            obs = estate.obs[0]  # (ns, n_cols)
            action = agent.act(astate, obs, gen, learning=learning, noise=d.noise, start=d.start)
            if step_idx < t_action_steps:
                action = torch.zeros_like(action)
            if (learning and replay.size > cfg.update_after * cfg.interleave
                    and astate.update_step % cfg.update_freq == 0):
                agent.learn_many(astate, replay, gen, offs=d.offs)
            with torch.no_grad():
                estate = env.step(estate, action[None])
                done = bool(estate.done[0])  # the step's one device-to-host read
                if learning:
                    replay_push_columns(replay, obs, action, estate.reward[0], done,
                                        estate.obs[0])
            rewards.append(estate.reward[0])
            if record:
                for k in outs:
                    outs[k].append(getattr(estate, k)[0])
            if done:
                break
        if learning and cfg.reset_stage == "post_episode":
            astate.update_step = 0
        steps = len(rewards)
        step_rewards = torch.zeros(n_steps, dtype=torch.float32, device=estate.y.device)
        step_rewards[:steps] = torch.stack(rewards).mean(dim=1)
        result = EpisodeResult(
            reward_sum=step_rewards.sum(),
            steps=steps,
            completed=bool(estate.time[0] >= env.te * (1.0 - 1e-6)),
            step_rewards=step_rewards,
            actor_loss=astate.actor_loss,
            critic_loss=astate.critic_loss,
            final_y=estate.y[0],
            **({f"{k}_trace": _pad_frozen(v, n_steps) for k, v in outs.items()} if record else {}),
        )
        return ts, result

    return episode
