"""Batched-env deterministic evaluation.

Counterpart of the eval half of ``distributedconvrl_pde_control_tpu/train/
batched.py::BatchedTrainer`` (`_fresh_eval_y0s`, `_obs_cols`,
`_actions_env`, `_env_scores`, `eval_mean_reward`). `n_envs` environments
advance in lockstep as one batch and the shared policy sees all
`n_envs * n_actuators` actuator columns as one batch. The fused train step
comes with the training slice of the port; so do the JAX package's
flat-carry layout knobs, which exist for the TPU's tiled layouts.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from distributedconvrl_pde_control_torch.agents.ddpg import DDPGAgent
from distributedconvrl_pde_control_torch.envs.pde_env import PDEEnv, where_state


@dataclasses.dataclass(frozen=True)
class BatchedTrainerConfig:
    """The eval half's field of the JAX config; the learner's fields come
    with the train step."""

    n_envs: int = 256


class BatchedTrainer:
    """Batched-env DDPG trainer; this slice carries its deterministic eval."""

    def __init__(self, env: PDEEnv, agent: DDPGAgent, cfg: BatchedTrainerConfig,
                 random_init: Optional[Callable] = None, y0_pool=None, eval_y0_pool=None):
        """`random_init(generator, n) -> (n, nx)` draws initial fields;
        `y0_pool` is a precomputed (P, nx) set of initial fields sampled
        uniformly instead; `eval_y0_pool` holds out ICs for the deterministic
        evals (without it the eval draws from the training IC source)."""
        self.env = env
        self.agent = agent
        self.cfg = cfg
        self.random_init = random_init
        self.y0_pool = y0_pool
        self.eval_y0_pool = eval_y0_pool

    def _obs_cols(self, obs_batch: torch.Tensor) -> torch.Tensor:
        """(B, ns, n_act) obs -> the (ns, B*n_act) column view the policy
        consumes."""
        acfg = self.agent.cfg
        b = obs_batch.shape[0]
        return obs_batch.permute(1, 0, 2).reshape(acfg.ns, b * acfg.n_actuators)

    def _actions_env(self, actions_flat: torch.Tensor, b: int) -> torch.Tensor:
        """(na_rows, B*n_act) policy output -> the (B, na_rows, n_act) action
        batch the env step consumes."""
        acfg = self.agent.cfg
        return actions_flat.reshape(acfg.na_rows, b, acfg.n_actuators).permute(1, 0, 2)

    def _fresh_y0s(self, generator: torch.Generator, n: int) -> torch.Tensor:
        if self.y0_pool is not None:
            idx = torch.randint(0, self.y0_pool.shape[0], (n,), generator=generator)
            return self.y0_pool[idx.to(self.y0_pool.device)]
        if self.random_init is not None:
            return self.random_init(generator, n)
        return self.env.y0.expand((n,) + tuple(self.env.y0.shape))

    def _fresh_eval_y0s(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """Eval ICs: the held-out `eval_y0_pool` when provided, else the
        training IC source."""
        if self.eval_y0_pool is not None:
            idx = torch.randint(0, self.eval_y0_pool.shape[0], (n,), generator=generator)
            return self.eval_y0_pool[idx.to(self.eval_y0_pool.device)]
        return self._fresh_y0s(generator, n)

    @staticmethod
    def _env_scores(rs: np.ndarray, actives: np.ndarray) -> np.ndarray:
        """Per-env masked mean step reward: (n_steps, B) traces -> (B,)
        scores, NaN for envs with zero active steps."""
        n = actives.sum(axis=0)
        tot = (rs * actives).sum(axis=0)
        return np.where(n > 0, tot / np.maximum(n, 1), np.nan)

    @torch.no_grad()
    def eval_mean_reward(self, actor_params, n_steps: int,
                         generator: Optional[torch.Generator] = None,
                         warmup_steps: int = 0, score: str = "mean",
                         y0s: Optional[torch.Tensor] = None) -> float:
        """Deterministic-policy evaluation over one episode batch (no noise,
        no learning): mean per-step reward over active steps.

        When `n_steps + warmup_steps` exceeds the episode cap te/dt, the
        rollout runs on a te-overridden clone of the env (te = t0 +
        (n_steps + warmup_steps)*dt + dt) so every requested step is a real
        step; blow-up termination stays active and masks post-termination
        steps. `warmup_steps > 0` first evolves the ICs uncontrolled (zero
        actions) for that many steps and scores only the controlled segment.
        `score="min"` reduces the per-env masked means by min instead of the
        batch mean. `y0s` (n_envs, nx) replaces the drawn ICs.
        """
        env, agent = self.env, self.agent
        acfg = agent.cfg
        b = self.cfg.n_envs
        if y0s is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            y0s = self._fresh_eval_y0s(generator, b)
        needed_te = env.t0 + (n_steps + warmup_steps) * env.dt
        if needed_te > env.te:
            env = dataclasses.replace(env, te=float(needed_te) + env.dt)

        estates = env.reset(y0s)
        if warmup_steps:
            # uncontrolled development phase: zero actions (forcing = 0),
            # blow-up masking identical to the scored phase
            zeros = torch.zeros_like(estates.action)
            for _ in range(warmup_steps):
                estates = where_state(~estates.done, env.step(estates, zeros), estates)

        rs, actives = [], []
        for _ in range(n_steps):
            a_flat = torch.clamp(agent.actor_apply(actor_params, self._obs_cols(estates.obs)),
                                 -acfg.act_limit, acfg.act_limit)
            active = ~estates.done
            new_estates = env.step(estates, self._actions_env(a_flat, b))
            estates = where_state(active, new_estates, estates)
            # the blow-up step itself can carry a non-finite reward; exclude
            # it from the mean instead of letting one diverged env NaN it all
            step_r = new_estates.reward.mean(dim=-1)
            ok = active & torch.isfinite(step_r)
            rs.append(torch.where(ok, step_r, torch.zeros_like(step_r)))
            actives.append(ok)
        rs = torch.stack(rs).cpu().numpy()
        actives = torch.stack(actives).cpu().numpy()
        if score == "min":
            per_env = self._env_scores(rs, actives)
            return float(np.nanmin(per_env)) if np.isfinite(per_env).any() else float("nan")
        return float(rs[actives].mean()) if actives.any() else float("nan")
