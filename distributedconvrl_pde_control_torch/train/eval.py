"""Evaluation rollouts: the plot_heat and testrun protocols.

Counterpart of ``distributedconvrl_pde_control_tpu/train/eval.py``:
  * `rollout`     - a policy rollout with horizon override and delayed
                    actuation (plotting.jl:4-73: te/dt overridden, zero action
                    until p_t_action, best-actor swap-in); `rollouts` rolls a
                    batch of envs at once (`per_env_policy` gives each env a
                    policy of its own);
  * `energy_eval` - the fluid testrun's per-step energy sum(|omega|)/(nx*ny)
                    (FluidSetup.jl:497-500), averaged over the active steps;
  * `regulation_of` - the Keller-Segel score of reproduce.py (:181-184):
                    the mean |u - 1| before actuation and over the last tenth.
Traces come back as host arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from distributedconvrl_pde_control_torch.envs.pde_env import PDEEnv, where_state


@torch.no_grad()
def rollouts(env: PDEEnv, policy_fn: Callable, y0s: Optional[torch.Tensor] = None,
             te: Optional[float] = None, t_action: float = 0.0) -> dict:
    """`rollout` of a batch of envs from the fields y0s (B, ...) (None: one
    env from the env's y0): traces (steps, B, ...), and `steps` and
    `completed` per env. Each env runs as it would alone: its own
    termination, its own frozen frames."""
    if te is not None:
        env = dataclasses.replace(env, te=float(te))
    n_steps = env.max_steps
    t_action_steps = int(round(t_action / env.dt))
    estate = env.reset(y0s)
    outs = {k: [] for k in ("y", "action", "forcing", "reward", "active")}
    for step_idx in range(n_steps):
        if step_idx < t_action_steps:
            action = torch.zeros_like(estate.action)
        else:
            action = policy_fn(estate.obs)
        active = ~estate.done
        estate = where_state(active, env.step(estate, action), estate)
        for k in ("y", "action", "forcing", "reward"):
            outs[k].append(getattr(estate, k))
        outs["active"].append(active)
    traces = {k: torch.stack(v).cpu().numpy() for k, v in outs.items()}
    traces["steps"] = traces["active"].sum(axis=0)
    traces["completed"] = (estate.time >= env.te * (1 - 1e-6)).cpu().numpy()
    traces["time"] = env.dt * np.arange(1, n_steps + 1)
    return traces


def rollout(env: PDEEnv, policy_fn: Callable, y0: Optional[torch.Tensor] = None,
            te: Optional[float] = None, t_action: float = 0.0) -> dict:
    """Roll `policy_fn(obs) -> action` on one env of `env`.

    `obs` is the env's (1, obs_dim, n_actuators) batch of one and the action
    (1, action_rows, n_actuators). te overrides the horizon (the
    reference's p_te); actions are zero until time >= t_action (the
    reference's p_t_action). An env that is done stays frozen: later steps
    repeat its last state and record active=False. Returns a dict of traces
    y, action, forcing, reward, active, plus steps, completed and time.
    """
    tr = rollouts(env, policy_fn, None if y0 is None else y0[None], te=te, t_action=t_action)
    traces = {k: tr[k][:, 0] for k in ("y", "action", "forcing", "reward", "active")}
    traces["steps"] = int(tr["steps"][0])
    traces["completed"] = bool(tr["completed"][0])
    traces["time"] = tr["time"]
    return traces


def per_env_policy(policies: list) -> Callable:
    """One policy over a batch of len(policies) envs: env i acts with
    `policies[i]` on its own observation (members of a population, or a
    controller beside its baselines, rolled as one batch)."""

    def policy_fn(obs):
        return torch.cat([p(obs[i:i + 1]) for i, p in enumerate(policies)])

    return policy_fn


def actor_policy(agent, actor_params, act_limit: float = 1.0):
    """Deterministic policy from actor params (eval mode: no noise, no
    warmup - the plot_heat start_steps=-1 override, plotting.jl:31).
    Maps observations (B, ns, n_act) to actions (B, na_rows, n_act) with
    every actuator column of every env as one batch of the shared actor."""

    def policy_fn(obs):
        b, ns, n_act = obs.shape
        cols = obs.permute(1, 0, 2).reshape(ns, b * n_act)
        a = torch.clamp(agent.actor_apply(actor_params, cols), -act_limit, act_limit)
        return a.reshape(-1, b, n_act).permute(1, 0, 2)

    return policy_fn


def energy_trace(y_trace: np.ndarray) -> np.ndarray:
    """Fluid energy diagnostic sum(|omega|)/(nx*ny) per step
    (FluidSetup.jl:497-500) of a (steps, ny, nx) trace, real or spectral."""
    steps = y_trace.shape[0]
    n = y_trace.shape[-2] * y_trace.shape[-1]
    omg = np.fft.ifft2(y_trace, axes=(-2, -1)).real if np.iscomplexobj(y_trace) else y_trace
    return np.abs(omg.reshape(steps, -1)).sum(axis=1) / n


def mean_energy(traces: dict) -> float:
    """Mean per-step energy over the active steps only: a rollout repeats
    its frozen final state after early termination, and averaging those
    frames would bias trained-vs-baseline comparisons."""
    energy = traces["energy"] if "energy" in traces else energy_trace(traces["y"])
    active = np.asarray(traces["active"], bool)
    if not active.any():
        return float("nan")
    return float(np.asarray(energy)[active].mean())


def energy_eval(env: PDEEnv, policy_fn: Callable, y0: Optional[torch.Tensor] = None,
                te: Optional[float] = None, t_action: float = 0.0) -> dict:
    """testrun-style evaluation: `rollout` plus the energy trace and its
    masked mean (fluid envs)."""
    traces = rollout(env, policy_fn, y0=y0, te=te, t_action=t_action)
    traces["energy"] = energy_trace(traces["y"])
    traces["mean_energy"] = mean_energy(traces)
    return traces


def regulation_of(y_trace: np.ndarray, t_action: float, dt: float) -> dict:
    """Keller-Segel regulation of a (steps, 2, nx) trace as reproduce.py
    computes it inline (:181-184): the deviation |u - 1| from the
    homogeneous state u = 1 (KellerSegelSetup.jl:241-263), averaged over the
    100 steps before actuation ("pre") and over the last tenth of the run
    ("post", the steps from -len // 10 on)."""
    dev = np.abs(np.asarray(y_trace)[:, 0] - 1.0)
    a0 = int(round(t_action / dt))
    return {"pre": float(dev[max(0, a0 - 100):a0].mean()),
            "post": float(dev[-len(dev) // 10:].mean())}
