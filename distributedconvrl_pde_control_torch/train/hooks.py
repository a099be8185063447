"""Experiment hook: the observability system.

Counterpart of ``distributedconvrl_pde_control_tpu/train/hooks.py``, the
host-side rebuild of `src/PDEhook.jl`: per-episode mean-reward accumulation
(:52), best-episode tracking with full-length + min-episode gating (:66-76),
best-actor parameter snapshot (:69), per-step trajectory capture (:54-62),
divergence flagging via pluggable error detection (:78-82), optional full
history (:84-87), and an ASCII reward curve on demand (:100-102).

The hook holds host data only. Actors are kept in the JAX package's
[{"w", "b"}, ...] format of numpy arrays, which is what saves/hook.npz
stores, so they are copies by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from distributedconvrl_pde_control_torch.models.mlp import chain_to_numpy

# Row order of the packed chunk-record array (5, n_steps, n_envs) f32.
# Chunked trainers write their per-step record fields into one device array
# so the host accounting costs a single device-to-host copy per chunk.
REC_FINISHED, REC_COMPLETED, REC_EP_REWARD, REC_ERRORED, REC_MEAN_REWARD = range(5)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def unpack_records(packed) -> dict:
    """Packed (5, n_steps, n_envs) f32 chunk records -> the dict form
    (bool masks finished/completed/errored, f32 ep_reward, and the
    per-step mean_reward (n_steps,), broadcast over envs when packed)."""
    arr = _host(packed)
    return {
        "finished": arr[REC_FINISHED] > 0.5,
        "completed": arr[REC_COMPLETED] > 0.5,
        "ep_reward": arr[REC_EP_REWARD],
        "errored": arr[REC_ERRORED] > 0.5,
        "mean_reward": arr[REC_MEAN_REWARD, :, 0],
    }


@dataclasses.dataclass
class PDEHook:
    min_best_episode: int = 0
    collect_nna: bool = True
    collect_best_trace: bool = True
    collect_history: bool = False
    error_detection: Optional[Callable[[np.ndarray], bool]] = None

    rewards: List[float] = dataclasses.field(default_factory=list)
    rewards_compare: List[float] = dataclasses.field(default_factory=list)
    bestreward: float = -1_000_000.0
    bestepisode: int = 0
    best_actor: Any = None
    best_trace: Any = None
    current_actor: Any = None
    history: List[Any] = dataclasses.field(default_factory=list)
    errored_episodes: List[int] = dataclasses.field(default_factory=list)
    ep: int = 1

    def on_episode(self, result, agent_state) -> None:
        """PostEpisode stage (PDEhook.jl:65-97). `result` carries
        reward_sum, completed, steps, final_y and the y/action/forcing/
        reward traces of one episode; `agent_state.actor` is a Chain."""
        reward = float(result.reward_sum)
        completed = bool(result.completed)
        trace = None
        if self.collect_best_trace or self.collect_history:
            trace = {
                "y": _host(result.y_trace),
                "action": _host(result.action_trace),
                "forcing": _host(result.forcing_trace),
                "reward": _host(result.reward_trace),
                "steps": int(result.steps),
            }

        if completed and self.ep >= self.min_best_episode:
            self.rewards_compare.append(reward)
            if self.collect_nna and reward >= max(self.rewards_compare):
                self.best_actor = chain_to_numpy(agent_state.actor)
                self.bestreward = reward
                self.bestepisode = self.ep
                if self.collect_best_trace:
                    self.best_trace = trace

        if not completed and self.error_detection is not None:
            if self.error_detection(_host(result.final_y)):
                self.errored_episodes.append(self.ep)

        if self.collect_history:
            self.history.append(trace)

        self.ep += 1
        self.rewards.append(reward)
        if self.collect_nna:
            # a copy: the optimizer goes on updating the live actor in place
            self.current_actor = chain_to_numpy(agent_state.actor)

    def feed_episode_records(self, recs) -> None:
        """Append finished-episode rewards from a chunk record, either a
        dict (keys finished/completed/ep_reward [+ optional errored], arrays
        (n_steps, n_envs)) or the packed single-array form
        (`unpack_records`), in step order. This is the host half of the
        PDEhook accounting for the batched trainer, whose episodes finish
        inside chunks. An `errored` flag records the episode index in
        `errored_episodes` (PDEhook.jl:78-82)."""
        if not isinstance(recs, dict):
            recs = unpack_records(recs)
        finished = np.asarray(recs["finished"])
        # a row-major flatnonzero walks the (n_steps, n_envs) grid step-major
        # then in env-index order: the order a per-row loop would append in
        idx = np.flatnonzero(finished.ravel())
        if idx.size == 0:
            return
        r = np.asarray(recs["ep_reward"], np.float64).ravel()[idx]
        comp = np.asarray(recs["completed"], bool).ravel()[idx]
        errored = recs.get("errored")
        ep0 = self.ep
        self.rewards.extend(r.tolist())
        self.rewards_compare.extend(r[comp].tolist())
        if errored is not None:
            err = np.asarray(errored, bool).ravel()[idx]
            self.errored_episodes.extend((ep0 + np.flatnonzero(err)).tolist())
        self.ep = ep0 + int(idx.size)

    def adopt_device_best(self, best_reward, best_episode, best_actor) -> None:
        """Copy the trainer's on-device best tracking into the host hook in
        the standard format."""
        if np.isfinite(float(best_reward)):
            self.bestreward = float(best_reward)
            self.bestepisode = int(best_episode)
            self.best_actor = chain_to_numpy(best_actor)

    def clamp_rewards(self, lo: float, hi: float) -> None:
        """The post-loop clamp (KSSetup.jl:317)."""
        self.rewards = [min(max(r, lo), hi) for r in self.rewards]

    def ascii_curve(self, width: int = 70, height: int = 12) -> str:
        """Terminal reward curve, the UnicodePlots lineplot stand-in
        (PDEhook.jl:100-102)."""
        if not self.rewards:
            return "(no episodes)"
        r = np.asarray(self.rewards, dtype=np.float64)
        xs = np.linspace(0, len(r) - 1, min(width, len(r))).astype(int)
        vals = r[xs]
        lo, hi = vals.min(), vals.max()
        span = hi - lo if hi > lo else 1.0
        rows = []
        levels = np.floor((vals - lo) / span * (height - 1)).astype(int)
        for row in range(height - 1, -1, -1):
            line = "".join("*" if lv == row else " " for lv in levels)
            rows.append(line)
        rows.append(f"episodes 1..{len(r)}  reward [{lo:.3f}, {hi:.3f}]  best {self.bestreward:.3f}")
        return "\n".join(rows)
