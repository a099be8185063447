"""Checkpoints: the hook's half, and state carried across from the JAX package.

Counterpart of ``distributedconvrl_pde_control_tpu/train/checkpoint.py``:

* `save` writes the hook as `saves/hook{number}.npz` with the JAX package's
  keys (`rewards`, `rewards_compare`, `errored_episodes`, `meta`,
  `best_actor_w{i}` / `best_actor_b{i}`, `best_trace_*`), so a run trained
  here is read by this package's `--eval --load-from` and by the JAX
  package's hook reader alike; `load_best_actor` / `load_hook` read it back;
* `save_config_overrides` / `load_config_overrides` ship the off-preset
  config deltas next to a checkpoint;
* `actor_from_jax`, `ddpg_state_from_jax` and `replay_from_jax` build the
  port's state from numpy pytrees of the JAX package's (a `DDPGState` with
  its optax Adam states, a `Replay`), for parity tests and warm starts.

The flax msgpack agent state is neither written nor read yet (ROADMAP.md
queue 1 items 10 and 17).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from distributedconvrl_pde_control_torch.agents.ddpg import DDPGAgent, DDPGState
from distributedconvrl_pde_control_torch.agents.replay import Replay, replay_init
from distributedconvrl_pde_control_torch.models.mlp import Chain
from distributedconvrl_pde_control_torch.train.hooks import PDEHook


def _hook_path(dirpath: str, number: Optional[int]) -> str:
    suffix = "" if number is None else str(number)
    return os.path.join(dirpath, "saves", f"hook{suffix}.npz")


def save(dirpath: str, hook: PDEHook, number: Optional[int] = None,
         config_overrides: Optional[dict] = None) -> None:
    """Write the hook (reward history, best actor, best trace, counters) as
    `dirpath`/saves/hook{number}.npz, and `config_overrides` (the config
    fields replaced on the preset, for artifacts trained off-preset) as
    `dirpath`/config_overrides.json."""
    if config_overrides:
        save_config_overrides(dirpath, config_overrides)
    os.makedirs(os.path.join(dirpath, "saves"), exist_ok=True)
    payload = {
        "rewards": np.asarray(hook.rewards, np.float64),
        "rewards_compare": np.asarray(hook.rewards_compare, np.float64),
        "errored_episodes": np.asarray(hook.errored_episodes, np.int64),
        "meta": np.frombuffer(
            json.dumps({
                "bestreward": hook.bestreward,
                "bestepisode": hook.bestepisode,
                "ep": hook.ep,
                "min_best_episode": hook.min_best_episode,
            }).encode(),
            dtype=np.uint8,
        ),
    }
    if hook.best_actor is not None:
        for i, layer in enumerate(hook.best_actor):
            payload[f"best_actor_w{i}"] = np.asarray(layer["w"])
            payload[f"best_actor_b{i}"] = np.asarray(layer["b"])
    if hook.best_trace is not None:
        for k, v in hook.best_trace.items():
            payload[f"best_trace_{k}"] = np.asarray(v)
    np.savez_compressed(_hook_path(dirpath, number), **payload)


def load_hook(dirpath: str, number: Optional[int] = None) -> PDEHook:
    """The hook `save` wrote (or the JAX package's `save`: same file)."""
    with np.load(_hook_path(dirpath, number), allow_pickle=False) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        hook = PDEHook(min_best_episode=meta["min_best_episode"])
        hook.rewards = list(data["rewards"])
        hook.rewards_compare = list(data["rewards_compare"])
        hook.errored_episodes = list(data["errored_episodes"])
        hook.bestreward = meta["bestreward"]
        hook.bestepisode = meta["bestepisode"]
        hook.ep = meta["ep"]
        n_layers = len([k for k in data.files if k.startswith("best_actor_w")])
        if n_layers:
            hook.best_actor = [{"w": data[f"best_actor_w{i}"], "b": data[f"best_actor_b{i}"]}
                               for i in range(n_layers)]
        trace_keys = [k for k in data.files if k.startswith("best_trace_")]
        if trace_keys:
            hook.best_trace = {k[len("best_trace_"):]: data[k] for k in trace_keys}
            if "steps" in hook.best_trace:
                hook.best_trace["steps"] = int(hook.best_trace["steps"])
    return hook


def save_config_overrides(dirpath: str, config_overrides: dict) -> None:
    """Write the off-preset config deltas next to a checkpoint (see save())."""
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "config_overrides.json"), "w") as f:
        json.dump(config_overrides, f, indent=1, sort_keys=True)


def load_config_overrides(dirpath: str) -> Optional[dict]:
    """The config overrides an off-preset artifact was trained with, or None
    when the artifact was trained at the preset config."""
    path = os.path.join(dirpath, "config_overrides.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def load_best_actor(dirpath: str) -> list[dict]:
    """The JAX actor pytree [{"w": (n_out, n_in), "b": (n_out,)}, ...] of the
    best actor in `dirpath`/saves/hook.npz, as numpy arrays."""
    path = _hook_path(dirpath, None)
    with np.load(path) as data:
        n_layers = len([k for k in data.files if k.startswith("best_actor_w")])
        if n_layers == 0:
            raise ValueError(f"{path} holds no best actor (best_actor_w0 missing)")
        return [{"w": np.asarray(data[f"best_actor_w{i}"], np.float32),
                 "b": np.asarray(data[f"best_actor_b{i}"], np.float32)}
                for i in range(n_layers)]


def actor_from_jax(params) -> Chain:
    """The port's chain from a JAX chain pytree (a list of {"w", "b"} arrays,
    numpy or anything np.asarray takes)."""
    return Chain([np.asarray(p["w"], np.float32) for p in params],
                 [np.asarray(p["b"], np.float32) for p in params])


def _set_adam_state(opt: torch.optim.Adam, chain: Chain, adam_state) -> None:
    """Carry optax's ScaleByAdamState (count, mu, nu as chain pytrees) into a
    torch Adam over `chain`'s parameters. torch keeps the step count per
    parameter: on the device for the fused form, on the host otherwise."""
    count = float(np.asarray(adam_state.count))
    fused = bool(opt.defaults.get("fused"))
    for i, (w, b) in enumerate(zip(chain.w, chain.b)):
        for p, key in ((w, "w"), (b, "b")):
            opt.state[p] = {
                "step": (torch.tensor(count, dtype=torch.float32, device=p.device) if fused
                         else torch.tensor(count, dtype=torch.float32)),
                "exp_avg": torch.as_tensor(np.asarray(adam_state.mu[i][key], np.float32),
                                           device=p.device).clone(),
                "exp_avg_sq": torch.as_tensor(np.asarray(adam_state.nu[i][key], np.float32),
                                              device=p.device).clone(),
            }


def ddpg_state_from_jax(agent: DDPGAgent, jstate, device="cuda") -> DDPGState:
    """The port's DDPGState on `device` from a JAX `DDPGState` whose leaves
    are numpy arrays (`jax.tree.map(np.asarray, state)`): the four networks,
    both optax Adam states (`opt[0].count/mu/nu`), the noise scale and the
    step counter. Nothing of JAX is imported: the fields are read by name."""
    state = agent.make_state(
        actor_from_jax(jstate.actor).to(device), actor_from_jax(jstate.critic).to(device),
        actor_from_jax(jstate.target_actor).to(device),
        actor_from_jax(jstate.target_critic).to(device))
    _set_adam_state(state.opt_actor, state.actor, jstate.opt_actor[0])
    _set_adam_state(state.opt_critic, state.critic, jstate.opt_critic[0])
    state.act_noise = float(np.asarray(jstate.act_noise))
    state.update_step = int(np.asarray(jstate.update_step))
    state.actor_loss = torch.tensor(float(np.asarray(jstate.actor_loss)), device=device)
    state.critic_loss = torch.tensor(float(np.asarray(jstate.critic_loss)), device=device)
    return state


def replay_from_jax(jreplay, device="cuda") -> Replay:
    """The port's Replay on `device` from a JAX `Replay` whose leaves are
    numpy arrays: its slot-minor (dim, capacity) arrays become the rows
    [s | a | r | t | sn] of the port's buffer."""
    s, a = np.asarray(jreplay.s, np.float32), np.asarray(jreplay.a, np.float32)
    rb = replay_init(s.shape[1], s.shape[0], a.shape[0], device)
    rows = np.concatenate([s.T, a.T, np.asarray(jreplay.r, np.float32)[:, None],
                           np.asarray(jreplay.t, np.float32)[:, None],
                           np.asarray(jreplay.sn, np.float32).T], axis=1)
    rb.buf.copy_(torch.as_tensor(rows))
    rb.ptr, rb.size = int(np.asarray(jreplay.ptr)), int(np.asarray(jreplay.size))
    return rb
