"""Checkpoints: agent state, replay and hook, and state carried across from
the JAX package.

Counterpart of ``distributedconvrl_pde_control_tpu/train/checkpoint.py``:

* `save` writes the hook as `saves/hook{number}.npz` with the JAX package's
  keys (`rewards`, `rewards_compare`, `errored_episodes`, `meta`,
  `best_actor_w{i}` / `best_actor_b{i}`, `best_trace_*`), and, given a
  `TrainState`, the agent checkpoint in flax's bytes (`utils/flax_msgpack.py`):
  the full `saves/agent{number}.msgpack`, `to_bytes({"agent", "replay",
  "key"})` with the replay in the JAX package's slot-minor layout (`s`, `a`,
  `sn` as (dim, capacity), then `r`, `t`, `ptr`, `size`), or with
  `include_replay=False` the light `saves/agent_light{number}.msgpack`,
  `to_bytes({"agent", "key"})`: networks, both optax Adam states, counters
  and losses;
* `load` reads the full file when it exists and the light one otherwise, as
  the JAX `checkpoint.load` does, and maps the replay onto the port's
  `[s|a|r|t|sn]` row buffer; a replay stored row-major (capacity, dim), the
  layout of the older shipped artifacts (`artifacts/KS22`, `artifacts/KS200`),
  is transposed, and one that is neither layout of the agent's capacity is
  refused. `load_hook` and `load_best_actor` read the hook alone;
* `save_config_overrides` / `load_config_overrides` ship the off-preset
  config deltas next to a checkpoint;
* `save_ppo` / `load_ppo` write and read a PPO run as the JAX package does:
  `saves/ppo.msgpack`, the `PPOState` in flax's bytes (`trunk`, `mu`,
  `logsig`, `critic`, the optax chain state `(EmptyState(),
  (ScaleByAdamState(count, mu, nu), EmptyState()))` and `update_count`), and
  `saves/ppo_info.npz` (`rewards`, the JSON `meta`, and the best params under
  `best_` + the `jax.tree_util.keystr` of their path);
* `actor_from_jax`, `ddpg_state_from_jax` and `replay_from_jax` build the
  port's state from numpy pytrees of the JAX package's (a `DDPGState` with
  its optax Adam states, a `Replay`), for parity tests and warm starts.

The key, a deliberate deviation. The port draws from a `torch.Generator`,
which shares no stream with `jax.random`. `save` writes the train state's
`key`: the two uint32 words of the file it was loaded from, unchanged, or for
a run of the port's own `jax.random.PRNGKey(seed)` of its generator's seed,
`[seed >> 32, seed & 0xffffffff]` (`jax_key`; `seed_of_key` gives the seed
back). The loop does not advance the key, as JAX's scan does, so the key of a
port-written file is that of the run's first seed. `load` therefore seeds the
resumed state's generator with `resume_seed(seed_of_key(key), hook.ep)`: the
hook's episode counter moves with every run, so a resumed run, and a resume of
it, draws a stream of its own (`drivers.train` re-seeds it from `--seed` when
one is given).
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from distributedconvrl_pde_control_torch.agents.ddpg import DDPGAgent, DDPGState
from distributedconvrl_pde_control_torch.agents.replay import Replay, replay_init
from distributedconvrl_pde_control_torch.models.mlp import Chain
from distributedconvrl_pde_control_torch.train.hooks import PDEHook
from distributedconvrl_pde_control_torch.train.loop import TrainState, resume_seed
from distributedconvrl_pde_control_torch.utils import flax_msgpack


def _saves_path(dirpath: str, name: str, number: Optional[int]) -> str:
    suffix = "" if number is None else str(number)
    return os.path.join(dirpath, "saves", name.format(suffix))


def _hook_path(dirpath: str, number: Optional[int]) -> str:
    return _saves_path(dirpath, "hook{}.npz", number)


def save(dirpath: str, ts: Optional[TrainState], hook: PDEHook, number: Optional[int] = None,
         include_replay: bool = True, config_overrides: Optional[dict] = None) -> None:
    """Write the hook (reward history, best actor, best trace, counters) as
    `dirpath`/saves/hook{number}.npz; given the train state `ts`, its agent,
    replay and key as the full `dirpath`/saves/agent{number}.msgpack, or with
    `include_replay=False` its agent and key as the light
    `agent_light{number}.msgpack` (a light state needs no replay); and
    `config_overrides` (the config fields replaced on the preset, for
    artifacts trained off-preset) as `dirpath`/config_overrides.json."""
    if config_overrides:
        save_config_overrides(dirpath, config_overrides)
    os.makedirs(os.path.join(dirpath, "saves"), exist_ok=True)
    if ts is not None:
        tree = {"agent": agent_state_dict(ts.agent)}
        if include_replay:
            tree["replay"] = replay_state_dict(ts.replay)
        tree["key"] = _state_key(ts)
        name = "agent{}.msgpack" if include_replay else "agent_light{}.msgpack"
        with open(_saves_path(dirpath, name, number), "wb") as f:
            f.write(flax_msgpack.pack(tree))
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
    numpy or anything np.asarray takes), its weights row-major whatever the
    arrays' order (`hook.npz` loads Fortran-ordered): every loader of the
    port and an exported controller share one layout, so that a matrix
    product rounds alike in each."""
    return Chain([np.ascontiguousarray(p["w"], np.float32) for p in params],
                 [np.ascontiguousarray(p["b"], np.float32) for p in params])


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


# ------------------------------------------------------------ agent state
def jax_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` for the default (threefry) PRNG: uint32[2],
    `[0, seed]` below 2**32; above, the high word is `seed >> 32`, as JAX
    makes it with 64-bit mode on, so that `seed_of_key` gives the seed back."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def seed_of_key(key) -> int:
    """A generator seed from a JAX key's uint32 words: the seed `jax_key`
    was given for a key it made; the last two words of any other key."""
    seed = 0
    for word in np.asarray(key, np.uint32).ravel():
        seed = ((seed << 32) | int(word)) & 0xFFFFFFFFFFFFFFFF
    return seed


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _chain_state_dict(w_list, b_list) -> dict:
    """A chain as flax writes the JAX package's [{"w", "b"}, ...] list (a map
    keyed "0", "1", ... whose layers list "b" before "w", as `jax.tree.map`
    rebuilds them)."""
    return {str(i): {"b": b, "w": w} for i, (w, b) in enumerate(zip(w_list, b_list))}


def _adam_state_dict(opt: torch.optim.Adam, chain: Chain) -> dict:
    """torch Adam state over `chain` as optax's `adam` state (ScaleByAdamState
    then the EmptyState of the learning-rate scale): count, mu, nu."""
    def moment(p, key):
        state = opt.state.get(p)
        return _host(state[key]) if state else np.zeros(tuple(p.shape), np.float32)

    first = opt.state.get(chain.w[0])
    count = int(float(first["step"])) if first else 0
    return {"0": {"count": np.array(count, np.int32),
                  "mu": _chain_state_dict([moment(p, "exp_avg") for p in chain.w],
                                          [moment(p, "exp_avg") for p in chain.b]),
                  "nu": _chain_state_dict([moment(p, "exp_avg_sq") for p in chain.w],
                                          [moment(p, "exp_avg_sq") for p in chain.b])},
            "1": {}}


def agent_state_dict(state: DDPGState) -> dict:
    """The JAX package's `DDPGState` state dict (its field order) of numpy
    arrays; scalars are 0-d arrays: float32 noise and losses, int32 counters."""
    chains = {name: getattr(state, name) for name in ("actor", "critic", "target_actor",
                                                       "target_critic")}
    out = {name: _chain_state_dict([_host(w) for w in c.w], [_host(b) for b in c.b])
           for name, c in chains.items()}
    out["opt_actor"] = _adam_state_dict(state.opt_actor, state.actor)
    out["opt_critic"] = _adam_state_dict(state.opt_critic, state.critic)
    out["act_noise"] = np.array(state.act_noise, np.float32)
    out["update_step"] = np.array(state.update_step, np.int32)
    out["actor_loss"] = np.array(float(state.actor_loss), np.float32)
    out["critic_loss"] = np.array(float(state.critic_loss), np.float32)
    return out


def _jax_like(agent: dict) -> SimpleNamespace:
    """The attribute view of a `DDPGState` state dict that
    `ddpg_state_from_jax` reads."""
    def chain(d):
        return [d[str(i)] for i in range(len(d))]

    def adam(d):
        s = d["0"]
        return (SimpleNamespace(count=s["count"], mu=chain(s["mu"]), nu=chain(s["nu"])),)

    return SimpleNamespace(
        **{k: chain(agent[k]) for k in ("actor", "critic", "target_actor", "target_critic")},
        opt_actor=adam(agent["opt_actor"]), opt_critic=adam(agent["opt_critic"]),
        **{k: agent[k] for k in ("act_noise", "update_step", "actor_loss", "critic_loss")})


def _state_key(ts: TrainState) -> np.ndarray:
    """The uint32 key words `save` writes for `ts` (see the module docstring)."""
    if ts.key is not None:
        return np.asarray(ts.key, np.uint32)
    return jax_key(ts.generator.initial_seed() if ts.generator is not None else 0)


def replay_state_dict(rb: Replay) -> dict:
    """The JAX package's `Replay` state dict: `s`, `a`, `sn` slot-minor
    (dim, capacity), `r`, `t` (capacity,), int32 `ptr` and `size`."""
    return {"s": _host(rb.s), "a": _host(rb.a), "r": _host(rb.r), "t": _host(rb.t),
            "sn": _host(rb.sn), "ptr": np.array(rb.ptr, np.int32),
            "size": np.array(rb.size, np.int32)}


def agent_from_state_dict(tree: dict, agent: DDPGAgent, path: str, device) -> DDPGState:
    """The port's DDPGState from a checkpoint's "agent" state dict; the
    networks must have the layer sizes of `agent`'s config."""
    jstate = _jax_like(tree)
    for name, sizes in (("actor", agent.actor_layer_sizes), ("critic", agent.critic_layer_sizes)):
        got = [np.shape(getattr(jstate, name)[0]["w"])[1]] + [
            np.shape(layer["w"])[0] for layer in getattr(jstate, name)]
        if got != list(sizes):
            raise ValueError(f"the {name} in {path} has layer sizes {got}, the agent's config "
                             f"{list(sizes)}")
    return ddpg_state_from_jax(agent, jstate, device)


def _replay_from_tree(tree: dict, agent: DDPGAgent, path: str, device) -> Replay:
    """The port's Replay from a full checkpoint's "replay" state dict, as the
    JAX loader takes it against a template of the agent's capacity: the
    slot-minor (dim, capacity) layout as it is, the older row-major
    (capacity, dim) transposed (decided on `s`, as JAX does), anything else
    refused."""
    cfg = agent.cfg
    want = (cfg.ns, cfg.capacity)
    s, a, sn = (np.asarray(tree[k]) for k in ("s", "a", "sn"))
    if s.shape != want:
        if s.shape != want[::-1]:
            raise ValueError(
                f"checkpoint replay state shape {s.shape} in {path} matches neither the "
                f"template's {want} nor its row-major transpose; rebuild the agent with the "
                "checkpoint's capacity to resume from it")
        s, a, sn = s.T, a.T, sn.T
    return replay_from_jax(SimpleNamespace(s=s, a=a, r=tree["r"], t=tree["t"], sn=sn,
                                           ptr=tree["ptr"], size=tree["size"]), device)


# -------------------------------------------------------------------- PPO
def _ppo_moments(tensors: list, names: list, n_layers: dict) -> dict:
    """Adam moments (one per tensor of `param_tensors`) as optax writes them:
    a dict keyed by the param names in sorted order (`jax.tree.map` rebuilds
    dicts sorted), each a chain state dict."""
    it = iter(_host(t) for t in tensors)
    by_name = {}
    for name in names:
        pairs = [(next(it), next(it)) for _ in range(n_layers[name])]
        by_name[name] = _chain_state_dict([w for w, _ in pairs], [b for _, b in pairs])
    return {name: by_name[name] for name in sorted(names)}


def ppo_state_dict(state) -> dict:
    """The JAX package's `PPOState` state dict of numpy arrays (see the
    module docstring)."""
    from distributedconvrl_pde_control_torch.agents.ppo import PARAM_NAMES

    names = list(PARAM_NAMES)
    chains = {name: getattr(state, name) for name in names}
    out = {name: _chain_state_dict([_host(w) for w in c.w], [_host(b) for b in c.b])
           for name, c in chains.items()}
    n_layers = {name: len(c.w) for name, c in chains.items()}
    adam = {"count": np.array(state.adam_count, np.int32),
            "mu": _ppo_moments(state.adam_mu, names, n_layers),
            "nu": _ppo_moments(state.adam_nu, names, n_layers)}
    out["opt_state"] = {"0": {}, "1": {"0": adam, "1": {}}}
    out["update_count"] = np.array(state.update_count, np.int32)
    return out


def _ppo_best_key(name: str, layer: int, leaf: str) -> str:
    """The npz key of a best-params leaf: "best_" + `jax.tree_util.keystr`
    of its path, as in "best_['critic'][0]['b']"."""
    return f"best_['{name}'][{layer}]['{leaf}']"


def save_ppo(dirpath: str, pstate, info: dict) -> None:
    """Checkpoint a PPO run: the `PPOState` as `saves/ppo.msgpack` and the
    reward history, selection trail and best params (a numpy pytree
    {name: [{"w", "b"}, ...]}, as `train_ppo` gives them) as
    `saves/ppo_info.npz`."""
    os.makedirs(os.path.join(dirpath, "saves"), exist_ok=True)
    with open(os.path.join(dirpath, "saves", "ppo.msgpack"), "wb") as f:
        f.write(flax_msgpack.pack(ppo_state_dict(pstate)))
    payload = {
        "rewards": np.asarray(info["rewards"], np.float64),
        "meta": np.frombuffer(json.dumps({
            "best_reward": float(info["best_reward"]),
            "best_iter": int(info["best_iter"]),
            "selection": info.get("selection", "rollout"),
            "evals": [[int(i), float(r)] for i, r in info.get("evals", [])],
        }).encode(), dtype=np.uint8),
    }
    best = info.get("best_params")
    if best is not None:
        for name in sorted(best):
            for i, layer in enumerate(best[name]):
                for leaf in ("b", "w"):
                    payload[_ppo_best_key(name, i, leaf)] = np.asarray(layer[leaf])
    np.savez_compressed(os.path.join(dirpath, "saves", "ppo_info.npz"), **payload)


def load_ppo(dirpath: str, agent, device="cuda"):
    """(PPOState on `device`, info) of the PPO checkpoint in `dirpath`/saves,
    written by either package; info holds `rewards`, the meta keys and, when
    stored, `best_params` as a numpy pytree {name: [{"w", "b"}, ...]}. The
    networks must have the layer sizes of `agent`'s config."""
    from distributedconvrl_pde_control_torch.agents.ppo import PARAM_NAMES, params_from_numpy

    path = os.path.join(dirpath, "saves", "ppo.msgpack")
    with open(path, "rb") as f:
        tree = flax_msgpack.unpack(f.read())
    cfg = agent.cfg
    want = {"trunk": [cfg.ns, cfg.hidden, cfg.hidden], "mu": [cfg.hidden, cfg.na],
            "logsig": [cfg.hidden, cfg.na], "critic": [cfg.ns, cfg.hidden, cfg.hidden, 1]}

    def chain_tree(d):
        return [d[str(i)] for i in range(len(d))]

    params_np = {name: chain_tree(tree[name]) for name in PARAM_NAMES}
    for name, layers in params_np.items():
        got = [np.shape(layers[0]["w"])[1]] + [np.shape(l["w"])[0] for l in layers]
        if got != want[name]:
            raise ValueError(f"the {name} chain in {path} has layer sizes {got}, the agent's "
                             f"config {want[name]}")
    params = params_from_numpy(params_np, device)
    adam = tree["opt_state"]["1"]["0"]

    def moments(d):
        return [torch.as_tensor(np.asarray(l[leaf], np.float32), device=device).clone()
                for name in PARAM_NAMES for l in chain_tree(d[name]) for leaf in ("w", "b")]

    state = agent.make_state(params, adam_count=int(np.asarray(adam["count"])),
                             adam_mu=moments(adam["mu"]), adam_nu=moments(adam["nu"]),
                             update_count=int(np.asarray(tree["update_count"])))
    with np.load(os.path.join(dirpath, "saves", "ppo_info.npz"), allow_pickle=False) as data:
        info = {"rewards": np.asarray(data["rewards"]),
                **json.loads(bytes(data["meta"]).decode())}
        if any(k.startswith("best_") for k in data.files):
            info["best_params"] = {
                name: [{leaf: np.asarray(data[_ppo_best_key(name, i, leaf)], np.float32)
                        for leaf in ("w", "b")} for i in range(len(params_np[name]))]
                for name in PARAM_NAMES}
    return state, info


def eval_actor(ts: TrainState, hook: PDEHook, device="cuda") -> Chain:
    """The actor an evaluation rolls: the hook's best actor, else the
    state's current one."""
    return actor_from_jax(hook.best_actor).to(device) if hook.best_actor is not None else ts.agent.actor


def load_actor(dirpath: str, agent: DDPGAgent, device="cuda") -> Chain:
    """`eval_actor` of the checkpoint in `dirpath`, on `device`."""
    return eval_actor(*load(dirpath, agent, device=device), device=device)


def load(dirpath: str, agent: DDPGAgent, number: Optional[int] = None, device="cuda"):
    """(TrainState, PDEHook) of the checkpoint in `dirpath`/saves: the full
    `agent{number}.msgpack` when it exists, else the light
    `agent_light{number}.msgpack` with an empty replay of the agent's
    capacity, as the JAX `checkpoint.load` chooses; written by either
    package. The networks must have the layer sizes of `agent`'s config. The
    state's key is the file's; its generator (on `device`) is seeded with
    `resume_seed` of the key's seed and the hook's episode counter."""
    path = _saves_path(dirpath, "agent{}.msgpack", number)
    full = os.path.exists(path)
    if not full:
        path = _saves_path(dirpath, "agent_light{}.msgpack", number)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint at {_saves_path(dirpath, 'agent{}.msgpack', number)}"
                                    f" or {path}")
    with open(path, "rb") as f:
        tree = flax_msgpack.unpack(f.read())
    cfg = agent.cfg
    state = agent_from_state_dict(tree["agent"], agent, path, device)
    replay = (_replay_from_tree(tree["replay"], agent, path, device) if full
              else replay_init(cfg.capacity, cfg.ns, cfg.na_rows, device))
    key = np.asarray(tree["key"], np.uint32)
    hook = load_hook(dirpath, number)
    generator = torch.Generator(device=device).manual_seed(resume_seed(seed_of_key(key), hook.ep))
    return TrainState(agent=state, replay=replay, generator=generator, key=key), hook
