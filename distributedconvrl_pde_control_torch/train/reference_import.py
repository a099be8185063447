"""Import the reference's shipped JLD2 checkpoints into the port.

Counterpart of ``distributedconvrl_pde_control_tpu/train/reference_import.py``
on the port's own JLD2 reader (`utils/jld2.py`, h5py imported when a file is
read): the chains drop into the port's `Chain`, and
`import_reference_checkpoint` writes the port's light checkpoint, which both
packages' `checkpoint.load` read.

The reference ships trained agents as `saves/agent.jld2` + `saves/hook.jld2`
per experiment (written by KSSetup.jl:390-402). A migrating user's existing
trained policies should not have to be retrained, so this module converts
them directly:

* `hook.jld2 -> bestNNA` — the network `plot_heat` actually evaluates
  (src/plotting.jl:28-30); present for EVERY shipped experiment, including
  those whose `agent.jld2` exceeded the reference repo's LFS limits.
* `agent.jld2 -> behavior/target actor+critic` + the scalar hyperparameters
  of `CustomDDPGPolicy` (src/PDEagent.jl:121-157), when present.

Flux `Dense` stores weight as (out, in) with column-major layout; after
JLD2's dimension reversal (utils/jld2.py) a transpose restores exactly the
(out, in) convention of models/mlp.py — the chains drop in unchanged, since
the MLP factory replicates `create_NNA` (src/PDEagent.jl:14-56) one-to-one.

The import doubles as an end-to-end semantic parity check: a policy trained
by the reference's Julia stack only controls this framework's environments
if the featurization, action smearing, reward and solver conventions all
match (tests/test_reference_import.py runs exactly that experiment on the JAX
package).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from distributedconvrl_pde_control_torch.utils.jld2 import (
    Unreadable,
    julia_array,
    load_jld2,
)

__all__ = [
    "load_reference_chain",
    "load_reference_best_actor",
    "load_reference_best_trace",
    "load_reference_agent",
    "load_warm_start",
    "import_reference_checkpoint",
]


def _chain(nna) -> list:
    """A Flux Chain (as derefed from JLD2) -> [{"w", "b"}, ...] float32."""
    layers = nna["model"]["layers"]
    out = []
    for name in sorted(layers, key=int):
        layer = layers[name]
        w = julia_array(layer["weight"]).astype(np.float32)
        b = julia_array(layer["bias"]).astype(np.float32)
        out.append({"w": w, "b": b})
    return out


def load_reference_chain(path: str, root: str, *fields) -> list:
    obj = load_jld2(path, root)
    for f in fields:
        obj = obj[f]
    return _chain(obj)


def load_reference_best_actor(saves_dir: str):
    """(best-actor chain, info) from a reference `saves/hook.jld2`.

    info: bestreward, bestepisode, rewards (per-episode history),
    errored_episodes. The bestNNA is what the reference's own evaluation
    path runs (src/plotting.jl:28-30)."""
    hook = load_jld2(os.path.join(saves_dir, "hook.jld2"), "hook")
    chain = _chain(hook["bestNNA"])

    def _vec(x):
        if x is None or isinstance(x, Unreadable):
            return None
        return np.atleast_1d(np.asarray(x, np.float64))

    info = {
        "bestreward": float(hook["bestreward"]),
        "bestepisode": int(hook["bestepisode"]),
        "rewards": _vec(hook.get("rewards")),
        # the completed-episode rewards the best gate compares against
        # (PDEhook.jl:66: reward >= maximum(rewards_compare)) — without it,
        # resumed training would clobber the imported best with the first
        # completed episode
        "rewards_compare": _vec(hook.get("rewards_compare")),
        "errored_episodes": hook.get("errored_episodes"),
    }
    return chain, info


def load_reference_best_trace(saves_dir: str) -> Optional[dict]:
    """The hook's stored best-episode trajectory (bestDF, a Julia DataFrame
    with columns timestep/action/p/y/reward — PDEhook.jl:54-62) as this
    framework's trace dict {"y", "forcing", "action", "reward"}, each
    (T, dim). Returns None when the bestDF is absent or not decodable
    (e.g. complex spectral fields the minimal reader skips)."""
    try:
        hook = load_jld2(os.path.join(saves_dir, "hook.jld2"), "hook")
        df = hook.get("bestDF")
        if not isinstance(df, dict) or "columns" not in df:
            return None
        names = {}
        for pair in df["colindex"]["lookup"]:
            names[int(np.asarray(pair["second"]).reshape(()))] = pair["first"]
        rename = {"p": "forcing"}
        out = {}
        for i, col in enumerate(np.atleast_1d(np.asarray(df["columns"], dtype=object))):
            name = names.get(i + 1)
            if name in (None, "timestep"):
                continue
            rows = col if isinstance(col, (list, np.ndarray)) else [col]
            try:
                arr = np.stack([np.asarray(r, np.float64) for r in rows])
            except (TypeError, ValueError):
                return None  # non-numeric column (complex struct etc.)
            out[rename.get(name, name)] = arr.astype(np.float32)
        return out if {"y", "forcing", "reward"} <= set(out) else None
    except Exception:
        return None


_POLICY_SCALARS = ("y", "p", "batch_size", "start_steps", "update_after",
                   "update_freq", "update_loops", "act_limit", "act_noise",
                   "memory_size", "update_step")


def load_reference_agent(saves_dir: str) -> dict:
    """Networks + hyperparameters from a reference `saves/agent.jld2`.

    Returns {"actor", "critic", "target_actor", "target_critic"} chains plus
    the CustomDDPGPolicy scalars (src/PDEagent.jl:121-157) under "hyper".
    Raises FileNotFoundError when the blob is LFS-missing in the reference
    snapshot — fall back to load_reference_best_actor."""
    path = os.path.join(saves_dir, "agent.jld2")
    pol = load_jld2(path, "agent")["policy"]
    nets = {
        "actor": _chain(pol["behavior_actor"]),
        "critic": _chain(pol["behavior_critic"]),
        "target_actor": _chain(pol["target_actor"]),
        "target_critic": _chain(pol["target_critic"]),
    }
    hyper = {}
    for k in _POLICY_SCALARS:
        v = pol.get(k)
        if v is not None and not isinstance(v, (Unreadable, dict)):
            hyper[k] = float(np.asarray(v).reshape(()))
    nets["hyper"] = hyper
    return nets


def _shapes(chain) -> list:
    """Layer weight shapes of a chain: a port `Chain` or a [{"w", "b"}] list."""
    if hasattr(chain, "w"):
        return [tuple(w.shape) for w in chain.w]
    return [tuple(np.asarray(layer["w"]).shape) for layer in chain]


def _check_shapes(name: str, got: list, want) -> None:
    got_s, want_s = _shapes(got), _shapes(want)
    if got_s != want_s:
        raise ValueError(
            f"imported {name} layer shapes {got_s} do not match the preset's "
            f"template {want_s} — wrong preset for this reference save dir?")


def load_warm_start(saves_dir: str) -> dict:
    """Network chains for warm-starting a trainer from a reference save:
    {"actor", "target_actor"} always (hook bestNNA), plus {"critic",
    "target_critic"} and the behavior nets when agent.jld2 is present.
    Used by the CLI's --batched --import-jld2 "migrate and improve" path."""
    best_chain, _ = load_reference_best_actor(saves_dir)
    try:
        nets = load_reference_agent(saves_dir)
        return {k: nets[k] for k in
                ("actor", "critic", "target_actor", "target_critic")}
    except (FileNotFoundError, OSError):
        return {"actor": best_chain, "target_actor": best_chain}


def import_reference_checkpoint(saves_dir: str, setup, out_dir: Optional[str] = None,
                                seed: int = 0):
    """Convert a reference experiment's saves/ into the port's standard
    (light) checkpoint.

    Builds a fresh TrainState on `setup` (the matching preset, on its env's
    device) from a generator seeded `seed`, loads the imported networks into
    its chains in place (the Adam states stay bound to them): behavior and
    target actor and critic when agent.jld2 is present, else hook bestNNA as
    the current and target actor; and a PDEHook carrying the reference's
    reward history and best metadata. When `out_dir` is given, writes the
    light checkpoint there, so that --eval/--load-from/--resume of either
    package take over.

    Returns (TrainState, PDEHook)."""
    import torch

    from distributedconvrl_pde_control_torch.models.mlp import Chain, chain_to_numpy
    from distributedconvrl_pde_control_torch.train import checkpoint
    from distributedconvrl_pde_control_torch.train.hooks import PDEHook
    from distributedconvrl_pde_control_torch.train.loop import init_train_state

    device = setup.env.y0.device
    ts = init_train_state(setup.env, setup.agent,
                          torch.Generator(device=device).manual_seed(seed))

    best_chain, info = load_reference_best_actor(saves_dir)
    _check_shapes("bestNNA actor", best_chain, ts.agent.actor)

    def load_into(name: str, chain: list) -> None:
        params = Chain([layer["w"] for layer in chain], [layer["b"] for layer in chain])
        getattr(ts.agent, name).load_state_dict(params.state_dict())

    try:
        nets = load_reference_agent(saves_dir)
    except (FileNotFoundError, OSError):
        nets = None  # LFS-missing blob: bestNNA becomes the behavior actor too
    if nets is not None:
        _check_shapes("behavior actor", nets["actor"], ts.agent.actor)
        _check_shapes("behavior critic", nets["critic"], ts.agent.critic)
        for name in ("actor", "critic", "target_actor", "target_critic"):
            load_into(name, nets[name])
        if "act_noise" in nets["hyper"]:
            ts.agent.act_noise = float(np.float32(nets["hyper"]["act_noise"]))
    else:
        load_into("actor", best_chain)
        load_into("target_actor", best_chain)

    hook = PDEHook(collect_best_trace=False)
    hook.best_trace = load_reference_best_trace(saves_dir)
    hook.best_actor = [{"w": np.asarray(l["w"]), "b": np.asarray(l["b"])}
                       for l in best_chain]
    hook.current_actor = chain_to_numpy(ts.agent.actor)
    hook.bestreward = info["bestreward"]
    hook.bestepisode = info["bestepisode"]
    if info["rewards"] is not None:
        hook.rewards = [float(r) for r in info["rewards"]]
        hook.ep = len(hook.rewards) + 1
    if info["rewards_compare"] is not None:
        hook.rewards_compare = [float(r) for r in info["rewards_compare"]]
    elif not hook.rewards_compare:
        # keep the best gate intact even if the history column was skipped
        hook.rewards_compare = [info["bestreward"]]
    ee = info.get("errored_episodes")
    if isinstance(ee, (list, np.ndarray)):
        try:
            hook.errored_episodes = [
                int(e) for e in np.atleast_1d(np.asarray(ee, np.int64))]
        except (TypeError, ValueError):
            pass  # undecodable column — leave the fresh hook's empty list

    if out_dir is not None:
        checkpoint.save(out_dir, ts, hook, include_replay=False)
    return ts, hook
