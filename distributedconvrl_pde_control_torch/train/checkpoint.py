"""Checkpoint read side: the best actor of a JAX-package run.

Counterpart of the read half of ``distributedconvrl_pde_control_tpu/train/
checkpoint.py`` for what an evaluation needs: the hook's best actor, stored
as `best_actor_w{i}` / `best_actor_b{i}` arrays in `saves/hook.npz`. The
flax msgpack agent state is not read yet (ROADMAP.md queue 1 item 10).
"""

from __future__ import annotations

import os

import numpy as np

from distributedconvrl_pde_control_torch.models.mlp import Chain


def load_best_actor(dirpath: str) -> list[dict]:
    """The JAX actor pytree [{"w": (n_out, n_in), "b": (n_out,)}, ...] of the
    best actor in `dirpath`/saves/hook.npz, as numpy arrays."""
    path = os.path.join(dirpath, "saves", "hook.npz")
    with np.load(path) as data:
        n_layers = len([k for k in data.files if k.startswith("best_actor_w")])
        if n_layers == 0:
            raise ValueError(f"{path} holds no best actor (best_actor_w0 missing)")
        return [{"w": np.asarray(data[f"best_actor_w{i}"], np.float32),
                 "b": np.asarray(data[f"best_actor_b{i}"], np.float32)}
                for i in range(n_layers)]


def actor_from_jax(params) -> Chain:
    """The port's actor from a JAX actor pytree (a list of {"w", "b"} arrays,
    numpy or anything np.asarray takes)."""
    return Chain([np.asarray(p["w"], np.float32) for p in params],
                 [np.asarray(p["b"], np.float32) for p in params])
