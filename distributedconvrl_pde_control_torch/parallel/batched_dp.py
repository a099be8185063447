"""Data-parallel scale-out of the batched trainer.

Counterpart of ``distributedconvrl_pde_control_tpu/parallel/batched_dp.py``.
The batched trainer (`train/batched.py`) steps `n_envs` environments in
lockstep; this module runs the same step on each rank of a pure-dp mesh of
ranks (``parallel/mesh.py``): rank d advances global envs
[d * n_envs / n_dp, (d + 1) * n_envs / n_dp) and pushes into a replay ring of
its own, and the only traffic between ranks is the DDPG gradient mean
(`agents/ddpg.py::learn_batch`'s `dp_group`, the sharded fluid trainer's dp
axis) plus three scalar collectives per step that keep the hook's accounting
global (the finished-episode sum, the best candidate's max, the mean
reward's mean).

What each rank holds:

  * its envs: `env_states`, `ep_reward` and `obs_flat`'s columns (env-major,
    so a dp split of columns is the env split), and its replay ring of
    `capacity_local` rows;
  * the networks, their optimizers and the hook scalars, replicated: the
    collectives keep them bit-identical on every rank;
  * its own generator, re-seeded per dp index after the networks are drawn
    (`parallel.mesh.fold_seed`, the JAX package's per-device key), so every
    rank draws its own exploration noise, samples and resets.

Every rank's state has the single-device trainer's fields at the local env
count, so the pipelined driver (`train_batched`), the hooks and the standard
checkpoint run unchanged on a `DPBatchedTrainer`: chunk records come back in
the packed (5, n_steps, n_envs) layout with the env axis in global order.

Learner: each rank samples `batch_size` transitions from its own ring and
the gradients are averaged over dp, so the effective batch is
n_dp * batch_size with per-rank sampling (the convention of the sharded fluid
trainer's capacity_per_dp / batch_size).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist

from distributedconvrl_pde_control_torch.agents.ddpg import DDPGAgent
from distributedconvrl_pde_control_torch.envs.pde_env import PDEEnv
from distributedconvrl_pde_control_torch.parallel.mesh import RankMesh, fold_seed, make_rank_mesh
from distributedconvrl_pde_control_torch.train.batched import (
    BatchedTrainer,
    BatchedTrainerConfig,
    BatchedTrainState,
    StepDraws,
)


def dp_mesh(n: Optional[int] = None, device: str = "cuda") -> Optional[RankMesh]:
    """A pure-dp mesh (n x 1) of the first `n` ranks (default: all) of the
    default process group, as this rank sees it, or None on a rank outside
    it; every rank of the group must call it (creating groups is collective).
    Without a process group, the mesh of one rank without groups."""
    if not dist.is_initialized():
        if n not in (None, 1):
            raise RuntimeError(f"a dp mesh of {n} ranks needs a process group "
                               "(parallel.mesh.launch)")
        return RankMesh(device=device)
    n = n or dist.get_world_size()
    return make_rank_mesh(n, 1, device)


class DPBatchedTrainer:
    """`train/batched.py`'s trainer on a rank of a pure-dp mesh.

    A drop-in for `BatchedTrainer` in `train_batched`: the same `init` /
    `make_chunk_fn` / `eval_mean_reward` / `cfg` surface and record layout.
    `cfg.n_envs` is the global env count and must divide by the mesh's dp
    size; `cfg.batch_size` is the per-rank learner batch (the effective batch
    is n_dp * batch_size, the gradients averaged)."""

    def __init__(self, env: PDEEnv, agent: DDPGAgent, cfg: BatchedTrainerConfig, mesh: RankMesh,
                 random_init: Optional[Callable] = None, y0_pool=None, eval_y0_pool=None):
        if mesh.sp != 1:
            raise ValueError(f"DPBatchedTrainer shards only over 'dp'; axis 'sp' has size "
                             f"{mesh.sp} (use a pure-dp mesh, e.g. dp_mesh())")
        self.mesh = mesh
        self.n_dp, self.dp_idx = mesh.dp, mesh.dp_idx
        if cfg.n_envs % self.n_dp:
            raise ValueError(f"n_envs={cfg.n_envs} must divide by dp={self.n_dp}")
        self.env, self.agent, self.cfg = env, agent, cfg
        n_local = cfg.n_envs // self.n_dp
        self.envs = slice(self.dp_idx * n_local, (self.dp_idx + 1) * n_local)
        # each rank's program is the single-device trainer at the local env count
        self.local = BatchedTrainer(env, agent, dataclasses.replace(cfg, n_envs=n_local),
                                    random_init=random_init, y0_pool=y0_pool,
                                    eval_y0_pool=eval_y0_pool)
        # the rank's replay ring: the capacity's share rounded up to the local
        # push width (the JAX package's rule)
        push_local = n_local * agent.cfg.n_actuators
        cap_local = max(1, agent.cfg.capacity // self.n_dp)
        self.capacity_local = ((cap_local + push_local - 1) // push_local) * push_local

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator, y0s=None, idx=None) -> BatchedTrainState:
        """This rank's part of a fresh state: the global env batch's initial
        fields (`y0s` (n_envs, ...) or pool rows `idx` (n_envs,), drawn as the
        single-device trainer draws them when neither is given) cut to its
        envs, the networks from `generator` (the same on every rank), then,
        when dp > 1, every later draw of the rank from `generator` re-seeded
        with `fold_seed`; the state keeps it. At dp = 1 this is the
        single-device trainer's `init`."""
        n = self.cfg.n_envs
        if y0s is None and idx is None:
            if self.local.y0_pool is not None:
                idx = torch.randint(0, self.local.y0_pool.shape[0], (n,), generator=generator,
                                    device=generator.device)
            else:
                y0s = self.local._fresh_y0s(generator, n)
        ts = self.local.init(generator, y0s=None if y0s is None else y0s[self.envs],
                             idx=None if idx is None else idx[self.envs],
                             capacity=self.capacity_local)
        if self.n_dp > 1:
            generator.manual_seed(fold_seed(generator.initial_seed(), self.dp_idx))
        return ts

    # ---------------------------------------------------------------- chunks
    def make_chunk_fn(self, n_steps: int, learn: bool = True):
        """The rank's chunk: `BatchedTrainer.make_chunk_fn` on this mesh,
        returning the packed (5, n_steps, n_envs) records of every rank's
        envs in global order."""
        return self.local.make_chunk_fn(n_steps, learn, mesh=self.mesh)

    # ------------------------------------------------------------------ eval
    def eval_mean_reward(self, actor_params, n_steps: int,
                         generator: Optional[torch.Generator] = None, warmup_steps: int = 0,
                         score: str = "mean", y0s: Optional[torch.Tensor] = None) -> float:
        """Deterministic eval on the local env batch: the networks are
        replicated, so every rank scores the same actor on the same drawn
        ICs and every rank's hook decides the same."""
        return self.local.eval_mean_reward(actor_params, n_steps, generator,
                                           warmup_steps=warmup_steps, score=score, y0s=y0s)


def merge_rank_draws(rank_draws: list, push: int) -> list:
    """The draws of a single-device chunk over the global env batch that
    repeats a dp chunk, from each rank's `StepDraws` sequence (`rank_draws[d]`,
    one per step; `push` a rank's push width, its envs x actuators): the
    noise and start columns and the reset draws concatenated in rank order,
    and each rank's replay offsets
    mapped to the rows its transitions take in the single-device replay, so
    that the learner batch is every rank's batch side by side. The gradient of
    the mean loss over that batch is the mean of the ranks' gradients, so the
    single-device chunk at batch n_dp * batch_size (with the same learn gate
    and capacity) is the dp chunk up to rounding."""
    n_dp = len(rank_draws)
    out = []
    for step in zip(*rank_draws):
        first = step[0]

        def glob(offs, d):
            return (offs // push) * (n_dp * push) + d * push + offs % push

        def cat(name, dim):
            parts = [getattr(s, name) for s in step]
            return None if parts[0] is None else torch.cat(parts, dim)

        out.append(StepDraws(
            noise=cat("noise", -1), start=cat("start", -1),
            offs=None if first.offs is None else torch.cat(
                [glob(s.offs, d) for d, s in enumerate(step)], -1),
            y0s=cat("y0s", 0), idx=cat("idx", 0)))
    return out
