"""Population trainer: P independent training runs fused into one program.

Counterpart of ``distributedconvrl_pde_control_tpu/train/population.py``.
The studies the repo runs are populations (training-seed robustness tables,
noise-schedule ablations, learning-rate sweeps; RESULTS.md), and a 256-env
member is far too small to fill the card. As in the JAX package the members
are flattened into the env axis: one `BatchedTrainer` over P * B envs,
member-major, so the solver, featurizer, auto-reset, replay push (one
contiguous block at one shared pointer) and accounting are those of the
single-run train step, which runs unchanged. What differs per member is
batched over a leading (P,) axis in `PopulationDDPG`: the actor and critic
forwards over member column blocks (batched matrix products), the sampling
of each member's replay region, and the per-member Adam steps.

Per-member variation inside the one program:

* draws: member-major env blocks reset from independent draws; the
  exploration noise is one draw over all columns;
* `act_noise` and its decay: a (P,) tensor scaled per member column block;
  the driver decays it with a (P,) factor;
* actor and critic learning rates: a (P,) learning rate in the stacked Adam
  (optax's `inject_hyperparams(adam)` in the JAX package; torch's Adam takes
  one scalar, so the Adam is written out on the stacked tensors).

Members are isolated by construction: member p's policy sees only its own
columns, its gradients come only from its own replay region (the slot
arithmetic of `member_slot_indices`) and its Adam moments are its own row.
The learner sums the members' losses, so that each member's gradient is its
own loss's, and keeps the stock order: the critic step first, then the
actor through the updated critic.

Population x dp (`mesh`, a pure-dp `RankMesh`): the study sharded over the
ranks of a mesh, as the JAX package shards it over devices. Every rank runs a
local mini-population, P members x (n_envs / n_dp) envs member-major, on a
`parallel/batched_dp.py::DPBatchedTrainer`, so the global env axis is
rank-major (rank d's block holds a member-major block of every member). The
stacked per-member gradients are averaged over dp elementwise, so member p's
gradients reduce over p's env blocks on every rank and never mix with
another member's. Replay regions, slot arithmetic, noise blocks and the
auto-reset run on local widths unchanged. Member evals run on one rank's
local env batch (the networks are replicated), n_envs / n_dp ICs per member.
"""

from __future__ import annotations

import dataclasses
import json
import os
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np
import torch

from distributedconvrl_pde_control_torch.agents.ddpg import DDPGAgent, DDPGState, dp_mean
from distributedconvrl_pde_control_torch.agents.replay import Replay
from distributedconvrl_pde_control_torch.models.mlp import Chain, chain_to_numpy, copy_chain
from distributedconvrl_pde_control_torch.train.batched import (
    BatchedTrainer,
    BatchedTrainerConfig,
    eval_rollout,
    score_rollout,
)
from distributedconvrl_pde_control_torch.train.hooks import PDEHook
from distributedconvrl_pde_control_torch.train.records import (
    consume_record_read,
    start_record_read,
)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults
PIPELINE_DEPTH = 4  # chunks in flight before their records are read, as train_batched


def member_slot_indices(generator: torch.Generator, n_chunks: int, n_members: int, block: int,
                        batch_size: int) -> torch.Tensor:
    """(P, batch_size) replay rows, uniform over each member's filled region.

    The flat trainer pushes P * block rows per step, member-major (block =
    per-member envs x actuators), so member p owns the rows
    k * (P * block) + p * block + j for push k < n_chunks and offset j < block:
    two draws, the push and the offset, drawn on the generator's device."""
    gdev = generator.device
    k_idx = torch.randint(0, max(n_chunks, 1), (n_members, batch_size), generator=generator,
                          device=gdev)
    j_idx = torch.randint(0, block, (n_members, batch_size), generator=generator, device=gdev)
    return member_slots(k_idx, j_idx, block)


def member_slots(k_idx: torch.Tensor, j_idx: torch.Tensor, block: int) -> torch.Tensor:
    """The rows of pushes `k_idx` and offsets `j_idx`, each (P, batch): member
    p's row k * (P * block) + p * block + j."""
    n_members = k_idx.shape[0]
    members = torch.arange(n_members, device=k_idx.device)[:, None]
    return k_idx * (n_members * block) + members * block + j_idx


def stack_chains(chains: list) -> Chain:
    """One chain whose every tensor has a leading (P,) member axis."""
    return Chain([torch.stack([c.w[i] for c in chains]) for i in range(len(chains[0].w))],
                 [torch.stack([c.b[i] for c in chains]) for i in range(len(chains[0].b))])


def member_chain(stacked: Chain, i: int) -> list:
    """Member i of a stacked chain as a numpy [{"w", "b"}, ...] pytree."""
    return [{"w": layer["w"][i], "b": layer["b"][i]} for layer in chain_to_numpy(stacked)]


def chain_tensors(chain: Chain) -> list:
    """A chain's tensors layer by layer: w0, b0, w1, b1, ..."""
    return [t for w, b in zip(chain.w, chain.b) for t in (w, b)]


def apply_stacked(params: Chain, x: torch.Tensor, hidden_act: Callable,
                  final_act: Optional[Callable]) -> torch.Tensor:
    """y_p = chain_p(x_p) for every member p: x (P, features, cols)."""
    h = x
    n = len(params.w)
    for i, (w, b) in enumerate(zip(params.w, params.b)):
        h = torch.baddbmm(b.unsqueeze(-1), w, h)
        if i < n - 1:
            h = hidden_act(h)
        elif final_act is not None:
            h = final_act(h)
    return h


class StackedAdam:
    """optax's `adam` over stacked (P, ...) member tensors with a (P,)
    learning rate (the JAX package's `inject_hyperparams(adam)` under the
    member axis): every member's moments and step are its own row; the step
    count is one host integer, as the members step in lockstep."""

    def __init__(self, params: list, lr: torch.Tensor):
        self.params = params
        self.count = 0
        self.exp_avg = [torch.zeros_like(p, requires_grad=False) for p in params]
        self.exp_avg_sq = [torch.zeros_like(p, requires_grad=False) for p in params]
        # the learning rate broadcast to each tensor's shape, once
        self._lr = [lr.reshape((-1,) + (1,) * (p.dim() - 1)).expand_as(p).contiguous()
                    for p in params]

    @torch.no_grad()
    def step(self, grads: list) -> None:
        self.count += 1
        torch._foreach_mul_(self.exp_avg, ADAM_B1)
        torch._foreach_add_(self.exp_avg, grads, alpha=1.0 - ADAM_B1)
        torch._foreach_mul_(self.exp_avg_sq, ADAM_B2)
        torch._foreach_addcmul_(self.exp_avg_sq, grads, grads, value=1.0 - ADAM_B2)
        denom = torch._foreach_div(self.exp_avg_sq, 1.0 - ADAM_B2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        step = torch._foreach_div(self.exp_avg, 1.0 - ADAM_B1 ** self.count)
        torch._foreach_div_(step, denom)
        torch._foreach_mul_(step, self._lr)
        torch._foreach_sub_(self.params, step)


class PopulationDDPG(DDPGAgent):
    """A DDPGAgent with a leading (P,) member axis on its networks and
    optimizers, presenting the stock agent interface over member-major column
    blocks so that `BatchedTrainer._train_step` runs unchanged on the flat
    P * B env batch.

    The `cfg` it shows the trainer scales `capacity` and `update_after` by P:
    the shared buffer holds every member's region, and the learn gate fires
    at the per-member fill of a standalone run."""

    def __init__(self, base_cfg, n_members: int, n_envs_per_member: int, lr_actor=None,
                 lr_critic=None, hidden_act: Callable = torch.relu,
                 hidden_act_critic: Optional[Callable] = None):
        self.n_members = int(n_members)
        self.block = n_envs_per_member * base_cfg.n_actuators
        self.base_cfg = base_cfg
        self.lr_actor = None if lr_actor is None else np.asarray(lr_actor, np.float32)
        self.lr_critic = None if lr_critic is None else np.asarray(lr_critic, np.float32)
        for nm, arr in (("lr_actor", self.lr_actor), ("lr_critic", self.lr_critic)):
            if arr is not None and arr.shape != (self.n_members,):
                raise ValueError(f"{nm} must be shape ({self.n_members},), got {arr.shape}")
        super().__init__(dataclasses.replace(base_cfg, capacity=base_cfg.capacity * self.n_members,
                                             update_after=base_cfg.update_after * self.n_members),
                         hidden_act=hidden_act, hidden_act_critic=hidden_act_critic)
        # the standalone agent: member inits and the format of member_state
        self._solo = DDPGAgent(base_cfg, hidden_act=self.hidden_act,
                               hidden_act_critic=self.hidden_act_critic)

    # -------------------------------------------------------- member blocks
    def _to_members(self, x: torch.Tensor) -> torch.Tensor:
        """(rows, P*block_cols) member-major columns -> (P, rows, block_cols)."""
        rows, cols = x.shape
        return x.reshape(rows, self.n_members, cols // self.n_members).permute(1, 0, 2)

    @staticmethod
    def _from_members(x: torch.Tensor) -> torch.Tensor:
        """(P, rows, block_cols) -> (rows, P*block_cols) member-major."""
        p, rows, bc = x.shape
        return x.permute(1, 0, 2).reshape(rows, p * bc)

    # ------------------------------------------------------------- networks
    def _actor_m(self, params: Chain, s: torch.Tensor) -> torch.Tensor:
        return apply_stacked(params, s, self.hidden_act, torch.tanh)

    def _critic_m(self, params: Chain, s: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        return apply_stacked(params, torch.cat([s, a], dim=1), self.hidden_act_critic, None)

    def actor_apply(self, params: Chain, s: torch.Tensor) -> torch.Tensor:
        """Each member's actor over its block of the member-major columns."""
        return self._from_members(self._actor_m(params, self._to_members(s)))

    def critic_apply(self, params: Chain, s: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        return self._from_members(self._critic_m(params, self._to_members(s),
                                                 self._to_members(a)))

    # ------------------------------------------------------------------ init
    def _lr(self, given, default: float, device) -> torch.Tensor:
        lr = np.full((self.n_members,), default, np.float32) if given is None else given
        return torch.as_tensor(lr, device=device)

    def make_state(self, actor: Chain, critic: Chain, target_actor: Optional[Chain] = None,
                   target_critic: Optional[Chain] = None) -> DDPGState:
        """A state around stacked behaviour networks: stacked Adams with the
        per-member learning rates (the config's where none are given), the
        config's noise for every member, step 0."""
        cfg = self.cfg
        device = next(actor.parameters()).device
        p = self.n_members
        return DDPGState(
            actor=actor, critic=critic,
            target_actor=copy_chain(actor) if target_actor is None else target_actor,
            target_critic=copy_chain(critic) if target_critic is None else target_critic,
            opt_actor=StackedAdam(chain_tensors(actor),
                                  self._lr(self.lr_actor, cfg.learning_rate, device)),
            opt_critic=StackedAdam(chain_tensors(critic),
                                   self._lr(self.lr_critic, cfg.learning_rate_critic, device)),
            act_noise=torch.full((p,), cfg.act_noise, dtype=torch.float32, device=device),
            update_step=0,
            actor_loss=torch.zeros((p,), dtype=torch.float32, device=device),
            critic_loss=torch.zeros((p,), dtype=torch.float32, device=device))

    def init_state(self, generator: torch.Generator, device="cuda") -> DDPGState:
        """P standalone member inits drawn one after another from
        `generator`, stacked."""
        members = [self._solo.init_state(generator, device) for _ in range(self.n_members)]
        return self.make_state(stack_chains([m.actor for m in members]),
                               stack_chains([m.critic for m in members]))

    # ------------------------------------------------------------------- act
    @torch.no_grad()
    def act(self, astate: DDPGState, obs: torch.Tensor,
            generator: Optional[torch.Generator] = None, learning: bool = True,
            noise: Optional[torch.Tensor] = None, start: Optional[torch.Tensor] = None):
        """The policy over the flat member-major columns: each member's actor,
        one exploration-noise draw scaled by each member's act_noise over its
        column block (memory rows zeroed), the shared warmup gate; the draws
        in the stock `act`'s order, `noise` and `start` replacing them."""
        cfg = self.cfg
        actions = self.actor_apply(astate.actor, obs)
        shape = actions.shape
        if learning:
            if astate.update_step <= cfg.start_steps:
                actions = (self.start_action(generator, shape, obs, obs.device) if start is None
                           else start.to(obs.device))
            else:
                if noise is None:
                    gdev = obs.device if generator is None else generator.device
                    noise = torch.randn(shape, generator=generator, dtype=torch.float32,
                                        device=gdev)
                scale = astate.act_noise[:, None].expand(self.n_members, self.block)
                noise = noise.to(obs.device) * scale.reshape(1, -1)
                if cfg.memory_size > 0:
                    noise[-cfg.memory_size:, :] = 0.0
                actions = actions + noise
        return torch.clamp(actions, -cfg.act_limit, cfg.act_limit)

    # ----------------------------------------------------------------- learn
    def sample(self, replay: Replay, batch_size: int,
               generator: Optional[torch.Generator] = None, offs=None):
        """Member-region sampling: (P, batch) rows of `member_slot_indices`
        (`offs` replaces the draw), gathered once into (P,)-stacked column
        batches (s, a, sn: (P, dim, batch); r, t: (P, batch))."""
        p, block = self.n_members, self.block
        idx = (member_slot_indices(generator, replay.size // (p * block), p, block, batch_size)
               if offs is None else offs)
        rows = replay.buf.index_select(0, idx.to(replay.buf.device).reshape(-1))
        rows = rows.reshape(p, batch_size, -1)
        ns, na = replay.ns, replay.na
        return (rows[..., :ns].transpose(1, 2), rows[..., ns:ns + na].transpose(1, 2),
                rows[..., ns + na], rows[..., ns + na + 1], rows[..., ns + na + 2:].transpose(1, 2))

    def learn_batch(self, astate: DDPGState, batch, dp_group=None) -> DDPGState:
        """The stock learn step (PDEagent.jl:363-418) for every member at once,
        in place: the sum of the members' losses, so that each member's
        gradient is its own loss's; the critic step, then the actor through
        the updated critic, then the polyak averaging. `dp_group`: the stacked
        gradients are averaged over its ranks, elementwise, before each Adam
        step (member p's rows only with member p's)."""
        cfg = self.cfg
        s, a, r, t, sn = batch
        with torch.no_grad():
            q_next = self._critic_m(astate.target_critic, sn,
                                    self._actor_m(astate.target_actor, sn))[:, 0]
            q_target = r + cfg.gamma * (1.0 - t) * q_next
        critic_params = chain_tensors(astate.critic)
        c_loss = torch.mean((q_target - self._critic_m(astate.critic, s, a)[:, 0]) ** 2, dim=1)
        astate.opt_critic.step(dp_mean(torch.autograd.grad(c_loss.sum(), critic_params),
                                        dp_group))
        actor_params = chain_tensors(astate.actor)
        a_loss = -torch.mean(self._critic_m(astate.critic, s, self._actor_m(astate.actor, s))[:, 0],
                             dim=1)
        astate.opt_actor.step(dp_mean(torch.autograd.grad(a_loss.sum(), actor_params),
                                       dp_group))
        with torch.no_grad():
            targets = chain_tensors(astate.target_actor) + chain_tensors(astate.target_critic)
            torch._foreach_mul_(targets, cfg.polyak)
            torch._foreach_add_(targets, actor_params + critic_params, alpha=1.0 - cfg.polyak)
        astate.actor_loss = a_loss.detach()
        astate.critic_loss = c_loss.detach()
        return astate

    # ------------------------------------------------------------- slicing
    def member_state(self, astate: DDPGState, i: int) -> DDPGState:
        """Member i's standalone DDPGState (torch Adams over its own chains):
        its Adam moments and count, or fresh moments when per-member learning
        rates were in play, as the JAX package gives."""
        from distributedconvrl_pde_control_torch.train.checkpoint import ddpg_state_from_jax

        fresh = self.lr_actor is not None or self.lr_critic is not None

        def adam(opt: StackedAdam):
            def layers(ts):
                return [{"w": ts[2 * l][i].cpu().numpy(), "b": ts[2 * l + 1][i].cpu().numpy()}
                        for l in range(len(ts) // 2)]

            mu, nu = layers(opt.exp_avg), layers(opt.exp_avg_sq)
            if fresh:
                mu = nu = [{k: np.zeros_like(v) for k, v in l.items()} for l in mu]
            return (SimpleNamespace(count=0 if fresh else opt.count, mu=mu, nu=nu),)

        jstate = SimpleNamespace(
            **{name: member_chain(getattr(astate, name), i)
               for name in ("actor", "critic", "target_actor", "target_critic")},
            opt_actor=adam(astate.opt_actor), opt_critic=adam(astate.opt_critic),
            act_noise=float(astate.act_noise[i]), update_step=astate.update_step,
            actor_loss=float(astate.actor_loss[i]), critic_loss=float(astate.critic_loss[i]))
        return ddpg_state_from_jax(self._solo, jstate, next(astate.actor.parameters()).device)


class PopulationTrainer:
    """A P-member population as one flat `BatchedTrainer`.

    `cfg.n_envs` is per member (global on a mesh); the trainer runs P *
    n_envs envs, member-major. `lr_actor` / `lr_critic`: optional (P,)
    per-member learning rates (see `PopulationDDPG`). `mesh`: a pure-dp
    `RankMesh`, the population x dp of the module docstring; per-member
    n_envs must divide by its dp size."""

    def __init__(self, env, agent: DDPGAgent, cfg: BatchedTrainerConfig, n_members: int,
                 random_init=None, y0_pool=None, eval_y0_pool=None, lr_actor=None,
                 lr_critic=None, mesh=None):
        self.n_members = int(n_members)
        self.mesh = mesh
        self.n_dp = 1 if mesh is None else mesh.dp
        if cfg.n_envs % self.n_dp:
            raise ValueError(f"per-member n_envs={cfg.n_envs} must divide by dp={self.n_dp}")
        self.n_envs_member_local = cfg.n_envs // self.n_dp
        self.agent = PopulationDDPG(agent.cfg, self.n_members, self.n_envs_member_local,
                                    lr_actor=lr_actor, lr_critic=lr_critic,
                                    hidden_act=agent.hidden_act,
                                    hidden_act_critic=agent.hidden_act_critic)
        flat_cfg = dataclasses.replace(cfg, n_envs=self.n_members * cfg.n_envs)
        if mesh is None:
            self.base = BatchedTrainer(env, self.agent, flat_cfg, random_init=random_init,
                                       y0_pool=y0_pool, eval_y0_pool=eval_y0_pool)
        else:
            from distributedconvrl_pde_control_torch.parallel.batched_dp import DPBatchedTrainer

            self.base = DPBatchedTrainer(env, self.agent, flat_cfg, mesh, random_init=random_init,
                                         y0_pool=y0_pool, eval_y0_pool=eval_y0_pool)

    @property
    def _local(self) -> BatchedTrainer:
        """The rank's BatchedTrainer (the trainer itself without a mesh)."""
        return self.base if self.mesh is None else self.base.local

    def init(self, generator: torch.Generator, y0s=None, idx=None):
        return self.base.init(generator, y0s=y0s, idx=idx)

    def make_chunk_fn(self, n_steps: int, learn: bool = True):
        """P members x `n_steps` train steps over the flat member-major env
        batch; records come back as the flat (5, n_steps, P*n_envs) plane
        (member p's env columns are [p*n_envs, (p+1)*n_envs))."""
        return self.base.make_chunk_fn(n_steps, learn)

    def eval_mean_rewards(self, actors: Chain, n_steps: int,
                          generator: Optional[torch.Generator] = None, warmup_steps: int = 0,
                          score: str = "mean", y0s: Optional[torch.Tensor] = None) -> np.ndarray:
        """Deterministic per-member evaluation: every member's actor rolls the
        same initial-condition batch (drawn as the trainer's eval draws it, or
        `y0s` (n_envs, ...)), tiled member-major, with the long-horizon and
        warmup semantics of `eval_rollout`. Returns (P,) scores, "mean" (the
        mean step reward over active steps) or "min" (the min over the
        member's per-env masked means); NaN for a member with no active step.
        On a mesh the eval runs the rank's local batch, n_envs / n_dp ICs per
        member (the networks are replicated)."""
        b = self.n_envs_member_local
        if y0s is None:
            y0s = self._local._fresh_eval_y0s(generator or torch.Generator().manual_seed(0), b)
        limit = self.agent.cfg.act_limit

        def act_cols(obs):
            return torch.clamp(self.agent.actor_apply(actors, obs), -limit, limit)

        rs, actives = eval_rollout(self._local.env, act_cols, torch.cat([y0s] * self.n_members),
                                   n_steps, warmup_steps)
        return np.array([score_rollout(rs[:, i * b:(i + 1) * b], actives[:, i * b:(i + 1) * b],
                                       score) for i in range(self.n_members)], np.float64)

    def member_records(self, recs: dict, i: int) -> dict:
        """Member i's (n_steps, n_envs) columns of a chunk's record dict
        (`consume_record_read`); `mean_reward` stays the population-global
        per-step mean (the fused step reduces over all envs): per-member
        curves come from ep_reward and the evals. On a mesh the env axis is
        rank-major (rank blocks of member-major local blocks), and member i's
        columns are gathered from every rank's block."""
        d, p, b = self.n_dp, self.n_members, self.n_envs_member_local

        def member(v):
            return v.reshape(v.shape[0], d, p, b)[:, :, i, :].reshape(v.shape[0], d * b)

        return {k: (v if k == "mean_reward" else member(v)) for k, v in recs.items()}


def train_population(trainer: PopulationTrainer, total_steps: int,
                     generator: Optional[torch.Generator] = None, act_noise=None,
                     noise_decay_every: int = 0, noise_decay=0.5, chunk_len: int = 50,
                     verbose: bool = False, eval_every: int = 0, eval_steps: int = 50,
                     eval_warmup_steps: int = 0, eval_score: str = "mean"):
    """Chunked population training: `train_batched`'s semantics per member
    (the same pipeline, the same eval-driven best-actor selection), P members
    at once.

    `act_noise` / `noise_decay`: scalars or (P,) per-member values.
    `generator` makes every draw (default: the env's device's, seeded 0).
    Returns (flat state, list of P PDEHooks, (chunks,) global mean rewards);
    episode indices in the hooks are population-global counts."""
    p = trainer.n_members
    env = trainer.base.env
    if generator is None:
        generator = torch.Generator(device=env.y0.device).manual_seed(0)
    ts = trainer.init(generator)
    device = ts.obs_flat.device
    noise_host = np.full((p,), trainer.agent.cfg.act_noise, np.float32)
    if act_noise is not None:
        noise_host = np.asarray(act_noise, np.float32)
        if noise_host.shape != (p,):
            raise ValueError(f"act_noise must be shape ({p},), got {noise_host.shape}")
        ts.agent.act_noise = torch.as_tensor(noise_host, device=device)
    decay = np.broadcast_to(np.asarray(noise_decay, np.float32), (p,)).copy()
    decay_dev = torch.as_tensor(decay, device=device)
    chunk_fn = trainer.make_chunk_fn(chunk_len)
    hooks = [PDEHook(min_best_episode=trainer.base.cfg.min_best_episode, collect_best_trace=False)
             for _ in range(p)]
    for h in hooks:
        h.evals = []
    chunk_means = []
    steps_done = 0
    next_decay = noise_decay_every if noise_decay_every else None
    next_eval = eval_every if eval_every else None
    best_evals = [None] * p  # (reward, step, episode, actor) per member

    def consume(handle):
        rec = consume_record_read(handle)
        for i in range(p):
            hooks[i].feed_episode_records(trainer.member_records(rec, i))
        chunk_means.append(float(rec["mean_reward"].mean()))

    pending: list = []
    while steps_done < total_steps:
        ts, recs = chunk_fn(ts)
        steps_done += chunk_len
        pending.append(start_record_read(recs))
        if len(pending) > PIPELINE_DEPTH:
            consume(pending.pop(0))
        if next_decay is not None and steps_done >= next_decay:
            ts.agent.act_noise = ts.agent.act_noise * decay_dev
            noise_host = noise_host * decay
            next_decay += noise_decay_every
        if next_eval is not None and steps_done >= next_eval:
            rs = trainer.eval_mean_rewards(ts.agent.actor, eval_steps,
                                           warmup_steps=eval_warmup_steps, score=eval_score)
            ep_count = int(ts.ep_count)
            for i in range(p):
                hooks[i].evals.append((steps_done, float(rs[i])))
                if best_evals[i] is None or rs[i] > best_evals[i][0]:
                    best_evals[i] = (float(rs[i]), steps_done, ep_count,
                                     member_chain(ts.agent.actor, i))
            next_eval += eval_every
        if verbose and chunk_means:
            print(f"steps {steps_done}: population mean {chunk_means[-1]:.4f} "
                  f"noise {noise_host.round(4)}")
    for handle in pending:
        consume(handle)
    pending.clear()
    for i in range(p):
        if best_evals[i] is not None:
            hooks[i].bestreward, hooks[i].best_eval_step = best_evals[i][0], best_evals[i][1]
            hooks[i].bestepisode, hooks[i].best_actor = best_evals[i][2], best_evals[i][3]
        hooks[i].current_actor = member_chain(ts.agent.actor, i)
    return ts, hooks, np.asarray(chunk_means)


# Search axes that can vary inside one fused population program (schedule and
# optimizer knobs, per-member state); structural axes (network scale, batch
# size) change program shapes and stay with the serial random search
# (train/hyperopt.py, KSglobalSetup.jl:269).
SCHEDULE_SPACE = {
    "act_noise": ("uniform", 0.3, 2.0),
    "noise_decay": ("uniform", 0.2, 0.9),
    "learning_rate": ("loguniform", 1e-4, 3e-3),
    "learning_rate_critic": ("loguniform", 2e-4, 6e-3),
}


def population_search(env, agent, cfg: BatchedTrainerConfig, n_trials: int, total_steps: int, *,
                      members_per_round: int = 8, seed: int = 0,
                      noise_decay_every: int = 0, eval_every: int = 50, eval_steps: int = 500,
                      eval_warmup_steps: int = 0, eval_score: str = "mean", chunk_len: int = 50,
                      y0_pool=None, eval_y0_pool=None, verbose: bool = True, mesh=None):
    """Schedule and optimizer search where every round of up to
    `members_per_round` trials trains as one fused population, each trial
    scored by its eval-driven best. The trials come from numpy's
    `default_rng(seed)` through `hyperopt.sample_trial`, the JAX package's
    trials for the same seed; round r draws from a generator seeded
    seed + 1000 r (on the env's device).

    Returns (best, trials, best_hook, best_state): `best["params"]` is the
    winning schedule, `best_hook` carries its eval-selected actor and
    `best_state` its standalone DDPGState."""
    from distributedconvrl_pde_control_torch.train.hyperopt import sample_trial

    rng = np.random.default_rng(seed)
    params = [sample_trial(rng, SCHEDULE_SPACE) for _ in range(n_trials)]
    trials = []
    best = {"reward": -np.inf, "params": None, "trial": -1}
    best_hook = best_state = None
    done = rnd = 0
    while done < n_trials:
        p = min(members_per_round, n_trials - done)
        batch = params[done:done + p]
        trainer = PopulationTrainer(env, agent, cfg, p, y0_pool=y0_pool,
                                    eval_y0_pool=eval_y0_pool, mesh=mesh,
                                    lr_actor=[t["learning_rate"] for t in batch],
                                    lr_critic=[t["learning_rate_critic"] for t in batch])
        ts, hooks, _ = train_population(
            trainer, total_steps=total_steps,
            generator=torch.Generator(device=env.y0.device).manual_seed(seed + 1000 * rnd),
            act_noise=[t["act_noise"] for t in batch],
            noise_decay_every=noise_decay_every or max(1, total_steps // 8),
            noise_decay=[t["noise_decay"] for t in batch], chunk_len=chunk_len,
            eval_every=eval_every, eval_steps=eval_steps, eval_warmup_steps=eval_warmup_steps,
            eval_score=eval_score)
        for i, t in enumerate(batch):
            row = {"trial": done + i, "round": rnd, "eval_reward": float(hooks[i].bestreward), **t}
            trials.append(row)
            if verbose:
                print(json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                                  for k, v in row.items()}), flush=True)
            if row["eval_reward"] > best["reward"]:
                best = {"reward": row["eval_reward"], "params": t, "trial": done + i}
                best_hook = hooks[i]
                best_state = trainer.agent.member_state(ts.agent, i)
        done += p
        rnd += 1
    if verbose:
        print(json.dumps({"best_trial": best["trial"], "best_eval_reward": round(best["reward"], 6),
                          "best_params": best["params"]}), flush=True)
    return best, trials, best_hook, best_state


def save_population(out_dir: str, trainer: PopulationTrainer, ts, hooks,
                    overrides=None) -> dict:
    """Each member as a standard light checkpoint under `out_dir/member_XX`
    (`checkpoint.save`: `--eval --load-from` reads it) and the ranking
    `population.json`."""
    from distributedconvrl_pde_control_torch.train import checkpoint
    from distributedconvrl_pde_control_torch.train.loop import TrainState

    rows = []
    for i, hook in enumerate(hooks):
        tag = f"member_{i:02d}"
        checkpoint.save(os.path.join(out_dir, tag),
                        TrainState(trainer.agent.member_state(ts.agent, i), None, ts.generator),
                        hook, include_replay=False, config_overrides=overrides)
        rows.append({"member": i, "dir": tag, "best_reward": float(hook.bestreward),
                     "best_episode": int(hook.bestepisode), "episodes": int(hook.ep - 1),
                     "evals": getattr(hook, "evals", [])})
    summary = {"n_members": trainer.n_members,
               "ranking": sorted(rows, key=lambda r: -r["best_reward"])}
    with open(os.path.join(out_dir, "population.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary
