"""Batched-env trainer: the throughput configuration.

Counterpart of ``distributedconvrl_pde_control_tpu/train/batched.py``. The
reference trains one env with batch_size=3 and 20 update loops per step
(KSSetup.jl:66-71); this module keeps the scaling axis the JAX package added:
`n_envs` environments advance in lockstep as one batch, the shared policy
sees all `n_envs * n_actuators` actuator columns as one batch, every step
pushes that many transitions into one shared replay, and the DDPG update
runs with a correspondingly larger batch. Finished episodes are reset inside
the step from fresh initial fields.

Where the JAX package compiles a chunk of steps into one program, here every
operation is a kernel launch that the host issues, so the step is written to
keep the host ahead of the device: no value is read back from the device
inside a chunk. The replay's pointer and size, `update_step` and the learn
gate are functions of the step count and live on the host; the reset select,
the episode accounting and the best-actor snapshot stay on the device as
`where`s. One packed record array leaves the device per chunk. The JAX
package's flat-carry layout knobs exist for the TPU's tiled layouts and are
not ported.

The step and the chunk take an optional `RankMesh` (the JAX package's
`axis_name`): with one, the step is a rank's part of a data-parallel step
(`parallel/batched_dp.py`): the DDPG gradients are averaged over dp, the
finished-episode count is summed, the mean reward averaged and the best
candidate maximized over dp, so that every rank keeps the same hook
scalars, and each chunk's records are gathered over dp in global env order.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from distributedconvrl_pde_control_torch.agents.ddpg import DDPGAgent, DDPGState
from distributedconvrl_pde_control_torch.agents.replay import Replay, replay_init, replay_push_flat
from distributedconvrl_pde_control_torch.envs.pde_env import (
    EnvState,
    PDEEnv,
    index_state,
    where_state,
)
from distributedconvrl_pde_control_torch.models.mlp import Chain, chain_to_numpy, copy_chain
from distributedconvrl_pde_control_torch.parallel.mesh import RankMesh
from distributedconvrl_pde_control_torch.train.hooks import (
    REC_COMPLETED,
    REC_EP_REWARD,
    REC_FINISHED,
    REC_MEAN_REWARD,
    PDEHook,
)
from distributedconvrl_pde_control_torch.train.records import (
    consume_record_read,
    start_record_read,
)


@dataclasses.dataclass
class BatchedTrainState:
    agent: DDPGState
    replay: Replay
    env_states: EnvState  # leading axis n_envs
    # flat (ns, n_envs*n_act) view of env_states.obs, carried across steps so
    # each step flattens the freshly produced obs once (policy forward, the
    # replay's s block and the previous step's sn all share it)
    obs_flat: torch.Tensor
    generator: torch.Generator  # on the trainer's device; every draw of the run
    total_env_steps: int
    # observability (PDEhook semantics, tracked on the device so the step
    # never waits for the host: PDEhook.jl:52,65-76)
    ep_reward: torch.Tensor  # (n_envs,) running sum of per-step mean rewards
    ep_count: torch.Tensor  # i32, episodes finished across all envs
    best_reward: torch.Tensor  # f32
    best_episode: torch.Tensor  # i32
    best_actor: Chain  # snapshot (a copy) of the actor (PDEhook bestNNA)


@dataclasses.dataclass
class StepDraws:
    """Draws of one train step made outside it (tests pass the JAX package's
    own): `noise` standard normal (na_rows, n_envs*n_act); `start` the start
    policy's actions, same shape; `offs` (update_loops, batch_size) replay
    offsets; the reset's fresh fields `y0s` (n_envs, nx) or pool rows `idx`
    (n_envs,). A field left None is drawn from the state's generator."""

    noise: Optional[torch.Tensor] = None
    start: Optional[torch.Tensor] = None
    offs: Optional[torch.Tensor] = None
    y0s: Optional[torch.Tensor] = None
    idx: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class BatchedTrainerConfig:
    n_envs: int = 256
    batch_size: int = 256  # learner batch (scaled up from the reference's 3)
    update_loops: int = 1  # gradient steps per env step (20 in fidelity mode)
    update_every: int = 1
    min_best_episode: int = 0  # PDEhook gate (PDEhook.jl:66)


class BatchedTrainer:
    """Batched-env DDPG trainer with in-step episode auto-reset."""

    def __init__(self, env: PDEEnv, agent: DDPGAgent, cfg: BatchedTrainerConfig,
                 random_init: Optional[Callable] = None, y0_pool=None, eval_y0_pool=None):
        """`random_init(generator, n) -> (n, nx)` draws initial fields;
        `y0_pool` is a precomputed (P, nx) set of initial fields sampled
        uniformly at every auto-reset instead; `eval_y0_pool` holds out ICs
        for the deterministic evals (with a training `y0_pool` the eval would
        otherwise score on training-seen fields)."""
        self.env = env
        self.agent = agent
        self.cfg = cfg
        self.random_init = random_init
        self.y0_pool = y0_pool
        self.eval_y0_pool = eval_y0_pool
        self._state_pool = None

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
            idx = torch.randint(0, self.y0_pool.shape[0], (n,), generator=generator,
                                device=generator.device)
            return self.y0_pool[idx.to(self.y0_pool.device)]
        if self.random_init is not None:
            return self.random_init(generator, n)
        return self.env.y0.expand((n,) + tuple(self.env.y0.shape))

    def _fresh_eval_y0s(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """Eval ICs: the held-out `eval_y0_pool` when provided, else the
        training IC source."""
        if self.eval_y0_pool is not None:
            idx = torch.randint(0, self.eval_y0_pool.shape[0], (n,), generator=generator,
                                device=generator.device)
            return self.eval_y0_pool[idx.to(self.eval_y0_pool.device)]
        return self._fresh_y0s(generator, n)

    def _fresh_states(self, generator: torch.Generator, n: int, y0s=None, idx=None) -> EnvState:
        """Fresh reset EnvStates for auto-reset. With a y0 pool the reset
        states (featurization and carry included) are computed once and
        gathered by `idx` (drawn when None); otherwise the env resets from
        `y0s` (drawn from the IC source when None)."""
        if self.y0_pool is not None and y0s is None:
            if self._state_pool is None:
                self._state_pool = self.env.reset(self.y0_pool)
            if idx is None:
                idx = torch.randint(0, self.y0_pool.shape[0], (n,), generator=generator,
                                    device=generator.device)
            return index_state(self._state_pool, idx.to(self.y0_pool.device))
        return self.env.reset(self._fresh_y0s(generator, n) if y0s is None else y0s)

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator, y0s=None, idx=None,
             capacity: Optional[int] = None) -> BatchedTrainState:
        """A fresh state whose every draw comes from `generator`, which the
        state keeps for the run. `capacity` replaces the agent's replay
        capacity (before its rounding to the push width)."""
        env_states = self._fresh_states(generator, self.cfg.n_envs, y0s=y0s, idx=idx)
        device = env_states.obs.device
        acfg = self.agent.cfg
        astate = self.agent.init_state(generator, device)
        # round the capacity up to a multiple of the per-step push width so
        # pushes take the contiguous path (replay_push_flat); a slightly
        # larger buffer is semantically benign
        push = self.cfg.n_envs * acfg.n_actuators
        capacity = acfg.capacity if capacity is None else capacity
        capacity = ((capacity + push - 1) // push) * push
        return BatchedTrainState(
            agent=astate,
            replay=replay_init(capacity, acfg.ns, acfg.na_rows, device),
            env_states=env_states,
            obs_flat=self._obs_cols(env_states.obs),
            generator=generator,
            total_env_steps=0,
            ep_reward=torch.zeros(self.cfg.n_envs, dtype=torch.float32, device=device),
            ep_count=torch.zeros((), dtype=torch.int32, device=device),
            best_reward=torch.full((), -torch.inf, dtype=torch.float32, device=device),
            best_episode=torch.zeros((), dtype=torch.int32, device=device),
            best_actor=copy_chain(astate.actor),
        )

    # ------------------------------------------------------------- one step
    def _train_step(self, ts: BatchedTrainState, learn: bool = True,
                    draws: Optional[StepDraws] = None, mesh: Optional[RankMesh] = None):
        """One train step, in place on `ts`; returns (ts, records). `mesh`:
        this rank's part of a data-parallel step (module docstring)."""
        env, agent, cfg = self.env, self.agent, self.cfg
        acfg = agent.cfg
        draws = draws or StepDraws()
        gen = ts.generator
        b = cfg.n_envs
        n_act = acfg.n_actuators
        astate = ts.agent

        # policy forward over all actuator columns of all envs at once, on
        # the carried (ns, B*n_act) flat view
        obs_flat = ts.obs_flat
        astate.update_step += 1
        actions_flat = agent.act(astate, obs_flat, gen, learning=True, noise=draws.noise,
                                 start=draws.start)
        actions = self._actions_env(actions_flat, b)

        with torch.no_grad():
            new_estates = env.step(ts.env_states, actions)

            # auto-reset finished episodes with fresh initial conditions
            # first: the post-reset flat obs doubles as this step's replay
            # `sn` (below) and the next step's policy input. Fresh states are
            # made and selected every step (the select is the identity when
            # no env is done), so the host never reads `done`
            done = new_estates.done
            fresh = self._fresh_states(gen, b, y0s=draws.y0s, idx=draws.idx)
            estates = where_state(done, fresh, new_estates)
            new_obs_flat = self._obs_cols(estates.obs)

            # push B*n_act transitions. `sn` is the post-reset observation:
            # for non-terminal rows it equals the post-step observation, and
            # for terminal rows (t=1) the learner's bootstrap term is masked
            # by (1 - t), so the stored `sn` is never read. Blow-up steps can
            # carry non-finite rewards; clamp them before they reach the
            # replay and the accounting, or one NaN row poisons the first
            # gradient update and cascades
            safe_reward = torch.where(torch.isfinite(new_estates.reward), new_estates.reward,
                                      -env.max_value)
            r_flat = safe_reward.reshape(b * n_act)
            t_flat = done.to(torch.float32).repeat_interleave(n_act)
            replay = replay_push_flat(ts.replay, obs_flat, actions_flat, r_flat, t_flat,
                                      new_obs_flat)

        # learn: the gate is a function of the step count alone
        if (learn and replay.size > acfg.update_after * n_act
                and astate.update_step % cfg.update_every == 0):
            for i in range(cfg.update_loops):
                # sampling routed through the agent so that agents with their
                # own sampling rule can substitute it (ddpg.py::sample)
                offs = None if draws.offs is None else draws.offs[i]
                agent.learn_batch(astate, agent.sample(replay, cfg.batch_size, gen, offs=offs),
                                  dp_group=None if mesh is None else mesh.dp_group)

        with torch.no_grad():
            # episode accounting + on-device best-actor tracking (PDEhook
            # semantics: the best completed episode past min_best_episode
            # snapshots the actor as of that episode's end, PDEhook.jl:65-76)
            completed = done & (new_estates.time >= env.te * (1.0 - 1e-6))
            ep_r = ts.ep_reward + safe_reward.mean(dim=-1)
            done_count = done.sum(dtype=torch.int32)
            mean_r_scalar = safe_reward.mean()
            cand_max = torch.where(completed, ep_r, -torch.inf).max()
            if mesh is not None:  # the hook scalars of every rank's envs
                done_count = mesh.psum(done_count, "dp")
                mean_r_scalar = mesh.pmean(mean_r_scalar, "dp")
                cand_max = mesh.pmax(cand_max, "dp")
            ep_count = ts.ep_count + done_count
            is_better = (cand_max > ts.best_reward) & (ep_count >= cfg.min_best_episode)
            for best, cur in zip(ts.best_actor.parameters(), astate.actor.parameters()):
                torch.where(is_better, cur, best, out=best)
            ts.best_reward = torch.where(is_better, cand_max, ts.best_reward)
            ts.best_episode = torch.where(is_better, ep_count, ts.best_episode)
            ts.ep_reward = torch.where(done, 0.0, ep_r)

        ts.env_states = estates
        ts.obs_flat = new_obs_flat
        ts.total_env_steps += b * (1 if mesh is None else mesh.dp)
        ts.ep_count = ep_count
        records = {
            "finished": done,
            "completed": completed,
            "ep_reward": ep_r,
            "mean_reward": mean_r_scalar,
        }
        return ts, records

    # ---------------------------------------------------------------- chunks
    def make_chunk_fn(self, n_steps: int, learn: bool = True, mesh: Optional[RankMesh] = None):
        """`chunk(ts, draws=None) -> (ts, packed)`: `n_steps` train steps in
        place on `ts`, and the packed (5, n_steps, n_envs) f32 record array
        on the device (train.hooks.unpack_records row order; errored is all
        zero, as the detector exists only in the sharded fluid family). One
        array means one device-to-host copy per chunk for the whole host
        accounting. `draws` is a sequence of `n_steps` StepDraws. With a
        `mesh` the steps are this rank's of a data-parallel chunk, and the
        records of every rank's envs come back, gathered over dp in rank
        order (the global env order)."""

        def chunk(ts: BatchedTrainState, draws: Optional[Sequence[StepDraws]] = None):
            packed = torch.zeros((5, n_steps, self.cfg.n_envs), dtype=torch.float32,
                                 device=ts.obs_flat.device)
            for i in range(n_steps):
                ts, rec = self._train_step(ts, learn, None if draws is None else draws[i], mesh)
                packed[REC_FINISHED, i] = rec["finished"]
                packed[REC_COMPLETED, i] = rec["completed"]
                packed[REC_EP_REWARD, i] = rec["ep_reward"]
                packed[REC_MEAN_REWARD, i] = rec["mean_reward"]
            return ts, packed if mesh is None else mesh.gather_cat(packed, "dp", -1)

        return chunk

    # ------------------------------------------------------------------ eval
    def eval_mean_reward(self, actor_params, n_steps: int,
                         generator: Optional[torch.Generator] = None,
                         warmup_steps: int = 0, score: str = "mean",
                         y0s: Optional[torch.Tensor] = None) -> float:
        """Deterministic-policy evaluation over one episode batch (no noise,
        no learning): mean per-step reward over active steps (`eval_rollout`,
        scored by `score_rollout`). `score="min"` reduces the per-env masked
        means by min instead of the batch mean. `y0s` (n_envs, nx) replaces
        the drawn ICs."""
        acfg = self.agent.cfg
        if y0s is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            y0s = self._fresh_eval_y0s(generator, self.cfg.n_envs)

        def act_cols(obs):
            return torch.clamp(self.agent.actor_apply(actor_params, obs), -acfg.act_limit,
                               acfg.act_limit)

        rs, actives = eval_rollout(self.env, act_cols, y0s, n_steps, warmup_steps)
        return score_rollout(rs, actives, score)


def score_rollout(rs: np.ndarray, actives: np.ndarray, score: str = "mean") -> float:
    """The eval score of `eval_rollout`'s traces: the mean step reward over
    active steps, or with `score="min"` the min over the per-env masked
    means (NaN for an env with no active step); NaN when nothing is
    active."""
    if score == "min":
        n = actives.sum(axis=0)
        per_env = np.where(n > 0, (rs * actives).sum(axis=0) / np.maximum(n, 1), np.nan)
        return float(np.nanmin(per_env)) if np.isfinite(per_env).any() else float("nan")
    return float(rs[actives].mean()) if actives.any() else float("nan")


@torch.no_grad()
def eval_rollout(env: PDEEnv, act_cols: Callable, y0s: torch.Tensor, n_steps: int,
                 warmup_steps: int = 0):
    """The deterministic evaluation rollout of every trainer: (rs, actives),
    host (n_steps, B) arrays of the per-env mean step reward and whether the
    step counted. `act_cols(obs (ns, B*n_act)) -> actions (na, B*n_act)` is
    the policy over every actuator column.

    When `n_steps + warmup_steps` exceeds the episode cap te/dt, the rollout
    runs on a te-overridden clone of the env (te = t0 + (n_steps +
    warmup_steps)*dt + dt) so every requested step is a real step; blow-up
    termination stays active and masks post-termination steps, and the
    blow-up step's own non-finite reward is left out. `warmup_steps > 0`
    first evolves the ICs uncontrolled (zero actions) for that many steps,
    and only the controlled segment is scored."""
    b = y0s.shape[0]
    needed_te = env.t0 + (n_steps + warmup_steps) * env.dt
    if needed_te > env.te:
        env = dataclasses.replace(env, te=float(needed_te) + env.dt)
    estates = env.reset(y0s)
    if warmup_steps:
        zeros = torch.zeros_like(estates.action)
        for _ in range(warmup_steps):
            estates = where_state(~estates.done, env.step(estates, zeros), estates)
    ns, n_act = estates.obs.shape[1], estates.obs.shape[2]
    rs, actives = [], []
    for _ in range(n_steps):
        a_cols = act_cols(estates.obs.permute(1, 0, 2).reshape(ns, b * n_act))
        active = ~estates.done
        new_estates = env.step(estates, a_cols.reshape(-1, b, n_act).permute(1, 0, 2))
        estates = where_state(active, new_estates, estates)
        step_r = new_estates.reward.mean(dim=-1)
        ok = active & torch.isfinite(step_r)
        rs.append(torch.where(ok, step_r, torch.zeros_like(step_r)))
        actives.append(ok)
    return torch.stack(rs).cpu().numpy(), torch.stack(actives).cpu().numpy()


def train_batched(trainer: BatchedTrainer, total_steps: int,
                  generator: Optional[torch.Generator] = None,
                  noise_decay_every: int = 0, noise_decay: float = 0.5,
                  chunk_len: int = 50, verbose: bool = False, hook: Optional[PDEHook] = None,
                  eval_every: int = 0, eval_steps: int = 50,
                  eval_warmup_steps: int = 0, eval_score: str = "mean",
                  warm_start: Optional[dict] = None, pipeline_depth: int = 4,
                  sparse_records: bool = False):
    """Throughput-mode training loop: run `total_steps` train steps in
    chunks, optionally decaying the exploration noise every
    `noise_decay_every` steps (the batched analogue of the reference's
    per-loop `act_noise *= 0.2`, KSSetup.jl:315).

    `generator` makes every draw of the run; it lives on the trainer's
    device (default: that device's generator seeded 0).

    Observability: per-env episode accounting and on-device best-actor
    snapshots feed a standard PDEHook (train.checkpoint.save ships it).
    `eval_every > 0` additionally runs a deterministic evaluation episode
    batch every N steps; in that case the deterministic evals drive the
    best-actor snapshot (hook.bestreward then holds the best eval mean step
    reward): with hundreds of noisy episodes finishing per chunk, the
    reference's best-noisy-episode rule (PDEhook.jl:65-76) selects
    exploration luck, not policy quality.

    `warm_start`: chains ({"actor"|"critic"|"target_actor"|"target_critic":
    Chain or [{"w", "b"}, ...]}) spliced into the fresh state; the warm actor
    also seeds the on-device best snapshot and is scored at step 0.

    `pipeline_depth`: how many chunks may be in flight before their records
    are consumed (drained at the end); accounting is order-identical at any
    depth. `sparse_records`: read each chunk's records as a small header +
    only the finished steps' rows (train/records.py); identical values and
    order.

    Returns (state, hook, mean rewards per chunk).
    """
    if generator is None:  # on the device the trainer's env lives on
        generator = torch.Generator(device=trainer.env.y0.device).manual_seed(0)
    ts = trainer.init(generator)
    if warm_start is not None:
        for name, chain in warm_start.items():
            if not isinstance(chain, Chain):
                chain = Chain([np.asarray(l["w"], np.float32) for l in chain],
                              [np.asarray(l["b"], np.float32) for l in chain])
            getattr(ts.agent, name).load_state_dict(chain.state_dict())
        if "actor" in warm_start:
            ts.best_actor = copy_chain(ts.agent.actor)
    chunk_fn = trainer.make_chunk_fn(chunk_len)
    if hook is None:
        hook = PDEHook(min_best_episode=trainer.cfg.min_best_episode, collect_best_trace=False)
    hook.evals = []  # (total_env_step, deterministic mean step reward)
    chunk_means = []
    steps_done = 0
    next_decay = noise_decay_every if noise_decay_every else None
    next_eval = eval_every if eval_every else None
    best_eval = None  # (mean step reward, step, episode, actor params)

    def run_eval():
        return trainer.eval_mean_reward(ts.agent.actor, eval_steps, warmup_steps=eval_warmup_steps,
                                        score=eval_score)

    if warm_start is not None and next_eval is not None:
        # score the warm-start actor at step 0 so eval-driven selection can
        # never ship something worse than the imported policy
        r0 = run_eval()
        hook.evals.append((0, r0))
        best_eval = (r0, 0, 0, chain_to_numpy(ts.agent.actor))
    # Software pipeline: queue chunks n+1..n+depth before reading chunk n's
    # records, so the host-side accounting overlaps device compute instead
    # of serializing with it.
    depth = max(1, pipeline_depth)
    pending: list = []

    def consume(handle):
        rec = consume_record_read(handle)
        hook.feed_episode_records(rec)
        chunk_means.append(float(rec["mean_reward"].mean()))

    while steps_done < total_steps:
        ts, recs = chunk_fn(ts)
        steps_done += chunk_len
        # start the device-to-host copy at dispatch time so that it overlaps
        # the chunks queued after it
        pending.append(start_record_read(recs, sparse_records))
        if len(pending) > depth:
            consume(pending.pop(0))
        if next_decay is not None and steps_done >= next_decay:
            ts.agent.act_noise *= noise_decay
            next_decay += noise_decay_every
        if next_eval is not None and steps_done >= next_eval:
            r_eval = run_eval()
            hook.evals.append((steps_done, r_eval))
            if best_eval is None or r_eval > best_eval[0]:
                # the eval already synchronized the host, so reading the
                # device episode counter here costs nothing extra: this is
                # the episode index the checkpoint metadata records. The
                # actor is copied: the optimizer goes on updating it in place
                best_eval = (r_eval, steps_done, int(ts.ep_count), chain_to_numpy(ts.agent.actor))
            next_eval += eval_every
        if verbose and chunk_means:
            print(f"steps {steps_done}: mean reward {chunk_means[-1]:.4f} "
                  f"noise {ts.agent.act_noise:.4f}")
    for handle in pending:
        consume(handle)
    pending.clear()
    if best_eval is not None:
        hook.best_actor = best_eval[3]
        hook.bestreward = best_eval[0]
        # episodes finished when the winning eval ran (not the final count)
        hook.bestepisode = best_eval[2]
        hook.best_eval_step = best_eval[1]
    else:
        hook.adopt_device_best(ts.best_reward, ts.best_episode, ts.best_actor)
    hook.current_actor = chain_to_numpy(ts.agent.actor)
    return ts, hook, np.asarray(chunk_means)
