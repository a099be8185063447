"""Preset-driven fluid control on the 2/3-rule solver over a dp x sp mesh:
training and evaluation.

Counterpart of ``distributedconvrl_pde_control_tpu/parallel/multichip.py``.
The reference trains and evaluates a fluid preset across a ('dp', 'sp') chip
mesh; here each mesh position is a rank (``parallel/mesh.py``):

  * the env batch is split over dp: each dp group steps its own n_envs / dp
    envs, keeps its own replay (capacity rounded to its push width) and
    draws its own noise, samples and resets; the DDPG gradients are averaged
    over dp (`DDPGAgent.learn_batch`'s `dp_group`), so the networks stay
    bit-identical on every rank;
  * each env's vorticity field is split over sp: a rank holds a y-pencil
    block of rows (n/S, n), the rows of the sensor and actuator kernels and
    of the reset pool, and the x-pencil columns of the operators; the sensor
    dots and the eval metric are partial sums `psum`'d over sp, the field's
    blow-up check and the corrupted-field detector `pmax`'d over sp (the
    detector's y-neighbour of a block's first row is the previous rank's
    last row), and the solver transforms by the transpose method
    (``parallel/ns_sharded.py``; K2 at sp = 1);
  * the episode accounting is reduced over dp (`psum` of the finished
    count, `pmax` of the best candidate, `pmean` of the mean reward), so
    every rank holds the same counters, best reward and best actor.

With no mesh (or a (1, 1) tuple) the trainer runs on one device and every
collective is the identity. Ported here: the trainer's arrays, the preset's
stepper dispatch, forcing, sensor readout, featurization, reward, the
evaluation rollout (`make_eval_fn`, the testrun protocol of
FluidSetup.jl:400-537), the fresh-IC pool, `init`, the train step
(`_local_step`), `make_chunk_fn`, `train_sharded`, the restart protocol
`train_multi_sharded`, the device-side corrupted-field detector, and the
light checkpoint (`save_sharded`, `load_sharded`, `load_actor_for_eval`).

Where the JAX package compiles a chunk of steps into one program, here every
operation is a launch the host makes, and the step is written so that the
host never waits for the device inside a chunk: `global_step`, the replay's
pointer and size, `update_step` and the learn gate follow from the step count
and are host integers identical on every rank (so every rank reaches the
gradient mean's collective together); termination, the episode accounting,
the best-actor snapshot and the auto-reset stay on the device as `where`s;
one packed record array per chunk is gathered over dp and leaves the device.
The adaptive stepper is the exception: it reads each trial's error back,
`pmax`'d over sp first (`parallel/ns_sharded.py`). Every draw of a run
comes from one `torch.Generator` that the state carries, re-seeded per dp
index after the networks are drawn (the JAX package's `fold_in(k, dp_idx)`);
tests pass the JAX package's own draws in (`train.batched.StepDraws`).
Every rank keeps the hook's accounting (the restart protocol's loop reads
it); rank 0 alone prints and writes checkpoints.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from distributedconvrl_pde_control_torch.agents.ddpg import DDPGAgent, DDPGState
from distributedconvrl_pde_control_torch.agents.replay import Replay, replay_init, replay_push_flat
from distributedconvrl_pde_control_torch.configs.fluid import (
    FluidConfig,
    fluid_agent_config,
    fluid_featurizer,
    fluid_kernels,
)
from distributedconvrl_pde_control_torch.models.mlp import Chain, chain_to_numpy, copy_chain
from distributedconvrl_pde_control_torch.ops.navier_stokes import initial_condition
from distributedconvrl_pde_control_torch.parallel.mesh import RankMesh, fold_seed
from distributedconvrl_pde_control_torch.parallel.ns_sharded import (
    NSShardedSolverRI,
    make_sharded_ops,
)
from distributedconvrl_pde_control_torch.train import checkpoint
from distributedconvrl_pde_control_torch.train.batched import StepDraws
from distributedconvrl_pde_control_torch.train.hooks import (
    REC_COMPLETED,
    REC_EP_REWARD,
    REC_ERRORED,
    REC_FINISHED,
    REC_MEAN_REWARD,
    PDEHook,
)
from distributedconvrl_pde_control_torch.train.loop import TrainState
from distributedconvrl_pde_control_torch.train.records import (
    SPARSE_RECORDS_MIN_BYTES,
    consume_record_read,
    record_bytes,
    start_record_read,
)
from distributedconvrl_pde_control_torch.utils.profiling import annotate, span


@dataclasses.dataclass(frozen=True)
class ShardedTrainConfig:
    """Scale-out knobs of the trainer (everything physics/agent comes from
    the `FluidConfig` preset), the JAX package's defaults."""

    n_envs: int = 8  # global env batch, split over dp
    batch_size: int = 32  # learner batch (scaled up from the reference's 3)
    update_loops: int = 1  # gradient steps per env step
    capacity_per_dp: int = 100_000  # rounded up to a multiple of the push width
    y0_pool_size: int = 8  # fresh-IC pool for in-step episode resets
    chunk_len: int = 25  # train steps per record read
    # chunks in flight before their records are read (drained at loop ends)
    pipeline_depth: int = 4


@dataclasses.dataclass
class MCState:
    """One rank's training state: its dp group's envs (Bl = n_envs / dp of
    them), its sp block of their fields, the dp group's replay (the JAX
    package's leading per-dp replay axis is the rank itself), and the
    replicated agent and accounting. Updated in place by the train step."""

    w: torch.Tensor  # (Bl, n/S, n) float32, the REAL vorticity's rows
    obs: torch.Tensor  # (Bl, obs_dim, n_act)
    action: torch.Tensor  # (Bl, na_rows, n_act)
    steps: torch.Tensor  # (Bl,) int32, per-env episode step counter
    ep_reward: torch.Tensor  # (Bl,) f32, running sum of per-step mean rewards
    agent: DDPGState
    replay: Replay
    generator: torch.Generator  # every draw of the dp group
    global_step: int  # train steps taken
    ep_count: torch.Tensor  # i32, episodes finished (all envs)
    best_reward: torch.Tensor  # f32 (PDEhook bestreward)
    best_episode: torch.Tensor  # i32
    best_actor: Chain  # a copy of the actor (PDEhook bestNNA)
    mean_reward: torch.Tensor  # f32 scalar diagnostic of the last step


@dataclasses.dataclass
class EvalState:
    w: torch.Tensor  # (Bl, n/S, n) float32, the REAL vorticity's rows
    obs: torch.Tensor  # (Bl, obs_dim, n_act)
    action: torch.Tensor  # (Bl, na_rows, n_act)
    steps: torch.Tensor  # (Bl,) int32
    done: torch.Tensor  # (Bl,) bool


def mesh_of(mesh: Union[RankMesh, tuple, None], device: str = "cuda") -> RankMesh:
    """A trainer's mesh: a RankMesh as given; for one device (None or the
    tuple (1, 1)) a RankMesh on `device` without groups, whose collectives
    are identities. A tuple of more ranks has no process groups to run on
    and is refused."""
    if isinstance(mesh, RankMesh):
        return mesh
    if mesh is not None and tuple(mesh) != (1, 1):
        raise ValueError(f"mesh {mesh[0]}x{mesh[1]}: a mesh of several ranks is a "
                         "parallel.mesh.RankMesh, one per rank (parallel.mesh.launch)")
    return RankMesh(device=device)


class ShardedFluidTrainer:
    """Builds one rank's arrays, the train step and the evaluation rollout
    of a fluid experiment preset on a dp x sp mesh (module docstring).

    Stepper dispatch: `adaptive=True` runs the step-doubling do_step2
    (`step_real_adaptive`), `stepper="ifrk4"` the integrating-factor tier,
    and the default is the reference's fixed-step do_step
    (FluidSetup.jl:163-172) at the preset's oversampling."""

    def __init__(self, cfg: FluidConfig, mesh: Union[RankMesh, tuple, None] = (1, 1),
                 tcfg: ShardedTrainConfig = ShardedTrainConfig(), device: str = "cuda"):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = device
        n = cfg.grid_nx
        self._place(mesh, n)
        self.solver = NSShardedSolverRI(nu=cfg.nu, fft_mode=cfg.fft_mode,
                                        nl_fft_mode=cfg.nl_fft_mode, mesh=self.mesh)
        self.ops = make_sharded_ops(n, n, cfg.lx, cfg.lx, device=device, mesh=self.mesh)

        n_act = cfg.sensors_per_axis**2
        self.n_act = n_act
        sens, acts = fluid_kernels(cfg)
        # y-pencil slices (n_act, n/S, n): this rank's rows of each kernel
        self.sensor_kernels = self._t(sens[:, self.rows])
        self.actuator_kernels = self._t(acts[:, self.rows])
        self._sens_local = self.sensor_kernels.reshape(n_act, -1)
        self.featurizer = fluid_featurizer(cfg, self._t(sens).reshape(n_act, -1))
        # the capacity rounded up to a multiple of the dp group's push width, so
        # pushes take the contiguous path (replay_push_flat); the agent's config
        # carries it
        push = self.n_local * n_act
        self.capacity_per_dp = ((tcfg.capacity_per_dp + push - 1) // push) * push
        self.agent = DDPGAgent(fluid_agent_config(cfg, self.featurizer.obs_dim,
                                                  capacity=self.capacity_per_dp))
        self.max_steps = int(math.ceil((cfg.te - cfg.t0) / cfg.dt - 1e-9))
        self.pool = None  # (P, n/S, n) this rank's rows of the fresh fields, set by init
        self.pool_obs = None  # (P, obs_dim, n_act) their reset observations

    def _place(self, mesh, n: int) -> None:
        """This rank's mesh, its envs and its rows of an n-point grid axis."""
        m = self.mesh = mesh_of(mesh, self.device)
        self.n_dp, self.n_sp = m.shape
        self.dp_idx, self.sp_idx = m.dp_idx, m.sp_idx
        self.n = n
        if n % self.n_sp:
            raise ValueError(f"the grid's {n} points do not divide over sp={self.n_sp}")
        if self.tcfg.n_envs % self.n_dp:
            raise ValueError(f"{self.tcfg.n_envs} envs do not divide over dp={self.n_dp}")
        self.n_local = self.tcfg.n_envs // self.n_dp
        rows = n // self.n_sp
        self.rows = slice(self.sp_idx * rows, (self.sp_idx + 1) * rows)
        self.envs = slice(self.dp_idx * self.n_local, (self.dp_idx + 1) * self.n_local)
        self.is_root = m.rank == 0

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=self.device)

    def _on_root(self, read):
        """`read()` on mesh rank 0, its value broadcast to every rank."""
        return self.mesh.broadcast_object(read() if self.is_root else None)

    # -------------------------------------------------------------- helpers
    @annotate("env.solve")
    def _solver_step(self, w, f):
        """Preset-honoring stepper dispatch (see class docstring)."""
        cfg = self.cfg
        if cfg.adaptive:
            return self.solver.step_real_adaptive(w, f, self.ops, cfg.dt, rtol=cfg.adaptive_tol,
                                                  atol=cfg.adaptive_tol)
        if cfg.stepper == "ifrk4":
            return self.solver.step_real_if(w, f, self.ops, cfg.dt, cfg.fast_oversampling_eff)
        return self.solver.step_real(w, f, self.ops, cfg.dt, cfg.oversampling)

    def _forcing(self, actions):
        """(Bl, na_rows, n_act) actions -> this rank's rows of the real-space
        forcing (Bl, n/S, n) (prepare_action, FluidSetup.jl:247-261; row 0 is
        the physical action)."""
        return self.cfg.agent_power * torch.einsum("bn,nyx->byx", actions[:, 0, :],
                                                   self.actuator_kernels)

    def _eval_metric(self, w):
        """Per-env eval diagnostic: fluid energy sum|omega|/(nx*ny)
        (testrun, FluidSetup.jl:497-500), its partial sums psum'd over sp."""
        return self.mesh.psum(w.abs().flatten(1).sum(-1), "sp") / (self.n * self.n)

    def _sensor_dots(self, w):
        """Per-env raw sensor inner products <omega, g_i>: partial products of
        this rank's rows (Bl, n/S, n), psum'd over sp -> (Bl, n_act)."""
        return self.mesh.psum(w.flatten(1) @ self._sens_local.T, "sp")

    def _featurize(self, dots, prev_obs, action):
        """(Bl, n_act) raw dots -> (Bl, obs_dim, n_act) via the preset's
        featurizer (window + actuators_to_sensors + temporal/memory rows)."""
        return self.featurizer.from_dots(dots, prev_obs, action)

    def _featurize_reset(self, dots):
        """Featurize at episode start (temporal blocks tiled, memory rows
        zero - KSSetup.jl:209-228 semantics)."""
        return self.featurizer.from_dots(dots, None, None)

    def _reward(self, dots, actions, delta):
        """The preset's reward (FluidSetup.jl:188-202): -|<w,g>|^pow/norm
        - ap*a^2 - dap*da^2, per actuator."""
        cfg = self.cfg
        rdots = dots.abs() ** cfg.reward_pow / cfg.reward_norm
        return (
            -rdots.abs()
            - cfg.action_punish * actions[:, 0, :] ** 2
            - cfg.delta_action_punish * delta[:, 0, :] ** 2
        )

    def _blowup(self, reward, w_new):
        """Per-env termination (PDEenv.jl:226-240): `check_max_value` on the
        reward or the field (its maximum pmax'd over sp), or a non-finite
        reward."""
        cfg = self.cfg
        if cfg.check_max_value == "reward":
            blowup = reward.abs().amax(-1) > cfg.max_value
        elif cfg.check_max_value == "y":
            blowup = self.mesh.pmax(w_new.abs().flatten(1).amax(-1), "sp") > cfg.max_value
        else:
            blowup = torch.zeros(reward.shape[:1], dtype=torch.bool, device=reward.device)
        return blowup | ~torch.isfinite(reward).all(-1)

    def _error_flags(self, w):
        """Per-env corrupted-field detector: real-space neighbour jumps > 10
        (FluidSetup.jl:263-273; the reference runs it on `real(ifft(y))`, `w`
        is already real). x-neighbours lie inside the block; the rolled
        y-neighbour of the block's first row is the previous sp rank's last
        row (on one rank the field's own last row), and the maximum is
        pmax'd over sp. NaN fields do not flag (NaN > 10 is false), matching
        Julia's `maximum`."""
        jump_x = (torch.roll(w, 1, 2) - w).abs().flatten(1).amax(-1)
        rolled_y = torch.cat([self.mesh.ppermute(w[:, -1:, :], "sp", 1), w[:, :-1, :]], dim=1)
        jump_y = (rolled_y - w).abs().flatten(1).amax(-1)
        return self.mesh.pmax(torch.maximum(jump_x, jump_y), "sp") > 10.0

    # ------------------------------------------------------------------ init
    def _make_pool(self, seed: int) -> np.ndarray:
        """Fresh-IC pool for in-step resets, whole fields (P, n, n): the
        host-side random-vortex generator (generate_random_init,
        FluidSetup.jl:386-394; case 3 train / 4 eval), drawn from
        `np.random.default_rng(seed)`."""
        cfg = self.cfg
        rng = np.random.default_rng(seed)
        case = 4 if cfg.evaluation else 3
        return np.stack([
            np.fft.ifft2(initial_condition(case, self.n, self.n, cfg.lx, cfg.lx, rng)).real
            for _ in range(self.tcfg.y0_pool_size)
        ]).astype(np.float32)

    def _local_rows(self, fields: np.ndarray) -> np.ndarray:
        """This rank's block of whole fields (..., n, n) -> (..., n/S, n)."""
        return fields[..., self.rows, :]

    @torch.no_grad()
    def init(self, generator: torch.Generator, seed: int = 0) -> MCState:
        """A fresh state: the pool of `seed`, global env i on pool row i mod P
        (this rank's envs and rows of them), fresh networks from `generator`
        (the same on every rank), then every later draw of the dp group from
        `generator`, re-seeded with `fold_seed` when dp > 1; the state keeps
        it."""
        bl, acfg, dev = self.n_local, self.agent.cfg, self.device
        self.pool = self._t(self._local_rows(self._make_pool(seed)))
        # the JAX package featurizes `pool[idx]` at every step; a pool row gives
        # the same reset observation every time, so the rows are featurized once
        # here and the step gathers them
        self.pool_obs = self._featurize_reset(self._sensor_dots(self.pool))
        rows = torch.arange(self.envs.start, self.envs.stop, device=dev) % self.pool.shape[0]
        astate = self.agent.init_state(generator, dev)
        if self.n_dp > 1:
            generator.manual_seed(fold_seed(generator.initial_seed(), self.dp_idx))
        return MCState(
            w=self.pool[rows],
            obs=self.pool_obs[rows],
            action=torch.zeros((bl, acfg.na_rows, self.n_act), dtype=torch.float32, device=dev),
            steps=torch.zeros((bl,), dtype=torch.int32, device=dev),
            ep_reward=torch.zeros((bl,), dtype=torch.float32, device=dev),
            agent=astate,
            replay=replay_init(self.capacity_per_dp, acfg.ns, acfg.na_rows, dev),
            generator=generator,
            global_step=0,
            ep_count=torch.zeros((), dtype=torch.int32, device=dev),
            best_reward=torch.full((), -torch.inf, dtype=torch.float32, device=dev),
            best_episode=torch.zeros((), dtype=torch.int32, device=dev),
            best_actor=copy_chain(astate.actor),
            mean_reward=torch.zeros((), dtype=torch.float32, device=dev),
        )

    # ------------------------------------------------------------- the step
    def _local_step(self, st: MCState, draws: Optional[StepDraws] = None):
        """One train step of this rank, in place on `st`; returns (st,
        records of its envs). `draws` (noise, start, offs, idx: the dp
        group's) replace the generator's draws."""
        cfg, tcfg = self.cfg, self.tcfg
        agent, acfg = self.agent, self.agent.cfg
        n_act = self.n_act
        draws = draws or StepDraws()
        gen = st.generator
        bl = st.obs.shape[0]
        astate = st.agent
        astate.update_step += 1
        st.global_step += 1

        # policy over all actuator columns of all envs (shared-MLP batching)
        obs_flat = st.obs.movedim(0, 1).reshape(acfg.ns, bl * n_act)
        actions_flat = agent.act(astate, obs_flat, gen, learning=True, noise=draws.noise,
                                 start=draws.start)
        with torch.no_grad():
            actions = actions_flat.reshape(acfg.na_rows, bl, n_act).movedim(1, 0)
            delta = actions - st.action
            with span("env.step"):
                # forcing, then the preset's stepper (K2 on every Runge-Kutta stage)
                w_new = self._solver_step(st.w, self._forcing(actions))
                dots = self._sensor_dots(w_new)
                obs_new = self._featurize(dots, st.obs, actions)
                reward = self._reward(dots, actions, delta)
                steps = st.steps + 1
                blowup = self._blowup(reward, w_new)
            horizon = steps >= self.max_steps
            done = horizon | blowup
            completed = horizon & ~blowup
            # the push: `sn` is the post-step observation, the reward clamped
            safe_r = torch.where(torch.isfinite(reward), reward, -cfg.max_value)
            replay_push_flat(st.replay, obs_flat, actions_flat, safe_r.reshape(-1),
                             done.to(torch.float32).repeat_interleave(n_act),
                             obs_new.movedim(0, 1).reshape(acfg.ns, -1))

        # learning: the gate is a function of the step count alone, a host
        # integer equal on every rank, so all of them reach the gradient mean
        if (st.replay.size > acfg.update_after * n_act
                and astate.update_step % acfg.update_freq == 0):
            for i in range(tcfg.update_loops):
                offs = None if draws.offs is None else draws.offs[i]
                batch = agent.sample(st.replay, tcfg.batch_size, gen, offs=offs)
                agent.learn_batch(astate, batch, dp_group=self.mesh.dp_group)

        with torch.no_grad():
            # episode accounting + on-device best-actor tracking (PDEhook.jl:65-76),
            # reduced over dp so that every rank holds the same counters
            step_mean_r = safe_r.mean(-1)
            ep_r = st.ep_reward + step_mean_r
            ep_count = st.ep_count + self.mesh.psum(done.sum(dtype=torch.int32), "dp")
            cand_max = self.mesh.pmax(torch.where(completed, ep_r, -torch.inf).max(), "dp")
            is_better = (cand_max > st.best_reward) & (ep_count >= cfg.min_best_episode)
            for best, cur in zip(st.best_actor.parameters(), astate.actor.parameters()):
                torch.where(is_better, cur, best, out=best)
            st.best_reward = torch.where(is_better, cand_max, st.best_reward)
            st.best_episode = torch.where(is_better, ep_count, st.best_episode)

            # auto-reset finished envs from the pool: the select runs every step,
            # so the host never reads `done`
            idx = draws.idx
            if idx is None:
                idx = torch.randint(0, self.pool.shape[0], (bl,), generator=gen,
                                    device=gen.device)
            idx = idx.to(self.device)
            donec = done.reshape(bl, 1, 1)
            st.w = torch.where(donec, self.pool[idx], w_new)
            st.obs = torch.where(donec, self.pool_obs[idx], obs_new)
            st.action = torch.where(donec, 0.0, actions)
            st.steps = torch.where(done, 0, steps)
            st.ep_reward = torch.where(done, 0.0, ep_r)
            st.ep_count = ep_count
            st.mean_reward = self.mesh.pmean(step_mean_r.mean(), "dp")
            # a diverged episode whose final field trips the corruption test
            errored = blowup & self._error_flags(w_new)
        return st, {"finished": done, "completed": completed, "ep_reward": ep_r,
                    "errored": errored, "mean_reward": st.mean_reward}

    def make_chunk_fn(self, n_steps: int):
        """`chunk(st, draws=None) -> (st, packed)`: `n_steps` train steps in
        place on `st`, and the packed (5, n_steps, n_envs) f32 record array
        of every env (gathered over dp) on the device
        (train.hooks.unpack_records row order): one device-to-host copy per
        chunk for the whole host accounting. `draws` is a sequence of
        `n_steps` StepDraws of this rank's dp group."""
        rows = ((REC_FINISHED, "finished"), (REC_COMPLETED, "completed"),
                (REC_EP_REWARD, "ep_reward"), (REC_ERRORED, "errored"),
                (REC_MEAN_REWARD, "mean_reward"))

        def chunk(st: MCState, draws: Optional[Sequence[StepDraws]] = None):
            packed = torch.zeros((5, n_steps, st.obs.shape[0]), dtype=torch.float32,
                                 device=self.device)
            for i in range(n_steps):
                st, rec = self._local_step(st, None if draws is None else draws[i])
                for row, name in rows:
                    packed[row, i] = rec[name]
            return st, self.mesh.gather_cat(packed, "dp", -1)

        return chunk

    # --------------------------------------------------------------- eval
    def make_eval_fn(self, n_steps: int, t_action_steps: int = 0):
        """Evaluation rollout (the testrun protocol, FluidSetup.jl:400-537):
        deterministic policy, no replay/learning, per-step energy
        sum(|omega|)/(nx*ny). Early-terminated envs freeze. The rollout has
        no te cap.

        Returns fn (actor: Chain, w0 (Bl, n/S, n): this rank's block of the
        initial fields, as `eval_w0` gives it) -> {energy, reward_mean,
        active: (n_steps, n_envs)} of every env (gathered over dp) as numpy
        arrays."""
        agent, acfg = self.agent, self.agent.cfg
        n_act = self.n_act

        @torch.no_grad()
        def evaluate(actor: Chain, w0: torch.Tensor):
            w0 = torch.as_tensor(w0, dtype=torch.float32, device=self.device)
            bl = w0.shape[0]
            est = EvalState(
                w=w0,
                obs=self._featurize_reset(self._sensor_dots(w0)),
                action=torch.zeros((bl, acfg.na_rows, n_act), dtype=torch.float32, device=self.device),
                steps=torch.zeros((bl,), dtype=torch.int32, device=self.device),
                done=torch.zeros((bl,), dtype=torch.bool, device=self.device),
            )
            recs = {"energy": [], "reward_mean": [], "active": []}
            for step_idx in range(n_steps):
                obs_flat = est.obs.movedim(0, 1).reshape(acfg.ns, bl * n_act)
                a_flat = agent.actor_apply(actor, obs_flat).clamp(-acfg.act_limit, acfg.act_limit)
                actions = a_flat.reshape(acfg.na_rows, bl, n_act).movedim(1, 0)
                if step_idx < t_action_steps:
                    actions = torch.zeros_like(actions)
                delta = actions - est.action
                with span("env.step"):
                    w_new = self._solver_step(est.w, self._forcing(actions))
                    dots = self._sensor_dots(w_new)
                    obs_new = self._featurize(dots, est.obs, actions)
                    reward = self._reward(dots, actions, delta)
                    blowup = self._blowup(reward, w_new)
                active = ~est.done
                keep = active & ~blowup
                keepc = keep.reshape(bl, 1, 1)
                w_out = torch.where(keepc, w_new, est.w)
                est = EvalState(
                    w=w_out,
                    obs=torch.where(keepc, obs_new, est.obs),
                    action=torch.where(keepc, actions, est.action),
                    steps=est.steps + active.to(torch.int32),
                    done=est.done | blowup,
                )
                recs["energy"].append(self._eval_metric(w_out))
                recs["reward_mean"].append(torch.where(keep, reward.mean(-1), 0.0))
                recs["active"].append(keep)
            return {k: self.mesh.gather_cat(torch.stack(v), "dp", -1).cpu().numpy()
                    for k, v in recs.items()}

        return evaluate

    def eval_w0(self, n_envs: int | None = None) -> torch.Tensor:
        """Evaluation initial fields: the preset's canonical y0 (seeded
        case-4 random vortices, FluidSetup.jl:33-37) replicated over the
        eval env batch of `n_envs` (default the trainer's), this rank's
        block of it: (n_envs / dp, n/S, n)."""
        cfg = self.cfg
        n_envs = n_envs or self.tcfg.n_envs
        if n_envs % self.n_dp:
            raise ValueError(f"{n_envs} eval envs do not divide over dp={self.n_dp}")
        rng = np.random.default_rng(cfg.grid_seed)
        y0 = np.fft.ifft2(
            initial_condition(4, self.n, self.n, cfg.lx, cfg.lx, rng)
        ).real.astype(np.float32)
        return self._t(self._local_rows(y0)).expand(n_envs // self.n_dp, -1, -1).contiguous()


# ---------------------------------------------------------- training loops
def train_sharded(trainer: ShardedFluidTrainer, loops: Optional[int] = None,
                  no_steps: Optional[int] = None, seed: int = 0, state: Optional[MCState] = None,
                  hook: Optional[PDEHook] = None, verbose: bool = True,
                  noise_decay: Optional[float] = None, chunk_fn=None, eval_every: int = 0,
                  eval_steps: int = 50):
    """The preset training protocol: `loops` rounds of `no_steps` train
    steps in chunks, act_noise decayed per round and rewards clamped
    (FluidSetup.jl:541-556 in chunked form).

    A fresh run (`state` None) draws everything from a generator on the
    trainer's device seeded `seed`, its pool from `seed` too. `noise_decay`
    overrides the preset's per-loop factor; `chunk_fn` reuses one chunk
    function across calls (train_multi_sharded). Chunk n's records are read
    after chunks n+1..n+pipeline_depth are queued, and drained at loop ends,
    so the per-loop accounting is complete. A chunk's plane of every env is
    read dense below `SPARSE_RECORDS_MIN_BYTES` and sparse from there on, as
    the JAX package switches (a dp-scaled env batch reads sparse). On a mesh
    every rank runs this loop and keeps the same hook; rank 0 alone prints.

    `eval_every > 0` runs a deterministic evaluation rollout (make_eval_fn
    on the preset's canonical eval fields, `eval_steps` steps, no te cap)
    every N train steps, and those evals drive the best-actor snapshot:
    with many noisy episodes per chunk, the reference's best-noisy-episode
    rule (PDEhook.jl:65-76) selects exploration luck.

    Returns (MCState, PDEHook) in the format `checkpoint.save` ships."""
    cfg, tcfg = trainer.cfg, trainer.tcfg
    loops = loops if loops is not None else cfg.loops
    no_steps = no_steps if no_steps is not None else cfg.no_steps
    decay = noise_decay if noise_decay is not None else cfg.noise_decay
    if state is None:
        state = trainer.init(torch.Generator(device=trainer.device).manual_seed(seed), seed=seed)
    if hook is None:
        hook = PDEHook(min_best_episode=cfg.min_best_episode, collect_best_trace=False)
    if chunk_fn is None:
        chunk_fn = trainer.make_chunk_fn(tcfg.chunk_len)

    eval_fn = eval_w0 = None
    best_eval = None  # (mean step reward, step, episode, actor as numpy)
    if eval_every and not hasattr(hook, "evals"):
        hook.evals = []  # (total steps, deterministic mean step reward)
    next_eval = eval_every if eval_every else None
    total_steps = 0

    def run_eval(actor):
        rec = eval_fn(actor, eval_w0)
        rs, active = rec["reward_mean"], rec["active"]
        return float(rs[active].mean()) if active.any() else float("nan")

    noise = float(state.agent.act_noise)
    depth = max(1, tcfg.pipeline_depth)
    pending: list = []
    sparse = record_bytes(tcfg.chunk_len, tcfg.n_envs) >= SPARSE_RECORDS_MIN_BYTES
    for i in range(loops):
        state.agent.act_noise = noise
        t0 = time.time()
        steps = 0
        while steps < no_steps:
            state, packed = chunk_fn(state)
            # the device-to-host copy starts at dispatch, overlapping the chunks
            # queued after it
            pending.append(start_record_read(packed, sparse))
            if len(pending) > depth:
                hook.feed_episode_records(consume_record_read(pending.pop(0)))
            steps += tcfg.chunk_len
            total_steps += tcfg.chunk_len
            if next_eval is not None and total_steps >= next_eval:
                if eval_fn is None:
                    eval_fn = trainer.make_eval_fn(eval_steps)
                    eval_w0 = trainer.eval_w0()
                r_eval = run_eval(state.agent.actor)
                hook.evals.append((total_steps, r_eval))
                if best_eval is None or r_eval > best_eval[0]:
                    # the eval synchronized the host, so reading the device's
                    # episode counter costs nothing extra; the actor is copied:
                    # the optimizer updates it in place
                    best_eval = (r_eval, total_steps, int(state.ep_count),
                                 chain_to_numpy(state.agent.actor))
                next_eval += eval_every
        for handle in pending:
            hook.feed_episode_records(consume_record_read(handle))
        pending.clear()
        if verbose and trainer.is_root:
            print(f"[{cfg.name} sharded {trainer.n_dp}x{trainer.n_sp}] "
                  f"loop {i + 1}/{loops} noise={noise:.4f} "
                  f"best={float(state.best_reward):.4f} eps={int(state.ep_count)} "
                  f"({time.time() - t0:.1f}s)")
        noise *= decay
        hook.clamp_rewards(-3000.0, 0.0)

    finalize_hook(hook, state)
    if best_eval is not None:
        # deterministic-eval-driven selection overrides the on-device
        # best-noisy-episode snapshot (hook.bestreward: the best eval's mean
        # step reward)
        hook.best_actor = best_eval[3]
        hook.bestreward = best_eval[0]
        hook.bestepisode = best_eval[2]
    return state, hook


def train_multi_sharded(trainer: ShardedFluidTrainer, no_episodes: int = 17,
                        n_experiments: int = 2, save_fn=None, seed: int = 0,
                        restart_noise: float = 0.17, inner_decay: float = 0.7,
                        inner_loops: int = 18, verbose: bool = True):
    """The multi-experiment restart protocol (the reference's fluid
    train_multi, FluidSetup.jl:559-601): experiment n re-seeds everything
    with `seed + 7919 n`, then runs rounds of one episode's worth of train
    steps with act_noise reset to `restart_noise` every `inner_loops` rounds
    and decayed by `inner_decay` per round, until the hook has recorded
    `no_episodes` finished episodes; the experiment is then saved by
    `save_fn(n, state, hook)` (a numbered save_sharded) and its best reward
    collected. `n_experiments <= 0` restarts endlessly. Episodes count per
    env: n_envs envs finish n_envs episodes per round. Returns the best
    rewards."""
    cfg, tcfg = trainer.cfg, trainer.tcfg
    episode_steps = int(round((cfg.te - cfg.t0) / cfg.dt))
    chunk_fn = trainer.make_chunk_fn(tcfg.chunk_len)
    best_rewards = []
    n_exp = 0
    while n_experiments <= 0 or n_exp < n_experiments:
        n_exp += 1
        exp_seed = seed + 7919 * n_exp  # a fresh stream per experiment
        state = trainer.init(torch.Generator(device=trainer.device).manual_seed(exp_seed),
                             seed=exp_seed)
        hook = PDEHook(min_best_episode=cfg.min_best_episode, collect_best_trace=False)
        if verbose and trainer.is_root:
            print(f"--------- STARTING EXPERIMENT # {n_exp} ---------")
        noise = restart_noise
        rounds = 0
        while hook.ep - 1 < no_episodes:
            if rounds % inner_loops == 0:
                noise = restart_noise
            state.agent.act_noise = noise
            state, hook = train_sharded(trainer, loops=1, no_steps=episode_steps, state=state,
                                        hook=hook, verbose=False, noise_decay=1.0,
                                        chunk_fn=chunk_fn)
            noise *= inner_decay
            rounds += 1
        best_rewards.append(hook.bestreward)
        if save_fn is not None:
            save_fn(n_exp, state, hook)
        if verbose and trainer.is_root:
            print(f"--------- BEST REWARD: {hook.bestreward} ---------")
    return best_rewards


def finalize_hook(hook: PDEHook, state: MCState) -> None:
    """Copy the on-device best tracking and the current actor into the host
    hook (numpy copies)."""
    hook.adopt_device_best(state.best_reward, state.best_episode, state.best_actor)
    hook.current_actor = chain_to_numpy(state.agent.actor)


def save_sharded(out_dir: str, trainer: ShardedFluidTrainer, state: MCState, hook: PDEHook,
                 number: Optional[int] = None) -> None:
    """Checkpoint a run in the standard light format (saves/hook{n}.npz and
    saves/agent_light{n}.msgpack, train.checkpoint), so both packages' eval
    and resume paths read it at any mesh or on one device. Mesh rank 0
    writes it (the agent and the hook are the same on every rank). The
    replay is not kept (light semantics); the key is that of the run's
    seed."""
    if trainer.is_root:
        checkpoint.save(out_dir, TrainState(state.agent, None, state.generator), hook,
                        number=number, include_replay=False)


def load_sharded(load_dir: str, trainer: ShardedFluidTrainer, number: Optional[int] = None):
    """(DDPGState, PDEHook) of a checkpoint, full or light as
    `checkpoint.load` chooses, on the trainer's device, against this
    trainer's agent config. On a mesh, rank 0 reads it and broadcasts the
    agent's state dict and the hook, so that every rank starts from the
    same bits."""
    if trainer.mesh.group is None:
        ts, hook = checkpoint.load(load_dir, trainer.agent, number, trainer.device)
        return ts.agent, hook

    def read():
        ts, hook = checkpoint.load(load_dir, trainer.agent, number, "cpu")
        return checkpoint.agent_state_dict(ts.agent), hook

    tree, hook = trainer._on_root(read)
    return checkpoint.agent_from_state_dict(tree, trainer.agent, load_dir, trainer.device), hook


def load_actor_for_eval(load_dir: str, trainer: ShardedFluidTrainer) -> Chain:
    """The best actor of the run in `load_dir` on the trainer's device - the
    plot_heat/testrun bestNNA swap-in (plotting.jl:28-30) - or, when the
    hook holds none, the current actor of its checkpoint. On a mesh, rank 0
    reads the hook and broadcasts it."""
    hook = trainer._on_root(lambda: checkpoint.load_hook(load_dir))
    if hook.best_actor is not None:
        actor = checkpoint.actor_from_jax(hook.best_actor)
    else:
        actor = load_sharded(load_dir, trainer)[0].actor
    acfg = trainer.agent.cfg
    if actor.w[0].shape[1] != acfg.ns or actor.w[-1].shape[0] != acfg.na_rows:
        raise ValueError(
            f"the actor in {load_dir} maps {actor.w[0].shape[1]} -> {actor.w[-1].shape[0]}, "
            f"the preset needs {acfg.ns} -> {acfg.na_rows}")
    return actor.to(trainer.device)


def mc_state_from_jax(trainer: ShardedFluidTrainer, jstate, seed: int = 0) -> MCState:
    """The port's MCState from a numpy pytree of the JAX package's MCState,
    this rank's part of it (its envs, its rows of their fields, its dp
    group's replay with the leading dp axis stripped): fields,
    observations, actions and counters, the agent (`ddpg_state_from_jax`),
    the replay (`replay_from_jax`), the episode accounting and the best
    actor. The pool is that of `seed`, as the JAX trainer's `init(key,
    seed)` makes it. Nothing of JAX is imported: fields are read by name."""
    dev = trainer.device
    st = trainer.init(torch.Generator(device=dev).manual_seed(seed), seed=seed)

    def tensor(x, dtype=None):
        return torch.as_tensor(np.array(x), dtype=dtype, device=dev)

    st.w, st.obs, st.action = (tensor(jstate.w), tensor(jstate.obs), tensor(jstate.action))
    st.steps, st.ep_reward = tensor(jstate.steps, torch.int32), tensor(jstate.ep_reward)
    st.agent = checkpoint.ddpg_state_from_jax(trainer.agent, jstate.agent, dev)
    st.replay = checkpoint.replay_from_jax(jstate.replay, dev)
    st.global_step = int(np.asarray(jstate.global_step))
    st.ep_count = tensor(jstate.ep_count, torch.int32)
    st.best_reward, st.best_episode = tensor(jstate.best_reward), tensor(jstate.best_episode)
    st.best_actor = checkpoint.actor_from_jax(jstate.best_actor).to(dev)
    st.mean_reward = tensor(jstate.mean_reward)
    return st
