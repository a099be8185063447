"""Preset-driven fluid control on the 2/3-rule solver: the evaluation half.

Counterpart of ``distributedconvrl_pde_control_tpu/parallel/multichip.py``
for a 1x1 mesh (one data-parallel group, one spatial shard): the reference
trains and evaluates a fluid preset across a ('dp', 'sp') chip mesh; with one
device the env batch and every field live whole on that device, and the
mesh collectives (psum, pmax over 'sp') are identities. Ported here is what
an evaluation runs: the trainer's arrays, the preset's stepper dispatch,
forcing, sensor readout, featurization, reward, the evaluation rollout
(`make_eval_fn`, the testrun protocol of FluidSetup.jl:400-537) and the
best-actor reader. The training half (replay, `_local_step`,
`make_chunk_fn`, `train_sharded`) and meshes of more than one device are not
ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributedconvrl_pde_control_torch.agents.ddpg import DDPGAgent
from distributedconvrl_pde_control_torch.configs.fluid import (
    FluidConfig,
    fluid_agent_config,
    fluid_featurizer,
    fluid_kernels,
)
from distributedconvrl_pde_control_torch.models.mlp import Chain
from distributedconvrl_pde_control_torch.ops.navier_stokes import initial_condition
from distributedconvrl_pde_control_torch.parallel.ns_sharded import (
    NSShardedSolverRI,
    make_sharded_ops,
)
from distributedconvrl_pde_control_torch.train.checkpoint import actor_from_jax, load_best_actor


@dataclasses.dataclass(frozen=True)
class ShardedTrainConfig:
    """Scale-out knobs of the trainer (everything physics/agent comes from
    the `FluidConfig` preset). The evaluation has one; the reference's
    learner and replay knobs come with the training half."""

    n_envs: int = 8  # global env batch


@dataclasses.dataclass
class EvalState:
    w: torch.Tensor  # (B, n, n) float32, the REAL vorticity
    obs: torch.Tensor  # (B, obs_dim, n_act)
    action: torch.Tensor  # (B, na_rows, n_act)
    steps: torch.Tensor  # (B,) int32
    done: torch.Tensor  # (B,) bool


class ShardedFluidTrainer:
    """Builds the device arrays and the evaluation rollout of a fluid
    experiment preset on a dp x sp = 1 x 1 mesh.

    Stepper dispatch: `adaptive=True` runs the step-doubling do_step2
    (`step_real_adaptive`), `stepper="ifrk4"` the integrating-factor tier,
    and the default is the reference's fixed-step do_step
    (FluidSetup.jl:163-172) at the preset's oversampling."""

    def __init__(self, cfg: FluidConfig, mesh: tuple[int, int] = (1, 1),
                 tcfg: ShardedTrainConfig = ShardedTrainConfig(), device: str = "cuda"):
        self.n_dp, self.n_sp = mesh
        if (self.n_dp, self.n_sp) != (1, 1):
            raise NotImplementedError(
                f"mesh {self.n_dp}x{self.n_sp}: the port runs dp = sp = 1 only; meshes of "
                "several devices (torch.distributed) are ROADMAP.md queue 1 item 15")
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = device
        n = cfg.grid_nx
        self.n = n
        self.solver = NSShardedSolverRI(nu=cfg.nu, fft_mode=cfg.fft_mode,
                                        nl_fft_mode=cfg.nl_fft_mode)
        self.ops = make_sharded_ops(n, n, cfg.lx, cfg.lx, device=device)

        n_act = cfg.sensors_per_axis**2
        self.n_act = n_act
        sens, acts = fluid_kernels(cfg)
        self.sensor_kernels = torch.as_tensor(sens, dtype=torch.float32, device=device)  # (n_act, n, n)
        self.actuator_kernels = torch.as_tensor(acts, dtype=torch.float32, device=device)
        self.featurizer = fluid_featurizer(cfg, self.sensor_kernels.reshape(n_act, -1))
        self.agent = DDPGAgent(fluid_agent_config(cfg, self.featurizer.obs_dim))

    # -------------------------------------------------------------- helpers
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
        """(B, na_rows, n_act) actions -> real-space forcing (B, n, n)
        (prepare_action, FluidSetup.jl:247-261; row 0 is the physical action)."""
        return self.cfg.agent_power * torch.einsum("bn,nyx->byx", actions[:, 0, :],
                                                   self.actuator_kernels)

    def _eval_metric(self, w):
        """Per-env eval diagnostic: fluid energy sum|omega|/(nx*ny)
        (testrun, FluidSetup.jl:497-500)."""
        return w.abs().flatten(1).sum(-1) / (self.n * self.n)

    def _sensor_dots(self, w):
        """Per-env raw sensor inner products <omega, g_i>: (B, n, n) -> (B, n_act)."""
        return w.flatten(1) @ self.featurizer.sensor_matrix.T

    def _featurize(self, dots, prev_obs, action):
        """(B, n_act) raw dots -> (B, obs_dim, n_act) via the preset's
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

    # --------------------------------------------------------------- eval
    def make_eval_fn(self, n_steps: int, t_action_steps: int = 0):
        """Evaluation rollout (the testrun protocol, FluidSetup.jl:400-537):
        deterministic policy, no replay/learning, per-step energy
        sum(|omega|)/(nx*ny). Early-terminated envs freeze. The rollout has
        no te cap.

        Returns fn (actor: Chain, w0 (B, n, n)) ->
        {energy, reward_mean, active: (n_steps, B)} as numpy arrays."""
        cfg = self.cfg
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
                w_new = self._solver_step(est.w, self._forcing(actions))
                dots = self._sensor_dots(w_new)
                obs_new = self._featurize(dots, est.obs, actions)
                reward = self._reward(dots, actions, delta)
                finite = torch.isfinite(reward).all(-1)
                if cfg.check_max_value == "reward":
                    blowup = reward.abs().amax(-1) > cfg.max_value
                elif cfg.check_max_value == "y":
                    blowup = w_new.abs().flatten(1).amax(-1) > cfg.max_value
                else:
                    blowup = torch.zeros((bl,), dtype=torch.bool, device=self.device)
                blowup = blowup | ~finite
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
            return {k: torch.stack(v).cpu().numpy() for k, v in recs.items()}

        return evaluate

    def eval_w0(self, n_envs: int | None = None) -> torch.Tensor:
        """Evaluation initial fields: the preset's canonical y0 (seeded
        case-4 random vortices, FluidSetup.jl:33-37) replicated over the
        eval env batch."""
        cfg = self.cfg
        n_envs = n_envs or self.tcfg.n_envs
        rng = np.random.default_rng(cfg.grid_seed)
        y0 = np.fft.ifft2(
            initial_condition(4, self.n, self.n, cfg.lx, cfg.lx, rng)
        ).real.astype(np.float32)
        return torch.as_tensor(y0, device=self.device).expand(n_envs, -1, -1).contiguous()


def load_actor_for_eval(load_dir: str, trainer: ShardedFluidTrainer) -> Chain:
    """The best actor of the run in `load_dir` (saves/hook.npz) on the
    trainer's device - the plot_heat/testrun bestNNA swap-in
    (plotting.jl:28-30). A run without a stored best actor raises: the
    reference's fall-back to the current actor needs the msgpack agent
    state, which the port does not read yet."""
    actor = actor_from_jax(load_best_actor(load_dir))
    acfg = trainer.agent.cfg
    if actor.w[0].shape[1] != acfg.ns or actor.w[-1].shape[0] != acfg.na_rows:
        raise ValueError(
            f"the actor in {load_dir} maps {actor.w[0].shape[1]} -> {actor.w[-1].shape[0]}, "
            f"the preset needs {acfg.ns} -> {acfg.na_rows}")
    return actor.to(trainer.device)
