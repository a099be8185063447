"""Preset-driven Keller-Segel training and evaluation over a dp x sp mesh.

Counterpart of ``distributedconvrl_pde_control_tpu/parallel/multichip_keller_segel.py``
(`ShardedKellerSegelTrainer`). The same dp x sp design as the fluid trainer
(``parallel/multichip.py``, whose docstring describes it): the env batch is
split over dp, each env's (2, nx) field over sp along the grid axis, and the
solver exchanges ghost cells with its ring neighbours
(``parallel/keller_segel_sharded.py``) instead of transposing spectra. The
trainer reuses the fluid trainer's machinery (the per-dp replay, the dp
gradient mean, the episode accounting, the best-actor tracking, the
checkpoints, the drivers) and replaces only the physics:

  * solver: the halo-exchange RK4 at the preset's fixed substeps
    (KellerSegelSetup.jl:213-239) at sp > 1; at sp = 1 the block is the
    whole grid and the single-device solver steps it (one launch of kernel
    K3 per step on the card, `ops/keller_segel.py`), as the fluid trainer
    keeps K2 at sp = 1;
  * sensors: each field's rectangle dots <y_f, rect_i> as partial products
    of this rank's grid columns, psum'd over sp (KellerSegelSetup.jl:112-128);
  * featurization: `TwoFieldFeaturizer.from_dots` (KellerSegelSetup.jl:265-316);
  * reward: -(<u - 1, rect>^2 / 800) on the actuator-mapped kernels
    (KellerSegelSetup.jl:241-263), with <u - 1, rect> = <u, rect> - sum(rect)
    taken from the raw dots;
  * forcing: into the v equation only (KellerSegelSetup.jl:228);
  * eval diagnostic: mean |u - 1|;
  * no corrupted-field detector (the reference installs none for this family).

At the reference's nx = 100 the grid divides over sp in {1, 2, 4, 5}.
"""

from __future__ import annotations

import math
from typing import Union

import numpy as np
import torch

from distributedconvrl_pde_control_torch.agents.ddpg import DDPGAgent, DDPGConfig
from distributedconvrl_pde_control_torch.configs.keller_segel import KellerSegelConfig
from distributedconvrl_pde_control_torch.envs.features import (
    TwoFieldFeaturizer,
    rectangle_kernels_1d,
)
from distributedconvrl_pde_control_torch.ops.keller_segel import KellerSegelSolver
from distributedconvrl_pde_control_torch.parallel.keller_segel_sharded import (
    KellerSegelShardedSolver,
)
from distributedconvrl_pde_control_torch.parallel.mesh import RankMesh
from distributedconvrl_pde_control_torch.parallel.multichip import (
    ShardedFluidTrainer,
    ShardedTrainConfig,
)
from distributedconvrl_pde_control_torch.utils.profiling import annotate


class ShardedKellerSegelTrainer(ShardedFluidTrainer):
    """Keller-Segel twin of the fluid trainer (module docstring). A rank's
    fields are (Bl, 2, nx/S): both fields, its columns of the grid."""

    def __init__(self, cfg: KellerSegelConfig, mesh: Union[RankMesh, tuple, None] = (1, 1),
                 tcfg: ShardedTrainConfig = ShardedTrainConfig(), device: str = "cuda"):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = device
        n = cfg.nx
        self._place(mesh, n)
        self.solver = (KellerSegelShardedSolver(nx=n, lx=cfg.lx, mesh=self.mesh) if self.n_sp > 1
                       else KellerSegelSolver(nx=n, lx=cfg.lx))
        self.ops = None  # a stencil solver has no operator arrays

        sens = rectangle_kernels_1d(cfg.sensor_positions, n, cfg.half_window)
        a2s = np.asarray(cfg.actuators_to_sensors)
        n_act = len(a2s)
        self.n_act = n_act
        self.sensor_kernels = self._t(sens[:, self.rows])  # (n_sens, nx/S)
        self.actuator_kernels = self._t(sens[a2s][:, self.rows])  # (n_act, nx/S)
        # <u - 1, rect> = <u, rect> - sum(rect), per actuator-mapped kernel
        self._rect_sums = self._t(sens[a2s].sum(axis=1))
        self._a2s = torch.as_tensor(a2s, device=device)
        self.featurizer = TwoFieldFeaturizer(
            sensor_matrix=self._t(sens),
            actuators_to_sensors=self._a2s,
            scale=cfg.sensor_scale,
            window_size=cfg.window_size,
            temporal_steps=cfg.temporal_steps,
            memory_size=cfg.memory_size,
            sees_action=cfg.sees_action,
            action_rows=1 + cfg.memory_size,
        )
        push = self.n_local * n_act
        self.capacity_per_dp = ((tcfg.capacity_per_dp + push - 1) // push) * push
        self.agent = DDPGAgent(DDPGConfig(
            ns=self.featurizer.obs_dim,
            na_rows=1 + cfg.memory_size,
            n_actuators=n_act,
            gamma=cfg.gamma,
            polyak=cfg.polyak,
            batch_size=tcfg.batch_size,
            start_steps=cfg.start_steps,
            start_policy=cfg.start_policy,
            update_after=cfg.update_after,
            update_freq=cfg.update_freq,
            update_loops=tcfg.update_loops,
            act_limit=cfg.act_limit,
            act_noise=cfg.act_noise,
            memory_size=cfg.memory_size,
            nna_scale=cfg.nna_scale,
            nna_scale_critic=cfg.nna_scale_critic,
            drop_middle_layer=cfg.drop_middle_layer,
            learning_rate=cfg.learning_rate,
            learning_rate_critic=cfg.learning_rate_critic,
            capacity=self.capacity_per_dp,
        ))
        self.max_steps = int(math.ceil((cfg.te - cfg.t0) / cfg.dt - 1e-9))
        self.pool = None
        self.pool_obs = None

    # ------------------------------------------------------- physics surface
    def _local_rows(self, fields: np.ndarray) -> np.ndarray:
        """This rank's columns of whole fields (..., 2, nx) -> (..., 2, nx/S)."""
        return fields[..., self.rows]

    @annotate("env.solve")
    def _solver_step(self, w, f):
        return self.solver.step(w, f, self.cfg.dt, self.cfg.oversampling)

    def _forcing(self, actions):
        """This rank's columns of the v equation's forcing (Bl, nx/S)
        (prepare_action: agent_power * a @ rects)."""
        return self.cfg.agent_power * (actions[:, 0, :] @ self.actuator_kernels)

    def _sensor_dots(self, w):
        """(Bl, 2, nx/S) blocks -> (Bl, 2, n_sens) raw dots, psum'd over sp."""
        return self.mesh.psum(torch.einsum("bfx,sx->bfs", w, self.sensor_kernels), "sp")

    def _reward(self, dots, actions, delta):
        """KellerSegelSetup.jl:241-263 from the raw dots (module docstring)."""
        cfg = self.cfg
        du = dots[:, 0, self._a2s] - self._rect_sums
        return (
            -(du**2 / cfg.reward_norm).abs()
            - cfg.action_punish * actions[:, 0, :] ** 2
            - cfg.delta_action_punish * delta[:, 0, :] ** 2
        )

    def _error_flags(self, w):
        """No corrupted-field detector for this family: the reference's
        error_detection exists only in the fluid setup (FluidSetup.jl:263-273)."""
        return torch.zeros(w.shape[:1], dtype=torch.bool, device=w.device)

    def _eval_metric(self, w):
        """Mean |u - 1|, the chemotaxis regulation diagnostic, its partial
        sums psum'd over sp."""
        return self.mesh.psum((w[:, 0, :] - 1.0).abs().sum(-1), "sp") / self.n

    def _make_pool(self, seed: int) -> np.ndarray:
        """Fresh-IC pool, whole fields (P, 2, nx): generate_random_init
        (KellerSegelSetup.jl:373-384) drawn from `np.random.default_rng(seed)`,
        the JAX trainer's numpy twin of the setup's random_init."""
        cfg = self.cfg
        rng = np.random.default_rng(seed)
        n_sin = int(np.ceil(cfg.lx / 3.0))
        dx = cfg.lx / cfg.nx
        x = np.arange(1, cfg.nx + 1, dtype=np.float32) * dx
        scale = 2.0 * np.pi * (cfg.lx / 22.0)
        harmonics = np.stack([np.sin(i * x / scale) for i in range(1, n_sin + 1)])
        pool = []
        for _ in range(self.tcfg.y0_pool_size):
            a = rng.uniform(-1.0, 1.0, 2 * n_sin).astype(np.float32)
            a = a / np.linalg.norm(a)
            pool.append(np.stack([1.0 + a[:n_sin] @ harmonics, 1.0 + a[n_sin:] @ harmonics]))
        return np.stack(pool).astype(np.float32)

    def eval_w0(self, n_envs: int | None = None) -> torch.Tensor:
        """Evaluation initial fields: the pool of the preset's seed, global
        env i on row i mod P (the RESULTS.md Keller-Segel protocol), this
        rank's block of them: (n_envs / dp, 2, nx/S)."""
        n_envs = n_envs or self.tcfg.n_envs
        if n_envs % self.n_dp:
            raise ValueError(f"{n_envs} eval envs do not divide over dp={self.n_dp}")
        pool = self._make_pool(self.cfg.seed)
        rows = np.arange(n_envs)[self.dp_idx * n_envs // self.n_dp:
                                 (self.dp_idx + 1) * n_envs // self.n_dp] % pool.shape[0]
        return self._t(self._local_rows(pool[rows]))
