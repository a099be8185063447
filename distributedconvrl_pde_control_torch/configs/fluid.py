"""2D Navier-Stokes vorticity-control presets (scripts/Fluid/*).

Counterpart of ``distributedconvrl_pde_control_tpu/configs/fluid.py``: the
constants of the Fluid_8/16/32 scripts and FluidSetup.jl, the sensor and
actuator kernels, the featurizer and the agent configuration of a preset,
and `build_fluid`, the single-device env on the 3/2-rule `NSSolver` with
its three steppers (adaptive RK4, the default of the single-grid presets;
fixed RK4; integrating-factor RK4). The env state is the REAL vorticity
field, as in the reference package. The `--mesh` paths run the same presets
on the 2/3-rule solver (``parallel/multichip.py``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from distributedconvrl_pde_control_torch.agents.ddpg import DDPGAgent, DDPGConfig
from distributedconvrl_pde_control_torch.envs.features import (
    AbsConv2DFeaturizer,
    Conv2DFeaturizer,
    taylor_kernels_2d,
)
from distributedconvrl_pde_control_torch.envs.pde_env import PDEEnv
from distributedconvrl_pde_control_torch.ops import fourier
from distributedconvrl_pde_control_torch.ops.integrators import rk4_adaptive
from distributedconvrl_pde_control_torch.ops.navier_stokes import NSSolver, initial_condition
from distributedconvrl_pde_control_torch.train.drivers import Setup


@dataclasses.dataclass(frozen=True)
class FluidConfig:
    """Constants of a fluid experiment (Fluid_8/16/32 scripts + FluidSetup.jl).
    Field for field the JAX package's FluidConfig, so presets and config
    overrides carry over."""

    name: str = "Fluid_8"
    seed: int = 531
    sensors_per_axis: int = 8
    variance: float = 0.08
    evaluation: bool = False  # eval: nx=256, seed=76 (FluidSetup.jl:33-36)
    nx: int = 128
    lx: float = 1.0
    nu: float = 5e-5
    dealias: bool = True
    # transform tier (ops/fourier.py): "auto" = torch.fft in float32; "matmul",
    # "matmul_hi", "matmul_fast" = the JAX package's DFT-product tiers; the
    # advection's tier is nl_fft_mode (None: fft_mode). On --mesh the
    # advection is kernel K2, float32 under every nl_fft_mode
    fft_mode: str = "auto"
    nl_fft_mode: str | None = None
    adaptive: bool = False  # do_step2 semantics: adaptive RK4, tol 1e0
    adaptive_tol: float = 1.0  # FluidSetup.jl:179
    # fixed-step scheme when adaptive=False: "rk4" = the reference's do_step
    # (FluidSetup.jl:163-172, oversampling = 16*nx*dt substeps); "ifrk4" =
    # the integrating-factor tier at `fast_oversampling` substeps
    stepper: str = "rk4"
    # substeps for the ifrk4 tier; None = oversampling/4
    fast_oversampling: int | None = None
    # env (FluidSetup.jl:44-57)
    te: float = 6.0
    t0: float = 0.0
    dt: float = 0.02
    max_value: float = 3.0
    check_max_value: str = "reward"
    # featurization (FluidSetup.jl:65-77, 188-261)
    window_size: int = 3
    temporal_steps: int = 1
    memory_size: int = 0
    agent_power: float = 70.0
    action_punish: float = 0.002
    delta_action_punish: float = 0.002
    sensor_scale: float = 1.0 / 70.0
    reward_norm: float = 320.0
    reward_pow: float = 1.1
    # extensions of the JAX package's single-device env (`build_fluid`; the
    # 2/3-rule --mesh path does not read them): a local-enstrophy penalty
    # -w <|omega|, g_i> in the reward, and an |omega| observation channel
    # (envs/features.py::AbsConv2DFeaturizer)
    energy_reward_weight: float = 0.0
    abs_sensor_channel: bool = False
    # agent (FluidSetup.jl:79-95)
    nna_scale: float = 1.8
    nna_scale_critic: float = 17.0
    drop_middle_layer: bool = True
    gamma: float = 0.99
    polyak: float = 0.995
    batch_size: int = 3
    start_steps: int = 10
    update_after: int = 10
    update_freq: int = 1
    update_loops: int = 20
    learning_rate: float = 5e-4
    learning_rate_critic: float = 1e-3
    act_limit: float = 1.0
    act_noise: float = 1.2
    capacity: int = 1_800_000
    # training protocol (FluidSetup.jl:541-556, Fluid_8.jl:27)
    loops: int = 10
    no_steps: int = 580
    noise_decay: float = 0.6
    min_best_episode: int = 1

    @property
    def grid_nx(self) -> int:
        return 256 if self.evaluation else self.nx

    @property
    def grid_seed(self) -> int:
        return 76 if self.evaluation else self.seed

    @property
    def oversampling(self) -> int:
        # oversampling = floor(16 * nx * dt) (FluidSetup.jl:47)
        return int(np.floor(16 * self.grid_nx * self.dt))

    @property
    def fast_oversampling_eff(self) -> int:
        if self.fast_oversampling is not None:
            return self.fast_oversampling
        return max(1, int(np.ceil(self.oversampling / 4)))

    @property
    def positions(self):
        """Sensor/actuator lattice (FluidSetup.jl:61-63), 1-based (i, j)."""
        n = self.grid_nx
        step = n // self.sensors_per_axis
        return [(i, j) for i in range(1, n + 1, step) for j in range(1, n + 1, step)]


# adaptive=True is the recipe of the shipped single-grid presets (the
# reference installs do_step2, FluidSetup.jl:333); the 256^2 presets run the
# fixed-step do_step (FluidSetup.jl:163-172).
FLUID_8 = FluidConfig(name="Fluid_8", seed=531, sensors_per_axis=8, variance=0.08,
                      adaptive=True)
FLUID_16 = FluidConfig(name="Fluid_16", seed=436, sensors_per_axis=16, variance=0.04,
                       adaptive=True)
FLUID_32 = FluidConfig(name="Fluid_32", seed=886, sensors_per_axis=32, variance=0.022,
                       adaptive=True)
# The scale-out presets: trained at the reference's evaluation resolution.
FLUID_8_256 = FluidConfig(name="Fluid_8_256", seed=531, sensors_per_axis=8,
                          variance=0.08, nx=256)
FLUID_16_256 = FluidConfig(name="Fluid_16_256", seed=436, sensors_per_axis=16,
                           variance=0.04, nx=256)

PRESETS = {c.name: c for c in (FLUID_8, FLUID_16, FLUID_32, FLUID_8_256, FLUID_16_256)}


def fluid_error_detection(y: np.ndarray) -> bool:
    """Corrupted-field detector: neighbor jumps > 10 in real space
    (FluidSetup.jl:263-273)."""
    return bool(
        np.abs(np.roll(y, 1, 0) - y).max() > 10.0 or np.abs(np.roll(y, 1, 1) - y).max() > 10.0
    )


def fluid_kernels(cfg: FluidConfig):
    """Sensor/actuator Taylor-vortex kernels for a preset, shape
    (n_act, n, n) each (FluidSetup.jl:139-161). Kept per grid and sensor
    lattice for the process (at 256^2 they take seconds of host time to
    make): the arrays are shared, and callers copy them before any change."""
    return _fluid_kernels(cfg.grid_nx, tuple(cfg.positions), cfg.lx, cfg.variance)


@functools.lru_cache(maxsize=4)
def _fluid_kernels(n: int, positions: tuple, lx: float, variance: float):
    sensors = taylor_kernels_2d(positions, n, n, lx, lx, variance, norm_mode=1)
    actuators = taylor_kernels_2d(positions, n, n, lx, lx, variance, norm_mode=2)
    return sensors, actuators


def fluid_featurizer(cfg: FluidConfig, sensor_matrix: torch.Tensor) -> Conv2DFeaturizer:
    """The preset's featurizer (FluidSetup.jl:204-245), incl. the
    actuators_to_sensors mapping and temporal/memory rows, on the device of
    `sensor_matrix` (n_act, n*n)."""
    return Conv2DFeaturizer(
        sensor_matrix=sensor_matrix,
        actuators_to_sensors=torch.arange(cfg.sensors_per_axis**2, device=sensor_matrix.device),
        sensors_per_axis=cfg.sensors_per_axis,
        scale=cfg.sensor_scale,
        window_size=cfg.window_size,
        temporal_steps=cfg.temporal_steps,
        memory_size=cfg.memory_size,
    )


def fluid_agent_config(cfg: FluidConfig, obs_dim: int, capacity: int | None = None) -> DDPGConfig:
    """The preset's DDPG hyperparameters (FluidSetup.jl:79-95)."""
    return DDPGConfig(
        ns=obs_dim,
        na_rows=1 + cfg.memory_size,
        n_actuators=cfg.sensors_per_axis**2,
        gamma=cfg.gamma,
        polyak=cfg.polyak,
        batch_size=cfg.batch_size,
        start_steps=cfg.start_steps,
        update_after=cfg.update_after,
        update_freq=cfg.update_freq,
        update_loops=cfg.update_loops,
        act_limit=cfg.act_limit,
        act_noise=cfg.act_noise,
        memory_size=cfg.memory_size,
        nna_scale=cfg.nna_scale,
        nna_scale_critic=cfg.nna_scale_critic,
        drop_middle_layer=cfg.drop_middle_layer,
        learning_rate=cfg.learning_rate,
        learning_rate_critic=cfg.learning_rate_critic,
        capacity=capacity if capacity is not None else cfg.capacity,
    )


class AdaptiveFluidStep:
    """The reference's do_step2 (FluidSetup.jl:181-186): adaptive RK4 at the
    loose tolerance `tol` over one env step, through
    `ops/integrators.py::rk4_adaptive` on the full complex spectra, each env
    with its own step control; the field's and the forcing's transforms run
    at the solver's `fft_mode`, the right-hand sides' at its `nl_fft_mode`.
    `last_trials` holds each env's trial count of the last call (host
    integers)."""

    def __init__(self, solver: NSSolver, dt: float, tol: float, max_steps: int = 256):
        self.solver, self.dt, self.tol, self.max_steps = solver, dt, tol, max_steps
        self.last_trials = None

    def __call__(self, y, forcing):
        s, mode = self.solver, self.solver.fft_mode
        f = fourier.fft2(forcing.to(torch.float32), mode=mode)
        info = {}
        w = rk4_adaptive(lambda z, f_: s.rhs_real_layout(z, f_),
                         fourier.fft2(y.to(torch.float32), mode=mode), f, self.dt, rtol=self.tol,
                         atol=self.tol, max_steps=self.max_steps, info=info)
        self.last_trials = info["trials"]
        return fourier.ifft2(w, mode=mode).real


def fluid_random_field(cfg: FluidConfig, seed: int) -> np.ndarray:
    """The random-vortex field of generate_random_init (FluidSetup.jl:386-394)
    for an integer seed, float32 (ny, nx): case 3 in training, case 4 in
    evaluation. The JAX package draws `seed` from its key; the port's
    `random_init` draws it from a torch generator."""
    n = cfg.grid_nx
    w = initial_condition(4 if cfg.evaluation else 3, n, n, cfg.lx, cfg.lx,
                          np.random.default_rng(seed))
    return np.fft.ifft2(w).real.astype(np.float32)


def build_fluid(cfg: FluidConfig = FLUID_8, device: str = "cuda") -> Setup:
    """Assemble the single-device fluid setup (FluidSetup.jl:188-394) on
    `device`: the 3/2-rule `NSSolver`, the preset's stepper, featurizer,
    reward and prepared forcing, its case-4 initial field and its agent."""
    n = cfg.grid_nx
    solver = NSSolver(nx=n, ny=n, lx=cfg.lx, ly=cfg.lx, nu=cfg.nu, dealias=cfg.dealias,
                      fft_mode=cfg.fft_mode, nl_fft_mode=cfg.nl_fft_mode, device=device)
    n_act = cfg.sensors_per_axis**2
    sensors, actuators = fluid_kernels(cfg)
    sensor_matrix = torch.as_tensor(sensors.reshape(n_act, -1), dtype=torch.float32, device=device)
    actuator_stack = torch.as_tensor(actuators.reshape(n_act, -1), dtype=torch.float32,
                                     device=device)
    if cfg.abs_sensor_channel:
        featurizer = AbsConv2DFeaturizer(
            sensor_matrix=sensor_matrix,
            actuators_to_sensors=torch.arange(n_act, device=device),
            sensors_per_axis=cfg.sensors_per_axis,
            scale=cfg.sensor_scale,
            window_size=cfg.window_size,
        )
    else:
        featurizer = fluid_featurizer(cfg, sensor_matrix)

    def reward_fn(y, action, delta_action):
        """FluidSetup.jl:188-202 on real fields: (B, n, n) -> (B, n_act)."""
        flat = y.flatten(1)
        dots = (flat @ sensor_matrix.T).abs() ** cfg.reward_pow / cfg.reward_norm
        r = (
            -dots.abs()
            - cfg.action_punish * action[:, 0] ** 2
            - cfg.delta_action_punish * delta_action[:, 0] ** 2
        )
        if cfg.energy_reward_weight > 0.0:
            r = r - cfg.energy_reward_weight * (flat.abs() @ sensor_matrix.T)
        return r

    def prepare_action(action):
        """FluidSetup.jl:247-261: the real forcing field; the solver
        transforms it once per env step."""
        return (cfg.agent_power * (action[:, 0] @ actuator_stack)).reshape(-1, n, n)

    if cfg.adaptive:
        step_fn = AdaptiveFluidStep(solver, cfg.dt, cfg.adaptive_tol)
    elif cfg.stepper == "ifrk4":
        def step_fn(y, forcing):
            return solver.step_real_if(y, forcing, cfg.dt, cfg.fast_oversampling_eff)
    else:
        def step_fn(y, forcing):
            return solver.step_real(y, forcing, cfg.dt, cfg.oversampling)

    rng0 = np.random.default_rng(cfg.grid_seed)
    y0 = np.fft.ifft2(initial_condition(4, n, n, cfg.lx, cfg.lx, rng0)).real.astype(np.float32)
    env = PDEEnv(
        step_fn=step_fn,
        featurize=featurizer,
        prepare_action=prepare_action,
        reward_fn=reward_fn,
        y0=torch.as_tensor(y0, device=device),
        action_shape=(1 + cfg.memory_size, n_act),
        n_rewards=n_act,
        te=cfg.te,
        t0=cfg.t0,
        dt=cfg.dt,
        max_value=cfg.max_value,
        check_max_value=cfg.check_max_value,
    )

    def random_init(generator: torch.Generator, count: int) -> torch.Tensor:
        """generate_random_init (FluidSetup.jl:386-394): `count` random-vortex
        fields (count, n, n), each from an integer seed in [0, 2^31 - 1)
        drawn from `generator`."""
        seeds = torch.randint(0, 2**31 - 1, (count,), generator=generator,
                              device=generator.device).tolist()
        return torch.as_tensor(np.stack([fluid_random_field(cfg, s) for s in seeds]),
                               device=device)

    return Setup(
        name=cfg.name,
        env=env,
        agent=DDPGAgent(fluid_agent_config(cfg, featurizer.obs_dim)),
        seed=cfg.seed,
        random_init=random_init,
        loops=cfg.loops,
        no_steps=cfg.no_steps,
        noise_decay=cfg.noise_decay,
        min_best_episode=cfg.min_best_episode,
        record=False,  # collect_bestDF=false for fluid (FluidSetup.jl:373-377)
        error_detection=fluid_error_detection,
        reward_clamp=-3000.0,
    )
