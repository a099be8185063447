"""Kuramoto-Sivashinsky experiment presets.

Counterpart of ``distributedconvrl_pde_control_tpu/configs/ks.py``: the
constants of `scripts/KS/setup/KSSetup.jl` (distributed agents) and
`scripts/KS/setup/KSglobalSetup.jl` (the mono/global ablation) and the
per-experiment scripts KS22 / KS200 / KS500 / KS200_disturbed /
KS22_global-agent; `build_ks` for the reference's CNAB2 stepper and for the
throughput tiers (`stepper="etdrk4"`, `spectral_carry`,
`spectral_featurize`, and the transform tiers `fft_mode` / `nl_fft_mode` of
``ops/fourier.py``), `build_ks_global` for the mono agent. The CNAB2 step
is kernel K1, which computes in float32 under every `fft_mode`, as its
Pallas twin does.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from distributedconvrl_pde_control_torch.agents.ddpg import DDPGAgent, DDPGConfig
from distributedconvrl_pde_control_torch.envs.features import (
    Conv1DFeaturizer,
    GlobalFeaturizer,
    gaussian_kernels_1d,
)
from distributedconvrl_pde_control_torch.envs.pde_env import PDEEnv
from distributedconvrl_pde_control_torch.ops.fourier import use_matmul_dft
from distributedconvrl_pde_control_torch.ops.ks import KSSolver, KSSolverETDRK4
from distributedconvrl_pde_control_torch.train.drivers import Setup


@dataclasses.dataclass(frozen=True)
class KSConfig:
    """Constants of a KS experiment (entry script + KSSetup.jl:20-77).
    Field for field the JAX package's KSConfig, so presets and config
    overrides carry over."""

    name: str = "KS22"
    seed: int = 609
    lx: float = 22.0
    nx: int = 192
    sensor_step: int = 24  # sensor_positions = 1:step:nx (1-based)
    n_actuators: int = 8
    sigma_sensors: float = 0.7
    sigma_actuators: float = 0.7
    mu: float = 0.0  # inhomogeneous disturbance amplitude
    # env
    te: float = 5.0
    t0: float = 0.0
    dt: float = 0.1
    oversampling: int = 30
    # transform tier (ops/fourier.py): "auto"/"native" = torch.fft in float32;
    # "matmul", "matmul_hi" (3-pass bf16), "matmul_fast" (1-pass bf16) = the
    # JAX package's DFT-product tiers. The CNAB2 stepper (K1) stays float32
    fft_mode: str = "auto"
    # integrator: "cnab2" = the reference's do_step (30 substeps,
    # KSSetup.jl:130-160), kernel K1; "etdrk4" = exact linear part, one step
    # per env step on torch.fft (ops/ks.py::KSSolverETDRK4)
    stepper: str = "cnab2"
    # etdrk4-only: the tier of the nonlinear evaluations' transforms (their
    # error enters scaled by the O(h) phi-weights); None = fft_mode
    nl_fft_mode: str | None = None
    # etdrk4-only: carry the field as its complex half-spectrum across env
    # steps and feed the solver spectral forcing computed directly from the
    # actions (exact: the forcing is a fixed-kernel linear combination,
    # KSSetup.jl:231-245). Drops 2 of the 3 per-env-step boundary transforms.
    spectral_carry: bool = False
    # etdrk4+carry-only trainer tier: featurize, reward and the blow-up guard
    # consume the carried half-spectrum through Parseval dots against
    # host-precomputed rfft'd kernels, deleting the last per-step synthesis
    # transform. The max|y| guard becomes the sound rms(y) > max_value
    # surrogate. Contract: EnvState.y then holds the episode's reset field,
    # so this is for the batched trainer and the bench only.
    spectral_featurize: bool = False
    max_value: float = 30.0
    check_max_value: str = "y"
    # featurization
    window_size: int = 1
    temporal_steps: int = 1
    memory_size: int = 0
    agent_power: float = 7.5
    action_punish: float = 0.002
    delta_action_punish: float = 0.002
    # agent (KSSetup.jl:39-77)
    nna_scale: float = 0.6
    nna_scale_critic: float = 7.0
    drop_middle_layer: bool = True
    gamma: float = 0.99
    polyak: float = 0.995
    batch_size: int = 3
    start_steps: int = 6
    update_after: int = 10
    update_freq: int = 1
    update_loops: int = 20
    learning_rate: float = 5e-4
    learning_rate_critic: float = 1e-3
    act_limit: float = 1.0
    act_noise: float = 1.2
    capacity: int = 150_000
    # training protocol (KSSetup.jl:304-319 + entry script loops)
    loops: int = 8
    no_steps: int = 800
    noise_decay: float = 0.2
    min_best_episode: int = 1

    @property
    def sensor_positions(self) -> np.ndarray:
        return np.arange(1, self.nx + 1, self.sensor_step)  # 1-based like the reference

    @property
    def actuators_to_sensors(self) -> np.ndarray:
        return np.arange(self.n_actuators)  # collect(1:n), 0-based here


# Shipped experiment constants (scripts/KS/*/*.jl).
KS22 = KSConfig(name="KS22", seed=609, lx=22.0, nx=192, sensor_step=24, n_actuators=8,
                sigma_sensors=0.7, sigma_actuators=0.7, loops=8)
KS200 = KSConfig(name="KS200", seed=59, lx=200.0, nx=240, sensor_step=3, n_actuators=80,
                 sigma_sensors=1.0, sigma_actuators=1.0, loops=6)
# KS500: zero-shot transfer target - eval-only, agent trained on KS200
# (scripts/KS/KS500/KS500.jl:21-24).
KS500 = KSConfig(name="KS500", seed=914, lx=500.0, nx=600, sensor_step=3, n_actuators=200,
                 sigma_sensors=1.0, sigma_actuators=1.0)
# Disturbed dynamics, eval-only with the mu=0 agent (KS200_disturbed.jl:16-24).
KS200_DISTURBED = dataclasses.replace(KS200, name="KS200_disturbed", seed=914, mu=0.02)
# Coarse-grid training tier of the JAX package: Lx=22 on 64 points.
KS22_64 = dataclasses.replace(KS22, name="KS22_64", nx=64, sensor_step=8)

# The mono/global-agent ablation (KSglobalSetup.jl, KS22_global-agent.jl).
KS22_GLOBAL = dataclasses.replace(KS22, name="KS22_global", seed=390, nna_scale=4.8,
                                  nna_scale_critic=56.0, capacity=700_000, no_steps=8000)

PRESETS = {c.name: c for c in (KS22, KS200, KS500, KS200_DISTURBED, KS22_64, KS22_GLOBAL)}


def ks_standard_y0(nx: int) -> np.ndarray:
    """y0_1D_standard: a 0.5-amplitude block over grid cells 4..44
    (KSSetup.jl:53)."""
    return np.asarray([0.5 if 4 <= i <= 44 else 0.0 for i in range(1, nx + 1)], np.float32)


def ks_random_init(cfg: KSConfig, device: str = "cuda"):
    """`generate_random_init` (KSSetup.jl:288-298): 8 random sines with unit-
    normalized coefficients, rescaled to ||y0|| = 30. Returns
    `init(generator, n) -> (n, nx)`; the coefficients are drawn on the
    generator's device (a CUDA generator draws on the card)."""
    dx = cfg.lx / cfg.nx
    x = torch.arange(1, cfg.nx + 1, dtype=torch.float32) * dx
    n_sin = 8
    harmonics = torch.stack([torch.sin(i * x / (2.0 * np.pi)) for i in range(1, n_sin + 1)])
    harmonics = harmonics.to(device)

    def init(generator: torch.Generator, n: int) -> torch.Tensor:
        a = torch.rand((n, n_sin), generator=generator, dtype=torch.float32,
                       device=generator.device).to(device) * 2.0 - 1.0
        a = a / torch.linalg.norm(a, dim=-1, keepdim=True)
        y0 = a @ harmonics
        return y0 * 30.0 / torch.linalg.norm(y0, dim=-1, keepdim=True)

    return init


def build_ks(cfg: KSConfig = KS22, device: str = "cuda") -> Setup:
    """Assemble the distributed-agent KS setup (KSSetup.jl:249-300) on `device`."""
    if cfg.spectral_featurize and not cfg.spectral_carry:
        raise ValueError("spectral_featurize requires spectral_carry")
    if cfg.spectral_carry and cfg.stepper != "etdrk4":
        raise ValueError("spectral_carry requires stepper='etdrk4'")
    if cfg.stepper not in ("cnab2", "etdrk4"):
        raise ValueError(f"unknown stepper {cfg.stepper!r}")
    if cfg.stepper == "etdrk4":
        solver = KSSolverETDRK4(nx=cfg.nx, lx=cfg.lx, dt=cfg.dt, oversampling=1, mu=cfg.mu,
                                fft_mode=cfg.fft_mode, nl_fft_mode=cfg.nl_fft_mode,
                                device=device)
    else:
        # K1 computes in float32 under every tier (its Pallas twin is HIGHEST only)
        use_matmul_dft(cfg.fft_mode)  # an unknown mode raises here
        solver = KSSolver(nx=cfg.nx, lx=cfg.lx, dt=cfg.dt, oversampling=cfg.oversampling,
                          mu=cfg.mu, device=device)
    sensors = gaussian_kernels_1d(cfg.sensor_positions, cfg.nx, cfg.lx, cfg.sigma_sensors,
                                  norm_mode=1)
    actuators = gaussian_kernels_1d(cfg.sensor_positions, cfg.nx, cfg.lx, cfg.sigma_actuators,
                                    norm_mode=2)[cfg.actuators_to_sensors]
    sensor_matrix = torch.as_tensor(sensors, dtype=torch.float32, device=device)
    actuator_matrix = torch.as_tensor(actuators, dtype=torch.float32, device=device)
    a2s = torch.as_tensor(cfg.actuators_to_sensors, device=device)

    featurizer = Conv1DFeaturizer(
        sensor_matrix=sensor_matrix,
        actuators_to_sensors=a2s,
        scale=1.0 / cfg.max_value,
        window_size=cfg.window_size,
        temporal_steps=cfg.temporal_steps,
        memory_size=cfg.memory_size,
    )
    reward_sel = sensor_matrix[a2s]  # sensor kernels at actuator sites

    def reward_fn(y, action, delta_action):
        """KSSetup.jl:162-184, per env: (B, nx) -> (B, n_actuators)."""
        dots = ((y * 6.0) @ reward_sel.T).abs() ** 1.3 / (cfg.max_value * 3.0)
        return (
            -dots.abs()
            - cfg.action_punish * action[:, 0] ** 2
            - cfg.delta_action_punish * delta_action[:, 0] ** 2
        )

    def prepare_action(action):
        """KSSetup.jl:231-245: forcing = sum_i agent_power * a_i * g_i."""
        return cfg.agent_power * (action[:, 0] @ actuator_matrix)

    def interleaved(rows):
        """Complex rows (m, nxh) as the real (m, 2*nxh) matrix that multiplies
        `torch.view_as_real` of a half-spectrum flattened to (B, 2*nxh)."""
        ri = np.stack([rows.real, rows.imag], axis=-1).reshape(rows.shape[0], -1)
        return torch.as_tensor(ri.astype(np.float32), device=device)

    init_carry = step_carry_fn = None
    step_carry_only = featurize_carry = reward_carry_fn = carry_guard = None
    if cfg.spectral_carry:
        # pre-transform the actuator kernels (float64 host FFT, cast f32):
        # F(forcing) = agent_power * sum_i a_i * F(g_i), exact, with no
        # per-step forcing analysis transform
        ghat = cfg.agent_power * np.fft.rfft(np.asarray(actuators, np.float64), axis=1)
        g_ri = interleaved(ghat)  # (n_actuators, 2*nxh)

        def forcing_hat(action):
            return torch.view_as_complex((action[:, 0] @ g_ri).reshape(action.shape[0], -1, 2))

        def step_carry_fn(carry, action):
            return solver.step_spectral(carry, forcing_hat(action))

        init_carry = solver.init_carry

    if cfg.spectral_featurize:
        # Parseval rows: sum_j g_j y_j = sum_k w_k (g_re_k y_re_k +
        # g_im_k y_im_k) with w = [1, 2, ..., 2, 1]/nx on the rfft
        # half-spectrum (the Nyquist weight 1 requires even nx, as every
        # shipped grid has). Kernels rfft'd host-side in float64, weights
        # folded in, cast f32: the sensor readout becomes one
        # (B, 2*nxh) x (2*nxh, n_sensors) product on the carry.
        nxh = cfg.nx // 2 + 1
        w = np.full(nxh, 2.0 / cfg.nx)
        w[0] = 1.0 / cfg.nx
        if cfg.nx % 2 == 0:
            w[-1] = 1.0 / cfg.nx
        shat = np.fft.rfft(np.asarray(sensors, np.float64), axis=1) * w
        s_ri_t = interleaved(shat).T.contiguous()  # (2*nxh, n_sensors)
        # reward uses reward_sel @ (y * 6.0): fold the 6 into the rows
        r_ri_t = (s_ri_t[:, a2s] * 6.0).contiguous()
        # rms guard rows: w/nx on both components of every bin
        w_ri = torch.as_tensor(np.repeat(w / cfg.nx, 2).astype(np.float32), device=device)

        def carry_ri(carry):
            return torch.view_as_real(carry).reshape(carry.shape[0], -1)

        def step_carry_only(carry, action):
            return solver.step_spectral_only(carry, forcing_hat(action))

        def featurize_carry(carry, prev_obs=None, action=None):
            return featurizer.from_dots(carry_ri(carry) @ s_ri_t, prev_obs, action)

        def reward_carry_fn(carry, action, delta_action):
            dots = (carry_ri(carry) @ r_ri_t).abs() ** 1.3 / (cfg.max_value * 3.0)
            return (
                -dots.abs()
                - cfg.action_punish * action[:, 0] ** 2
                - cfg.delta_action_punish * delta_action[:, 0] ** 2
            )

        def carry_guard(carry):
            return (carry_ri(carry).square() @ w_ri).sqrt() > cfg.max_value

    env = PDEEnv(
        step_fn=solver.step,
        featurize=featurizer,
        prepare_action=prepare_action,
        reward_fn=reward_fn,
        y0=torch.as_tensor(ks_standard_y0(cfg.nx), device=device),
        action_shape=(1 + cfg.memory_size, cfg.n_actuators),
        n_rewards=cfg.n_actuators,
        te=cfg.te,
        t0=cfg.t0,
        dt=cfg.dt,
        max_value=cfg.max_value,
        check_max_value=cfg.check_max_value,
        init_carry=init_carry,
        step_carry_fn=step_carry_fn,
        step_carry_only=step_carry_only,
        featurize_carry=featurize_carry,
        reward_carry_fn=reward_carry_fn,
        carry_guard=carry_guard,
    )

    agent = DDPGAgent(DDPGConfig(
        ns=featurizer.obs_dim,
        na_rows=1 + cfg.memory_size,
        n_actuators=cfg.n_actuators,
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
        capacity=cfg.capacity,
    ))

    return Setup(
        name=cfg.name,
        env=env,
        agent=agent,
        seed=cfg.seed,
        random_init=ks_random_init(cfg, device),
        loops=cfg.loops,
        no_steps=cfg.no_steps,
        noise_decay=cfg.noise_decay,
        min_best_episode=cfg.min_best_episode,
    )


# --------------------------------------------------------- global (mono) KS
def ks_global_fixed_y0() -> np.ndarray:
    """The stored fixed random init the reference's mono setup uses as its
    env default (KSglobalSetup.jl:62 loads y0.jld2: an 8-random-sine field
    normalized to ||y0|| = 30, generate_random_init at :314-323), shipped as
    data (data_ks_global_y0.npy, the JAX package's file byte for byte)."""
    return np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "data_ks_global_y0.npy"))


def build_ks_global(cfg: KSConfig = KS22_GLOBAL, device: str = "cuda") -> Setup:
    """Mono/global-agent ablation (KSglobalSetup.jl) on `device`: one MLP
    sees the whole sensor vector as one column and emits every actuator's
    command (na_rows = n_actuators, one column), with a scalar reward, the
    mean of the per-actuator terms, and replay interleave 1. The env steps
    through `KSSolver.step` (K1).

    Per-episode training inits stay random (the reference trains with
    use_random_init=true, KSglobalSetup.jl:326,330); the fixed stored y0 is
    the env's reset default, which evaluation protocols use. K1 computes in
    float32 under every `fft_mode`."""
    use_matmul_dft(cfg.fft_mode)  # an unknown mode raises here
    solver = KSSolver(nx=cfg.nx, lx=cfg.lx, dt=cfg.dt, oversampling=cfg.oversampling, mu=cfg.mu,
                      device=device)
    sensors = gaussian_kernels_1d(cfg.sensor_positions, cfg.nx, cfg.lx, cfg.sigma_sensors,
                                  norm_mode=1)
    actuators = gaussian_kernels_1d(cfg.sensor_positions, cfg.nx, cfg.lx, cfg.sigma_actuators,
                                    norm_mode=2)
    sensor_matrix = torch.as_tensor(sensors, dtype=torch.float32, device=device)
    actuator_matrix = torch.as_tensor(actuators, dtype=torch.float32, device=device)
    reward_sel = sensor_matrix[torch.as_tensor(cfg.actuators_to_sensors, device=device)]

    featurizer = GlobalFeaturizer(sensor_matrix=sensor_matrix, scale=1.0 / cfg.max_value,
                                  temporal_steps=cfg.temporal_steps, memory_size=cfg.memory_size)

    def reward_fn(y, action, delta_action):
        """KSglobalSetup.jl:174-205: the scalar mean of the per-actuator
        terms, per env: (B, nx) -> (B, 1)."""
        dots = ((y * 6.0) @ reward_sel.T).abs() ** 1.3 / (cfg.max_value * 3.0)
        per = (
            -dots.abs()
            - cfg.action_punish * action[:, :, 0] ** 2
            - cfg.delta_action_punish * delta_action[:, :, 0] ** 2
        )
        return per.mean(dim=1, keepdim=True)

    def prepare_action(action):
        """forcing = sum_i agent_power * a_i * g_i over the action column."""
        return cfg.agent_power * (action[:, :, 0] @ actuator_matrix)

    y0 = ks_global_fixed_y0() if cfg.nx == 192 else ks_standard_y0(cfg.nx)
    env = PDEEnv(
        step_fn=solver.step,
        featurize=featurizer,
        prepare_action=prepare_action,
        reward_fn=reward_fn,
        y0=torch.as_tensor(y0, dtype=torch.float32, device=device),
        action_shape=(cfg.n_actuators, 1),  # the flat action vector as one column
        n_rewards=1,
        te=cfg.te,
        t0=cfg.t0,
        dt=cfg.dt,
        max_value=cfg.max_value,
        check_max_value=cfg.check_max_value,
    )

    agent = DDPGAgent(DDPGConfig(
        ns=featurizer.obs_dim,
        na_rows=cfg.n_actuators,
        n_actuators=1,
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
        drop_middle_layer_critic=cfg.drop_middle_layer,
        learning_rate=cfg.learning_rate,
        learning_rate_critic=cfg.learning_rate_critic,
        capacity=cfg.capacity,
        mono=True,
    ))

    return Setup(
        name=cfg.name,
        env=env,
        agent=agent,
        seed=cfg.seed,
        random_init=ks_random_init(cfg, device),
        loops=cfg.loops,
        no_steps=cfg.no_steps,
        noise_decay=cfg.noise_decay,
        min_best_episode=cfg.min_best_episode,
    )
