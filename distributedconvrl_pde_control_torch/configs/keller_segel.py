"""Keller-Segel chemotaxis control presets (scripts/Keller-Segel/*).

Counterpart of ``distributedconvrl_pde_control_tpu/configs/keller_segel.py``:
`KellerSegelConfig` (Keller-Segel10_16.jl + KellerSegelSetup.jl:24-84), the
two presets and `build_keller_segel`, all in float32 on one device.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from distributedconvrl_pde_control_torch.agents.ddpg import DDPGAgent, DDPGConfig
from distributedconvrl_pde_control_torch.envs.features import (
    TwoFieldFeaturizer,
    rectangle_kernels_1d,
)
from distributedconvrl_pde_control_torch.envs.pde_env import PDEEnv
from distributedconvrl_pde_control_torch.ops.keller_segel import KellerSegelSolver
from distributedconvrl_pde_control_torch.train.drivers import Setup


@dataclasses.dataclass(frozen=True)
class KellerSegelConfig:
    """Constants of Keller-Segel10_16.jl + KellerSegelSetup.jl:24-84. Field
    for field the JAX package's KellerSegelConfig, so presets and config
    overrides carry over."""

    name: str = "KellerSegel10_16"
    seed: int = 155
    lx: float = 10.0
    nx: int = 100
    te: float = 8.0
    t0: float = 0.0
    dt: float = 0.006
    oversampling: int = 50
    max_value: float = 20.0  # PDEenv defaults (no override in this setup)
    check_max_value: str = "y"
    # featurization (KellerSegelSetup.jl:43-57, 112-128)
    half_window: int = 2  # rectangle kernel half width
    window_size: int = 3
    temporal_steps: int = 2
    sees_action: bool = False
    memory_size: int = 0
    agent_power: float = 10.0
    action_punish: float = 0.0
    delta_action_punish: float = 0.0
    sensor_scale: float = 0.25
    reward_norm: float = 800.0
    # agent (KellerSegelSetup.jl:68-84)
    nna_scale: float = 2.0
    nna_scale_critic: float = 17.0
    drop_middle_layer: bool = True
    gamma: float = 0.99
    polyak: float = 0.995
    batch_size: int = 3
    start_steps: int = -1  # start policy disabled (KellerSegelSetup.jl:74)
    start_policy: str = "random"
    update_after: int = 1
    update_freq: int = 1
    update_loops: int = 20
    learning_rate: float = 5e-4
    learning_rate_critic: float = 1e-3
    act_limit: float = 1.0
    act_noise: float = 1.2
    capacity: int = 100_000
    # training protocol (KellerSegelSetup.jl:390-406)
    loops: int = 13
    no_steps: int = 5000
    noise_decay: float = 0.6
    min_best_episode: int = 1

    @property
    def sensor_positions(self) -> np.ndarray:
        """collect(3:5:nx), 1-based (Keller-Segel10_16.jl:12)."""
        return np.arange(3, self.nx + 1, 5)

    @property
    def actuators_to_sensors(self) -> np.ndarray:
        """collect(3:18) 1-based -> 0-based sensor indices 2..17."""
        return np.arange(2, 18)


KELLER_SEGEL_10_16 = KellerSegelConfig()
# The JAX package's throughput tier: 10 RK4 substeps instead of the
# reference's 50 (its single-step error against a 500-substep oracle
# plateaus at the float32 floor from 5 substeps on).
KELLER_SEGEL_10_16_FAST = dataclasses.replace(
    KELLER_SEGEL_10_16, name="KellerSegel10_16_fast", oversampling=10)

PRESETS = {c.name: c for c in (KELLER_SEGEL_10_16, KELLER_SEGEL_10_16_FAST)}

_Y0_KEY8 = os.path.join(os.path.dirname(__file__), "data_keller_segel_y0_key8.npy")
_Y0_KEY7 = os.path.join(os.path.dirname(__file__), "data_keller_segel_y0_key7.npy")


def keller_segel_y0_key8() -> np.ndarray:
    """The JAX package's `random_init(jax.random.PRNGKey(8))` of the
    KellerSegel10_16 presets (threefry keys), (2, 100) float32: the unseen
    initial field of reproduce.py's Keller-Segel rows. A torch generator
    cannot draw that stream, so the field ships as data, written once by the
    JAX package on the CPU."""
    return np.load(_Y0_KEY8)


def keller_segel_y0_key7() -> np.ndarray:
    """The JAX package's `random_init(jax.random.PRNGKey(7))` of the
    KellerSegel10_16 presets (threefry keys), (2, 100) float32: the initial
    field of reproduce.py's Keller-Segel PPO row, shipped as data like the
    key-8 field."""
    return np.load(_Y0_KEY7)


SHIPPED_KEYS = (7, 8, 9, 10)


def keller_segel_y0_key(seed: int) -> np.ndarray:
    """The JAX package's `random_init(jax.random.PRNGKey(seed))` of the
    KellerSegel10_16 presets, (2, 100) float32, for the seeds whose field
    ships as data (`SHIPPED_KEYS`: the unseen initial fields of
    eval_kss_pop.py's protocol)."""
    if seed not in SHIPPED_KEYS:
        raise ValueError(f"the JAX package's Keller-Segel field of key {seed} does not ship; "
                         f"shipped keys: {SHIPPED_KEYS}")
    return np.load(os.path.join(os.path.dirname(__file__),
                                f"data_keller_segel_y0_key{seed}.npy"))


def keller_segel_random_init(cfg: KellerSegelConfig, device: str = "cuda"):
    """generate_random_init (KellerSegelSetup.jl:373-384): u and v are 1 plus
    ceil(Lx/3) sines with coefficients drawn uniform in [-1, 1) and
    normalized together to unit length. Returns `init(generator, n) ->
    (n, 2, nx)`; the coefficients are drawn on the generator's device."""
    n_sin = int(np.ceil(cfg.lx / 3.0))
    dx = cfg.lx / cfg.nx
    x = torch.arange(1, cfg.nx + 1, dtype=torch.float32) * dx
    scale = 2.0 * np.pi * (cfg.lx / 22.0)
    harmonics = torch.stack([torch.sin(i * x / scale) for i in range(1, n_sin + 1)]).to(device)

    def init(generator: torch.Generator, n: int) -> torch.Tensor:
        a = torch.rand((n, 2 * n_sin), generator=generator, dtype=torch.float32,
                       device=generator.device).to(device) * 2.0 - 1.0
        a = a / torch.linalg.norm(a, dim=-1, keepdim=True)
        return torch.stack([1.0 + a[:, :n_sin] @ harmonics, 1.0 + a[:, n_sin:] @ harmonics], dim=1)

    return init


def build_keller_segel(cfg: KellerSegelConfig = KELLER_SEGEL_10_16, device: str = "cuda") -> Setup:
    """Assemble the Keller-Segel setup (KellerSegelSetup.jl:24-406) on `device`."""
    solver = KellerSegelSolver(nx=cfg.nx, lx=cfg.lx)
    sensors = rectangle_kernels_1d(cfg.sensor_positions, cfg.nx, cfg.half_window)
    sensor_matrix = torch.as_tensor(sensors, dtype=torch.float32, device=device)
    a2s = torch.as_tensor(cfg.actuators_to_sensors, device=device)
    n_act = len(cfg.actuators_to_sensors)
    actuator_matrix = sensor_matrix[a2s]  # gaussians_actuators = gaussians[a2s]

    featurizer = TwoFieldFeaturizer(
        sensor_matrix=sensor_matrix,
        actuators_to_sensors=a2s,
        scale=cfg.sensor_scale,
        window_size=cfg.window_size,
        temporal_steps=cfg.temporal_steps,
        memory_size=cfg.memory_size,
        sees_action=cfg.sees_action,
        action_rows=1 + cfg.memory_size,
    )
    reward_sel = actuator_matrix.T.contiguous()  # (nx, n_act)

    def reward_fn(y, action, delta_action):
        """KellerSegelSetup.jl:241-263: -(dot(u - 1, rect)^2 / 800), per env."""
        dots = ((y[:, 0] - 1.0) @ reward_sel) ** 2 / cfg.reward_norm
        return (
            -dots.abs()
            - cfg.action_punish * action[:, 0] ** 2
            - cfg.delta_action_punish * delta_action[:, 0] ** 2
        )

    def prepare_action(action):
        return cfg.agent_power * (action[:, 0] @ actuator_matrix)

    def step_fn(y, forcing):
        return solver.step(y, forcing, cfg.dt, cfg.oversampling)

    y0 = np.ones((2, cfg.nx), np.float32)
    y0[1] *= 1.01  # y0_2D_standard (KellerSegelSetup.jl:59-61)

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

    agent = DDPGAgent(DDPGConfig(
        ns=featurizer.obs_dim,
        na_rows=1 + cfg.memory_size,
        n_actuators=n_act,
        gamma=cfg.gamma,
        polyak=cfg.polyak,
        batch_size=cfg.batch_size,
        start_steps=cfg.start_steps,
        start_policy=cfg.start_policy,
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
        random_init=keller_segel_random_init(cfg, device),
        loops=cfg.loops,
        no_steps=cfg.no_steps,
        noise_decay=cfg.noise_decay,
        min_best_episode=cfg.min_best_episode,
    )
