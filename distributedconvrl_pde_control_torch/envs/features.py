"""Sensor/actuator kernels and the KS featurizer.

Counterpart of ``distributedconvrl_pde_control_tpu/envs/features.py``
(``gaussian_kernels_1d``, ``_window_stack_1d``, ``_temporal_and_memory``,
``Conv1DFeaturizer``). The env batch is an explicit leading dimension:
fields are (B, nx), sensor readouts (B, n_sensors), observations
(B, obs_dim, n_actuators).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


def gaussian_kernels_1d(
    positions: Sequence[int],
    nx: int,
    lx: float,
    sigma: float,
    norm_mode: int = 1,
    normalized_amplitude: bool = True,
) -> np.ndarray:
    """Periodic-wrapped Gaussian kernels, matrix of shape (n_kernels, nx).

    Mirrors `prepare_gaussians` (KSSetup.jl:82-109): a Gaussian centered at
    `position*dx` evaluated on an extended grid, normalized by sum
    (norm_mode=1, for sensors) or max (norm_mode=2, for actuators), then the
    tails outside [dx, Lx] are wrapped around periodically. The reference's
    width convention `exp(-x^2/2 * sigma^2)` (sigma multiplies) is kept.
    """
    dx = lx / nx
    extra = 50
    t = (np.arange(1 - extra, nx + extra + 1)) * dx  # dx-extra*dx : dx : Lx+extra*dx
    kernels = np.zeros((len(positions), nx))
    for i, pos in enumerate(positions):
        p = np.exp(-((t - pos * dx) ** 2) / 2.0 * sigma**2)
        if normalized_amplitude:
            p = p / np.sqrt(2.0 * np.pi * sigma)
        if norm_mode == 1:
            p = p / p.sum()
        else:
            p = p / p.max()
        left = p[:extra]
        right = p[extra + nx :]
        core = p[extra : extra + nx].copy()
        core[nx - extra :] += left
        core[: len(right)] += right
        kernels[i] = core
    return kernels


def _window_stack_1d(sensors: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, n) -> (B, window_size, n): rows i = -h..h of roll(sensors, i)
    along the sensor axis (`vcat([circshift(sensors, i)' for i in -h:h]...)`,
    KSSetup.jl:204-205)."""
    h = window_size // 2
    return torch.stack([torch.roll(sensors, i, dims=-1) for i in range(-h, h + 1)], dim=1)


def _temporal_and_memory(
    base: torch.Tensor,
    prev_obs: Optional[torch.Tensor],
    action: Optional[torch.Tensor],
    temporal_steps: int,
    memory_size: int,
    n_cols: int,
) -> torch.Tensor:
    """Temporal stacking + action-memory tail (KSSetup.jl:209-228) on
    (B, rows, n_cols) blocks.

    On init (prev_obs None): tile the base block `temporal_steps` times and
    zero memory rows. On step: new base block on top, previous obs shifted
    down (its oldest block and memory rows dropped), then the last
    `memory_size` action rows.
    """
    blocks = [base]
    if temporal_steps > 1:
        if prev_obs is None:
            blocks += [base] * (temporal_steps - 1)
        else:
            keep = prev_obs.shape[1] - base.shape[1] - memory_size
            blocks.append(prev_obs[:, :keep])
    if memory_size > 0:
        if action is None:
            blocks.append(base.new_zeros((base.shape[0], memory_size, n_cols)))
        else:
            blocks.append(action[:, -memory_size:])
    return torch.cat(blocks, dim=1) if len(blocks) > 1 else base


@dataclasses.dataclass(frozen=True)
class Conv1DFeaturizer:
    """KS-style local observations: per-sensor Gaussian dot products scaled by
    1/max_value, neighbor window, per-actuator columns (KSSetup.jl:190-229)."""

    sensor_matrix: torch.Tensor  # (n_sensors, nx)
    actuators_to_sensors: torch.Tensor  # (n_actuators,) int indices (0-based), on the device
    scale: float  # 1 / max_value
    window_size: int = 1
    temporal_steps: int = 1
    memory_size: int = 0

    @property
    def n_actuators(self) -> int:
        return len(self.actuators_to_sensors)

    @property
    def obs_dim(self) -> int:
        return self.window_size * self.temporal_steps + self.memory_size

    def from_dots(self, dots, prev_obs=None, action=None):
        """Featurize from raw sensor dot products <y, g_i> of shape (B, n_sensors)."""
        sensors = dots * self.scale
        base = _window_stack_1d(sensors, self.window_size)
        base = base[:, :, self.actuators_to_sensors]
        return _temporal_and_memory(
            base, prev_obs, action, self.temporal_steps, self.memory_size, self.n_actuators
        )

    def __call__(self, y, prev_obs=None, action=None):
        return self.from_dots(y @ self.sensor_matrix.T, prev_obs, action)
