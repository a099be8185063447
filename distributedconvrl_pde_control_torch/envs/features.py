"""Sensor/actuator kernels and the KS and fluid featurizers.

Counterpart of ``distributedconvrl_pde_control_tpu/envs/features.py``
(``gaussian_kernels_1d``, ``rectangle_kernels_1d``, ``taylor_kernels_2d``,
``_window_stack_1d``, ``_window_stack_2d``, ``_temporal_and_memory``,
``Conv1DFeaturizer``, ``Conv2DFeaturizer``, ``GlobalFeaturizer``,
``TwoFieldFeaturizer``, ``AbsConv2DFeaturizer``). The env batch is an
explicit leading dimension: fields are (B, nx), (B, 2, nx) (Keller-Segel) or
(B, ny, nx), sensor readouts (B, n_sensors), observations (B, obs_dim,
n_actuators).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from distributedconvrl_pde_control_torch.ops.navier_stokes import meshgrid_xy, taylor_vortex


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


def rectangle_kernels_1d(positions: Sequence[int], nx: int, half_window: int = 2) -> np.ndarray:
    """Top-hat kernels of width 2*half_window+1 (KellerSegelSetup.jl:112-126).

    Positions are 1-based grid indices as in the reference; no periodic wrap
    (the reference indexes directly, valid because positions stay interior).
    """
    kernels = np.zeros((len(positions), nx))
    for i, pos in enumerate(positions):
        kernels[i, pos - 1 - half_window : pos + half_window] = 1.0
    return kernels


def taylor_kernels_2d(
    positions: Sequence[tuple],
    nx: int,
    ny: int,
    lx: float,
    ly: float,
    variance: float,
    norm_mode: int = 1,
) -> np.ndarray:
    """Taylor-vortex-shaped 2D kernels, shape (n_kernels, ny, nx).

    Mirrors FluidSetup.jl:139-157: a Taylor vortex centered at the sensor
    position (1-based grid indices), thresholded at 0.1 (the
    sparsification), normalized by sum (sensors) or max (actuators). The
    reference stores these as sparse matrices; here they stay dense, so the
    sensor readout and the action smearing are one matrix product each.
    """
    dx, dy = lx / nx, ly / ny
    xx, yy = meshgrid_xy(nx, ny, lx, ly)
    kernels = np.zeros((len(positions), ny, nx))
    for i, (pi, pj) in enumerate(positions):
        k = taylor_vortex(xx, yy, pi * dx - dx, pj * dy - dy, variance, 1.0, lx, ly)
        k[k < 0.1] = 0.0
        if norm_mode == 1:
            k = k / k.sum()
        else:
            k = k / k.max()
        kernels[i] = k
    return kernels


def _window_stack_1d(sensors: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, n) -> (B, window_size, n): rows i = -h..h of roll(sensors, i)
    along the sensor axis (`vcat([circshift(sensors, i)' for i in -h:h]...)`,
    KSSetup.jl:204-205)."""
    h = window_size // 2
    return torch.stack([torch.roll(sensors, i, dims=-1) for i in range(-h, h + 1)], dim=1)


def _window_stack_2d(sensors: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, spa, spa) -> (B, window_size**2, spa*spa): rows (i, j) =
    roll(sensors, (i, j)) over the two sensor axes, flattened row-major
    (FluidSetup.jl:219-223; the transpose + column-major reshape there is a
    row-major flatten)."""
    h = window_size // 2
    rows = [
        torch.roll(sensors, (i, j), dims=(-2, -1)).flatten(-2)
        for i in range(-h, h + 1)
        for j in range(-h, h + 1)
    ]
    return torch.stack(rows, dim=1)


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


@dataclasses.dataclass(frozen=True)
class Conv2DFeaturizer:
    """Fluid-style observations (FluidSetup.jl:204-245): sensor dot products
    against the real-space vorticity field, a window of neighbouring
    sensors on the 2D sensor lattice, per-actuator columns."""

    sensor_matrix: torch.Tensor  # (n_sensors, ny*nx), row-major sensor order
    actuators_to_sensors: torch.Tensor  # (n_actuators,) int indices (0-based), on the device
    sensors_per_axis: int
    scale: float  # 1/70
    window_size: int = 3
    temporal_steps: int = 1
    memory_size: int = 0

    @property
    def n_actuators(self) -> int:
        return len(self.actuators_to_sensors)

    @property
    def obs_dim(self) -> int:
        return self.window_size**2 * self.temporal_steps + self.memory_size

    def from_dots(self, dots, prev_obs=None, action=None):
        """Featurize from raw sensor dot products <omega, g_i> of shape
        (B, n_sensors); sensor i sits at (i // spa, i % spa), FluidSetup.jl:216."""
        spa = self.sensors_per_axis
        sensors = (dots * self.scale).reshape(-1, spa, spa)
        base = _window_stack_2d(sensors, self.window_size)
        base = base[:, :, self.actuators_to_sensors]
        return _temporal_and_memory(
            base, prev_obs, action, self.temporal_steps, self.memory_size, self.n_actuators
        )

    def __call__(self, y, prev_obs=None, action=None):
        return self.from_dots(y.flatten(-2) @ self.sensor_matrix.T, prev_obs, action)


@dataclasses.dataclass(frozen=True)
class GlobalFeaturizer:
    """Mono/global-agent observations: the whole sensor vector as one column
    (KSglobalSetup.jl:210-249), (B, n_sensors * temporal_steps + memory_size, 1)."""

    sensor_matrix: torch.Tensor  # (n_sensors, nx)
    scale: float
    temporal_steps: int = 1
    memory_size: int = 0

    @property
    def obs_dim(self) -> int:
        return self.sensor_matrix.shape[0] * self.temporal_steps + self.memory_size

    def __call__(self, y, prev_obs=None, action=None):
        base = ((y @ self.sensor_matrix.T) * self.scale)[:, :, None]
        return _temporal_and_memory(base, prev_obs, action, self.temporal_steps,
                                    self.memory_size, 1)


@dataclasses.dataclass(frozen=True)
class TwoFieldFeaturizer:
    """Keller-Segel observations (KellerSegelSetup.jl:265-316): both fields'
    rectangle dots scaled by `scale`, a window per field, optionally the
    last action rows, temporal stacking and memory rows."""

    sensor_matrix: torch.Tensor  # (n_sensors, nx)
    actuators_to_sensors: torch.Tensor  # (n_actuators,) int indices (0-based), on the device
    scale: float = 0.25
    window_size: int = 3
    temporal_steps: int = 2
    memory_size: int = 0
    sees_action: bool = False
    action_rows: int = 1

    @property
    def n_actuators(self) -> int:
        return len(self.actuators_to_sensors)

    @property
    def obs_dim(self) -> int:
        base = 2 * self.window_size + (self.action_rows if self.sees_action else 0)
        return base * self.temporal_steps + self.memory_size

    def from_dots(self, dots, prev_obs=None, action=None):
        """Featurize from raw per-field sensor dots <y_f, rect_i> of shape
        (B, 2, n_sensors)."""
        blocks = [_window_stack_1d(dots[:, f] * self.scale, self.window_size)
                  [:, :, self.actuators_to_sensors] for f in range(2)]
        if self.sees_action:
            blocks.append(dots.new_zeros((dots.shape[0], self.action_rows, self.n_actuators))
                          if action is None else action)
        base = torch.cat(blocks, dim=1)
        return _temporal_and_memory(
            base, prev_obs, action, self.temporal_steps, self.memory_size, self.n_actuators
        )

    def __call__(self, y, prev_obs=None, action=None):
        return self.from_dots(y @ self.sensor_matrix.T, prev_obs, action)


@dataclasses.dataclass(frozen=True)
class AbsConv2DFeaturizer:
    """Fluid observations with a second channel of |field| sensor readings,
    an extension of the JAX package (not in the reference): windowed
    <|omega|, g_i> rows under the windowed <omega, g_i> rows, so that
    zero-circulation structures, which the signed readings miss, are
    observable."""

    sensor_matrix: torch.Tensor  # (n_sensors, ny*nx)
    actuators_to_sensors: torch.Tensor  # (n_actuators,) int indices (0-based), on the device
    sensors_per_axis: int
    scale: float
    window_size: int = 3

    @property
    def n_actuators(self) -> int:
        return len(self.actuators_to_sensors)

    @property
    def obs_dim(self) -> int:
        return 2 * self.window_size**2

    def __call__(self, y, prev_obs=None, action=None):
        flat = y.flatten(-2)
        spa = self.sensors_per_axis
        vals = ((flat @ self.sensor_matrix.T) * self.scale).reshape(-1, spa, spa)
        avals = ((flat.abs() @ self.sensor_matrix.T) * self.scale).reshape(-1, spa, spa)
        base = torch.cat([_window_stack_2d(vals, self.window_size),
                          _window_stack_2d(avals, self.window_size)], dim=1)
        return base[:, :, self.actuators_to_sensors]
