"""Baseline policies: Zero, Random, Negate (classical opposition control).

Counterpart of ``distributedconvrl_pde_control_tpu/agents/policies.py``:
`ZeroPolicy` (src/PDEagent.jl:420-424), the uniform `RandomPolicy` of the
Keller-Segel setup (KellerSegelSetup.jl:75) and `NegatePolicy`
(FluidSetup.jl:277-326). A policy maps a batch of observations (B, ns,
n_actuators) to actions (B, action_rows, n_actuators), as
`train/eval.py::actor_policy` does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ZeroPolicy:
    action_shape: tuple

    def __call__(self, obs, generator: Optional[torch.Generator] = None):
        return torch.zeros((obs.shape[0],) + tuple(self.action_shape), dtype=torch.float32,
                           device=obs.device)


@dataclasses.dataclass(frozen=True)
class RandomPolicy:
    """Uniform actions in [-1, 1), drawn from the caller's generator on its
    device (JAX draws from an explicit key)."""

    action_shape: tuple

    def __call__(self, obs, generator: torch.Generator):
        u = torch.rand((obs.shape[0],) + tuple(self.action_shape), generator=generator,
                       dtype=torch.float32, device=generator.device)
        return (2.0 * u - 1.0).to(obs.device)


def negate_center_row(featurizer) -> int:
    """The own-site sensor row of the observation matrix for opposition
    control, derived from the featurizer: the current window block comes
    first in every column and its centre row is the actuator's own sensor
    (FluidSetup.jl:219-223). `ns // 2` would be wrong once temporal_steps >
    1 or memory rows are present."""
    ws = int(getattr(featurizer, "window_size", 1))
    if hasattr(featurizer, "sensors_per_axis"):  # 2D window (fluid family)
        return (ws * ws) // 2
    return ws // 2


@dataclasses.dataclass(frozen=True)
class NegatePolicy:
    """Opposition control: each actuator pushes against its own sensor.

    The reference loops `result[i] = -env.state[i]` over linear indices
    (FluidSetup.jl:292-295), which with a multi-row observation walks down
    the first columns; the JAX package implements the stated intent (actuator
    i opposes the centre row of column i) and keeps the literal column-major
    walk as `faithful=True`, and so does the port. `start_steps` and
    `start_policy` (None = zeros) give the warmup of create_agent_negate
    (FluidSetup.jl:284-326) when the caller passes the step index."""

    action_shape: tuple
    center_row: int  # index of the own-site sensor row in the obs matrix
    faithful: bool = False
    start_steps: int = 0
    start_policy: object = None

    def __call__(self, obs, generator: Optional[torch.Generator] = None,
                 step_idx: Optional[int] = None):
        n_rows, n_act = self.action_shape
        b = obs.shape[0]
        if self.faithful:
            flat = obs.transpose(1, 2).reshape(b, -1)  # column-major walk, like Julia's A[i]
            act = -flat[:, : n_rows * n_act].reshape(b, n_act, n_rows).transpose(1, 2)
        else:
            act = (-obs[:, self.center_row]).reshape(b, 1, -1).expand(b, n_rows, n_act)
        act = torch.clamp(act, -1.0, 1.0)
        if self.start_steps > 0 and step_idx is not None and step_idx < self.start_steps:
            act = (self.start_policy(obs, generator) if self.start_policy is not None
                   else torch.zeros_like(act))
        return act
