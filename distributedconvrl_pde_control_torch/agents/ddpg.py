"""Multi-agent-via-batching DDPG: configuration and the actor half.

Counterpart of ``distributedconvrl_pde_control_tpu/agents/ddpg.py``. One
tiny MLP actor is shared by all actuators (the actuator axis is the batch
axis of the forward pass, PDEagent.jl:189). The critic, noisy `act` and the
learn step come with the training slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from distributedconvrl_pde_control_torch.models.mlp import Chain, apply_chain


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    """Hyperparameters, defaults = the KS setup (KSSetup.jl:39-77).

    `ns`/`na_rows` are the per-actuator observation/action dims (state matrix
    rows); `n_actuators` is the shared-policy batch width. `mono=True` is the
    global-agent ablation: one column, scalar reward (PDEagent.jl:79-83).
    """

    ns: int
    na_rows: int
    n_actuators: int
    gamma: float = 0.99
    polyak: float = 0.995
    batch_size: int = 3
    start_steps: int = 6
    start_policy: str = "zero"  # "zero" | "random" | "negate"
    negate_center_row: int = 0  # obs row for the "negate" start policy
    update_after: int = 10
    update_freq: int = 1
    update_loops: int = 20
    act_limit: float = 1.0
    act_noise: float = 1.2
    memory_size: int = 0
    nna_scale: float = 0.6
    nna_scale_critic: Optional[float] = None
    drop_middle_layer: bool = True
    drop_middle_layer_critic: Optional[bool] = None
    learning_rate: float = 5e-4
    learning_rate_critic: float = 1e-3
    capacity: int = 150_000
    mono: bool = False
    reset_stage: str = "post_episode"  # when update_step resets (PDEagent.jl:215-235)

    @property
    def scale_critic(self) -> float:
        return self.nna_scale if self.nna_scale_critic is None else self.nna_scale_critic

    @property
    def drop_mid_critic(self) -> bool:
        return (
            self.drop_middle_layer
            if self.drop_middle_layer_critic is None
            else self.drop_middle_layer_critic
        )

    @property
    def interleave(self) -> int:
        """Replay interleaving width (1 in mono mode, PDEagent.jl:348-353)."""
        return 1 if self.mono else self.n_actuators

    @property
    def n_rewards(self) -> int:
        return 1 if self.mono else self.n_actuators


class DDPGAgent:
    """Config + the deterministic actor forward (relu hidden, tanh head)."""

    def __init__(self, cfg: DDPGConfig, hidden_act: Callable = torch.relu):
        self.cfg = cfg
        self.hidden_act = hidden_act

    def actor_apply(self, params: Chain, s: torch.Tensor) -> torch.Tensor:
        """Actions (na_rows, cols) for observations s (ns, cols)."""
        return apply_chain(params, s, self.hidden_act, torch.tanh)
