"""Training drivers: the experiment-layer entry points.

Counterpart of ``distributedconvrl_pde_control_tpu/train/drivers.py``; the
port carries the `Setup` record only. The batched trainer
(`train/batched.py`) reads it as it is; the single-env fidelity loops, and
the fields of `Setup` that only they read (`record`, `use_random_init`,
`reward_clamp`, `error_detection`), are not ported yet (ROADMAP.md queue 1
item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from distributedconvrl_pde_control_torch.agents.ddpg import DDPGAgent
from distributedconvrl_pde_control_torch.envs.pde_env import PDEEnv


@dataclasses.dataclass
class Setup:
    """A fully assembled experiment: env + agent + training protocol.

    Plays the role of a reference setup file's module-level globals + the
    `initialize_setup()` call (e.g. KSSetup.jl:249-300).
    """

    name: str
    env: PDEEnv
    agent: DDPGAgent
    seed: int = 0
    random_init: Optional[Callable] = None  # (generator, n) -> (n, nx) y0 batch
    loops: int = 8
    no_steps: int = 800
    noise_decay: float = 0.2
    min_best_episode: int = 1
