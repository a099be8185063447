"""Batched PDE-control environment.

Counterpart of ``distributedconvrl_pde_control_tpu/envs/pde_env.py``: the
standard solver path and the two spectral-carry tiers. Where the JAX env is
one env under `vmap`, here every EnvState field has the env batch as its
leading dimension:

  * `PDEEnv.reset` reproduces RLBase.reset! (PDEenv.jl:183-193) for a batch
    of initial fields y0 (B, nx), or a batch of one from the default y0;
  * `PDEEnv.step` reproduces the step operator (PDEenv.jl:195-241):
    delta_action, prepare_action, solver step, reward, featurize, time
    advance, and termination at te, on blow-up (`check_max_value` in
    {"y", "reward", "none"}) or on a non-finite field or reward. With
    `step_carry_fn` the solver advances a carried half-spectrum instead of
    re-analyzing `y`; with the four `*_carry*` callables of the
    spectral-featurize tier, featurize, reward and the guards read the
    carry and `EnvState.y` keeps the episode's reset field.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from distributedconvrl_pde_control_torch.utils.profiling import annotate, span


@dataclasses.dataclass
class EnvState:
    """Batched snapshot of the environment (PDEenv.jl:26-62)."""

    y: torch.Tensor  # (B, nx), (B, 2, nx) or (B, ny, nx) PDE field
    obs: torch.Tensor  # (B, obs_dim, n_actuators)
    action: torch.Tensor  # (B, action_rows, n_actuators) last action
    delta_action: torch.Tensor
    forcing: torch.Tensor  # (B, ...) env.p, the prepared forcing
    steps: torch.Tensor  # (B,) int32
    time: torch.Tensor  # (B,) float32
    reward: torch.Tensor  # (B, n_rewards)
    done: torch.Tensor  # (B,) bool
    # solver carry of the spectral-state tiers (None on the standard path):
    # the (B, nx//2+1) complex64 half-spectrum of the field
    carry: Optional[torch.Tensor] = None


def where_state(mask: torch.Tensor, new: EnvState, old: EnvState) -> EnvState:
    """Per env, `new` where mask (B,) is true and `old` elsewhere."""
    def pick(n, o):
        if n is None:
            return None
        return torch.where(mask.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)

    return EnvState(**{f.name: pick(getattr(new, f.name), getattr(old, f.name))
                       for f in dataclasses.fields(EnvState)})


def index_state(state: EnvState, idx: torch.Tensor) -> EnvState:
    """The envs `idx` (n,) of a batched state, as a new batch of n."""
    return EnvState(**{f.name: None if getattr(state, f.name) is None
                       else getattr(state, f.name).index_select(0, idx)
                       for f in dataclasses.fields(EnvState)})


@dataclasses.dataclass(frozen=True)
class PDEEnv:
    """A batch of PDE control environments: dynamics + featurization + reward.

    All callables act on the whole batch:
      step_fn(y, forcing) -> y'                (the solver step)
      featurize(y, prev_obs, action) -> obs    (None args at reset)
      prepare_action(action) -> forcing        (action smearing)
      reward_fn(y, action, delta_action) -> rewards (B, n_rewards)
    """

    step_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    featurize: Callable[..., torch.Tensor]
    prepare_action: Callable[[torch.Tensor], torch.Tensor]
    reward_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
    y0: torch.Tensor  # (nx,), (2, nx) or (ny, nx) default initial field
    action_shape: tuple  # (action_rows, n_actuators)
    n_rewards: int
    te: float = 2.0
    t0: float = 0.0
    dt: float = 0.005
    max_value: float = 20.0
    check_max_value: str = "y"  # "y" | "reward" | "none" (PDEenv.jl:226-240)
    # Optional spectral-carry pair (throughput tier; both or neither):
    #   init_carry(y) -> carry
    #   step_carry_fn(carry, action) -> (carry', y')
    # When set, the solver advances the carried spectrum instead of
    # re-analyzing `y` each step; featurize, reward and termination still see
    # the per-step real field y', so every downstream semantic is unchanged.
    init_carry: Optional[Callable] = None
    step_carry_fn: Optional[Callable] = None
    # Spectral-featurize tier (on top of the carry; all four or none):
    # featurize, reward and the blow-up guard consume the carry directly
    # (sensor readouts are linear in y, so <y, g_i> is an exact Parseval dot
    # on the half-spectrum), and the step skips the synthesis transform:
    #   step_carry_only(carry, action) -> carry'
    #   featurize_carry(carry, prev_obs, action) -> obs
    #   reward_carry_fn(carry, action, delta_action) -> rewards
    #   carry_guard(carry) -> (B,) bool   (check_max_value surrogate; for "y"
    #       mode a sound under-trigger: rms(y) > max_value implies
    #       max|y| > max_value, so it never fires spuriously but fires a
    #       step or two later into an exponential blow-up than the exact
    #       max; the non-finite guard still backstops)
    # Contract: EnvState.y then holds the episode's reset field, not the
    # per-step field. A trainer tier (the batched trainer never reads y);
    # evaluation rollouts that record fields use the standard presets.
    step_carry_only: Optional[Callable] = None
    featurize_carry: Optional[Callable] = None
    reward_carry_fn: Optional[Callable] = None
    carry_guard: Optional[Callable] = None

    @property
    def max_steps(self) -> int:
        """Episode length cap: steps until time >= te."""
        return int(math.ceil((self.te - self.t0) / self.dt - 1e-9))

    def reset(self, y0: Optional[torch.Tensor] = None) -> EnvState:
        """Reset a batch from initial fields y0 (B, ...), or a batch of one
        from the env's default y0."""
        y = (self.y0[None] if y0 is None else y0).to(torch.float32)
        b, dev = y.shape[0], y.device
        action0 = torch.zeros((b,) + tuple(self.action_shape), dtype=torch.float32, device=dev)
        carry = self.init_carry(y) if self.init_carry is not None else None
        if self.featurize_carry is not None:
            obs = self.featurize_carry(carry, None, None)
        else:
            obs = self.featurize(y, None, None)
        return EnvState(
            y=y,
            obs=obs,
            action=action0,
            delta_action=torch.zeros_like(action0),
            forcing=self.prepare_action(action0),
            steps=torch.zeros(b, dtype=torch.int32, device=dev),
            time=torch.full((b,), self.t0, dtype=torch.float32, device=dev),
            reward=torch.zeros((b, self.n_rewards), dtype=torch.float32, device=dev),
            done=torch.zeros(b, dtype=torch.bool, device=dev),
            carry=carry,
        )

    @annotate("env.step")
    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        """Step operator (PDEenv.jl:195-241) on the whole batch."""
        delta_action = action - state.action
        forcing = self.prepare_action(action)
        spectral_io = self.featurize_carry is not None
        if spectral_io:
            with span("env.solve"):
                carry = self.step_carry_only(state.carry, action)
            y = state.y  # stale: the episode's reset field (tier contract)
            reward = self.reward_carry_fn(carry, action, delta_action)
            obs = self.featurize_carry(carry, state.obs, action)
        elif self.step_carry_fn is not None:
            with span("env.solve"):
                carry, y = self.step_carry_fn(state.carry, action)
            reward = self.reward_fn(y, action, delta_action)
            obs = self.featurize(y, state.obs, action)
        else:
            with span("env.solve"):
                carry, y = None, self.step_fn(state.y, forcing)
            reward = self.reward_fn(y, action, delta_action)
            obs = self.featurize(y, state.obs, action)
        steps = state.steps + 1
        # time = t0 + steps*dt (not accumulated) so the te comparison is
        # exact under f32 - 50 additions of f32(0.1) drift below 5.0
        time = (torch.tensor(self.t0, dtype=torch.float32)
                + steps.to(torch.float32) * torch.tensor(self.dt, dtype=torch.float32))
        done = time >= self.te * (1.0 - 1e-6)
        if self.check_max_value == "y":
            if spectral_io:
                done = done | self.carry_guard(carry)
            else:
                done = done | (y.flatten(1).abs().amax(dim=-1) > self.max_value)
        elif self.check_max_value == "reward":
            done = done | (reward.abs().amax(dim=-1) > self.max_value)
        # non-finite fields always terminate (the reference reaches the same
        # outcome through max() comparisons); on the spectral-featurize tier
        # the carry is read, since y is stale there
        field = carry if spectral_io else y
        finite = torch.isfinite(field.flatten(1)).all(dim=-1) & torch.isfinite(reward).all(dim=-1)
        done = done | ~finite
        return EnvState(
            y=y,
            obs=obs,
            action=action,
            delta_action=delta_action,
            forcing=forcing,
            steps=steps,
            time=time,
            reward=reward,
            done=done,
            carry=carry,
        )
