"""Multi-agent-via-batching DDPG.

Counterpart of ``distributedconvrl_pde_control_tpu/agents/ddpg.py``, the
rebuild of the reference's `CustomDDPGPolicy` + learner (src/PDEagent.jl):
one tiny MLP actor shared by all actuators (the actuator axis is the batch
axis of the forward pass, PDEagent.jl:189), exploration noise on the
non-memory action rows (:201), clamping (:202-204), warmup start policy
(:180-181), and the learn step of PDEagent.jl:363-418:

    a'     = target_actor(s')
    qnext  = r + gamma * (1 - t) * target_critic([s'; a'])
    critic <- grad mean((qnext - critic([s; a]))^2)      (ADAM)
    actor  <- grad -mean(critic_updated([s; actor(s)]))  (ADAM)
    targets <- polyak * targets + (1 - polyak) * behavior

Where the JAX package returns new immutable pytrees, here `DDPGState` holds
`nn.Module` chains and `torch.optim.Adam` optimizers that `learn_batch`
updates in place; whoever keeps a snapshot of parameters copies them
(`models.mlp.copy_chain`). `update_step` and `act_noise` are host numbers:
the loop owns them and no device value decides them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed

from distributedconvrl_pde_control_torch.agents.replay import Replay, replay_sample
from distributedconvrl_pde_control_torch.models.mlp import (
    Chain,
    actor_sizes,
    apply_chain,
    copy_chain,
    critic_sizes,
    init_chain,
)
from distributedconvrl_pde_control_torch.utils.profiling import annotate


def dp_mean(grads, group) -> list:
    """The gradients averaged over the ranks of `group` (None: as they are):
    one `all_reduce` of their concatenation, divided by the group's size."""
    if group is None:
        return list(grads)
    flat = torch.cat([g.reshape(-1) for g in grads])
    torch.distributed.all_reduce(flat, group=group)
    flat /= torch.distributed.get_world_size(group)
    return [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]


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


@dataclasses.dataclass
class DDPGState:
    """Agent state on one device (networks, optimizers, schedule counters)."""

    actor: Chain
    critic: Chain
    target_actor: Chain
    target_critic: Chain
    opt_actor: torch.optim.Adam
    opt_critic: torch.optim.Adam
    act_noise: float  # decayed by the training loop (train_batched)
    update_step: int  # reset at reset_stage
    actor_loss: torch.Tensor  # f32 scalars on the device
    critic_loss: torch.Tensor


class DDPGAgent:
    """Static wrapper: config + network applies + optimizer factory. The
    state lives in `DDPGState`."""

    def __init__(self, cfg: DDPGConfig, hidden_act: Callable = torch.relu,
                 hidden_act_critic: Optional[Callable] = None):
        self.cfg = cfg
        self.hidden_act = hidden_act
        self.hidden_act_critic = hidden_act_critic or hidden_act
        self.actor_layer_sizes = actor_sizes(cfg.ns, cfg.na_rows, cfg.nna_scale,
                                             cfg.drop_middle_layer)
        self.critic_layer_sizes = critic_sizes(cfg.ns, cfg.na_rows, cfg.scale_critic,
                                               cfg.drop_mid_critic)

    # ------------------------------------------------------------- networks
    def actor_apply(self, params: Chain, s: torch.Tensor) -> torch.Tensor:
        """Actions (na_rows, cols) for observations s (ns, cols)."""
        return apply_chain(params, s, self.hidden_act, torch.tanh)

    def critic_apply(self, params: Chain, s: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        """Q values (1, cols) for [s; a] stacked on the feature axis."""
        return apply_chain(params, torch.cat([s, a], dim=0), self.hidden_act_critic, None)

    # ------------------------------------------------------------------ init
    def make_state(self, actor: Chain, critic: Chain, target_actor: Optional[Chain] = None,
                   target_critic: Optional[Chain] = None) -> DDPGState:
        """A state around the given behaviour networks: targets copied from
        them unless given, fresh Adam optimizers (optax.adam's defaults: b1
        0.9, b2 0.999, eps 1e-8 outside the root, bias correction on both
        moments), the config's noise, step 0. On a CUDA device Adam runs its
        fused form: one launch per optimizer step instead of one per tensor
        and operation."""
        cfg = self.cfg
        fused = next(actor.parameters()).is_cuda
        device = next(actor.parameters()).device
        return DDPGState(
            actor=actor,
            critic=critic,
            target_actor=copy_chain(actor) if target_actor is None else target_actor,
            target_critic=copy_chain(critic) if target_critic is None else target_critic,
            opt_actor=torch.optim.Adam(actor.parameters(), lr=cfg.learning_rate, fused=fused),
            opt_critic=torch.optim.Adam(critic.parameters(), lr=cfg.learning_rate_critic,
                                        fused=fused),
            act_noise=float(cfg.act_noise),
            update_step=0,
            actor_loss=torch.zeros((), dtype=torch.float32, device=device),
            critic_loss=torch.zeros((), dtype=torch.float32, device=device),
        )

    def init_state(self, generator: torch.Generator, device="cuda") -> DDPGState:
        """Fresh networks on `device` drawn from `generator`; the targets are
        force-synced copies of the behaviour networks (PDEagent.jl:76-77)."""
        actor = init_chain(generator, self.actor_layer_sizes, device)
        critic = init_chain(generator, self.critic_layer_sizes, device)
        return self.make_state(actor, critic)

    # ------------------------------------------------------------------- act
    def start_action(self, generator: Optional[torch.Generator], shape, obs=None, device="cuda"):
        """Warmup start policy: zeros (ZeroPolicy, PDEagent.jl:420-424),
        uniform random (RandomPolicy, KellerSegelSetup.jl:75), or corrected
        opposition control ("negate", an extension for warm-starting DDPG
        from the classical baseline)."""
        if self.cfg.start_policy == "random":
            gdev = device if generator is None else generator.device
            u = torch.rand(shape, generator=generator, dtype=torch.float32, device=gdev)
            return (2.0 * u - 1.0).to(device)
        if self.cfg.start_policy == "negate" and obs is not None:
            act = -obs[self.cfg.negate_center_row].reshape(1, -1)
            return torch.clamp(act.expand(shape), -1.0, 1.0)
        return torch.zeros(shape, dtype=torch.float32, device=device)

    @annotate("agent.act")
    @torch.no_grad()
    def act(self, astate: DDPGState, obs: torch.Tensor,
            generator: Optional[torch.Generator] = None, learning: bool = True,
            noise: Optional[torch.Tensor] = None, start: Optional[torch.Tensor] = None):
        """Policy call (PDEagent.jl:175-209). `learning` adds exploration
        noise to the non-memory rows and is gated by the warmup phase. Does
        not bump update_step: the loop owns that counter.

        `noise` (standard normal, the actions' shape) and `start` (the start
        policy's actions) replace the draws, which are otherwise made from
        `generator` on its device."""
        cfg = self.cfg
        actions = self.actor_apply(astate.actor, obs)
        shape = actions.shape  # (na_rows, n_cols); n_cols widens in batched-env mode
        if learning:
            # warmup: update_step <= start_steps -> start policy (:180-181)
            if astate.update_step <= cfg.start_steps:
                actions = (self.start_action(generator, shape, obs, obs.device)
                           if start is None else start.to(obs.device))
            else:
                if noise is None:
                    gdev = obs.device if generator is None else generator.device
                    noise = torch.randn(shape, generator=generator, dtype=torch.float32,
                                        device=gdev)
                noise = noise.to(obs.device) * astate.act_noise
                if cfg.memory_size > 0:
                    noise[-cfg.memory_size:, :] = 0.0
                actions = actions + noise
        return torch.clamp(actions, -cfg.act_limit, cfg.act_limit)

    # ----------------------------------------------------------------- learn
    def sample(self, replay: Replay, batch_size: int,
               generator: Optional[torch.Generator] = None, offs=None):
        """Learner-batch sampling route for the batched trainer. Next states
        are stored explicitly, so every entry is a complete transition and
        no newest-rows exclusion is needed (that exclusion mirrors the
        reference's slot arithmetic in fidelity mode, agents/replay.py)."""
        return replay_sample(replay, batch_size, 0, generator=generator, offs=offs)

    @annotate("agent.learn")
    def learn_batch(self, astate: DDPGState, batch, dp_group=None) -> DDPGState:
        """One sampled SGD step, the math of PDEagent.jl:363-418, in place
        on `astate`'s networks and optimizers. `dp_group` is the JAX
        package's `axis_name`: a process group over which the critic's and
        then the actor's gradients are averaged before each Adam step
        (data-parallel learning), one `all_reduce` of each network's
        flattened gradients, so that the parameters stay bit-identical on
        every rank of the group; the losses stay local."""
        cfg = self.cfg
        s, a, r, t, sn = batch

        with torch.no_grad():
            a_next = self.actor_apply(astate.target_actor, sn)
            q_next_t = self.critic_apply(astate.target_critic, sn, a_next).reshape(-1)
            q_target = r + cfg.gamma * (1.0 - t) * q_next_t

        critic_params = list(astate.critic.parameters())
        q = self.critic_apply(astate.critic, s, a).reshape(-1)
        c_loss = torch.mean((q_target - q) ** 2)
        for p, g in zip(critic_params, dp_mean(torch.autograd.grad(c_loss, critic_params),
                                                dp_group)):
            p.grad = g
        astate.opt_critic.step()

        # through the *updated* critic, as the reference does (gs2 computed
        # after update!(C, gs1), PDEagent.jl:400-412); the gradient is taken
        # for the actor's parameters alone, so nothing lands on the critic's
        actor_params = list(astate.actor.parameters())
        a_loss = -torch.mean(self.critic_apply(astate.critic, s, self.actor_apply(astate.actor, s)))
        for p, g in zip(actor_params, dp_mean(torch.autograd.grad(a_loss, actor_params),
                                               dp_group)):
            p.grad = g
        astate.opt_actor.step()

        # polyak averaging (PDEagent.jl:415-417), both targets in two launches
        with torch.no_grad():
            targets = list(astate.target_actor.parameters()) + list(astate.target_critic.parameters())
            torch._foreach_mul_(targets, cfg.polyak)
            torch._foreach_add_(targets, actor_params + critic_params, alpha=1.0 - cfg.polyak)
        astate.actor_loss = a_loss.detach()
        astate.critic_loss = c_loss.detach()
        return astate

    def learn_many(self, astate: DDPGState, replay: Replay,
                   generator: Optional[torch.Generator] = None,
                   offs: Optional[torch.Tensor] = None) -> DDPGState:
        """`update_loops` sampled SGD steps (PDEagent.jl:357-360), each
        excluding the newest `interleave` rows. `offs` (update_loops,
        batch_size) replaces the replay offsets drawn from `generator`."""
        cfg = self.cfg
        for i in range(cfg.update_loops):
            batch = replay_sample(replay, cfg.batch_size, cfg.interleave, generator=generator,
                                  offs=None if offs is None else offs[i])
            self.learn_batch(astate, batch)
        return astate
