"""Tensor-parallel (parameter-sharded) DDPG learn step.

Counterpart of ``distributedconvrl_pde_control_tpu/parallel/tp.py``. The
reference's networks are tiny MLPs (KSSetup.jl:40-42), so tensor parallelism
buys nothing for the shipped experiments; the JAX package keeps it for
completeness and so does the port. The critic's hidden axis is split over
the ranks of a one-axis `tp` mesh, Megatron-style: layer 0 column-parallel
(rank i holds rows [i H/n, (i+1) H/n) of w0 and b0), the last layer
row-parallel (the same columns of w1, its bias replicated). Where JAX's
partitioner inserts the all-reduces into the unmodified `learn_batch`, here
the sharded critic's forward carries them as the two Megatron operators,
and the stock `DDPGAgent.learn_batch` runs on it unchanged:

  * at the column-parallel input, `_CopyToTP`: identity forward,
    `all_reduce` of the input's gradient backward: the actor's update
    differentiates through the critic into the action, and each rank's
    shard contributes a part of that gradient;
  * after the row-parallel output, `_ReduceFromTP`: `all_reduce` of the
    partial products forward, identity backward.

Adam and the polyak averaging are elementwise, so on the shards they are
the single-device update's slices. The actor, its Adam and the batch are
replicated.

The mesh is a small sibling of `parallel/mesh.py::RankMesh` (`TPMesh`: one
axis, its group), built from the same process groups (`make_rank_mesh`).

A critic with a middle layer (`drop_middle_layer_critic=False`) is refused:
the JAX package's `critic_tp_spec` gives such a layer `P("tp", "tp")`
(``distributedconvrl_pde_control_tpu/parallel/tp.py:47``), which JAX refuses
with a DuplicateSpecError, so the reference has no layout for it to mirror.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from distributedconvrl_pde_control_torch.agents.ddpg import DDPGAgent, DDPGState
from distributedconvrl_pde_control_torch.models.mlp import Chain, copy_chain
from distributedconvrl_pde_control_torch.parallel.mesh import make_rank_mesh

MIDDLE_LAYER_REFUSAL = (
    "a critic with a middle layer has no tensor-parallel layout: the JAX package's "
    "critic_tp_spec gives it PartitionSpec('tp', 'tp'), which JAX refuses with a "
    "DuplicateSpecError (distributedconvrl_pde_control_tpu/parallel/tp.py:47); use a "
    "two-layer critic (drop_middle_layer_critic=True, every shipped preset's)")


@dataclasses.dataclass(eq=False)
class TPMesh:
    """This rank's place on a one-axis `tp` mesh and the axis's group (None:
    a mesh of one rank, whose collectives are identities)."""

    tp: int = 1
    tp_idx: int = 0
    device: str = "cuda"
    group: Any = None

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        y = x.contiguous().clone()
        if self.group is not None:
            dist.all_reduce(y, group=self.group)
        return y

    def gather_cat(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's block concatenated along `dim` in rank order."""
        if self.group is None:
            return x.clone()
        parts = [torch.empty_like(x) for _ in range(self.tp)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim)


def make_tp_mesh(n: Optional[int] = None, device: str = "cuda") -> Optional[TPMesh]:
    """The `tp` mesh of the first `n` ranks (default: all) of the default
    process group as this rank sees it, or None on a rank outside it; every
    rank of the group must call it. Without a process group, the mesh of one
    rank."""
    if not dist.is_initialized():
        if n not in (None, 1):
            raise RuntimeError(f"a tp mesh of {n} ranks needs a process group "
                               "(parallel.mesh.launch)")
        return TPMesh(device=device)
    n = n or dist.get_world_size()
    m = make_rank_mesh(1, n, device)
    return None if m is None else TPMesh(n, m.sp_idx, device, m.sp_group)


def critic_tp_spec(critic: Chain) -> list:
    """The layout of a critic chain's tensors, one {"w", "b"} per layer, in
    the JAX package's PartitionSpec terms as tuples: layer 0 column-parallel
    (w ("tp", None), b ("tp",)), the last layer row-parallel (w (None, "tp"),
    b () replicated). Refuses a critic with a middle layer (module
    docstring)."""
    if len(critic.w) != 2:
        raise ValueError(MIDDLE_LAYER_REFUSAL)
    return [{"w": ("tp", None), "b": ("tp",)}, {"w": (None, "tp"), "b": ()}]


def _flat_specs(critic: Chain) -> list:
    """`critic_tp_spec` in the order of `critic.parameters()` (w0, w1, b0, b1)."""
    spec = critic_tp_spec(critic)
    return [layer["w"] for layer in spec] + [layer["b"] for layer in spec]


def _dim(spec: tuple) -> Optional[int]:
    return spec.index("tp") if "tp" in spec else None


def _shard(t: torch.Tensor, spec: tuple, mesh: TPMesh) -> torch.Tensor:
    d = _dim(spec)
    if d is not None and t.shape[d] % mesh.tp:
        raise ValueError(f"the critic's hidden width {t.shape[d]} does not divide over "
                         f"tp={mesh.tp}")
    t = t.detach() if d is None else t.detach().chunk(mesh.tp, d)[mesh.tp_idx]
    return t.contiguous().clone()


def _gather(t: torch.Tensor, spec: tuple, mesh: TPMesh) -> torch.Tensor:
    d = _dim(spec)
    return t.detach().clone() if d is None else mesh.gather_cat(t.detach(), d)


def _chain_like(chain: Chain, specs: list, fn) -> Chain:
    """A chain of `fn(tensor, spec)` over `chain`'s tensors."""
    ts = [fn(t, s) for t, s in zip(chain.parameters(), specs)]
    n = len(chain.w)
    return Chain(ts[:n], ts[n:])


def _adam_like(opt: torch.optim.Adam, params: list, fn) -> torch.optim.Adam:
    """An Adam over `params` with `opt`'s hyperparameters and its state, each
    moment mapped by `fn(moment, i)` (i: the parameter's index)."""
    g = opt.param_groups[0]
    new = torch.optim.Adam(params, lr=g["lr"], betas=g["betas"], eps=g["eps"],
                           fused=bool(g.get("fused")))
    for i, (old, p) in enumerate(zip(g["params"], params)):
        st = opt.state.get(old)
        if st:
            new.state[p] = {"step": st["step"].clone(), "exp_avg": fn(st["exp_avg"], i),
                            "exp_avg_sq": fn(st["exp_avg_sq"], i)}
    return new


def _relayout(astate: DDPGState, critic_specs: list, fn) -> DDPGState:
    """`astate` with its critic, target critic and their Adam moments mapped
    by `fn(tensor, spec)`, everything else copied (the result shares no
    tensor with `astate`)."""
    critic = _chain_like(astate.critic, critic_specs, fn)
    actor = copy_chain(astate.actor)
    return DDPGState(
        actor=actor, critic=critic, target_actor=copy_chain(astate.target_actor),
        target_critic=_chain_like(astate.target_critic, critic_specs, fn),
        opt_actor=_adam_like(astate.opt_actor, list(actor.parameters()),
                             lambda m, i: m.clone()),
        opt_critic=_adam_like(astate.opt_critic, list(critic.parameters()),
                              lambda m, i: fn(m, critic_specs[i])),
        act_noise=astate.act_noise, update_step=astate.update_step,
        actor_loss=astate.actor_loss.clone(), critic_loss=astate.critic_loss.clone())


def shard_agent_state(astate: DDPGState, mesh: TPMesh) -> DDPGState:
    """This rank's state on the tp mesh: its slices of the critic, the target
    critic and the critic's Adam moments; the actor, its Adam and the
    counters replicated. `astate` (the single-device layout, the same on
    every rank) is left as it is."""
    return _relayout(astate, _flat_specs(astate.critic), lambda t, s: _shard(t, s, mesh))


def gather_agent_state(astate: DDPGState, mesh: TPMesh) -> DDPGState:
    """The single-device layout of a sharded state, on every rank."""
    return _relayout(astate, _flat_specs(astate.critic), lambda t, s: _gather(t, s, mesh))


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the input's gradient all-reduced over tp backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad), None


class _ReduceFromTP(torch.autograd.Function):
    """The partial products all-reduced over tp forward; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class TPCriticAgent(DDPGAgent):
    """A DDPGAgent whose critic is this rank's shard of a two-layer critic:
    `critic_apply` is the Megatron forward, and the inherited `learn_batch`
    (the stock arithmetic) runs on it."""

    def __init__(self, agent: DDPGAgent, mesh: TPMesh):
        super().__init__(agent.cfg, hidden_act=agent.hidden_act,
                         hidden_act_critic=agent.hidden_act_critic)
        self.mesh = mesh

    def critic_apply(self, params: Chain, s: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        x = _CopyToTP.apply(torch.cat([s, a], dim=0), self.mesh)
        h = self.hidden_act_critic(params.w[0] @ x + params.b[0][:, None])
        return _ReduceFromTP.apply(params.w[1] @ h, self.mesh) + params.b[1][:, None]


def make_tp_learn_step(agent: DDPGAgent, mesh: TPMesh):
    """`run(astate, batch, shard_inputs=True, gather=True) -> DDPGState`: one
    `learn_batch` of `agent` with the critic sharded over `mesh`'s tp ranks.
    `astate` is the single-device layout (the same on every rank) unless
    `shard_inputs` is False (a state of `shard_agent_state` or of an earlier
    `run(..., gather=False)`); the result is a new state in the single-device
    layout, or with `gather=False` this rank's sharded state. Every rank of
    the mesh calls it with the same batch."""
    tp_agent = TPCriticAgent(agent, mesh)

    def run(astate: DDPGState, batch, shard_inputs: bool = True,
            gather: bool = True) -> DDPGState:
        sharded = shard_agent_state(astate, mesh) if shard_inputs else astate
        tp_agent.learn_batch(sharded, batch)
        return gather_agent_state(sharded, mesh) if gather else sharded

    return run
