"""Rank-side functions of the port's data-parallel tests
(tests/test_torch_batched_dp.py, tests/test_torch_population_dp.py,
tests/test_torch_tp.py).

As in tests/torch_mesh_ranks.py: the tests spawn gloo CPU ranks with
`parallel.mesh.launch`, each rank unpickles the function it runs from this
module (which imports torch and the port only), every rank builds every
sub-mesh (creating a group is collective), and rank 0 returns numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributedconvrl_pde_control_torch.configs import ks as tks
from distributedconvrl_pde_control_torch.models.mlp import chain_to_numpy, copy_chain
from distributedconvrl_pde_control_torch.parallel.batched_dp import DPBatchedTrainer
from distributedconvrl_pde_control_torch.parallel.mesh import make_rank_mesh
from distributedconvrl_pde_control_torch.train import checkpoint
from distributedconvrl_pde_control_torch.train.batched import (
    BatchedTrainerConfig,
    StepDraws,
    train_batched,
)
from distributedconvrl_pde_control_torch.train.population import PopulationTrainer

from torch_mesh_ranks import TEST_TIMEOUT_S, _np

NETS = ("actor", "critic", "target_actor", "target_critic")


def dp_mesh_of(n: int):
    """The n x 1 mesh of ranks 0..n-1 (None on the others)."""
    return make_rank_mesh(n, 1, "cpu", ranks=list(range(n)), timeout_s=TEST_TIMEOUT_S)


def ks_setup(over: dict):
    return tks.build_ks(dataclasses.replace(tks.KS22, **over), device="cpu")


def _every_rank(mesh, ts) -> list:
    """Every rank's networks and hook scalars as one vector each."""
    flat = torch.cat([torch.from_numpy(np.concatenate([np.ravel(l[k]) for l in chain_to_numpy(c)
                                                       for k in ("w", "b")]))
                      for c in [getattr(ts.agent, n) for n in NETS] + [ts.best_actor]])
    mine = torch.cat([flat, torch.tensor([float(ts.ep_count), float(ts.best_reward),
                                          float(ts.best_episode)])])
    return [_np(t) for t in mesh.all_gather(mine, "dp")]


def chunk_case(p: dict):
    """One chunk of `DPBatchedTrainer` (or, with `p["members"]`, of a
    population over dp) on a dp mesh from the JAX state in `p` with JAX's
    draws for each rank; None on ranks outside the mesh."""
    mesh = dp_mesh_of(p["dp"])
    if mesh is None:
        return None
    setup = ks_setup(p["ks"])
    cfg = BatchedTrainerConfig(n_envs=p["n_envs"], batch_size=p["batch"],
                               min_best_episode=p.get("min_best_episode", 0))
    pool = torch.from_numpy(p["pool"])
    if p.get("members"):
        tr = PopulationTrainer(setup.env, setup.agent, cfg, p["members"], y0_pool=pool,
                               lr_actor=p["lrs"][0], lr_critic=p["lrs"][1], mesh=mesh)
        ts = tr.init(torch.Generator().manual_seed(0), y0s=torch.from_numpy(p["y0s"]))
        ts.agent = tr.agent.make_state(checkpoint.actor_from_jax(p["agent"]["actor"]),
                                       checkpoint.actor_from_jax(p["agent"]["critic"]))
        ts.agent.act_noise = torch.tensor(p["noise"])
        ts.best_actor = copy_chain(ts.agent.actor)
    else:
        tr = DPBatchedTrainer(setup.env, setup.agent, cfg, mesh, y0_pool=pool)
        ts = tr.init(torch.Generator().manual_seed(0), y0s=torch.from_numpy(p["y0s"]))
        ts.agent = checkpoint.ddpg_state_from_jax(setup.agent, checkpoint._jax_like(p["agent"]),
                                                  "cpu")
        ts.best_actor = copy_chain(ts.agent.actor)
    draws = [StepDraws(**{k: torch.from_numpy(v) for k, v in d.items()})
             for d in p["draws"][mesh.dp_idx]]
    ts, packed = tr.make_chunk_fn(len(draws))(ts, draws)
    return {"packed": _np(packed), **{n: chain_to_numpy(getattr(ts.agent, n)) for n in NETS},
            "best_actor": chain_to_numpy(ts.best_actor), "ep_count": int(ts.ep_count),
            "best_reward": float(ts.best_reward), "best_episode": int(ts.best_episode),
            "total_env_steps": ts.total_env_steps, "replay_size": ts.replay.size,
            "replay_capacity": ts.replay.capacity,
            "carry_shape": (None if ts.env_states.carry is None else
                            tuple(ts.env_states.carry.shape)),
            "carry_finite": ts.env_states.carry is None or bool(
                torch.isfinite(torch.view_as_real(ts.env_states.carry)).all()),
            "every_rank": _every_rank(mesh, ts)}


def driver_case(p: dict):
    """`train_batched` unchanged on a dp mesh: `p["kwargs"]` of the driver;
    the hook's accounting, the chunk means, the final noise and an eval."""
    mesh = dp_mesh_of(p["dp"])
    if mesh is None:
        return None
    setup = ks_setup(p["ks"])
    tr = DPBatchedTrainer(setup.env, setup.agent,
                          BatchedTrainerConfig(n_envs=p["n_envs"], batch_size=p["batch"],
                                               update_loops=p["update_loops"]),
                          mesh, random_init=setup.random_init)
    ts, hook, means = train_batched(tr, generator=torch.Generator().manual_seed(p["seed"]),
                                    **p["kwargs"])
    return {"means": means, "total_env_steps": ts.total_env_steps, "ep": hook.ep,
            "rewards": list(hook.rewards), "bestreward": hook.bestreward,
            "best_actor": hook.best_actor, "act_noise": ts.agent.act_noise,
            "eval": tr.eval_mean_reward(ts.agent.actor, 10)}


def eval_pool_case(p: dict):
    """`eval_mean_reward` at dp 2 with a held-out eval pool, with the pools
    swapped, and with the training pool alone, on `p["y0s"]` when given,
    else on the drawn ICs."""
    mesh = dp_mesh_of(p["dp"])
    if mesh is None:
        return None
    setup = ks_setup({})
    cfg = BatchedTrainerConfig(n_envs=4, batch_size=8, update_loops=0)
    train, held = torch.from_numpy(p["train_pool"]), torch.from_numpy(p["eval_pool"])
    actor = checkpoint.actor_from_jax(p["actor"])
    out = {}
    for name, kw in (("held", dict(y0_pool=train, eval_y0_pool=held)),
                     ("swap", dict(y0_pool=held)), ("train", dict(y0_pool=train))):
        tr = DPBatchedTrainer(setup.env, setup.agent, cfg, mesh, **kw)
        out[name] = tr.eval_mean_reward(actor, 10, generator=torch.Generator().manual_seed(2))
    tr = DPBatchedTrainer(setup.env, setup.agent, cfg, mesh, y0_pool=train, eval_y0_pool=held)
    out["given"] = tr.eval_mean_reward(actor, 10, y0s=torch.from_numpy(p["y0s"]))
    return out


def merged_case(p: dict):
    """A dp chunk from a fresh state (`p["seed"]`, the pool rows `p["idx0"]`)
    with each rank's draws `p["draws"]`: records and networks."""
    mesh = dp_mesh_of(p["dp"])
    if mesh is None:
        return None
    setup = ks_setup(p["ks"])
    tr = DPBatchedTrainer(setup.env, setup.agent,
                          BatchedTrainerConfig(n_envs=p["n_envs"], batch_size=p["batch"]),
                          mesh, y0_pool=torch.from_numpy(p["pool"]))
    ts = tr.init(torch.Generator().manual_seed(p["seed"]), idx=torch.from_numpy(p["idx0"]))
    draws = [StepDraws(**{k: torch.from_numpy(v) for k, v in d.items()})
             for d in p["draws"][mesh.dp_idx]]
    ts, packed = tr.make_chunk_fn(len(draws))(ts, draws)
    return {"packed": _np(packed), **{n: chain_to_numpy(getattr(ts.agent, n)) for n in NETS}}


def batched_dp_checks(world, p: dict) -> dict:
    """Every check of tests/test_torch_batched_dp.py's world, in turn."""
    return {"chunks": {k: chunk_case(c) for k, c in p["chunks"].items()},
            "drivers": {k: driver_case(c) for k, c in p["drivers"].items()},
            "eval_pools": eval_pool_case(p["eval_pools"]), "merged": merged_case(p["merged"])}


# ------------------------------------------------------- population x dp
def _pop(p: dict, mesh, lrs=None):
    setup = ks_setup({"stepper": "etdrk4"})
    return PopulationTrainer(setup.env, setup.agent,
                             BatchedTrainerConfig(n_envs=p["n_envs"], batch_size=16),
                             2, y0_pool=torch.from_numpy(p["pool"]),
                             lr_actor=None if lrs is None else lrs[0],
                             lr_critic=None if lrs is None else lrs[1], mesh=mesh)


def pop_isolation(p: dict):
    """A 40-step chunk at dp 2 with member 1 at learning rate 0: each
    member's largest parameter change."""
    mesh = dp_mesh_of(2)
    if mesh is None:
        return None
    pop = _pop(p, mesh, ([5e-4, 0.0], [1e-3, 0.0]))
    ts = pop.init(torch.Generator().manual_seed(1))
    a0 = chain_to_numpy(ts.agent.actor)
    ts, _ = pop.make_chunk_fn(40)(ts)
    a1 = chain_to_numpy(ts.agent.actor)
    return [max(np.abs(x[k][m] - y[k][m]).max() for x, y in zip(a1, a0) for k in ("w", "b"))
            for m in range(2)]


def pop_layout(p: dict):
    """`train_population` at dp 2 with both members frozen, member 0
    noise-free and member 1 noisy: each member's hook rewards."""
    from distributedconvrl_pde_control_torch.train.population import train_population

    mesh = dp_mesh_of(2)
    if mesh is None:
        return None
    pop = _pop(p, mesh, ([0.0, 0.0], [0.0, 0.0]))
    _, hooks, _ = train_population(pop, total_steps=340, chunk_len=170,
                                   generator=torch.Generator().manual_seed(0),
                                   act_noise=[0.0, 3.0], noise_decay_every=0)
    return [{"ep": h.ep, "rewards": list(h.rewards)} for h in hooks]


def pop_driver_save(p: dict):
    """`train_population` at dp 2 with per-member noise schedules and evals,
    then `save_population` into `p["out"]` on rank 0."""
    from distributedconvrl_pde_control_torch.train.population import (
        save_population,
        train_population,
    )

    mesh = dp_mesh_of(2)
    if mesh is None:
        return None
    pop = _pop(p, mesh)
    ts, hooks, _ = train_population(pop, total_steps=60, chunk_len=20,
                                    generator=torch.Generator().manual_seed(0),
                                    act_noise=[1.2, 0.6], noise_decay_every=20,
                                    noise_decay=[0.5, 1.0], eval_every=30, eval_steps=10)
    summary = save_population(p["out"], pop, ts, hooks) if mesh.rank == 0 else None
    return {"act_noise": ts.agent.act_noise.numpy(), "evals": [h.evals for h in hooks],
            "bestrewards": [h.bestreward for h in hooks], "summary": summary}


def population_dp_checks(world, p: dict) -> dict:
    """Every check of tests/test_torch_population_dp.py's world, in turn."""
    return {"chunks": {k: chunk_case(c) for k, c in p["chunks"].items()},
            "isolation": pop_isolation(p["small"]), "layout": pop_layout(p["small"]),
            "driver": pop_driver_save(p["small"])}


# --------------------------------------------------------------- tp
def tp_checks(world, p: dict) -> dict:
    """The TP learn step on all ranks of the world (a tp mesh of 8) from the
    JAX state in `p`: one step gathered; `p["steps"]` steps chained on the
    sharded state, then gathered; each rank's layer-0 rows; the actor's
    gradient of -mean(Q(s, actor(s))) through the sharded critic."""
    from distributedconvrl_pde_control_torch.agents.ddpg import DDPGAgent, DDPGConfig
    from distributedconvrl_pde_control_torch.parallel.tp import (
        TPCriticAgent,
        gather_agent_state,
        make_tp_learn_step,
        make_tp_mesh,
        shard_agent_state,
    )

    mesh = make_tp_mesh(None, "cpu")
    agent = DDPGAgent(DDPGConfig(**p["cfg"]))
    state = checkpoint.ddpg_state_from_jax(agent, checkpoint._jax_like(p["agent"]), "cpu")
    batch = tuple(torch.from_numpy(x) for x in p["batch"])
    step = make_tp_learn_step(agent, mesh)
    one = step(state, batch)
    chained = step(state, batch, gather=False)
    rows = mesh.gather_cat(torch.tensor([chained.critic.w[0].shape]), 0)
    for _ in range(p["steps"] - 1):
        chained = step(chained, batch, shard_inputs=False, gather=False)
    chained = gather_agent_state(chained, mesh)

    sharded = shard_agent_state(state, mesh)
    s = batch[0]
    q = TPCriticAgent(agent, mesh).critic_apply(sharded.critic, s,
                                                agent.actor_apply(sharded.actor, s))
    grads = torch.autograd.grad(-torch.mean(q), list(sharded.actor.parameters()))
    return {"one": {n: chain_to_numpy(getattr(one, n)) for n in NETS},
            "chained": {n: chain_to_numpy(getattr(chained, n)) for n in NETS},
            "critic_loss": float(one.critic_loss), "rows": _np(rows).tolist(),
            "actor_grads": [_np(g) for g in grads]}
