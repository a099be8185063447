"""Rank-side functions of the port's mesh tests (tests/test_torch_mesh.py,
tests/test_torch_multichip.py, tests/test_torch_kss_sharded.py).

The tests spawn gloo CPU ranks with `parallel.mesh.launch`; each rank
unpickles the function it runs by module, so the functions live here, in a
module that imports torch and the port only (the test modules import JAX,
which the ranks must not load). A function builds the sub-meshes it needs
from the world's ranks (every rank builds every sub-mesh, since creating a
group is collective), runs its checks on the ranks of each, and gathers each
result over the mesh, so that rank 0 returns whole arrays as numpy.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from distributedconvrl_pde_control_torch.parallel.mesh import launch, make_rank_mesh

TEST_TIMEOUT_S = 120.0  # the group timeout in tests: a hang fails, never reaches the suite's limit


def run_world(fn, n_ranks: int, store_dir: str, *args, timeout_s: float = TEST_TIMEOUT_S):
    """`fn(world_mesh, *args)` on `n_ranks` gloo CPU ranks; rank 0's result.
    The deadline leaves a loaded machine a minute to start the ranks."""
    return launch(fn, 1, n_ranks, *args, backend="gloo", store_dir=store_dir,
                  timeout_s=timeout_s, deadline_s=60.0 + 4 * timeout_s)


def _np(x):
    return x.detach().cpu().numpy()


def _rows(mesh, n):
    s = n // mesh.sp
    return slice(mesh.sp_idx * s, (mesh.sp_idx + 1) * s)


# ---------------------------------------------------------------- transforms
def mesh_checks(world, p: dict) -> dict:
    """The transpose transforms, the halo exchange and the sharded NS steppers
    at sp = 2 (ranks 0-1) and sp = 4 (ranks 0-3) on `p`'s global inputs."""
    from distributedconvrl_pde_control_torch.parallel.dfft import dfft2, difft2, difft2_real
    from distributedconvrl_pde_control_torch.parallel.halo import halo_exchange_1d
    from distributedconvrl_pde_control_torch.parallel.ns_sharded import (
        NSShardedSolver,
        make_sharded_ops,
    )

    out = {}
    for s in (2, 4):
        mesh = make_rank_mesh(1, s, "cpu", ranks=list(range(s)), timeout_s=TEST_TIMEOUT_S)
        if mesh is None:
            continue
        x, w = torch.from_numpy(p["x"]), torch.from_numpy(p["w"])
        rows, cols = _rows(mesh, x.shape[-2]), _rows(mesh, x.shape[-1])
        out[f"dfft2_{s}"] = _np(mesh.gather_cat(dfft2(x[..., rows, :], mesh), "sp", -1))
        out[f"difft2_{s}"] = _np(mesh.gather_cat(difft2(w[..., cols], mesh), "sp", -2))
        out[f"difft2_real_{s}"] = _np(mesh.gather_cat(difft2_real(w[..., cols], mesh), "sp", -2))
        line = torch.from_numpy(p["line"])
        block = line[..., _rows(mesh, line.shape[-1])]
        for periodic in (True, False):
            out[f"halo_{s}_{periodic}"] = _np(mesh.gather_cat(
                halo_exchange_1d(block, mesh, halo=1, periodic=periodic), "sp", -1))
        n = p["omg"].shape[-1]
        solver = NSShardedSolver(nu=p["nu"], mesh=mesh)
        ops = make_sharded_ops(n, n, device="cpu", mesh=mesh)
        omg, f = (torch.from_numpy(p[k])[..., _rows(mesh, n), :] for k in ("omg", "forcing"))
        steps = {"step_real": lambda: solver.step_real(omg, f, ops, p["dt"], p["os"]),
                 "step_real_if": lambda: solver.step_real_if(omg, f, ops, p["dt"], p["os"]),
                 "step_real_adaptive": lambda: solver.step_real_adaptive(
                     omg, f, ops, p["dt"], rtol=p["tol"], atol=p["tol"])}
        for name, step in steps.items():
            out[f"{name}_{s}"] = _np(mesh.gather_cat(step(), "sp", -2))
        trials = torch.tensor([solver.last_trials])
        out[f"trials_{s}"] = [int(t) for t in mesh.all_gather(trials, "sp")]
    return out


def mismatched_collective(world, hold_s: float) -> None:
    """Rank 0 prints a line and sums over sp; rank 1 never joins it and
    holds for `hold_s`."""
    if world.sp_idx == 0:
        print("rank 0 sums over sp", flush=True)
        world.psum(torch.ones(1), "sp")
    else:
        time.sleep(hold_s)


def paced_collectives(world, n: int, pause_s: float) -> float:
    """`n` sums over sp, `pause_s` apart, rank 0 printing each; the last sum."""
    total = torch.zeros(1)
    for i in range(n):
        time.sleep(pause_s)
        total = total + world.psum(torch.ones(1), "sp")
        if world.sp_idx == 0:
            print(f"sum {i}: {float(total)}", flush=True)
    return float(total)


# ------------------------------------------------------------ fluid trainer
def _state_ns(sd: dict) -> SimpleNamespace:
    """The attribute view of a JAX MCState's flax state dict (numpy leaves)
    that `mc_state_from_jax` reads."""
    from distributedconvrl_pde_control_torch.train.checkpoint import _jax_like

    def chain(d):
        return [d[str(i)] for i in range(len(d))]

    return SimpleNamespace(**{**sd, "agent": _jax_like(sd["agent"]),
                              "replay": SimpleNamespace(**sd["replay"]),
                              "best_actor": chain(sd["best_actor"])})


def rank_state(sd: dict, dp: int, sp: int, dp_idx: int, sp_idx: int, row_axis: int) -> dict:
    """Rank (dp_idx, sp_idx)'s part of a global JAX MCState dict: its envs,
    its rows (fluid, axis 1 of a field) or columns (Keller-Segel, axis 2) of
    their fields, and its dp group's replay."""
    bl = sd["obs"].shape[0] // dp
    envs = slice(dp_idx * bl, (dp_idx + 1) * bl)
    n = sd["w"].shape[row_axis]
    rows = [slice(None)] * 3
    rows[row_axis] = slice(sp_idx * n // sp, (sp_idx + 1) * n // sp)
    local = dict(sd)
    local["w"] = sd["w"][envs][tuple(rows)]
    for k in ("obs", "action", "steps", "ep_reward"):
        local[k] = sd[k][envs]
    local["replay"] = {k: v[dp_idx] for k, v in sd["replay"].items()}
    return local


def _trainer(kind: str, cfg, mesh, tcfg):
    from distributedconvrl_pde_control_torch.parallel.multichip import ShardedFluidTrainer
    from distributedconvrl_pde_control_torch.parallel.multichip_keller_segel import (
        ShardedKellerSegelTrainer,
    )

    cls = ShardedKellerSegelTrainer if kind == "kss" else ShardedFluidTrainer
    return cls(cfg, mesh, tcfg, device="cpu")


def chunk_on_mesh(world, p: dict) -> dict:
    """One chunk of the trainer (`p["kind"]`: "fluid" or "kss") on a dp x sp
    mesh from a JAX state with JAX's draws for each dp group; returns the
    chunk's records, the final agent and accounting of every rank (so that
    the test can check they are bit-identical), and each dp group's replay
    size."""
    from distributedconvrl_pde_control_torch.models.mlp import chain_to_numpy
    from distributedconvrl_pde_control_torch.parallel.multichip import (
        ShardedTrainConfig,
        mc_state_from_jax,
    )
    from distributedconvrl_pde_control_torch.train.batched import StepDraws

    dp, sp = p["mesh"]
    mesh = make_rank_mesh(dp, sp, "cpu", ranks=list(range(dp * sp)), timeout_s=TEST_TIMEOUT_S)
    if mesh is None:
        return None
    tr = _trainer(p["kind"], p["cfg"], mesh, ShardedTrainConfig(**p["tcfg"]))
    local = rank_state(p["state"], dp, sp, mesh.dp_idx, mesh.sp_idx, p["row_axis"])
    st = mc_state_from_jax(tr, _state_ns(local), seed=p["seed"])
    draws = [StepDraws(**{k: torch.from_numpy(v) for k, v in d.items()})
             for d in p["draws"][mesh.dp_idx]]
    st, packed = tr.make_chunk_fn(len(draws))(st, draws)
    params = {name: chain_to_numpy(getattr(st.agent, name))
              for name in ("actor", "critic", "target_actor", "target_critic")}
    params["best_actor"] = chain_to_numpy(st.best_actor)
    flat = torch.cat([torch.from_numpy(np.concatenate([np.ravel(l[k]) for l in chain
                                                       for k in ("w", "b")]))
                      for chain in params.values()])
    mine = torch.cat([flat, torch.tensor([float(st.ep_count), float(st.best_reward),
                                          float(st.best_episode), float(st.mean_reward),
                                          float(st.replay.size)])])
    every = [_np(t) for t in mesh.all_gather(mine, "dp")]
    every = [_np(t) for e in every for t in mesh.all_gather(torch.from_numpy(e), "sp")]
    return {"packed": _np(packed), "params": params, "every_rank": every,
            "ep_count": int(st.ep_count), "best_reward": float(st.best_reward),
            "best_episode": int(st.best_episode), "mean_reward": float(st.mean_reward),
            "replay_size": st.replay.size}


def eval_on_mesh(world, p: dict) -> dict:
    """The trainer's evaluation rollout of `p["actor"]` (a JAX actor as numpy)
    on each mesh of `p["meshes"]`, from the trainer's `eval_w0`."""
    from distributedconvrl_pde_control_torch.parallel.multichip import ShardedTrainConfig
    from distributedconvrl_pde_control_torch.train.checkpoint import actor_from_jax

    out = {}
    for dp, sp in p["meshes"]:
        mesh = make_rank_mesh(dp, sp, "cpu", ranks=list(range(dp * sp)), timeout_s=TEST_TIMEOUT_S)
        if mesh is None:
            continue
        tr = _trainer(p["kind"], p["cfg"], mesh, ShardedTrainConfig(**p["tcfg"]))
        recs = tr.make_eval_fn(p["n_steps"], p["t_action_steps"])(actor_from_jax(p["actor"]),
                                                                   tr.eval_w0())
        out[f"{dp}x{sp}"] = recs
        if getattr(p["cfg"], "adaptive", False):
            trials = torch.tensor([tr.solver.last_trials])
            out[f"{dp}x{sp}_trials"] = [int(t) for t in mesh.all_gather(trials, "dp")]
    return out


def error_flags_on_mesh(world, p: dict) -> dict:
    """`_error_flags` of the fluid trainer on a 2x4 mesh for the global fields
    `p["w"]` (B, n, n), then one train step from the state `p["state"]` with
    `p["w"]` as its fields: the flags and the step's records."""
    from distributedconvrl_pde_control_torch.parallel.multichip import (
        ShardedTrainConfig,
        mc_state_from_jax,
    )
    from distributedconvrl_pde_control_torch.train.batched import StepDraws

    dp, sp = p["mesh"]
    mesh = make_rank_mesh(dp, sp, "cpu", ranks=list(range(dp * sp)), timeout_s=TEST_TIMEOUT_S)
    if mesh is None:
        return None
    tr = _trainer("fluid", p["cfg"], mesh, ShardedTrainConfig(**p["tcfg"]))
    w = torch.from_numpy(p["w"])[tr.envs, tr.rows]
    flags = mesh.gather_cat(tr._error_flags(w), "dp", 0)
    local = rank_state(p["state"], dp, sp, mesh.dp_idx, mesh.sp_idx, 1)
    st = mc_state_from_jax(tr, _state_ns(local), seed=p["seed"])
    draws = [StepDraws(**{k: torch.from_numpy(v) for k, v in d.items()})
             for d in p["draws"][mesh.dp_idx]]
    _, packed = tr.make_chunk_fn(1)(st, draws)
    return {"flags": _np(flags), "packed": _np(packed)}


def _flat(tree: dict) -> torch.Tensor:
    """A nested dict of arrays as one float64 vector, in key order."""
    leaves = [_flat(v) if isinstance(v, dict) else torch.from_numpy(np.asarray(v, np.float64).ravel())
              for _, v in sorted(tree.items())]
    return torch.cat(leaves) if leaves else torch.zeros(0, dtype=torch.float64)


def load_on_mesh(world, p: dict) -> dict:
    """`load_sharded` of the checkpoint in `p["load_dir"]` on a dp x sp mesh
    (rank 0 reads, the ranks receive): every rank's agent state as one vector,
    and the hook's episode count."""
    from distributedconvrl_pde_control_torch.parallel.multichip import (
        ShardedTrainConfig,
        load_sharded,
    )
    from distributedconvrl_pde_control_torch.train.checkpoint import agent_state_dict

    dp, sp = p["mesh"]
    mesh = make_rank_mesh(dp, sp, "cpu", ranks=list(range(dp * sp)), timeout_s=TEST_TIMEOUT_S)
    if mesh is None:
        return None
    tr = _trainer("fluid", p["cfg"], mesh, ShardedTrainConfig(**p["tcfg"]))
    agent, hook = load_sharded(p["load_dir"], tr)
    mine = _flat(agent_state_dict(agent))
    every = [_np(t) for t in mesh.all_gather(mine, "dp")]
    every = [_np(t) for e in every for t in mesh.all_gather(torch.from_numpy(e), "sp")]
    return {"every_rank": every, "ep": hook.ep}


# ---------------------------------------------------------- Keller-Segel
def kss_solver_checks(world, p: dict) -> dict:
    """`KellerSegelShardedSolver.step` at sp = 2 (ranks 0-1) and sp = 4."""
    from distributedconvrl_pde_control_torch.parallel.keller_segel_sharded import (
        KellerSegelShardedSolver,
    )

    out = {}
    for s in (2, 4):
        mesh = make_rank_mesh(1, s, "cpu", ranks=list(range(s)), timeout_s=TEST_TIMEOUT_S)
        if mesh is None:
            continue
        cols = _rows(mesh, p["nx"])
        solver = KellerSegelShardedSolver(nx=p["nx"], lx=p["lx"], mesh=mesh)
        y = solver.step(torch.from_numpy(p["y"])[..., cols], torch.from_numpy(p["f"])[..., cols],
                        p["dt"], p["os"])
        out[f"step_{s}"] = _np(mesh.gather_cat(y, "sp", -1))
    return out


def multichip_checks(world, p: dict) -> dict:
    """Every fluid-trainer check of one world, in turn: the 2x2 chunk, the
    fixed-step and adaptive evaluations, the 2x4 error flags, a 2x2 load."""
    return {"chunk": chunk_on_mesh(world, p["chunk"]),
            "eval_fixed": eval_on_mesh(world, p["eval_fixed"]),
            "eval_adaptive": eval_on_mesh(world, p["eval_adaptive"]),
            "flags": error_flags_on_mesh(world, p["flags"]),
            "load": load_on_mesh(world, p["load"])}


def kss_checks(world, p: dict) -> dict:
    """Every Keller-Segel check of one world: the solver at sp = 2 and 4, the
    2x2 trainer chunk and its evaluation."""
    return {"solver": kss_solver_checks(world, p["solver"]),
            "chunk": chunk_on_mesh(world, p["chunk"]),
            "eval": eval_on_mesh(world, p["eval"])}
