"""Driver of the Keller-Segel training cells: `run.py KellerSegel10_16 --train
--mesh 1x1` as the port's CLI runs it
(`parallel/multichip_keller_segel.py::ShardedKellerSegelTrainer` at 1x1 in
the process, no process group: the finite-difference RK4 at the preset's
substeps, one CUDA graph replay per env step on the card, rectangle sensors,
the two-field temporally stacked observation, a pool of fresh fields for the
in-step resets, one DDPG update per step), chunks back to back with the
records read `pipeline_depth` chunks behind, through `drive.py`'s window as
the fluid driver runs it. Set-up runs the window's loop for
`warmup_seconds` before the measured window: on an H100 the device's chunk
time (CUDA events a chunk) stayed 4.4 % above its steady value for the
first 0-10 s of load after set-up, a different stretch in each process.

The benchmark makes the networks and the compared steps' draws from the
seed and hands the same to the program and to the reference. The reset pool
is the program's own, made by its `init` from the seed; the reference makes
the same fields from the seed by its own code, and the first fields are
compared too.

The check adds two numbers to `compare.train_gaps`' own:

- `loss`: each update's losses, each gap over a size that cannot vanish.
  The actor loss is -mean(Q(s, actor(s))); with seeded weights and rewards
  of (du)^2 / 800 that mean can lie near zero while the Q values it
  averages do not, and a gap relative to the mean alone has no bound. Its
  gap is taken over the larger of |reference actor loss| and the
  reference's mean |Q(s, actor(s))| over the batch: round-off in the Q
  values scales with their sizes, which the mean |Q| measures. The critic
  loss L = mean(d^2), d = q_target - Q(s, a), is small where the critic
  fits its batch, while its gap, 2 mean(d dd) to first order, stays of the
  size of sqrt(L) times the Q values' round-off: its gap is taken over the
  larger of L and sqrt(L) times the reference's mean |Q(s, a)|, so that a
  critic that fits does not read as a fault.
- `graph`: the share of the window's solver calls that a step launched op
  by op on the card or a new graph capture served
  (`ops/keller_segel.py::KELLER_SEGEL_STEPS`); every step of the window
  should be a replay of the graph captured at set-up. A program without the
  counters (whose card step has no route but the graph) is read from its
  solver's table of graphs: a capture in the window adds an entry.
"""

from __future__ import annotations

import math
from pathlib import Path

import torch

from benchmark import compare, drive, harness
from benchmark.reference import keller_segel as ref_ksg
from benchmark.reference import nets

train_fluid = harness.load_module(Path(__file__).with_name("train_fluid.py"))

N_ACT = len(ref_ksg.actuator_sensors())


def obs_dim(config: dict) -> int:
    action = 1 + config["memory_size"] if config["sees_action"] else 0
    return (2 * config["window_size"] + action) * config["temporal_steps"] + config["memory_size"]


def reference_config(config: dict, workload: dict) -> dict:
    return {**config, "n_envs": workload["n_envs"], "y0_pool_size": workload["pool_size"],
            "max_steps": int(math.ceil((config["te"] - config["t0"]) / config["dt"] - 1e-9)),
            "agent": drive.agent_dict(config, obs_dim(config), workload["capacity_per_dp"])}


def plan(config: dict, workload: dict) -> dict:
    push = workload["n_envs"] * N_ACT
    first = drive.first_learn_step(push, workload["capacity_per_dp"], config["update_after"],
                                   N_ACT)
    n = first + workload["compared_updates"] - 1
    return {"steps": n, "learned": [k >= first for k in range(1, n + 1)], "push": push}


def make_inputs(config: dict, workload: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    actor, critic = drive.networks(gen, obs_dim(config), config, device)
    b = workload["n_envs"]
    p = plan(config, workload)
    return {"actor": actor, "critic": critic, "seed": seed, "device": device,
            "draws": drive.compared_draws(gen, p["steps"], b * N_ACT,
                                          workload["learner_batch"], p["push"],
                                          workload["capacity_per_dp"], workload["pool_size"], b)}


def reference(config: dict, workload: dict, inputs: dict, precision: str = "float32",
              fault: str | None = None) -> dict:
    if torch.device(inputs["device"]).type == "cuda":
        nets.ieee_matmuls()
    return ref_ksg.train_steps(reference_config(config, workload), inputs,
                               plan(config, workload)["steps"], precision, fault)


def build(ctx):
    from distributedconvrl_pde_control_torch.configs.keller_segel import KellerSegelConfig
    from distributedconvrl_pde_control_torch.parallel.multichip import ShardedTrainConfig
    from distributedconvrl_pde_control_torch.parallel.multichip_keller_segel import (
        ShardedKellerSegelTrainer,
    )
    from distributedconvrl_pde_control_torch.train.batched import StepDraws

    config, wl = ctx.cell.config, ctx.cell.workload
    tcfg = ShardedTrainConfig(n_envs=wl["n_envs"], batch_size=wl["learner_batch"],
                              update_loops=wl["update_loops"],
                              capacity_per_dp=wl["capacity_per_dp"], y0_pool_size=wl["pool_size"],
                              chunk_len=wl["chunk_len"], pipeline_depth=wl["pipeline_depth"])
    trainer = ShardedKellerSegelTrainer(drive.program_config(KellerSegelConfig, config), (1, 1),
                                        tcfg, device=ctx.device)
    inputs = make_inputs(config, wl, ctx.seed, ctx.device)
    st = trainer.init(torch.Generator(device=ctx.device).manual_seed(ctx.seed + 1), seed=ctx.seed)
    init_field = st.w.detach().clone()
    drive.hand_weights(st.agent, st.best_actor, inputs["actor"], inputs["critic"])
    p = plan(config, wl)

    def step_draws(d):
        return StepDraws(noise=d["noise"], start=d["start"], offs=d["offs"][None], idx=d["idx"])

    st, prog = drive.run_compared(trainer.make_chunk_fn(1), st, inputs["draws"], step_draws,
                                  p["learned"], lambda s: s.w)
    prog["init_field"] = init_field
    return trainer, st, inputs, prog, None


# ------------------------------------------------------------ solver routes
def routes(solver) -> dict:
    """Captures and steps launched op by op so far: the program's counters,
    or for a program without them its solver's count of graphs."""
    from distributedconvrl_pde_control_torch.ops import keller_segel

    counters = getattr(keller_segel, "KELLER_SEGEL_STEPS", None)
    if counters is None:
        return {"captures": len(solver.graphs), "eager_steps": 0}
    return {"captures": counters.captures, "eager_steps": counters.eager_steps}


def setup(ctx):
    state = drive.train_setup(ctx, *build(ctx), sparse=train_fluid._sparse(ctx.cell.workload))
    # the window starts from the card's steady state (module docstring)
    drive.train_window(state, seconds=ctx.cell.workload["warmup_seconds"])
    state.solver = state.trainer.solver
    state.routes_before = routes(state.solver)
    state.window_steps = 0
    return state


def window(state, seconds=None, chunks=None) -> dict:
    res = drive.train_window(state, seconds, chunks)
    state.window_steps += res["steps"]
    return res


def graph_share(state) -> float:
    """Share of the window's solver calls served op by op or by a capture."""
    after = routes(state.solver)
    odd = sum(after[k] - state.routes_before[k] for k in after)
    return odd / max(state.window_steps, 1)


def shape(state) -> dict:
    config, wl = state.ctx.cell.config, state.ctx.cell.workload
    ns = obs_dim(config)
    return {"family": "keller_segel", "rows": wl["n_envs"], "nx": config["nx"],
            "substeps": config["oversampling"], "n_actuators": N_ACT,
            "n_sensors": len(ref_ksg.rectangles(config)),
            "actor": nets.chain_sizes(ns, 1, 10.0, config["nna_scale"]),
            "critic": nets.chain_sizes(ns + 1, 1, 20.0, config["nna_scale_critic"]),
            "batch": wl["learner_batch"], "updates": wl["update_loops"]}


def kernel_names() -> dict:
    return {}


def loss_gap(prog: dict, ref: dict) -> float:
    """Worst update of the critic loss gap over max(L, sqrt(L) mean |Q(s,
    a)|) and the actor loss gap over max(|actor loss|, mean |Q(s,
    actor(s))|), the reference's (module docstring)."""
    gaps = []
    for (pc, pa), (rc, ra), (q_sa, q_pol) in zip(prog["losses"], ref["losses"], ref["q_scale"]):
        gaps += [abs(pc - rc) / max(rc, math.sqrt(rc) * q_sa, 1e-30),
                 abs(pa - ra) / max(abs(ra), q_pol, 1e-30)]
    return max(gaps)


def gaps(prog: dict, ref: dict) -> dict:
    """`compare.train_gaps` with the scaled `loss`."""
    return {**compare.train_gaps(prog, ref), "loss": loss_gap(prog, ref)}


def check(state) -> dict:
    graph = graph_share(state)
    state.solver = None
    ref = {}

    def kept(config, workload, inputs):
        ref.update(reference(config, workload, inputs))
        return ref

    drive.train_check(state, kept)
    return {**gaps(state.prog, ref), "graph": graph}
