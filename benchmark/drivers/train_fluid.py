"""Driver of the fluid training cells: `run.py Fluid_16_256 --train --mesh
1x1` as the port's CLI runs it (`parallel/multichip.py::ShardedFluidTrainer`
at 1x1 in the process, no process group: the fixed-step RK4 of the 2/3-rule
solver, K2 on every Runge-Kutta stage, a pool of fresh fields for the
in-step resets, one DDPG update per step), chunks back to back with the
records read `pipeline_depth` chunks behind, as `train_sharded` reads them.

The benchmark makes the networks and the compared steps' draws from the
seed and hands the same to the program and to the reference. The reset pool
is the program's own, made by its `init` from the seed (30 random Taylor
vortices per field); the reference makes the same fields from the seed by
its own code, and the first fields are compared too.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import drive, tracing
from benchmark.reference import fluid as ref_fluid
from benchmark.reference import nets


def grid(config: dict) -> int:
    return 256 if config["evaluation"] else config["nx"]


def reference_config(config: dict, workload: dict) -> dict:
    ns = config["window_size"] ** 2 * config["temporal_steps"] + config["memory_size"]
    return {**config, "grid_nx": grid(config), "n_envs": workload["n_envs"],
            "y0_pool_size": workload["pool_size"],
            "max_steps": int(math.ceil((config["te"] - config["t0"]) / config["dt"] - 1e-9)),
            "agent": drive.agent_dict(config, ns, workload["capacity_per_dp"])}


def n_act(config: dict) -> int:
    return config["sensors_per_axis"] ** 2


def plan(config: dict, workload: dict) -> dict:
    push = workload["n_envs"] * n_act(config)
    first = drive.first_learn_step(push, workload["capacity_per_dp"], config["update_after"],
                                   n_act(config))
    n = first + workload["compared_updates"] - 1
    return {"steps": n, "learned": [k >= first for k in range(1, n + 1)], "push": push}


def make_inputs(config: dict, workload: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    ns = config["window_size"] ** 2 * config["temporal_steps"] + config["memory_size"]
    actor, critic = drive.networks(gen, ns, config, device)
    b = workload["n_envs"]
    p = plan(config, workload)
    return {"actor": actor, "critic": critic, "seed": seed, "device": device,
            "draws": drive.compared_draws(gen, p["steps"], b * n_act(config),
                                          workload["learner_batch"], p["push"],
                                          workload["capacity_per_dp"], workload["pool_size"], b)}


def reference(config: dict, workload: dict, inputs: dict, precision: str = "float32",
              fault: str | None = None) -> dict:
    if torch.device(inputs["device"]).type == "cuda":
        nets.ieee_matmuls()
    return ref_fluid.train_steps(reference_config(config, workload), inputs,
                                 plan(config, workload)["steps"], precision, fault)


def build(ctx):
    from distributedconvrl_pde_control_torch.configs.fluid import FluidConfig
    from distributedconvrl_pde_control_torch.parallel.multichip import (
        ShardedFluidTrainer,
        ShardedTrainConfig,
    )
    from distributedconvrl_pde_control_torch.parallel.ns_sharded import NSShardedSolver
    from distributedconvrl_pde_control_torch.train.batched import StepDraws

    config, wl = ctx.cell.config, ctx.cell.workload
    restore = tracing.wrap_entry(NSShardedSolver, "step_real", "ns_step") if ctx.trace else None
    tcfg = ShardedTrainConfig(n_envs=wl["n_envs"], batch_size=wl["learner_batch"],
                              update_loops=wl["update_loops"],
                              capacity_per_dp=wl["capacity_per_dp"], y0_pool_size=wl["pool_size"],
                              chunk_len=wl["chunk_len"], pipeline_depth=wl["pipeline_depth"])
    trainer = ShardedFluidTrainer(drive.program_config(FluidConfig, config), (1, 1), tcfg, device=ctx.device)
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
    return trainer, st, inputs, prog, restore


def _sparse(wl: dict) -> bool:
    from distributedconvrl_pde_control_torch.train.records import (
        SPARSE_RECORDS_MIN_BYTES,
        record_bytes,
    )

    return record_bytes(wl["chunk_len"], wl["n_envs"]) >= SPARSE_RECORDS_MIN_BYTES


def setup(ctx):
    return drive.train_setup(ctx, *build(ctx), sparse=_sparse(ctx.cell.workload))


window = drive.train_window


def shape(state) -> dict:
    config, wl = state.ctx.cell.config, state.ctx.cell.workload
    ns = config["window_size"] ** 2 * config["temporal_steps"] + config["memory_size"]
    n = grid(config)
    return {"family": "fluid", "rows": wl["n_envs"], "n": n,
            "substeps": int(np.floor(16 * n * config["dt"])), "n_actuators": n_act(config),
            "actor": nets.chain_sizes(ns, 1, 10.0, config["nna_scale"]),
            "critic": nets.chain_sizes(ns + 1, 1, 20.0, config["nna_scale_critic"]),
            "batch": wl["learner_batch"], "updates": wl["update_loops"], "range": "ns_step"}


def kernel_names() -> dict:
    return {"ns_step": ["ns_adv"]}


def check(state) -> dict:
    return drive.train_check(state, reference)
