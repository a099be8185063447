"""Driver of the KS batched-training cells: `run.py KS22 --train --batched`
as the port's CLI runs it (`train/batched.py::BatchedTrainer` on the
configuration's CNAB2 env, K1 once per step, a pool of fresh fields for the
in-step resets, one DDPG update per step), chunks back to back.

The benchmark makes the networks, the pool and the first fields from the
seed and hands the same to the program and to the reference; the program's
generator (seeded from the seed) makes the window's draws. The compared
steps run through a chunk function of one step of the same trainer object,
which then goes on into the window.
"""

from __future__ import annotations

import torch

from benchmark import drive, tracing
from benchmark.reference import ks as ref_ks
from benchmark.reference import nets


def reference_config(config: dict, workload: dict) -> dict:
    ns = config["window_size"] * config["temporal_steps"] + config["memory_size"]
    return {**config, "n_envs": workload["n_envs"],
            "agent": drive.agent_dict(config, ns, config["capacity"])}


def plan(config: dict, workload: dict) -> dict:
    """The compared steps: up to the third update after the learn gate."""
    push = workload["n_envs"] * config["n_actuators"]
    first = drive.first_learn_step(push, config["capacity"], config["update_after"],
                                   config["n_actuators"])
    n = first + workload["compared_updates"] - 1
    return {"steps": n, "learned": [k >= first for k in range(1, n + 1)], "push": push}


def make_inputs(config: dict, workload: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    ns = config["window_size"] * config["temporal_steps"] + config["memory_size"]
    actor, critic = drive.networks(gen, ns, config, device)
    pool = ref_ks.random_fields(config, gen, workload["pool_size"])
    b = workload["n_envs"]
    p = plan(config, workload)
    return {"actor": actor, "critic": critic, "pool": pool,
            "init_idx": torch.randint(0, pool.shape[0], (b,), generator=gen, device=device),
            "draws": drive.compared_draws(gen, p["steps"], b * config["n_actuators"],
                                          workload["learner_batch"], p["push"], config["capacity"],
                                          pool.shape[0], b)}


def reference(config: dict, workload: dict, inputs: dict, precision: str = "float32",
              fault: str | None = None) -> dict:
    if inputs["pool"].is_cuda:
        nets.ieee_matmuls()
    return ref_ks.train_steps(reference_config(config, workload), inputs,
                              plan(config, workload)["steps"], precision, fault)


def build(ctx):
    """The program's trainer and state, the benchmark's inputs handed in,
    and the compared steps run."""
    from distributedconvrl_pde_control_torch.configs.ks import KSConfig, KSSolver, build_ks
    from distributedconvrl_pde_control_torch.train.batched import (
        BatchedTrainer,
        BatchedTrainerConfig,
        StepDraws,
    )

    config, wl = ctx.cell.config, ctx.cell.workload
    restore = tracing.wrap_entry(KSSolver, "step", "ks_step") if ctx.trace else None
    pcfg = drive.program_config(KSConfig, config)
    setup = build_ks(pcfg, device=ctx.device)
    inputs = make_inputs(config, wl, ctx.seed, ctx.device)
    trainer = BatchedTrainer(setup.env, setup.agent,
                             BatchedTrainerConfig(n_envs=wl["n_envs"], batch_size=wl["learner_batch"],
                                                  update_loops=wl["update_loops"],
                                                  min_best_episode=pcfg.min_best_episode),
                             y0_pool=inputs["pool"])
    ts = trainer.init(torch.Generator(device=ctx.device).manual_seed(ctx.seed + 1),
                      idx=inputs["init_idx"])
    drive.hand_weights(ts.agent, ts.best_actor, inputs["actor"], inputs["critic"])
    p = plan(config, wl)

    def step_draws(d):
        return StepDraws(noise=d["noise"], start=d["start"], offs=d["offs"][None], idx=d["idx"])

    ts, prog = drive.run_compared(trainer.make_chunk_fn(1), ts, inputs["draws"], step_draws,
                                  p["learned"], lambda s: s.env_states.y)
    return trainer, ts, inputs, prog, restore


def setup(ctx):
    return drive.train_setup(ctx, *build(ctx), sparse=False)


window = drive.train_window


def shape(state) -> dict:
    config, wl = state.ctx.cell.config, state.ctx.cell.workload
    ns = config["window_size"] * config["temporal_steps"] + config["memory_size"]
    return {"family": "ks", "rows": wl["n_envs"], "nx": config["nx"],
            "oversampling": config["oversampling"], "n_actuators": config["n_actuators"],
            "actor": nets.chain_sizes(ns, 1, 10.0, config["nna_scale"]),
            "critic": nets.chain_sizes(ns + 1, 1, 20.0, config["nna_scale_critic"]),
            "batch": wl["learner_batch"], "updates": wl["update_loops"], "range": "ks_step"}


def kernel_names() -> dict:
    return {"ks_step": ["ks_cnab2"]}


def check(state) -> dict:
    return drive.train_check(state, reference)
