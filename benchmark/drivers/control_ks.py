"""Driver of the KS closed-loop control cells: one env, one control step
after another as a deployed controller runs them (`run.py --eval --serve`,
`--live`): the agent's deterministic actor on the observation, the env's
step (`envs/pde_env.py::PDEEnv.step`, K1 at one row), and the action, the
reward and the end-of-episode flag read to the host in one copy. Steps run
back to back, not paced at the control interval. An episode lasts
`episode_steps` steps (the paper's evaluation horizon) unless the field
blows up; the next one starts from a field of a pool drawn from the seed.

The check follows the program step by step from its own state: at steps
drawn from the seed (an offset, then every `sample_stride`-th step) the
field, observation and previous action before the step are kept with the
action, reward and field it produced, and the reference recomputes those
from the kept state. The first `start_steps` steps from the first reset are
compared with the reference run from the same field on its own.
"""

from __future__ import annotations

import dataclasses
import gc
import time
import types

import torch

from benchmark import compare, drive, tracing
from benchmark.reference import ks as ref_ks
from benchmark.reference import nets


def make_inputs(config: dict, workload: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    ns = config["window_size"] * config["temporal_steps"] + config["memory_size"]
    actor, _ = drive.networks(gen, ns, config, device)
    pool = ref_ks.random_fields(config, gen, workload["pool_size"])
    resets = torch.randint(0, pool.shape[0], (workload["reset_draws"],), generator=gen,
                           device=device).tolist()
    offset = int(torch.randint(0, workload["sample_stride"], (1,), generator=gen, device=device))
    return {"actor": actor, "pool": pool, "resets": resets, "offset": offset}


def setup(ctx):
    from distributedconvrl_pde_control_torch.configs.ks import KSConfig, KSSolver, build_ks

    config, wl = ctx.cell.config, ctx.cell.workload
    restore = tracing.wrap_entry(KSSolver, "step", "ks_step") if ctx.trace else None
    setup_ = build_ks(drive.program_config(KSConfig, config), device=ctx.device)
    env = setup_.env
    env = dataclasses.replace(env, te=env.t0 + wl["episode_steps"] * env.dt)
    agent = setup_.agent
    inputs = make_inputs(config, wl, ctx.seed, ctx.device)
    astate = agent.init_state(torch.Generator(device=ctx.device).manual_seed(ctx.seed + 1),
                              ctx.device)
    drive.load_chain(astate.actor, inputs["actor"])
    acfg = agent.cfg

    @torch.no_grad()
    def control_step(st):
        obs = st.obs.permute(1, 0, 2).reshape(acfg.ns, acfg.n_actuators)
        a = agent.act(astate, obs, learning=False)
        action = a.reshape(acfg.na_rows, 1, acfg.n_actuators).permute(1, 0, 2)
        new = env.step(st, action)
        host = torch.cat([action.flatten(), new.reward.flatten(), new.done.to(torch.float32)]).cpu()
        return new, action, host

    state = types.SimpleNamespace(ctx=ctx, env=env, step=control_step, inputs=inputs,
                                  restore=restore, n_resets=0, samples=[], k=0)
    state.st = _reset(state)
    start = {"action": [], "reward": [], "y": []}
    for _ in range(wl["start_steps"]):
        new, action, host = control_step(state.st)
        if bool(host[-1] > 0.5):
            break
        start["action"].append(action.clone())
        start["reward"].append(new.reward.clone())
        start["y"].append(new.y.clone())
        state.st = new
    state.prog_start = start
    state.y0 = inputs["pool"][inputs["resets"][0]][None]
    state.st = _reset(state)  # the window starts from a reset, as a deployment does
    state.st, *_ = control_step(state.st)  # warm-up of the reset's shapes
    return state


def _reset(state):
    inputs = state.inputs
    row = inputs["resets"][state.n_resets % len(inputs["resets"])]
    state.n_resets += 1
    return state.env.reset(inputs["pool"][row][None])


def window(state, seconds=None, chunks=None) -> dict:
    wl = state.ctx.cell.workload
    stride, offset = wl["sample_stride"], state.inputs["offset"]
    n = failed = 0
    t0 = time.perf_counter()
    while True:
        st = state.st
        sample = (state.k + offset) % stride == 0
        if sample:
            before = {"y": st.y.clone(), "obs": st.obs.clone(), "prev_action": st.action.clone()}
        new, action, host = state.step(st)
        failed += int(not bool(torch.isfinite(host).all()))
        if sample:
            state.samples.append({**before, "action": action.clone(),
                                  "reward": new.reward.clone(), "y_next": new.y.clone()})
        state.st = _reset(state) if bool(host[-1] > 0.5) else new
        state.k += 1
        n += 1
        if (n >= chunks) if chunks is not None else (time.perf_counter() - t0 >= seconds):
            break
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {"work": n, "seconds": time.perf_counter() - t0, "steps": n, "attempted": n,
            "failed": failed}


def shape(state) -> dict:
    config = state.ctx.cell.config
    ns = config["window_size"] * config["temporal_steps"] + config["memory_size"]
    return {"family": "ks", "rows": 1, "nx": config["nx"], "oversampling": config["oversampling"],
            "n_actuators": config["n_actuators"],
            "actor": nets.chain_sizes(ns, 1, 10.0, config["nna_scale"]),
            "critic": nets.chain_sizes(ns + 1, 1, 20.0, config["nna_scale_critic"]),
            "updates": 0, "range": "ks_step"}


def kernel_names() -> dict:
    return {"ks_step": ["ks_cnab2"]}


def reference(config: dict, inputs: dict, samples: list, y0, n_start: int,
              precision: str = "float32") -> tuple:
    if inputs["pool"].is_cuda:
        nets.ieee_matmuls()
    steps = ref_ks.control_steps(config, inputs["actor"], samples, precision)
    start = ref_ks.control_start(config, inputs["actor"], y0, n_start, precision)
    return steps, start


def check(state) -> dict:
    config = state.ctx.cell.config
    if not state.samples:
        raise RuntimeError("the window sampled no control step")
    state.st = state.step = state.env = None
    if state.restore is not None:
        state.restore()
    gc.collect()
    steps, start = reference(config, state.inputs, state.samples, state.y0,
                             len(state.prog_start["action"]))
    prog_steps = [{"action": s["action"], "reward": s["reward"], "y": s["y_next"]}
                  for s in state.samples]
    return compare.control_gaps(prog_steps, steps, state.prog_start, start)
