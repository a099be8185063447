"""What the train drivers share: the compared first steps through the
program's own chunk function, the measured window of chunks, and the
weights and draws the benchmark hands to both the program and the
reference."""

from __future__ import annotations

import dataclasses
import gc
import time
import types

import numpy as np
import torch

from benchmark.reference import nets


def program_config(cls, config: dict):
    """The program's configuration dataclass from the configuration file,
    field by field."""
    return cls(**{f.name: config[f.name] for f in dataclasses.fields(cls)})


def leaves_of(chain) -> list:
    """A program chain's leaves in the reference's order (w0, b0, w1, ...)."""
    return [t for w, b in zip(chain.w, chain.b) for t in (w, b)]


@torch.no_grad()
def load_chain(chain, src) -> None:
    """Copy the benchmark's [[w, b], ...] into a program chain, in place."""
    for w, b, (sw, sb) in zip(chain.w, chain.b, src):
        w.copy_(sw)
        b.copy_(sb)


def hand_weights(agent_state, best_actor, actor, critic) -> None:
    """The benchmark's networks into the program's behaviour, target and
    best-actor chains (the optimizers hold no state yet)."""
    for chain, src in ((agent_state.actor, actor), (agent_state.target_actor, actor),
                       (best_actor, actor), (agent_state.critic, critic),
                       (agent_state.target_critic, critic)):
        load_chain(chain, src)


def first_learn_step(push: int, capacity: int, update_after: int, n_act: int) -> int:
    """The first step (1-based) after whose push the replay holds more than
    update_after * n_act rows: the learn gate of both trainers."""
    cap = (capacity + push - 1) // push * push
    k = 1
    while min(k * push, cap) <= update_after * n_act:
        k += 1
    return k


def compared_draws(gen: torch.Generator, n_steps: int, n_cols: int, batch: int, push: int,
                   capacity: int, pool: int, n_envs: int) -> list[dict]:
    """Draws of the compared steps: start-policy actions uniform in [-1, 1]
    (so that the forcing acts from the first step), exploration noise,
    replay offsets without repeats (every sampled row differs) and reset
    rows."""
    cap = (capacity + push - 1) // push * push
    out = []
    for k in range(1, n_steps + 1):
        size = min(k * push, cap)
        out.append({
            "start": torch.rand((1, n_cols), generator=gen, device=gen.device) * 2.0 - 1.0,
            "noise": torch.randn((1, n_cols), generator=gen, device=gen.device),
            "offs": torch.randperm(size, generator=gen, device=gen.device)[:batch],
            "idx": torch.randint(0, pool, (n_envs,), generator=gen, device=gen.device),
        })
    return out


def networks(gen: torch.Generator, ns: int, cfg: dict, device) -> tuple:
    """The actor and critic of a preset, glorot-uniform from `gen`."""
    actor = nets.glorot_chain(gen, nets.chain_sizes(ns, 1, 10.0, cfg["nna_scale"]), device)
    critic = nets.glorot_chain(gen, nets.chain_sizes(ns + 1, 1, 20.0, cfg["nna_scale_critic"]),
                               device)
    return actor, critic


def agent_dict(cfg: dict, ns: int, capacity: int) -> dict:
    keys = ("learning_rate", "learning_rate_critic", "gamma", "polyak", "act_noise",
            "start_steps", "update_after")
    return {**{k: cfg[k] for k in keys}, "ns": ns, "capacity": capacity}


def run_compared(chunk1, st, draws: list, step_draws, learned: list[bool], field_of) -> tuple:
    """The compared steps through the program's chunk function of one step
    (the window's code path): per step the mean reward from its record,
    after each update the losses, after the first the gradients as Adam got
    them (its first moment over 1 - b1), and the leaves before and after."""
    from distributedconvrl_pde_control_torch.train.hooks import REC_MEAN_REWARD

    agent = st.agent
    params = leaves_of(agent.actor) + leaves_of(agent.critic)
    out = {"mean_reward": [], "losses": [], "grads": None,
           "before": [p.detach().clone() for p in params]}
    for d, learns in zip(draws, learned):
        st, packed = chunk1(st, [step_draws(d)])
        out["mean_reward"].append(float(packed[REC_MEAN_REWARD, 0, 0]))
        if learns:
            out["losses"].append((float(agent.critic_loss), float(agent.actor_loss)))
            if out["grads"] is None:
                # an optimizer that holds no state for a leaf got no gradient
                state = {**agent.opt_actor.state, **agent.opt_critic.state}
                out["grads"] = [state[p]["exp_avg"].detach().clone() / (1.0 - 0.9)
                                if p in state else torch.zeros_like(p) for p in params]
    out["after"] = [p.detach().clone() for p in params]
    out["field"] = field_of(st).detach().clone()
    return st, out


def run_window(chunk, st, n_envs: int, chunk_len: int, depth: int, sparse: bool, hook,
               seconds: float | None = None, chunks: int | None = None) -> tuple:
    """Chunks back to back for `seconds` (or `chunks` of them), each
    chunk's records read as the port's drivers read them: the copy started
    at dispatch, consumed `depth` chunks later, fed to the hook; the window
    ends when the last records are consumed and the device has finished."""
    from distributedconvrl_pde_control_torch.train.records import (
        consume_record_read,
        start_record_read,
    )

    pending, n, failed, marks = [], 0, 0, []

    def consume(handle):
        rec = consume_record_read(handle)
        hook.feed_episode_records(rec)
        return int(not np.isfinite(rec["mean_reward"]).all())

    t0 = time.perf_counter()
    while True:
        st, packed = chunk(st)
        pending.append(start_record_read(packed, sparse))
        if len(pending) > depth:
            failed += consume(pending.pop(0))
        n += 1
        marks.append(time.perf_counter())
        if (n >= chunks) if chunks is not None else (time.perf_counter() - t0 >= seconds):
            break
    for handle in pending:
        failed += consume(handle)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = n * chunk_len
    gaps = np.diff([t0] + marks)
    return st, {"work": steps * n_envs, "seconds": dt, "steps": steps, "attempted": steps,
                "failed": failed * chunk_len,
                "pace": f"chunk dispatch s: min {float(gaps.min())!r} median {float(np.median(gaps))!r} "
                        f"max {float(gaps.max())!r}; halves {float(gaps[:len(gaps) // 2].sum())!r} "
                        f"{float(gaps[len(gaps) // 2:].sum())!r}"}


def train_setup(ctx, trainer, st, inputs, prog, restore, sparse: bool):
    """The state a train cell's window starts from: the trainer object that
    ran the compared steps, its chunk function of the window's length, and
    one chunk of it run as the warm-up of every shape the window uses."""
    from distributedconvrl_pde_control_torch.train.hooks import PDEHook

    wl = ctx.cell.workload
    chunk = trainer.make_chunk_fn(wl["chunk_len"])
    hook = PDEHook(min_best_episode=trainer.cfg.min_best_episode, collect_best_trace=False)
    state = types.SimpleNamespace(ctx=ctx, trainer=trainer, st=st, chunk=chunk, hook=hook,
                                  inputs=inputs, prog=prog, restore=restore, sparse=sparse)
    train_window(state, chunks=1)
    return state


def train_window(state, seconds=None, chunks=None) -> dict:
    wl = state.ctx.cell.workload
    state.st, res = run_window(state.chunk, state.st, wl["n_envs"], wl["chunk_len"],
                               wl["pipeline_depth"], state.sparse, state.hook, seconds, chunks)
    return res


def train_check(state, reference) -> dict:
    """Free the program's state, run the reference on the inputs it was
    handed, return the gaps."""
    from benchmark import compare

    cell = state.ctx.cell
    state.trainer = state.st = state.chunk = None
    if state.restore is not None:
        state.restore()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return compare.train_gaps(state.prog, reference(cell.config, cell.workload, state.inputs))
