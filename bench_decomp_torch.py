#!/usr/bin/env python3
"""Where bench_torch.py's step time goes: bench_decomp.py's decomposition, in the port.

    python3 bench_decomp_torch.py [--n-envs 16384] [--chunks 5] [--chunk-len 50]
                                  [--driver-chunks 10] [--cpu]

The configuration of bench_decomp.py: KS22 on ETDRK4 with the `matmul_hi`
transform tier and `nl_fft_mode="matmul_fast"`, 16384 envs, learner batch
4096, one update per step, initial fields from `ks_random_init`. Each line
times `--chunks` chunks of `--chunk-len` train steps after one warm-up chunk
and prints the JAX script's label with the rate, in its format:

  * full (rollout+push+learn), and rollout+push (learn=False);
  * the flat carried layouts: the port's trainer has one, the flat (ns,
    B*n_act) observation view it always carries, and no carried action, so
    those two lines say so and carry no number;
  * spectral carry, then spectral carry+featurize (configs/ks.py);
  * solver+policy only: a loop of env steps with a fixed actor (a fresh
    agent state, in its warm-up phase as the JAX script's is), written
    against the port's env and agent (the JAX script's hand-written scan);
  * no reset regeneration (the fresh states of auto-reset made once and
    reused) and no replay push (learn=False), by replacing
    `BatchedTrainer._fresh_states` and `train.batched.replay_push_flat` for
    the line, as the JAX script does;
  * the driver in the loop: the chunk's records read back `train_batched`'s
    way (up to 4 chunks queued before chunk n's records are read and fed to
    the hook), the dense plane and the sparse reader.

Then one JSON line: every rate by label, the card's name and power limit as
nvidia-smi gives them, and the settings. It needs a CUDA device and exits
non-zero without one; `--cpu` runs the same lines on the CPU at whatever
size is given, a rehearsal whose numbers are CPU times.
"""

import argparse
import dataclasses
import json
import sys
import time

N_ENVS = 16384
LEARNER_BATCH = 4096
TIER = dict(fft_mode="matmul_hi", stepper="etdrk4", nl_fft_mode="matmul_fast")
FLAT_LAYOUTS = ("flat obs carry            ", "flat obs+action carry     ")


def run(n_envs: int, chunks: int, chunk_len: int, driver_chunks: int, device: str) -> dict:
    """Every line of the decomposition; returns {label: env-steps/s}."""
    import torch

    import distributedconvrl_pde_control_torch.train.batched as B
    from distributedconvrl_pde_control_torch.configs.ks import KS22, build_ks, ks_random_init
    from distributedconvrl_pde_control_torch.envs.pde_env import index_state
    from distributedconvrl_pde_control_torch.train.batched import BatchedTrainer, BatchedTrainerConfig
    from distributedconvrl_pde_control_torch.train.hooks import PDEHook
    from distributedconvrl_pde_control_torch.train.records import (
        consume_record_read,
        start_record_read,
    )

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    rates = {}

    def report(label: str, rate: float) -> None:
        rates[label.strip()] = rate
        print(f"{label}: {rate / 1e6:7.2f}M env steps/s", flush=True)

    cfg = BatchedTrainerConfig(n_envs=n_envs, batch_size=LEARNER_BATCH, update_loops=1)
    init = ks_random_init(KS22, device)

    def trainer_of(**over) -> BatchedTrainer:
        s = build_ks(dataclasses.replace(KS22, **TIER, **over), device=device)
        return BatchedTrainer(s.env, s.agent, cfg, random_init=init)

    def timed(label: str, trainer: BatchedTrainer, learn: bool) -> None:
        ts = trainer.init(torch.Generator(device=device).manual_seed(1))
        chunk = trainer.make_chunk_fn(chunk_len, learn=learn)
        ts, _ = chunk(ts)
        sync()
        t0 = time.perf_counter()
        for _ in range(chunks):
            ts, _ = chunk(ts)
        sync()
        report(label, chunks * chunk_len * n_envs / (time.perf_counter() - t0))

    trainer = trainer_of()
    timed("full (rollout+push+learn)", trainer, learn=True)
    timed("rollout+push (learn=False)", trainer, learn=False)
    for label in FLAT_LAYOUTS:
        print(f"{label}: no twin (the port's trainer carries the flat obs view and no action: "
              f"the full line's layout)", flush=True)
    timed("spectral carry            ", trainer_of(spectral_carry=True), learn=True)
    timed("spectral carry+featurize  ", trainer_of(spectral_carry=True, spectral_featurize=True),
          learn=True)

    # solver+policy only: env steps with a fixed actor from a fresh agent state, whose
    # `act(learning=True)` is in its warm-up phase, as the JAX script's
    env, agent = trainer.env, trainer.agent
    acfg = agent.cfg
    gen = torch.Generator(device=device).manual_seed(3)
    astate = agent.init_state(torch.Generator(device=device).manual_seed(0), device)
    est = env.reset(env.y0.expand(n_envs, -1).contiguous())

    def roll(est):
        for _ in range(chunk_len):
            obs_flat = est.obs.permute(1, 0, 2).reshape(acfg.ns, n_envs * acfg.n_actuators)
            a_flat = agent.act(astate, obs_flat, gen, learning=True)
            est = env.step(est, a_flat.reshape(acfg.na_rows, n_envs, acfg.n_actuators)
                           .permute(1, 0, 2))
        return est

    with torch.no_grad():
        est = roll(est)
        sync()
        t0 = time.perf_counter()
        for _ in range(chunks):
            est = roll(est)
        sync()
    report("solver+policy only        ", chunks * chunk_len * n_envs / (time.perf_counter() - t0))

    # (a) constant reset states: auto-reset still selects, but the fresh states are one
    # state repeated, made once, instead of regenerated every step
    with torch.no_grad():
        st0 = trainer.env.reset(trainer._fresh_y0s(torch.Generator(device=device).manual_seed(9), 8))
        const_states = index_state(st0, torch.zeros(n_envs, dtype=torch.long, device=device))
    orig_fresh = BatchedTrainer._fresh_states
    BatchedTrainer._fresh_states = lambda self, generator, n, y0s=None, idx=None: const_states
    try:
        timed("no reset regeneration   ", trainer, learn=True)
    finally:
        BatchedTrainer._fresh_states = orig_fresh

    # (b) the replay push skipped (learn off, so sampling never sees it)
    orig_push = B.replay_push_flat
    B.replay_push_flat = lambda buf, *a, **k: buf
    try:
        timed("no replay push (nolearn)", trainer, learn=False)
    finally:
        B.replay_push_flat = orig_push

    # (c) the driver in the loop: records read back as train_batched reads them
    def timed_driver(label: str, sparse: bool, depth: int = 4) -> None:
        ts = trainer.init(torch.Generator(device=device).manual_seed(1))
        chunk = trainer.make_chunk_fn(chunk_len)
        hook = PDEHook(collect_best_trace=False)
        ts, recs = chunk(ts)
        sync()
        pending = []
        t0 = time.perf_counter()
        for _ in range(driver_chunks):
            ts, recs = chunk(ts)
            pending.append(start_record_read(recs, sparse))
            if len(pending) > depth:
                hook.feed_episode_records(consume_record_read(pending.pop(0)))
        for h in pending:
            hook.feed_episode_records(consume_record_read(h))
        sync()
        report(label, driver_chunks * chunk_len * n_envs / (time.perf_counter() - t0))

    timed_driver("driver-in-loop dense reads", sparse=False)
    timed_driver("driver-in-loop sparse reads", sparse=True)
    return rates


def main(argv=None) -> int:
    import torch

    from bench_torch import card

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n-envs", type=int, default=N_ENVS)
    parser.add_argument("--chunks", type=int, default=5, help="timed chunks per line")
    parser.add_argument("--chunk-len", type=int, default=50)
    parser.add_argument("--driver-chunks", type=int, default=10,
                        help="timed chunks of the driver-in-loop lines")
    parser.add_argument("--cpu", action="store_true", help="a rehearsal on the CPU (CPU times)")
    args = parser.parse_args(argv)
    if args.cpu:
        device, name, power = "cpu", "cpu", None
    elif not torch.cuda.is_available():
        print("bench_decomp_torch: no CUDA device (--cpu rehearses on the CPU)", file=sys.stderr)
        return 1
    else:
        device, (name, power) = "cuda", card()
        print(f"{name}, {power}", flush=True)
    rates = run(args.n_envs, args.chunks, args.chunk_len, args.driver_chunks, device)
    print(json.dumps({"bench": "bench_decomp_torch", "env_steps_per_s": rates, "n_envs": args.n_envs,
                      "chunks": args.chunks, "chunk_len": args.chunk_len,
                      "driver_chunks": args.driver_chunks, "device": name, "power_limit": power}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
