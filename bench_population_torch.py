#!/usr/bin/env python3
"""Population scaling in the port: bench_population.py's measurement on one GPU.

    python3 bench_population_torch.py [--chunks 5] [--chunk-len 50] [--cpu]

P members x B envs as one fused program (`train/population.py`) against the
standalone single-member rate (`train/batched.py`): the study speedup is the
aggregate rate over the solo rate, since a serial multi-seed study advances
one member at the solo rate and the population advances all P at once. The
configuration of bench_population.py: KS22 on ETDRK4 with the `matmul_hi`
tier, `nl_fft_mode="matmul_fast"` and the spectral carry, one update per
step, initial fields drawn from a pool of 32 `random_init` fields made once
on the device. Two regimes, with the JAX script's learner batches:

  * B = 256 (batch 256), P = 8: the recipe's scale (the lh training recipe
    trains at 256 envs), where one member underfills the card;
  * B = 2048 (batch 1024), P = 2, 4 and 8: members large enough that P = 8
    is 16384 envs.

Then the P = 8 x 2048 population with per-member learning rates given
(`lr_actor`, `lr_critic`: the JAX script's traced rates; the port's stacked
Adam always takes a (P,) rate, so this line runs the same program with
explicit rates). Each line times `--chunks` chunks of `--chunk-len` train
steps after one warm-up chunk and prints the JAX script's label and format;
then one JSON line with every rate, every speedup, the card's name and power
limit as nvidia-smi gives them. It needs a CUDA device and exits non-zero
without one; `--cpu` runs the same lines on the CPU (with `--scale` dividing
every env count), a rehearsal whose numbers are CPU times.
"""

import argparse
import dataclasses
import json
import sys
import time

REGIMES = ((256, 256, (8,)), (2048, 1024, (2, 4, 8)))  # (B, learner batch, members)
TIER = dict(fft_mode="matmul_hi", stepper="etdrk4", nl_fft_mode="matmul_fast",
            spectral_carry=True)
POOL = 32


def run(chunks: int, chunk_len: int, device: str, scale: int = 1) -> dict:
    """Every line; returns {"rates": {label: env-steps/s}, "speedups": {...}}."""
    import numpy as np
    import torch

    from distributedconvrl_pde_control_torch.configs.ks import KS22, build_ks
    from distributedconvrl_pde_control_torch.train.batched import BatchedTrainer, BatchedTrainerConfig
    from distributedconvrl_pde_control_torch.train.population import PopulationTrainer

    setup = build_ks(dataclasses.replace(KS22, **TIER), device=device)
    pool = setup.random_init(torch.Generator(device=device).manual_seed(99), POOL)
    rates, speedups = {}, {}

    def timed(label: str, trainer, n_total_envs: int) -> float:
        ts = trainer.init(torch.Generator(device=device).manual_seed(0))
        chunk = trainer.make_chunk_fn(chunk_len)
        ts, _ = chunk(ts)
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(chunks):
            ts, _ = chunk(ts)
        if device == "cuda":
            torch.cuda.synchronize()
        rate = chunks * chunk_len * n_total_envs / (time.perf_counter() - t0)
        rates[label.strip()] = rate
        print(f"{label}: {rate / 1e6:7.2f}M env steps/s", flush=True)
        return rate

    for b, batch, members in REGIMES:
        b //= scale
        tcfg = BatchedTrainerConfig(n_envs=b, batch_size=batch // scale, update_loops=1)
        solo = BatchedTrainer(setup.env, setup.agent, tcfg, y0_pool=pool)
        r_solo = timed(f"B={b}: solo member          ", solo, b)
        for p in members:
            pop = PopulationTrainer(setup.env, setup.agent, tcfg, n_members=p, y0_pool=pool)
            r = timed(f"B={b}: population P={p}       ", pop, p * b)
            speedups[f"B={b} P={p}"] = r / r_solo
            print(f"  -> study speedup over {p} serial runs: {r / r_solo:.2f}x (ideal {p}.0x)",
                  flush=True)

    b = 2048 // scale
    tcfg = BatchedTrainerConfig(n_envs=b, batch_size=1024 // scale, update_loops=1)
    pop_lr = PopulationTrainer(setup.env, setup.agent, tcfg, n_members=8, y0_pool=pool,
                               lr_actor=np.full(8, 5e-4, np.float32),
                               lr_critic=np.full(8, 1e-3, np.float32))
    timed(f"B={b}: population P=8 + traced lrs", pop_lr, 8 * b)
    return {"rates": rates, "speedups": speedups}


def main(argv=None) -> int:
    import torch

    from bench_torch import card

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chunks", type=int, default=5, help="timed chunks per line")
    parser.add_argument("--chunk-len", type=int, default=50)
    parser.add_argument("--cpu", action="store_true", help="a rehearsal on the CPU (CPU times)")
    parser.add_argument("--scale", type=int, default=1,
                        help="with --cpu: divide every env count and learner batch by this")
    args = parser.parse_args(argv)
    if args.scale != 1 and not args.cpu:
        parser.error("--scale is for a --cpu rehearsal: on the card the regimes run at full width")
    if args.cpu:
        device, name, power = "cpu", "cpu", None
    elif not torch.cuda.is_available():
        print("bench_population_torch: no CUDA device (--cpu rehearses on the CPU)",
              file=sys.stderr)
        return 1
    else:
        device, (name, power) = "cuda", card()
        print(f"{name}, {power}", flush=True)
    got = run(args.chunks, args.chunk_len, device, args.scale)
    print(json.dumps({"bench": "bench_population_torch", "env_steps_per_s": got["rates"],
                      "study_speedup": got["speedups"], "chunks": args.chunks,
                      "chunk_len": args.chunk_len, "scale": args.scale, "device": name,
                      "power_limit": power}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
