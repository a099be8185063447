#!/usr/bin/env python3
"""Benchmark of the PyTorch port: batched KS rollout+train throughput on one GPU.

    python3 bench_torch.py [--tier sf|tp]

The unit `bench.py` measures for the JAX package, in the port: per train step
the KS22 physics on the reference's 192-point grid (ETDRK4 on the carried
half-spectrum, featurize, reward and blow-up guard by Parseval on the carry),
the shared-policy forward over all 16384*8 actuator columns, exploration
noise, 131072 replay pushes and one DDPG update at batch 4096. `--tier tp`
runs `bench.py`'s exact configuration: the transforms at its bf16 tiers
(`matmul_hi`, and `matmul_fast` in the nonlinear term; with the spectral
carry and featurize, all eight transforms of a step are nonlinear ones).
The default, `--tier sf`, runs the same with float32 `torch.fft`, so that
the two can be compared. Initial fields come from `ks_random_init`, drawn on
the card.

One warm-up chunk of 50 steps, then the best of 3 rounds of 5 chunks queued
back to back with one `synchronize` at the end of each round. Prints one JSON
line: `metric`, `value`, `unit`, `tier`, and the card's `device` and
`power_limit` as nvidia-smi gives them. It needs a CUDA device and exits
non-zero without one.

One attempt, bounded by a hard deadline (`utils/resilience.py`;
`BENCH_DEADLINE_S`, default 1020 s). When the attempt fails or the deadline
passes, the one JSON line carries `value` 0.0 and an `error` field, and the
exit status is non-zero.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

N_ENVS = 16384
CHUNK = 50
TIMED_ROUNDS = 5
REPEATS = 3
LEARNER_BATCH = 4096
METRIC = "env steps/sec (batched KS rollout+train)"
SF = dict(stepper="etdrk4", spectral_carry=True, spectral_featurize=True)
TIERS = {"sf": SF, "tp": dict(SF, fft_mode="matmul_hi", nl_fft_mode="matmul_fast")}


def run_once(tier: str = "sf") -> float:
    """Build, warm up and measure: env-steps/s, the best of REPEATS rounds of
    TIMED_ROUNDS chunks each, at the transform tier `tier` (a key of TIERS)."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("bench_torch needs a CUDA device")
    from distributedconvrl_pde_control_torch.configs.ks import KS22, build_ks
    from distributedconvrl_pde_control_torch.train.batched import BatchedTrainer, BatchedTrainerConfig

    setup = build_ks(dataclasses.replace(KS22, **TIERS[tier]), device="cuda")
    trainer = BatchedTrainer(setup.env, setup.agent,
                             BatchedTrainerConfig(n_envs=N_ENVS, batch_size=LEARNER_BATCH, update_loops=1),
                             random_init=setup.random_init)
    ts = trainer.init(torch.Generator(device="cuda").manual_seed(0))
    chunk_fn = trainer.make_chunk_fn(CHUNK)
    ts, recs = chunk_fn(ts)  # warm-up: cuFFT plans, allocator, past the learn gate
    torch.cuda.synchronize()
    best_rate = 0.0
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(TIMED_ROUNDS):
            ts, recs = chunk_fn(ts)
        torch.cuda.synchronize()
        best_rate = max(best_rate, TIMED_ROUNDS * CHUNK * N_ENVS / (time.perf_counter() - t0))
    if not bool(torch.isfinite(recs).all()):
        raise RuntimeError("bench_torch: the last chunk's records are not finite")
    return best_rate


def card() -> tuple:
    """(name, power limit) of the card as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    name, power = (x.strip() for x in smi.stdout.strip().splitlines()[0].split(","))
    return name, power


def main(argv=None) -> int:
    import torch

    from distributedconvrl_pde_control_torch.utils.resilience import arm_hard_deadline

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tier", choices=sorted(TIERS), default="sf",
                        help="sf: float32 torch.fft; tp: bench.py's bf16 transform tiers")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device", file=sys.stderr)
        return 1
    name, power = card()
    line = {"metric": METRIC, "value": 0.0, "unit": "env_steps/s", "tier": args.tier,
            "device": name, "power_limit": power}
    deadline_s = float(os.environ.get("BENCH_DEADLINE_S", "1020"))
    deadline = arm_hard_deadline(deadline_s, lambda: print(json.dumps(
        {**line, "error": f"TimeoutError: bench exceeded the {deadline_s:.0f}s hard deadline"})))
    try:
        rate = run_once(args.tier)
    except Exception as e:
        deadline.cancel()
        print(json.dumps({**line, "error": f"{type(e).__name__}: {e}"[:500]}))
        return 1
    deadline.cancel()
    print(json.dumps({**line, "value": round(rate, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
