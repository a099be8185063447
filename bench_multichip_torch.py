#!/usr/bin/env python3
"""Multi-rank benchmark of the PyTorch port: the sharded fluid train step
over (dp, sp) meshes, and the data-parallel batched KS trainer.

The port's twin of `bench_multichip.py`. Prints one JSON line per point,
with the JAX bench's keys for its family plus `device` (the card's name, or
"cpu" on gloo ranks) and `power_limit` (nvidia-smi's, null on the CPU):

  --family fluid: {"metric": "sharded_fluid_train_step", "tier", "mesh",
      "nx", "n_envs", "oversampling", "ms_per_step", "ms_per_step_driver",
      "driver_overhead_pct", "env_steps_per_sec", "collective_ms_est",
      "collective_fraction_est", "backend", ...}: `parallel/multichip.py`'s
      chunk, FLUID_8 on the fixed-step RK4 path (K2 on every stage at sp = 1)
      or `--tier tp` (IF-RK4, bf16 transform tiers); dt is chosen so that
      floor(16 nx dt) equals --oversampling (FluidSetup.jl:47);
  --family ks-dp: {"metric": "dp_batched_ks_train_step", "mesh", "n_envs",
      "ms_per_step", "ms_per_step_driver", "driver_overhead_pct",
      "env_steps_per_sec", "backend", ...}: `parallel/batched_dp.py`'s
      `DPBatchedTrainer` on KS22 at `bench.py`'s `_tp` tier (ETDRK4,
      matmul_hi, matmul_fast in the nonlinear term).

Each mode is timed after a warm-up of one chunk, best of 2 rounds:
`chunk_only` queues chunks and synchronizes once, `driver_in_loop` reads
every chunk's records through the `train_batched` pipeline (depth 4, the
dense/sparse dispatch of `train/records.py`). `collective_ms_est` times the
transform's transpose `all_to_all` alone on the message the solver moves,
times the transforms per env step (3 + 20 x substeps); 0 at sp = 1.

    python3 bench_multichip_torch.py --meshes 1x1 --nx 256            # the card
    python3 bench_multichip_torch.py --family ks-dp --meshes 1x1 --n-envs 16384
    python3 bench_multichip_torch.py --virtual 8 --nx 64 --meshes 8x1,4x2,2x4,1x8

Without `--virtual` a mesh runs one NCCL rank per card (the card's 1x1 is an
NCCL group of one) and the bench exits 1 without a card; `--virtual N` runs
the meshes on N gloo CPU ranks, whose times are CPU times that show the
shape of the scaling, never a speed of the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time


def _timers(chunk, state_box: list, chunk_len: int, n_envs: int, sync):
    """(chunk_only, driver_in_loop, timed): the bench's two loop modes over
    `chunk(state) -> (state, records)` and their timer (per-mode warm-up, best
    of `reps`, seconds per train step)."""
    from distributedconvrl_pde_control_torch.train.hooks import PDEHook
    from distributedconvrl_pde_control_torch.train.records import (
        SPARSE_RECORDS_MIN_BYTES,
        consume_record_read,
        record_bytes,
        start_record_read,
    )

    def chunk_only(n):
        """Compute only: queue the chunks, synchronize once at the end."""
        s = state_box[0]
        done = 0
        while done < n:
            s, _ = chunk(s)
            done += chunk_len
        sync()
        state_box[0] = s

    def driver_in_loop(n):
        """The product loop: every chunk's records read on the host (the hook's
        accounting) with a depth-4 deferral, as `train_batched` reads them."""
        s = state_box[0]
        hook = PDEHook(collect_best_trace=False)
        sparse = record_bytes(chunk_len, n_envs) >= SPARSE_RECORDS_MIN_BYTES
        pending: list = []
        done = 0
        while done < n:
            s, recs = chunk(s)
            pending.append(start_record_read(recs, sparse))
            if len(pending) > 4:
                hook.feed_episode_records(consume_record_read(pending.pop(0)))
            done += chunk_len
        for handle in pending:
            hook.feed_episode_records(consume_record_read(handle))
        sync()
        state_box[0] = s

    def timed(loop_fn, n, reps=2):
        loop_fn(chunk_len)  # warm this mode's loop
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            loop_fn(n)
            best = min(best, (time.perf_counter() - t0) / n)
        return best

    return chunk_only, driver_in_loop, timed


def _sync_of(device: str):
    import torch

    return torch.cuda.synchronize if device.startswith("cuda") else (lambda: None)


def _fluid_point(mesh, nx: int, n_envs: int, oversampling: int, steps: int, chunk_len: int,
                 batch_size: int, tier: str) -> dict:
    """One fluid point on this rank of `mesh`; every rank runs the same loops."""
    import torch

    from distributedconvrl_pde_control_torch.configs.fluid import FLUID_8
    from distributedconvrl_pde_control_torch.parallel.multichip import (
        ShardedFluidTrainer,
        ShardedTrainConfig,
    )

    dp, sp = mesh.shape
    dt = (oversampling + 0.5) / (16.0 * nx)
    # adaptive=False: the fixed-step RK4 program, deterministic substeps
    cfg = dataclasses.replace(FLUID_8, nx=nx, dt=dt, te=1000.0 * dt, adaptive=False)
    if tier == "tp":
        cfg = dataclasses.replace(cfg, stepper="ifrk4", fft_mode="matmul_hi",
                                  nl_fft_mode="matmul_fast")
    assert cfg.oversampling == oversampling
    tcfg = ShardedTrainConfig(n_envs=n_envs, batch_size=batch_size, capacity_per_dp=50_000,
                              y0_pool_size=2, chunk_len=chunk_len)
    tr = ShardedFluidTrainer(cfg, mesh, tcfg, device=mesh.device)
    sync = _sync_of(mesh.device)
    state_box = [tr.init(torch.Generator(device=mesh.device).manual_seed(0))]
    chunk_only, driver_in_loop, timed = _timers(tr.make_chunk_fn(chunk_len), state_box,
                                                chunk_len, n_envs, sync)
    chunk_only(chunk_len)  # warm-up
    dt_step = timed(chunk_only, steps)
    dt_driver = timed(driver_in_loop, steps)

    # the transform's transpose alone on its message (2, Bl, n/S, n), both ways
    n_sub = cfg.fast_oversampling_eff if tier == "tp" else oversampling
    n_transforms = 3 + 20 * n_sub
    coll_ms = 0.0
    if sp > 1:
        z = torch.zeros((2, n_envs // dp, nx // sp, nx), device=mesh.device)
        mesh.all_to_all(mesh.all_to_all(z, "sp", 3, 2), "sp", 2, 3)
        sync()
        reps = 20
        t0 = time.perf_counter()
        for _ in range(reps):
            z = mesh.all_to_all(mesh.all_to_all(z, "sp", 3, 2), "sp", 2, 3)
        sync()
        coll_ms = (time.perf_counter() - t0) / reps / 2.0 * 1e3
    coll_est_ms = coll_ms * n_transforms
    step_ms = dt_step * 1e3
    return {"metric": "sharded_fluid_train_step", "tier": tier, "mesh": f"{dp}x{sp}", "nx": nx,
            "n_envs": n_envs, "oversampling": oversampling, "ms_per_step": step_ms,
            "ms_per_step_driver": dt_driver * 1e3,
            "driver_overhead_pct": (dt_driver / dt_step - 1.0) * 100.0,
            "env_steps_per_sec": n_envs / dt_step, "collective_ms_est": coll_est_ms,
            "collective_fraction_est": min(coll_est_ms / step_ms, 1.0), "backend": mesh.backend}


def _ks_dp_point(mesh, n_envs: int, steps: int, chunk_len: int, batch_size: int) -> dict:
    """One ks-dp point on this rank of a pure-dp `mesh`."""
    import torch

    from distributedconvrl_pde_control_torch.configs.ks import KS22, build_ks, ks_random_init
    from distributedconvrl_pde_control_torch.parallel.batched_dp import DPBatchedTrainer
    from distributedconvrl_pde_control_torch.train.batched import BatchedTrainerConfig

    setup = build_ks(dataclasses.replace(KS22, fft_mode="matmul_hi", stepper="etdrk4",
                                         nl_fft_mode="matmul_fast"), device=mesh.device)
    tr = DPBatchedTrainer(setup.env, setup.agent,
                          BatchedTrainerConfig(n_envs=n_envs, batch_size=batch_size,
                                               update_loops=1),
                          mesh, random_init=ks_random_init(KS22, mesh.device))
    sync = _sync_of(mesh.device)
    state_box = [tr.init(torch.Generator(device=mesh.device).manual_seed(0))]
    chunk_only, driver_in_loop, timed = _timers(tr.make_chunk_fn(chunk_len), state_box,
                                                chunk_len, n_envs, sync)
    chunk_only(chunk_len)  # warm-up
    dt_step = timed(chunk_only, steps)
    dt_driver = timed(driver_in_loop, steps)
    return {"metric": "dp_batched_ks_train_step", "mesh": f"{mesh.dp}x1", "n_envs": n_envs,
            "ms_per_step": dt_step * 1e3, "ms_per_step_driver": dt_driver * 1e3,
            "driver_overhead_pct": (dt_driver / dt_step - 1.0) * 100.0,
            "env_steps_per_sec": n_envs / dt_step, "backend": mesh.backend}


def card() -> tuple:
    """(name, power limit) of the card as nvidia-smi gives them."""
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    name, power = (x.strip() for x in smi.stdout.strip().splitlines()[0].split(","))
    return name, power


def main(argv=None) -> int:
    import torch

    from distributedconvrl_pde_control_torch.parallel.mesh import launch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--meshes", default="1x1", help="comma-separated DPxSP (ks-dp: N or Nx1)")
    ap.add_argument("--nx", type=int, default=128)
    ap.add_argument("--n-envs", type=int, default=8)
    ap.add_argument("--oversampling", type=int, default=4)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--chunk-len", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--virtual", type=int, default=None,
                    help="run the meshes on N gloo CPU ranks (the scaling's shape, never a speed)")
    ap.add_argument("--tier", default="rk4", choices=("rk4", "tp"),
                    help="fluid solver tier: the fixed-step rk4 program or the `_tp` tier")
    ap.add_argument("--family", default="fluid", choices=("fluid", "ks-dp"),
                    help="fluid: the DPxSP sharded 2D trainer; ks-dp: the data-parallel "
                         "batched KS trainer (pure-dp meshes)")
    args = ap.parse_args(argv)
    if args.virtual:
        backend, have, device, power = "gloo", args.virtual, "cpu", None
    elif not torch.cuda.is_available():
        print("bench_multichip_torch: no CUDA device (--virtual N runs gloo CPU ranks)",
              file=sys.stderr)
        return 1
    else:
        backend, have = "nccl", torch.cuda.device_count()
        device, power = card()
    for spec in args.meshes.split(","):
        dims = [int(x) for x in spec.strip().lower().split("x")]
        dp, sp = dims[0], dims[1] if len(dims) > 1 else 1
        if args.family == "ks-dp" and sp != 1:
            raise SystemExit(f"ks-dp wants a pure-dp mesh, got {spec!r}")
        if dp * sp > have:
            raise SystemExit(f"mesh {dp}x{sp} needs {dp * sp} devices, have {have} "
                             "(hint: --virtual N)")
        point_args = ((args.n_envs, args.steps, args.chunk_len, args.batch_size)
                      if args.family == "ks-dp" else
                      (args.nx, args.n_envs, args.oversampling, args.steps, args.chunk_len,
                       args.batch_size, args.tier))
        fn = _ks_dp_point if args.family == "ks-dp" else _fluid_point
        with tempfile.TemporaryDirectory() as store_dir:
            point = launch(fn, dp, sp, *point_args, backend=backend, store_dir=store_dir)
        print(json.dumps({**point, "device": device, "power_limit": power}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
