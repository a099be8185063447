#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

  1. the card's name and power limit (nvidia-smi);
  2. build the port's CUDA kernel from the source in the checkout and print
     ptxas's register/shared-memory lines;
  3. kernel K1 (the fused KS CNAB2 step) against its plain PyTorch version
     on the card, at the three shapes of tests/test_pallas_kernels.py and at
     the two shapes the main path gives it (nx=192, 30 substeps, 1 env for
     the protocol rollout and 16384 envs for the batched eval);
  4. the KS22 reproduce protocol on the card: the shipped best actor of
     artifacts/KS22 rolled for te=200 with actuation from t=100; its
     suppression must stay below 0.05;
  5. the batched eval: `eval_mean_reward` over 16384 envs from random ICs,
     50 controlled steps after 2 uncontrolled ones, scored "mean" and "min";
     env-steps/s and peak device memory, and the same eval at 4 envs held
     against the CPU run of the port;
  6. K1's time per launch (CUDA events) beside its bound and its plain
     version's time;
  7. the device time of 5 batched env steps by kernel, and the device's
     idle share, from torch.profiler.

K1's launch count is set to 0 just before phases 4-5 (the main path) and read
just after them. The second-to-last line is the kernels JSON line and the
last line is {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_ENVS = 16384
EVAL_STEPS, EVAL_WARMUP = 50, 2
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# K1 against its plain version: the Pallas kernel's own tolerances at the
# test shapes; at the main path's shapes (the 1-env row takes the CTA's
# zero-padded rows and its output guard) the fields are ~5x larger (||y0|| = 30)
# and take 30 substeps, 64 transforms of 192-term float32 sums each.
SHAPES = [  # (label, nx, oversampling, mu, batch, atol)
    ("nx192_os10_b8", 192, 10, 0.0, 8, 2e-4),
    ("nx64_os5_mu0.02_b4", 64, 5, 0.02, 4, 1e-5),
    ("nx192_os5_b512", 192, 5, 0.0, 512, 2e-4),
    ("nx192_os30_b1", 192, 30, 0.0, 1, 1e-3),
    ("nx192_os30_b16384", 192, 30, 0.0, N_ENVS, 1e-3),
]
MAIN_PATH_SHAPES = ("nx192_os30_b1", "nx192_os30_b16384")


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` calls after 3 warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from distributedconvrl_pde_control_torch.configs.ks import KS22, build_ks
    from distributedconvrl_pde_control_torch.ops.kernels import build, ks_kernel
    from distributedconvrl_pde_control_torch.ops.ks import KSSolver
    from distributedconvrl_pde_control_torch.train.batched import BatchedTrainer, BatchedTrainerConfig
    from distributedconvrl_pde_control_torch.train.checkpoint import actor_from_jax, load_best_actor
    from distributedconvrl_pde_control_torch.train.eval import actor_policy, rollout

    dev = "cuda"
    print("== 1. device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    print("== 2. build")
    t0 = time.perf_counter()
    log = build.build(ks_kernel.SOURCE)
    print(f"built {ks_kernel.SOURCE} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "ptxas" in line:
            print(f"{ks_kernel.SOURCE}: {line.strip()}")
    rows, threads = ks_kernel.launch_shape(192, N_ENVS)
    print(f"K1 at 192 points x {N_ENVS} rows: {rows} rows and {threads} threads per CTA, "
          f"{ks_kernel.smem_bytes(192, rows)} B of dynamic shared memory")

    print("== 3. K1 against its plain version")
    setup = build_ks(KS22, device=dev)
    gen = torch.Generator().manual_seed(0)
    slice_y = setup.random_init(gen, N_ENVS)
    slice_a = torch.rand((N_ENVS, 1, KS22.n_actuators), generator=gen).to(dev) * 2.0 - 1.0
    slice_f = setup.env.prepare_action(slice_a)
    errs = {}
    for label, nx, os_, mu, batch, atol in SHAPES:
        solver = KSSolver(nx=nx, lx=22.0, dt=0.1, oversampling=os_, mu=mu, device=dev)
        if nx == 192 and os_ == 30:  # the main path's shapes, from its own fields
            y, f = slice_y[:batch].contiguous(), slice_f[:batch].contiguous()
        else:
            rng = np.random.default_rng(1 if batch == 512 else 0)
            amp_y, amp_f = {8: (0.4, 0.2), 4: (0.0, 0.0), 512: (0.3, 0.1)}[batch]
            y = torch.tensor(amp_y * rng.standard_normal((batch, nx)), dtype=torch.float32, device=dev)
            f = torch.tensor(amp_f * rng.standard_normal((batch, nx)), dtype=torch.float32, device=dev)
        got = ks_kernel.ks_cnab2_step(y, f, solver)
        want = ks_kernel.ks_cnab2_plain(y, f, solver)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        errs[label] = err
        print(f"{label}: max_abs_err {err:.3e} (atol {atol:.0e}), max|y'| {want.abs().max().item():.3f}")
        check(bool(torch.isfinite(got).all()) and err <= atol, f"K1 disagrees at {label}")

    actor = actor_from_jax(load_best_actor(str(ROOT / "artifacts" / "KS22"))).to(dev)
    policy = actor_policy(setup.agent, actor)
    ks_kernel.KS_CNAB2.launches = 0  # the main path starts here

    print("== 4. KS22 reproduce protocol (te=200, actuation from t=100)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traces = rollout(setup.env, policy, te=200.0, t_action=100.0)
    torch.cuda.synchronize()
    t_roll = time.perf_counter() - t0
    yt = traces["y"]
    act_start = 1000
    pre = float(np.abs(yt[act_start - 100:act_start]).mean())
    post = float(np.abs(yt[-len(yt) // 10:]).mean())
    supp = post / pre
    launches_rollout = ks_kernel.KS_CNAB2.launches
    print(json.dumps({"row": "KS22 stabilization", "pre": pre, "post": post, "suppression": supp,
                      "steps": len(yt), "seconds": t_roll, "K1_launches": launches_rollout}))
    check(np.isfinite(yt).all() and yt.shape == (2000, KS22.nx), "rollout trace malformed")
    check(supp < 0.05, f"suppression {supp} not below 0.05")

    print(f"== 5. batched eval: {N_ENVS} envs, {EVAL_STEPS} steps after {EVAL_WARMUP} warm-up steps")
    trainer = BatchedTrainer(setup.env, setup.agent, BatchedTrainerConfig(n_envs=N_ENVS),
                             random_init=setup.random_init)
    torch.cuda.reset_peak_memory_stats()
    scores, rates = {}, {}
    for score in ("mean", "min"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores[score] = trainer.eval_mean_reward(actor, EVAL_STEPS, generator=torch.Generator().manual_seed(1),
                                                 warmup_steps=EVAL_WARMUP, score=score)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rates[score] = N_ENVS * (EVAL_STEPS + EVAL_WARMUP) / secs
        print(f"score={score}: {scores[score]:.6f} in {secs:.3f} s -> {rates[score]:.0f} env-steps/s")
    peak_mem = torch.cuda.max_memory_allocated()
    launches = ks_kernel.KS_CNAB2.launches  # the main path ends here
    print(f"peak device memory {peak_mem} bytes; K1 launches on the main path {launches} "
          f"(rollout {launches_rollout}, batched eval {launches - launches_rollout})")
    check(launches > 0 and launches - launches_rollout > 0, "K1 was not launched on the main path")
    check(np.isfinite(scores["mean"]) and np.isfinite(scores["min"])
          and scores["min"] <= scores["mean"], f"eval scores malformed: {scores}")

    # the slice on the card against the slice on the CPU (plain K1) at 4 envs
    cpu_setup = build_ks(KS22, device="cpu")
    cpu_actor = actor_from_jax(load_best_actor(str(ROOT / "artifacts" / "KS22")))
    small_y0 = cpu_setup.random_init(torch.Generator().manual_seed(2), 4)
    for score in ("mean", "min"):
        vals = []
        for s, a, d in ((setup, actor, dev), (cpu_setup, cpu_actor, "cpu")):
            tr = BatchedTrainer(s.env, s.agent, BatchedTrainerConfig(n_envs=4))
            vals.append(tr.eval_mean_reward(a, 10, warmup_steps=2, score=score,
                                            y0s=small_y0.to(d)))
        rel = abs(vals[0] - vals[1]) / abs(vals[1])
        print(f"4-env eval score={score}: cuda {vals[0]:.7f} cpu {vals[1]:.7f} rel {rel:.2e} (rtol 1e-4)")
        check(rel <= 1e-4, f"card and CPU evals disagree ({score})")

    print("== 6. K1 time at the slice's shape")
    solver = KSSolver(nx=192, lx=22.0, dt=0.1, oversampling=30, device=dev)
    k_ms = cuda_ms(lambda: ks_kernel.ks_cnab2_step(slice_y, slice_f, solver), 20)
    plain_ms = cuda_ms(lambda: ks_kernel.ks_cnab2_plain(slice_y, slice_f, solver), 5)
    n_bytes = 3 * N_ENVS * 192 * 4
    flops = ks_kernel.flops_per_row(192, 30) * N_ENVS
    bytes_ms, ops_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_F32_FLOPS
    bound_ms = max(bytes_ms, ops_ms)
    step_ms = 1e3 * N_ENVS / rates["min"]
    print(f"K1 {k_ms:.4f} ms/launch, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"(bytes {bytes_ms:.4f} ms for {n_bytes} B, operations {ops_ms:.4f} ms for {flops:.0f} flop: FFT count); "
          f"K1 is {100 * k_ms / step_ms:.1f}% of the {step_ms:.4f} ms batched env step; {card}")
    print(json.dumps({"slice": "KS22 batched eval", "n_envs": N_ENVS, "env_steps_per_s": rates["min"],
                      "env_steps_per_s_first_call": rates["mean"], "peak_mem_bytes": peak_mem,
                      "rollout_seconds": t_roll, "card": card}))

    print("== 7. device time of 5 batched env steps by kernel (torch.profiler)")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.eval_mean_reward(actor, 5, generator=torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    print(json.dumps({"profile": f"batched eval, {N_ENVS} envs, 5 steps, under the profiler",
                      "wall_us": wall_us, "device_busy_us": busy_us if kern else "not measured",
                      "idle_share": 1.0 - busy_us / wall_us if kern else "not measured",
                      "kernels": len(kern), "launches": sum(e.count for e in kern),
                      "top": [[e.key[:60], e.count, e.self_device_time_total] for e in top]}))

    print(json.dumps({"kernels": [{
        "name": "ks_cnab2", "route": "cuda",
        "source": "distributedconvrl_pde_control_torch/csrc/" + ks_kernel.SOURCE,
        "replaces": ks_kernel.REPLACES, "launches": launches,
        "max_abs_err": max(errs[k] for k in MAIN_PATH_SHAPES), "ms": k_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "library_ms": None, "status": "ok"}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
