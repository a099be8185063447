#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --train-only
    python3 chip_smoke.py --fidelity-only
    python3 chip_smoke.py --families-only
    python3 chip_smoke.py --agents-only
    python3 chip_smoke.py --tiers-only
    python3 chip_smoke.py --tools-only
    python3 chip_smoke.py --mesh-only
    python3 chip_smoke.py --dp-only
    python3 chip_smoke.py --grids-only
    python3 chip_smoke.py --times-only [--tree DIR]

With no argument it runs the phases below. `--train-only` runs phases 1, 2 and
14-22 (the training paths), `--fidelity-only` phases 1, 2 and 23-28 (the KS
fidelity loop), `--families-only` phases 1, 2 and 29-33 (the single-device
fluid env and Keller-Segel), `--agents-only` phases 1, 2 and 34-39 (PPO and
populations), and none of them prints a result line; `--tiers-only` runs
phases 1, 2 and 40-44 (the reduced-precision transform tiers and the `_tp`
presets), `--tools-only` phases 1, 2 and 45-50 (serving, export, the live
view, the population evaluation scripts, the profiler), `--mesh-only`
phases 1, 2 and 51-54 (the rank mesh), `--dp-only` phases 1, 2 and 55-60
(data and tensor parallelism) and `--grids-only` phases 1, 2 and 61 (both
kernels on grids other than the main paths'); these five end with the ok line. `--times-only` prints the card and
one JSON line of both kernels' times through their wrappers at the main
paths' shapes and nothing else; `--tree DIR` imports the package from another
checkout inside this one (an unpacked earlier commit under build/, say), so
that two designs of a kernel are timed in turns within one run on one card.

Every phase's banner carries the seconds since its process started, and each
process prints the seconds of its phases as one JSON line before it ends.

Phases, each of which fails the run (non-zero exit, no result line):

  1. the card's name and power limit (nvidia-smi);
  2. build the port's CUDA kernels (K1, K2) from the sources in the checkout,
     one nvcc each, started together, and print ptxas's register/shared-memory
     lines;
  3. kernel K1 (the fused KS CNAB2 step) against its plain PyTorch version
     on the card, at the three shapes of tests/test_pallas_kernels.py, at
     the two shapes the main path gives it (nx=192, 30 substeps, 1 env for
     the protocol rollout and 16384 envs for the batched eval), and at the
     grids of the KS200 and KS500 presets (nx=240 and nx=600);
  4. the KS22 reproduce protocol on the card: the shipped best actor of
     artifacts/KS22 rolled for te=200 with actuation from t=100; its
     suppression must stay below 0.05;
  5. the batched eval: `eval_mean_reward` over 16384 envs from random ICs,
     50 controlled steps after 2 uncontrolled ones, scored "mean" and "min";
     env-steps/s and peak device memory, and the same eval at 4 envs held
     against the CPU run of the port;
  6. K1's time per launch (CUDA events) beside its bound and its plain
     version's time, at 16384 rows and at the rollout's single row;
  7. the device time of 5 batched env steps by kernel, and the device's
     idle share, from torch.profiler;
  8. kernel K2 (the NS advection term with the 2/3-rule mask) against its
     plain PyTorch version on the card, at the Pallas test's shape (n=32,
     batch 4), at n=16 and n=128, and at the fluid path's two shapes (n=256,
     batch 1 and 16) on spectra of real case-4 vortex fields and of white
     noise; then, at the fluid path's two shapes with the solver's constants,
     on spectra with non-Hermitian content on the Nyquist row and column, in
     both launch forms (one cooperative launch, the chain of three), with the
     operands lin and f against their plain twin, and the library's loop of
     RK4 substeps (whose stages carry the stage state and the combination)
     against the plain composition;
  9. the Fluid_16_256 protocol on the card (256x256 grid, 16x16 actuators, 81
     RK4 substeps per env step, the shipped best actor of
     artifacts/Fluid_16_256): 1 env for te=2 (100 env steps), trained and
     no-action; every step must stay active and the trained controller's mean
     energy must stay below 0.7 of the uncontrolled one;
 10. the same evaluation at 16 envs for 5 steps: env-steps/s and peak device
     memory;
 11. the fluid slice on the card against the port on the CPU at a small size
     (32x32 grid, 4x4 actuators, 2 envs, 6 steps, actuation from step 2), on
     the fixed-step and the adaptive stepper, and 10 steps of the adaptive
     Fluid_8 preset at its own 128x128 grid;
 12. K2's time per call (CUDA events) at n=256, batch 1 and 16, in both
     launch forms, beside its bound and its plain version's time; the time of
     the right-hand side (lin and f given) and of a stage inside the library's
     substep loop, in both forms;
 13. the device time of one fluid env step by kernel group (torch.profiler),
     with the launches per env step and K2's launches per RK4 substep;
 14. the batched train step on the card against the port on the CPU: 4 envs,
     20 steps (learning from step 3, an episode boundary at step 15), every
     draw made once on the CPU and passed to both, on CNAB2 (K1 against its
     plain twin inside a train step) and on the spectral-featurize tier;
 15. training to a controller: the KS22 long-horizon recipe (spectral-featurize
     tier, 256 envs, 3000 steps, learner batch 256, noise x0.5 every 1000,
     capacity 1,000,000, a 500-step deterministic eval every 150 steps picks the
     best actor) through `train_batched`, saved and read back through the
     checkpoint; then that actor on the te=200 protocol of phase 4 on the
     standard CNAB2 env (K1): suppression must stay below 0.05;
 16. training with K1 at full width: KS22 CNAB2, 16384 envs, learner batch
     4096, a warm-up chunk and 2 chunks of 50 steps, the timed chunks under
     `torch.cuda.set_sync_debug_mode("error")` (no device-to-host read inside a
     chunk): env-steps/s, peak memory, K1's launches equal the train steps, the
     replay holds min(steps*131072, capacity) entries; the dense and sparse
     record readers' times;
 17. the bench unit, `bench_torch.run_once`: env-steps/s at 16384 envs on the
     spectral-featurize tier;
 18. the device time of 5 train steps on each stepper by kernel group (K1 /
     cuFFT / matmul / optimizer / copies / elementwise), launches per train step
     and the device's idle share;
 19. the fluid train chunk on the card against the port on the CPU: 32x32
     grid, 4x4 actuators, 2 envs, 20 steps (learning from step 3, episodes
     ending at step 15), every draw made once on the CPU and passed to both:
     K2 against its plain twin inside a train step, phase 14's limits;
 20. training a fluid controller at full width through the CLI's code path
     (`run Fluid_16_256 --train --mesh 1x1`: 1 env, 8 of the recipe's 10 loops
     x 580 steps in chunks of 25 = 4800 train steps, learner batch 32, capacity 100,000,
     seed 436, the recipe of artifacts/Fluid_16_256), read back through the
     light checkpoint and hook.npz; its best actor on phase 9's te=2 protocol
     must keep all 100 steps active with a mean energy below 0.7 of no action.
     Its host times come after the profiles of phases 7, 13 and 18
     in this process (PERF.md: slower than the CLI alone);
 21. fluid training throughput at 16 envs (learner batch 32): a warm-up chunk,
     then 2 chunks of 25 steps under `torch.cuda.set_sync_debug_mode("error")`:
     env-steps/s, peak memory, K2's launches equal 324 per train step, the
     replay holds min(steps*4096, capacity) rows;
 22. the device time of one fluid train step at 1 and at 16 envs by kernel
     group (K2 / cuFFT / matmul / optimizer / copies / elementwise), launches
     per train step and the device's idle share;
 23. one KS22 fidelity episode with learning (`train/loop.py::make_episode_fn`,
     30 steps, learning from step 12, 20 learner updates per step) on the card
     against the port on the CPU, every draw made once on the CPU and passed
     to both: K1 against its plain twin inside the loop; parameters and
     reward_sum within 1e-4, equal steps and replay size;
 24-27 run in a process of their own (no profiler session before them):
 24. the KS22 fidelity recipe through the CLI (`run KS22 --train`: seed 609,
     cut from 8 loops of 800 steps to 2 of 400), read back through the full
     checkpoint; its best actor on phase 4's te=200 protocol must reach
     suppression < 0.25; env-steps/s, and K1's launches equal the env steps;
 25. `--resume` from phase 24's checkpoint for 1 loop x 100 steps (episodes,
     replay and Adam steps go on from the saved ones), then `--train-multi`
     (1 experiment, 50 episodes cut to te=1) with its numbered saves;
 26. the KS mono ablation: 1 loop x 200 steps of `KS22_global --train` at
     full width, and `--hyperopt 2 --hyperopt-episodes 3`: every step and
     cost finite;
 27. reproduce_torch.py on the card: every KS row of reproduce.py (the two
     KS22_global rows included) beside the JAX package's value for it
     (`reproduce_torch.JAX_KS_ROWS`, from reproduce.py on the CPU), each within
     max(0.1 JAX, 0.0005);
 28. the device time of 5 fidelity env steps with learning by kernel group
     (K1 / matmul / optimizer / copies / elementwise), launches per env step,
     K1's share of device time and the device's idle share.
 29-33: the single-device fluid env and Keller-Segel (see `families_phases`);
 34. one PPO `collect_and_update` iteration on KS22 (2 envs, rollout 8, 2
     epochs x 4 microbatches) on the card against the CPU, every draw made once
     on the CPU: K1 against its plain twin inside it; parameters within 1e-4 of
     each tensor's largest value, the mean reward within 1e-4, K1's launches
     equal to the env steps;
 35. the shipped PPO controllers on the card: KS22_ppo, _ref, _lh and _ref_lh
     at te=200 from actuation at t=100 (K1 at 1 row), each within
     max(0.1 JAX, 0.0005) of the JAX package's suppression (`JAX_PPO_KS_ROWS`);
     the Keller-Segel PPO row of reproduce.py (pre within 1e-3, post within
     max(0.1 JAX, 0.0005)); Fluid_8_ppo and _lh on the te=3 protocol, each mean
     energy within 2 % of JAX's (`JAX_PPO_FLUID_ROWS`);
 37. one P=2 population chunk (4 envs per member, per-member learning rates
     and act_noise, 20 steps) on the card against the CPU on CNAB2 (K1 against
     its plain twin) and on the sf tier: phase 14's limits;
 36, 38 and 39's rates run in a process of their own (no profiler session):
 36. PPO through the CLI: the KS22_ppo_lh recipe in full (tuned config, 8
     envs, 60 iterations, a 500-step eval every 5), then `--eval --ppo` at
     te=200: suppression < 0.05; the iteration's time alone; KellerSegel10_16_
     fast and Fluid_8 `--train --ppo` cut in depth, read back through
     `load_ppo`, every reward and parameter finite;
 38. a CNAB2 population of 8 x 256 at full width for 2 chunks (K1 at 2048
     rows, once per train step); `--pop-search 4 --population 2` and
     `KellerSegel10_16_fast --population 4`, cut in depth (the population
     study on phase 15's recipe is phase 42's, on the JAX study's preset);
 39. the population's cost: env-steps/s of 8 x 256 fused against a solo run at
     256 (sf tier) and their ratio, the study speedup; then, under the
     profiler, launches per train step of each and the idle share;
 40. each transform tier (matmul, matmul_hi, matmul_fast) on the card at the
     slice's shapes: 16384x192 `rfft_ri`/`irfft_ri`, Fluid_8's 3/2-padded
     192^2 grid (the four stacked spectra's inverse and the product's forward,
     full and half spectrum), 256^2 `fft2_ri`/`ifft2_ri_real` at 16 fields;
     each against the port on the CPU (rel 1e-5) and against a float64
     transform (rel L2 <= 2e-6 matmul, <= 2e-5 matmul_hi, 3e-4..1e-2
     matmul_fast), with its time beside cuFFT's; cuBLAS's float32 precision
     unchanged after;
 41. the tiers' error per env step against the float32 step of the same
     stepper: KS22 ETDRK4 on 16384 states after 500 uncontrolled steps,
     matmul_hi everywhere and with the nonlinear term at matmul_fast, each
     within 0.1x-3x of the TPU's ladder (2.0e-5, 1.8e-4: PERFORMANCE.md, an
     accuracy, not a speed); Fluid_8_tp's IF-RK4 step against Fluid_8_fast's:
     > 0 and <= 1.1e-3;
 42-43 run in a process of their own (no profiler session):
 42. `KS22_tp --train --batched --population 8` on phase 15's recipe (256
     envs per member, 3000 steps, noise x0.5 per 1000, a 500-step eval every
     300, cut from the JAX study's 50 for room; the JAX study's preset,
     artifacts/KS22_tp_pop8), then every member at
     te=200 on the standard CNAB2 env (K1 at 1 row): the median member's
     suppression < 0.05, every member finite, printed beside the JAX study's
     0.24-0.85 % (RESULTS.md:32);
 43. `Fluid_8_tp --train` (20 env steps of te=0.2) and `Fluid_16_256_tp
     --train --mesh 1x1` (50 train steps of te=0.5), read back through their
     checkpoints: every reward and parameter finite, a best actor; on the
     mesh K2's launches equal 4 x the IF-RK4 substeps x the train steps;
 44. `bench_torch.py` and `bench_torch.py --tier tp` (bench.py's exact
     configuration), each in a process of its own, in turns (sf, tp):
     their train env-steps/s side by side;
 45-50 run in a process of their own, 50 last in it (its profiler session
 slows every later launch of the process):
 45. `run.py --eval --serve` on the shipped KS22, KellerSegel10_16_fast
     (artifacts/KellerSegel_popsearch_pop8/member_00) and Fluid_8 controllers:
     200 control steps each, p50, p99 and headroom over the control interval
     (> 1, and neither kernel launched);
 46. `run.py --eval --export-controller` for the same three on the card, each
     program reloaded by `load_exported`'s own source in a process where the
     port cannot be imported, on the card (bit-equal to the live step there)
     and moved to the CPU (bit-equal to the port's live CPU step); then
     `serve --from-export` on each (neither kernel launched by the export or
     the serving);
 47. `run.py KS22 --eval --live` (te=200) to a non-TTY stream: one frame per
     env step, K1's launches equal to the env steps, suppression < 0.05, and
     the plots written or one line saying matplotlib is missing;
 48. `eval_kss_pop_torch.py` on KellerSegel_popsearch_pop8 (8 members x keys
     7-10): each post value within max(0.1 JAX, 0.0005) of eval_kss_pop.py's
     (`JAX_KSS_POP`, computed on the CPU);
 49. `eval_fluid_pop_torch.py` on Fluid_8_tp_pop8 (te=6, 8 members and the 2
     baselines as one batch): each energy prefix within 2 % of
     eval_fluid_pop.py's (`JAX_FLUID_POP`);
 50. `run.py KS22 --train --profile` cut to one loop of one 30-step episode
     (the learner starts after the preset's update_after of 10 steps):
     the trace file exists, holds K1 once per env step (as the library counts
     it), and the StepTimer summary is printed.
 51-54 run in a process of their own (no profiler session); the card's 1x1
 mesh is an NCCL process group of one rank, larger meshes run on gloo CPU
 ranks, whose times are CPU times and never a speed of the port:
 51. phase 9's protocol cut to 20 env steps through the sharded trainer on an
     NCCL group of one (the backend must be nccl), against the same code
     without a group and phase 9's per-step energies (rel 1e-6), K2 launched
     4 x substeps x env steps, the ms per env step with and without the group;
     then `run.py Fluid_16_256 --eval --mesh 1x1` (NCCL) over the same steps;
 52. `run.py Fluid_16_256 --train --mesh 1x1` (NCCL) for 50 train steps with
     K2 launched 4 x substeps x train steps; on the NCCL group, two chunks of
     25 under `set_sync_debug_mode("error")` (no device-to-host read inside a
     chunk); the save evaluated by the single-device `--eval`;
 53. `run.py Fluid_16_256 --eval --virtual-devices 4 --mesh 2x2` on gloo CPU
     ranks at 256^2 for 2 env steps: the trained energy within rel 1e-4 of
     phase 51's card energies on the same steps;
 54. `run.py KellerSegel10_16_fast --mesh 1x1 --eval` (NCCL), then
     reproduce.py's KellerSegel10_16_fast row through the sharded trainer's
     rollout on the 1x1 NCCL mesh, then, cut to te=5, on 2 gloo CPU
     ranks (1x2) once every card phase is timed, each against the
     single-device port's row at its te: pre within 1e-3, post within
     max(0.1 JAX, 0.0005).
 55-60 run in a process of their own (data and tensor parallelism,
 `parallel/batched_dp.py`, `train/population.py` over dp, `parallel/tp.py`):
 55. `DPBatchedTrainer` on an NCCL group of one at bench.py's shape (KS22,
     16384 envs, learner batch 4096, the sf tier) against `BatchedTrainer`
     from the same state: a warm-up chunk each, then 2 chunks of 50 each in
     turns (no group, group, group, no group) under
     `set_sync_debug_mode("error")`; records and obs_flat equal, parameters
     within 1e-7, env-steps/s with and without the group; then at 4 envs (the
     sf tier, learning from step 1) on the ranks' draws of phase 60 merged
     into one single-device batch (`merge_rank_draws`);
 56. `run.py KS22 --train --batched --mesh 1` (NCCL, CNAB2: 256 envs, 200
     steps, an eval of 50 steps every 100): K1 launched once per train step
     and eval step; the save read by the single-device `--eval` (te=20);
 57. `run.py KS22 --train --batched --population 2 --mesh 1` (NCCL, CNAB2: 2 x
     128 envs, 100 steps, an eval of 20 steps every 50): every member finite,
     K1 once per train step and eval step; then a 20-step population chunk at
     2 x 4 envs on the NCCL group against the unsharded population from the
     same state: records and every member's routed records equal;
 58. `make_tp_learn_step` at tp = 1 on the NCCL group against `learn_batch`
     (KS22's agent, a batch of 4096): networks within 1e-5;
 59. `bench_multichip_torch.py --meshes 1x1 --nx 256` (the fluid family, K2
     launched 4 x 4 substeps x train steps) and `--family ks-dp --meshes 1x1
     --n-envs 16384`, their lines as they come;
 60. last and alone: 2 gloo CPU ranks of `DPBatchedTrainer` on phase 55's
     small run's draws, each rank's own: records within phase 14's limits of
     the card's single-device run (finished exact, ep_reward 1e-3,
     mean_reward 1e-4), networks within 1e-4 of each tensor's maximum.
 61 runs in a process of its own (no profiler session): both kernels on every
 grid the JAX package steps. K2 against its plain version at n = 24, 45, 96,
 176, 384, 2048 and 4096 (mixed-radix lines, odd n, a generic stage of 11,
 the largest power-of-two lines) and K1 at nx = 45, 50, 190 (16384 rows) and
 250 on the block route; above the shared-memory limits, on the device
 route (line transforms as levels through device memory, or Bluestein), K2
 at n = 4097, 4099, 6144, 6561 and 8192 and K1 at nx = 4320, 4327 and 8192
 (2 and 64 rows); each launched once with torch.fft and both plain versions
 made to raise (no plain route on the card); the device route forced at the
 main paths' shapes (the wrappers' SMEM_LIMIT patched: K1 at 16384x192, K2's
 RK4 loop at 256^2, batch 1 and 16) against the block route; K2's time at n
 = 96, 384, 2048, 4096 and the device grids, K1's at nx = 190, 250, 45 and
 the device grids, and both forced routes', beside their bounds and their
 plain versions' times; `run.py Fluid_16_256 --mesh 1x1 --eval --nx 96` on
 the card against its `--cpu` run (rel 1e-4; K2 = 2 x 4 x substeps x env
 steps), then again with K2's SMEM_LIMIT patched so that it runs the device
 route; `run.py KS22 --eval --config-overrides '{"nx": 190}' --p-te 20`
 (suppression within 1e-4; K1 = env steps) and the paper's transfer to a
 10x larger domain, `run.py KS500 --eval --load-from
 artifacts/KS200_batched_lh --config-overrides '{"lx": 5000.0, "nx": 6000,
 "n_actuators": 2000}' --p-te 20` (K1's device route; suppression within
 1e-4 of `--cpu`, K1 = env steps); `bench_decomp_torch.py` and
 `bench_population_torch.py` cut in depth (one timed chunk of 5 steps per
 line), through their `main` in this process.

Times of the kernels' first designs (PERF.md, same card and power limit) are
printed beside the new ones in the phases' text lines; the kernels JSON line
holds only what this run measured.

K1's launch count is set to 0 just before phases 4-5 (the KS evaluation
path) and read just after them, and again around phases 15-16 (the training
path: the trained controller's protocol rollout and the full-width train
steps); K2's is set to 0 just before phases 9-10 (the fluid evaluation
path) and read just after them, and again around phases 20-21 (the fluid
training path: the train steps and the trained controller's protocol
rollout); a stage of an RK4 substep is one launch of K2, counted by the
library where it launches. Phases 24-27 count K1 in their own process, from 0
before each CLI run, rollout and the rows, and report the counts by path; so
do phases 35 (the shipped PPO controllers' rollouts), 36 (PPO training and the
trained controller's rollout), 38 (the CNAB2 population at full width), 42
(the KS22_tp members' rollouts), 43 (K2 in the Fluid_16_256_tp mesh
training), 47 (the live eval), 50 (the profiled training), 51-52 (K2 on
the NCCL 1x1 mesh's evaluation and training), 56-57 (K1 in the data-parallel
training, its evals and the save's eval), 59 (K2 in the bench's fluid
chunks) and 61 (K2 in the 96^2 fluid eval, K1 in the nx = 190 KS eval). K2 lies on
none of the PPO, population and tooling paths; serving and export launch
neither kernel. The line before the kernels JSON line holds the seconds of
the main process's phases; the second-to-last line is the kernels JSON line
and the last line is {"ok": true, "device": {...}}.
"""

import argparse
import contextlib
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
    ("nx240_os30_mu0.02_b33", 240, 30, 0.02, 33, 1e-3),  # KS200's grid: factors 4, 4, 3, 5
    ("nx600_os30_b37", 600, 30, 0.0, 37, 1e-3),  # KS500's grid: factors 4, 2, 3, 5, 5
]
MAIN_PATH_SHAPES = ("nx192_os30_b1", "nx192_os30_b16384")
# K2 against its plain version: (label, n, batch, input spectra, constants).
# "normal" spectra are fft2 of white noise, which puts comparable energy in
# every kept mode (the band edge and the Nyquist row and column included);
# "case4" spectra are those of real vortex fields, what the solver feeds K2.
# "fftfreq" constants are the Pallas kernel's (negative Nyquist wavenumber),
# "solver" constants the fluid path's (make_sharded_ops). The tolerance is 1e-4
# of the largest expected value at every shape, the Pallas kernel's own
# (tests/test_pallas_kernels.py); both sides are float32 FFTs of length <= 256
# whose rounding is ~1e-6 of that scale, so it leaves ~100x room.
K2_SHAPES = [
    ("n32_b4", 32, 4, "normal", "fftfreq"),
    ("n16_b4", 16, 4, "normal", "fftfreq"),
    ("n128_b8", 128, 8, "normal", "fftfreq"),
    ("n128_b1", 128, 1, "case4", "solver"),  # the adaptive Fluid_8 rollout of phase 11
    ("n256_b1", 256, 1, "case4", "solver"),
    ("n256_b16", 256, 16, "case4", "solver"),
    ("n256_b1_noise", 256, 1, "normal", "solver"),
    ("n256_b16_noise", 256, 16, "normal", "solver"),
]
K2_MAIN_PATH_SHAPES = ("n256_b1", "n256_b16", "n256_b1_noise", "n256_b16_noise")
K2_TIMED_SHAPES = ("n256_b1", "n256_b16")
K2_RTOL = 1e-4
# ms per call of the kernels' first designs on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md
# section 6: K1 radix-4-split direct DFTs, K2 five radix-2 transforms in three launches)
FIRST_DESIGN_MS = {"K1 16384x192": 3.7358, "K1 1x192": 0.3682, "K2 n256_b1": 0.0404,
                   "K2 n256_b16": 0.1393}
FLUID_P_TE = 2.0  # 100 env steps of dt = 0.02
FLUID_BATCH, FLUID_BATCH_STEPS = 16, 5
SF_TIER = dict(stepper="etdrk4", spectral_carry=True, spectral_featurize=True)
TRAIN_SEED = 609  # phase 15: the KS22 preset's seed, the CLI's default
# phases 15 and 42: the JAX study evaluates every 50 steps (artifacts/KS22_tp_pop8: 60 evals
# per member; 0.42 % median here at 50); every 500 steps selected from 6 evals and left the
# members' median at 2.09 % against the JAX study's 0.34 %. Both cut for room to 20 evals
# each, phase 42 further to 10 (PERF.md section 4)
POP_EVAL_EVERY = 300
TRAIN_EVAL_EVERY = 150
TRAIN_CHUNK = 50
LEARNER_BATCH = 4096
FLUID_TRAIN_SEED = 436  # phase 20: the Fluid_16_256 preset's seed, the CLI's default
FLUID_TRAIN_CHUNK = 25  # phase 20: the CLI's chunk length on --mesh
# phase 20: the recipe's 10 loops cut to 8 (4,800 train steps): its best actor came at episode
# 15 of 20, in loop 8 (PERF.md section 4)
FLUID_TRAIN_LOOPS = 8
FLUID_TRAIN_BATCH, FLUID_TRAIN_ENVS = 32, 16  # phases 20-22: the CLI's learner batch; phase 10's width


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(msg)


T_START = time.perf_counter()
PHASE_SECONDS = {}  # banner -> seconds, for this process
_CURRENT_PHASE = [None, T_START]


def phase(banner: str) -> None:
    """Print a phase's banner with the seconds since the process started; the
    phase before it ends here and its seconds are kept for
    `print_phase_seconds`."""
    now = time.perf_counter()
    end_phase(now)
    _CURRENT_PHASE[:] = [banner[3:].split(" ")[0].rstrip(".") if banner.startswith("== ")
                         else banner, now]
    print(f"{banner} [at {now - T_START:.1f} s]", flush=True)


def end_phase(now: float) -> None:
    name, t0 = _CURRENT_PHASE
    if name is not None:
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + now - t0
    _CURRENT_PHASE[:] = [None, now]


def print_phase_seconds() -> None:
    """One JSON line: the seconds of each phase this process ran (a phase
    that starts a child process counts the child's run)."""
    end_phase(time.perf_counter())
    print(json.dumps({"phase_seconds": {k: round(v, 1) for k, v in PHASE_SECONDS.items()},
                      "process_seconds": round(time.perf_counter() - T_START, 1)}), flush=True)


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


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def times_only(tree) -> int:
    """K1 (`ks_cnab2_step`) at 16384x192 and 1x192 with 30 substeps and K2
    at n=256, batch 1 and 16 with the fluid solver's constants (the bare
    `ns_advection` call, and a stage inside `ns_rk4_substeps`' loop), from the
    checkout `tree` or this one."""
    if tree:
        sys.path.insert(0, tree)
    import numpy as np
    import torch

    from distributedconvrl_pde_control_torch.ops.kernels import ks_kernel
    from distributedconvrl_pde_control_torch.ops.kernels import ns_advection as k2
    from distributedconvrl_pde_control_torch.ops.ks import KSSolver
    from distributedconvrl_pde_control_torch.parallel.ns_sharded import make_sharded_ops

    card = card_line()
    print(card)
    rng = np.random.default_rng(0)
    times = {}
    solver = KSSolver(nx=192, lx=22.0, dt=0.1, oversampling=30, device="cuda")
    for batch, iters in ((N_ENVS, 20), (1, 200)):
        y = torch.tensor(3.0 * rng.standard_normal((batch, 192)), dtype=torch.float32, device="cuda")
        f = torch.tensor(rng.standard_normal((batch, 192)), dtype=torch.float32, device="cuda")
        times[f"K1 {batch}x192"] = cuda_ms(lambda: ks_kernel.ks_cnab2_step(y, f, solver), iters)
    ops = make_sharded_ops(256, 256, device="cuda")
    lin = (-1e-3 * ops.k2).contiguous()
    for batch in (1, 16):
        w = torch.fft.fft2(torch.tensor(rng.standard_normal((batch, 256, 256)), dtype=torch.float32,
                                        device="cuda"))
        f = (0.01 * w).contiguous()
        times[f"K2 n256_b{batch}"] = cuda_ms(lambda: k2.ns_advection(w, ops), 200)
        # a stage inside the library's loop of 20 RK4 substeps (80 launches per call)
        times[f"K2 n256_b{batch} stage in loop"] = cuda_ms(
            lambda: k2.ns_rk4_substeps(w, ops, lin, f, 1e-6, 20), 5) / 80
    print(json.dumps({"tree": tree or ".", "card": card, "ms_per_call": times}))
    return 0


def profile_groups(prof):
    """{group: [launches, device us]} of a torch.profiler run, by kernel name."""
    import torch

    groups = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key.startswith("Optimizer."):
            continue  # host events, and the annotation around an optimizer step
        low = e.key.lower()
        group = ("K1" if "ks_cnab2" in low else
                 "K2" if "ns_adv" in low else
                 "cuFFT" if "fft" in low else
                 "optimizer" if "adam" in low or "multi_tensor" in low else
                 "matmul" if "gemm" in low or "gemv" in low else
                 "copies" if low.startswith("memcpy") or low.startswith("memset") else
                 "elementwise and other")
        g = groups.setdefault(group, [0, 0.0])
        g[0] += e.count
        g[1] += e.self_device_time_total
    return groups


def train_phases(card: str) -> dict:
    """Phases 14-18: the batched training path. Returns K1's launches on it."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import bench_torch
    from distributedconvrl_pde_control_torch.agents.ddpg import DDPGAgent
    from distributedconvrl_pde_control_torch.configs.ks import KS22, build_ks
    from distributedconvrl_pde_control_torch.models.mlp import chain_to_numpy, copy_chain
    from distributedconvrl_pde_control_torch.ops.kernels import ks_kernel
    from distributedconvrl_pde_control_torch.train import checkpoint
    from distributedconvrl_pde_control_torch.train.batched import (
        BatchedTrainer,
        BatchedTrainerConfig,
        StepDraws,
        train_batched,
    )
    from distributedconvrl_pde_control_torch.train.eval import actor_policy, rollout
    from distributedconvrl_pde_control_torch.train.records import (
        consume_record_read,
        record_bytes,
        start_record_read,
    )

    dev = "cuda"
    phase("== 14. the train step on the card against the CPU (4 envs, 20 steps)")
    n_small, b_small, steps_small, n_pool = 4, 16, 20, 6
    for tier, over in (("cnab2 (K1 vs its plain twin)", {}), ("spectral-featurize", SF_TIER)):
        cfg = dataclasses.replace(KS22, te=1.5, **over)  # episodes end at step 15
        gen = torch.Generator().manual_seed(14)
        draws = [dict(noise=torch.randn((1, n_small * KS22.n_actuators), generator=gen),
                      offs=torch.randint(0, (i + 1) * n_small * KS22.n_actuators, (1, b_small),
                                         generator=gen),
                      idx=torch.randint(0, n_pool, (n_small,), generator=gen))
                 for i in range(steps_small)]
        outs = []
        for d in (dev, "cpu"):
            s = build_ks(cfg, device=d)
            pool = s.random_init(torch.Generator().manual_seed(15), n_pool)
            tr = BatchedTrainer(s.env, s.agent, BatchedTrainerConfig(n_envs=n_small, batch_size=b_small,
                                                                     min_best_episode=1), y0_pool=pool)
            ts = tr.init(torch.Generator().manual_seed(16), idx=torch.arange(n_small))
            seed_state = s.agent.init_state(torch.Generator().manual_seed(17), "cpu")  # same nets on both
            ts.agent = s.agent.make_state(copy_chain(seed_state.actor).to(d),
                                          copy_chain(seed_state.critic).to(d))
            ts.best_actor = copy_chain(ts.agent.actor)
            before = ks_kernel.KS_CNAB2.launches
            ts, packed = tr.make_chunk_fn(steps_small)(
                ts, [StepDraws(**{k: v.to(d) for k, v in dr.items()}) for dr in draws])
            outs.append((ts, packed.cpu().numpy(), ks_kernel.KS_CNAB2.launches - before))
        (ts_c, rec_c, k1_c), (ts_h, rec_h, k1_h) = outs
        check(k1_h == 0 and k1_c == (0 if over else steps_small),
              f"K1 launches in the small train chunk: card {k1_c}, CPU {k1_h}")
        p_err = max(float(np.abs(a[k] - b[k]).max())
                    for name in ("actor", "critic", "target_actor", "target_critic")
                    for a, b in zip(chain_to_numpy(getattr(ts_c.agent, name)),
                                    chain_to_numpy(getattr(ts_h.agent, name))) for k in ("w", "b"))
        r_err = float(np.abs(rec_c[2] - rec_h[2]).max())
        m_err = float(np.abs(rec_c[4] - rec_h[4]).max())
        print(f"{tier}: parameters max abs difference {p_err:.2e} (atol 1e-4), ep_reward "
              f"{r_err:.2e} (atol 1e-3 on sums up to {np.abs(rec_h[2]).max():.2f}), mean_reward "
              f"{m_err:.2e} (atol 1e-4); finished steps {np.flatnonzero(rec_h[0].any(axis=1)).tolist()}, "
              f"K1 launches {k1_c}")
        check(bool((rec_c[0] == rec_h[0]).all() and (rec_c[1] == rec_h[1]).all()
                   and rec_h[0, 14].all() and rec_h[0].sum() == n_small),
              f"card and CPU train chunks finish episodes at different steps ({tier})")
        check(np.isfinite(rec_c).all() and p_err <= 1e-4 and r_err <= 1e-3 and m_err <= 1e-4,
              f"card and CPU train chunks disagree ({tier})")
        check(int(ts_c.ep_count) == int(ts_h.ep_count) == n_small
              and ts_c.replay.size == ts_h.replay.size == steps_small * n_small * KS22.n_actuators,
              f"card and CPU train chunks count differently ({tier})")

    ks_kernel.KS_CNAB2.launches = 0  # the training path starts here

    phase("== 15. training to a controller (sf tier, 256 envs, 3000 steps), then te=200 on CNAB2")
    setup = build_ks(dataclasses.replace(KS22, **SF_TIER), device=dev)
    agent = DDPGAgent(dataclasses.replace(setup.agent.cfg, capacity=1_000_000))
    pool = setup.random_init(torch.Generator().manual_seed(setup.seed), 32)  # the CLI's pool
    trainer = BatchedTrainer(setup.env, agent,
                             BatchedTrainerConfig(n_envs=256, batch_size=256, update_loops=1,
                                                  min_best_episode=setup.min_best_episode),
                             y0_pool=pool)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, hook, means = train_batched(trainer, total_steps=3000,
                                    generator=torch.Generator(device=dev).manual_seed(TRAIN_SEED),
                                    noise_decay_every=1000, noise_decay=0.5, chunk_len=TRAIN_CHUNK,
                                    eval_every=TRAIN_EVAL_EVERY, eval_steps=500)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    check(ks_kernel.KS_CNAB2.launches == 0, "the sf tier launched K1")
    run_dir = str(ROOT / "build" / "smoke_KS22_sf_lh")
    checkpoint.save(run_dir, None, hook, config_overrides=SF_TIER)
    trained = checkpoint.actor_from_jax(checkpoint.load_best_actor(run_dir)).to(dev)
    std = build_ks(KS22, device=dev)  # the standard fidelity env: CNAB2, K1
    t0 = time.perf_counter()
    yt = rollout(std.env, actor_policy(std.agent, trained), te=200.0, t_action=100.0)["y"]
    torch.cuda.synchronize()
    t_roll = time.perf_counter() - t0
    pre, post = float(np.abs(yt[900:1000]).mean()), float(np.abs(yt[-len(yt) // 10:]).mean())
    k1_rollout = ks_kernel.KS_CNAB2.launches
    print(json.dumps({"row": "KS22 sf-tier-trained controller, te=200 on the CNAB2 env",
                      "seed": TRAIN_SEED, "evals": [[s, r] for s, r in hook.evals],
                      "best_eval_step": hook.best_eval_step, "best_eval": hook.bestreward,
                      "episodes": hook.ep - 1, "train_seconds": t_train,
                      "train_env_steps_per_s": ts.total_env_steps / t_train,
                      "chunk_means_first_last": [float(means[0]), float(means[-1])],
                      "pre": pre, "post": post, "suppression": post / pre,
                      "rollout_seconds": t_roll, "K1_launches": k1_rollout, "card": card}))
    check(np.isfinite(means).all() and len(hook.evals) == 3000 // TRAIN_EVAL_EVERY
          and ts.total_env_steps == 3000 * 256
          and ts.replay.size == min(3000 * 256 * 8, ts.replay.capacity),
          "the training run is malformed")
    check(np.isfinite(yt).all() and yt.shape == (2000, KS22.nx) and k1_rollout == 2000,
          "the trained controller's rollout is malformed")
    check(post / pre < 0.05, f"trained controller's suppression {post / pre} not below 0.05")

    phase(f"== 16. training with K1 at full width ({N_ENVS} envs, learner batch {LEARNER_BATCH})")
    full = build_ks(KS22, device=dev)
    full_pool = full.random_init(torch.Generator().manual_seed(full.seed), 32)
    push = N_ENVS * KS22.n_actuators
    tr = BatchedTrainer(full.env, full.agent,
                        BatchedTrainerConfig(n_envs=N_ENVS, batch_size=LEARNER_BATCH), y0_pool=full_pool)
    before = ks_kernel.KS_CNAB2.launches
    torch.cuda.reset_peak_memory_stats()
    ts = tr.init(torch.Generator(device=dev).manual_seed(1))
    chunk_fn = tr.make_chunk_fn(TRAIN_CHUNK)
    ts, packed = chunk_fn(ts)  # warm-up
    torch.cuda.synchronize()
    # the train step reads nothing back inside a chunk: any synchronizing call raises
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        for _ in range(2):
            ts, packed = chunk_fn(ts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rate16 = 2 * TRAIN_CHUNK * N_ENVS / secs
    steps = 3 * TRAIN_CHUNK
    k1_steps = ks_kernel.KS_CNAB2.launches - before
    print(json.dumps({"slice": "KS22 CNAB2 batched training", "n_envs": N_ENVS,
                      "env_steps_per_s": rate16, "ms_per_train_step": 1e3 * secs / (2 * TRAIN_CHUNK),
                      "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                      "K1_launches": k1_steps, "train_steps": steps,
                      "replay_size": ts.replay.size, "replay_capacity": ts.replay.capacity,
                      "episodes": int(ts.ep_count), "card": card}))
    check(k1_steps == steps, f"K1 launched {k1_steps} times in {steps} train steps")
    check(bool(torch.isfinite(packed).all()), "full-width training records are not finite")
    check(ts.replay.size == min(steps * push, ts.replay.capacity) and ts.agent.update_step == steps
          and int(ts.ep_count) >= 2 * N_ENVS, "full-width training state is malformed")
    k1_train = ks_kernel.KS_CNAB2.launches  # the training path ends here
    reads = {}
    for kind, sparse in (("dense", False), ("sparse", True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            rec = consume_record_read(start_record_read(packed, sparse))
        reads[kind] = 1e2 * (time.perf_counter() - t0)
    print(f"record read of the {record_bytes(TRAIN_CHUNK, N_ENVS)} B plane, started and waited for at "
          f"once: dense {reads['dense']:.3f} ms, sparse {reads['sparse']:.3f} ms "
          f"({rec['finished'].shape[0]} finished step(s)); a chunk takes "
          f"{1e3 * TRAIN_CHUNK * N_ENVS / rate16:.0f} ms; {card}")

    phase("== 17. the bench unit (bench_torch.run_once): sf tier, 16384 envs, random_init")
    bench = bench_torch.run_once()
    print(json.dumps({"metric": bench_torch.METRIC, "value": bench, "unit": "env_steps/s",
                      "cnab2_value": rate16, "card": card}))
    check(np.isfinite(bench) and bench > 0, "the bench unit is malformed")

    phase("== 18. device time of 5 train steps by kernel group (torch.profiler)")
    for tier, s_ in (("cnab2", full), ("spectral-featurize", setup)):
        tr = BatchedTrainer(s_.env, s_.agent,
                            BatchedTrainerConfig(n_envs=N_ENVS, batch_size=LEARNER_BATCH),
                            random_init=s_.random_init)
        ts = tr.init(torch.Generator(device=dev).manual_seed(2))
        ts, _ = tr.make_chunk_fn(10)(ts)  # past the warmup and the learn gate
        five = tr.make_chunk_fn(5)
        for attempt in range(3):
            before = ks_kernel.KS_CNAB2.launches
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                five(ts)
                torch.cuda.synchronize()
                wall_us = 1e6 * (time.perf_counter() - t0)
            groups = profile_groups(prof)
            counted = ks_kernel.KS_CNAB2.launches - before
            seen = groups.get("K1", [0])[0]
            # a session can lose records (one K1 launch of five, once in PR 8's runs): the
            # library counts every launch, so a session that saw fewer is measured again
            if not groups or seen == counted:
                break
            print(f"the profiler saw {seen} of the {counted} launches of K1 the library counted; "
                  "profiling again")
        busy_us = sum(g[1] for g in groups.values())
        print(json.dumps({"profile": f"KS22 {tier} train step, {N_ENVS} envs, 5 steps, under the profiler",
                          "wall_us": wall_us, "device_busy_us": busy_us if groups else "not measured",
                          "idle_share": 1.0 - busy_us / wall_us if groups else "not measured",
                          "launches_per_train_step": sum(g[0] for g in groups.values()) / 5,
                          "sessions": attempt + 1,
                          "groups": {k: {"launches": v[0], "device_us": v[1]} for k, v in groups.items()}}))
        want = 5 if tier == "cnab2" else 0
        check(counted == want and (not groups or seen == want),
              f"the profiler saw {seen} and the library counted {counted} launches of K1 in 5 "
              f"{tier} train steps")
    return {"rollout": k1_rollout, "train_steps": k1_train - k1_rollout}


def fluid_energies(trainer, actor, n_steps: int) -> dict:
    """Phase 9's protocol: mean energy over the active steps, trained and
    with no action, from the preset's evaluation field; every step active."""
    import numpy as np

    energies = {}
    for label, t_act in (("trained", 0), ("no action", n_steps)):
        recs = trainer.make_eval_fn(n_steps, t_action_steps=t_act)(actor, trainer.eval_w0())
        check(recs["energy"].shape == (n_steps, 1) and bool(recs["active"].all()),
              f"fluid rollout ({label}) did not keep every step active")
        check(bool(np.isfinite(recs["energy"]).all() and np.isfinite(recs["reward_mean"]).all()),
              f"fluid rollout ({label}) is not finite")
        energies[label] = float(recs["energy"][recs["active"]].mean())
    return energies


def fluid_train_phases(card: str) -> int:
    """Phases 19-22: the fluid training path. Returns K2's launches on it
    (phases 20-21)."""
    from distributedconvrl_pde_control_torch.ops.kernels import ns_advection as k2

    fluid_chunk_vs_cpu()
    k2.NS_ADVECTION.launches = 0  # the fluid training path starts here
    fluid_train_to_controller(card)
    fluid_train_rate(card)
    k2_train = k2.NS_ADVECTION.launches  # the fluid training path ends here
    fluid_train_profile(card)
    return k2_train


def fluid_chunk_vs_cpu() -> None:
    """Phase 19: a small fluid train chunk, the card against the CPU."""
    import dataclasses

    import numpy as np
    import torch

    from distributedconvrl_pde_control_torch.configs.fluid import FLUID_16_256
    from distributedconvrl_pde_control_torch.models.mlp import chain_to_numpy
    from distributedconvrl_pde_control_torch.ops.kernels import ns_advection as k2
    from distributedconvrl_pde_control_torch.parallel.multichip import (
        ShardedFluidTrainer,
        ShardedTrainConfig,
    )
    from distributedconvrl_pde_control_torch.train.batched import StepDraws

    dev = "cuda"
    phase("== 19. the fluid train chunk on the card against the CPU (32x32, 2 envs, 20 steps)")
    small = dataclasses.replace(FLUID_16_256, nx=32, sensors_per_axis=4, te=0.3, start_steps=2,
                                update_after=4)  # episodes end at step 15, learning from step 3
    tcfg = ShardedTrainConfig(n_envs=2, batch_size=16, capacity_per_dp=4096)
    gen = torch.Generator().manual_seed(19)
    draws = [dict(noise=torch.randn((1, 32), generator=gen),
                  offs=torch.randint(0, (i + 1) * 32, (1, 16), generator=gen),
                  idx=torch.randint(0, tcfg.y0_pool_size, (2,), generator=gen)) for i in range(20)]
    outs = []
    for d in (dev, "cpu"):
        tr = ShardedFluidTrainer(small, (1, 1), tcfg, device=d)
        st = tr.init(torch.Generator().manual_seed(20), seed=21)  # same nets and pool on both
        before = k2.NS_ADVECTION.launches
        st, packed = tr.make_chunk_fn(20)(
            st, [StepDraws(**{k: v.to(d) for k, v in dr.items()}) for dr in draws])
        outs.append((st, packed.cpu().numpy(), k2.NS_ADVECTION.launches - before))
    (st_c, rec_c, k2_c), (st_h, rec_h, k2_h) = outs
    check(k2_h == 0 and k2_c == 20 * 4 * small.oversampling,
          f"K2 launches in the small fluid train chunk: card {k2_c}, CPU {k2_h}")
    p_err = max(float(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-3))
                for name in ("actor", "critic", "target_actor", "target_critic")
                for a, b in zip(chain_to_numpy(getattr(st_c.agent, name)),
                                chain_to_numpy(getattr(st_h.agent, name))) for k in ("w", "b"))
    r_err = float(np.abs(rec_c[2] - rec_h[2]).max())
    m_err = float(np.abs(rec_c[4] - rec_h[4]).max())
    print(f"parameters max rel difference {p_err:.2e} (rtol 1e-4 of each tensor's max), ep_reward "
          f"{r_err:.2e} (atol 1e-3 on sums up to {np.abs(rec_h[2]).max():.3f}), mean_reward {m_err:.2e} "
          f"(atol 1e-4); finished steps {np.flatnonzero(rec_h[0].any(axis=1)).tolist()}, K2 launches "
          f"{k2_c}; optimizer steps {st_h.agent.opt_actor.state[st_h.agent.actor.w[0]]['step']:.0f}")
    check(bool((rec_c[0] == rec_h[0]).all() and (rec_c[1] == rec_h[1]).all() and rec_h[0, 14].all()
               and rec_h[0].sum() == 2), "card and CPU fluid train chunks finish at different steps")
    check(np.isfinite(rec_c).all() and p_err <= 1e-4 and r_err <= 1e-3 and m_err <= 1e-4,
          "card and CPU fluid train chunks disagree")
    check(int(st_c.ep_count) == int(st_h.ep_count) == 2 and st_c.replay.size == st_h.replay.size == 640,
          "card and CPU fluid train chunks count differently")


def fluid_train_to_controller(card: str) -> None:
    """Phase 20: the Fluid_16_256 recipe through the CLI, then its controller
    on phase 9's protocol."""
    import shutil

    import numpy as np
    import torch

    from distributedconvrl_pde_control_torch.configs.fluid import FLUID_16_256
    from distributedconvrl_pde_control_torch.experiments import run
    from distributedconvrl_pde_control_torch.ops.kernels import ns_advection as k2
    from distributedconvrl_pde_control_torch.parallel.multichip import (
        ShardedFluidTrainer,
        ShardedTrainConfig,
        load_actor_for_eval,
        load_sharded,
    )

    dev = "cuda"
    loops, no_steps, chunk = FLUID_TRAIN_LOOPS, FLUID_16_256.no_steps, FLUID_TRAIN_CHUNK
    # a loop runs whole chunks: 580 steps are 24 chunks of 25, 600 steps, as in the JAX package
    train_steps = loops * chunk * -(-no_steps // chunk)
    phase(f"== 20. training a fluid controller: Fluid_16_256, 1 env, {loops} loops x {no_steps} steps "
          f"in chunks of {chunk} through the CLI, then te=2 on the protocol of phase 9")
    run_dir = str(ROOT / "build" / "smoke_Fluid_16_256")
    shutil.rmtree(run_dir, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run.main(["Fluid_16_256", "--train", "--mesh", "1x1", "--seed", str(FLUID_TRAIN_SEED),
              "--loops", str(loops), "--out", run_dir])
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    ftr = ShardedFluidTrainer(FLUID_16_256, (1, 1), ShardedTrainConfig(n_envs=1), device=dev)
    agent_state, hook = load_sharded(run_dir, ftr)
    actor = load_actor_for_eval(run_dir, ftr)
    n_steps = int(round(FLUID_P_TE / FLUID_16_256.dt))
    t0 = time.perf_counter()
    energies = fluid_energies(ftr, actor, n_steps)
    t_eval = time.perf_counter() - t0
    k2_train_run = k2.NS_ADVECTION.launches
    print(json.dumps({"row": f"Fluid_16_256 controller trained by the port (1 env, {train_steps} "
                      "steps), te=2 on the 2/3-rule solver", "seed": FLUID_TRAIN_SEED,
                      "train_seconds": t_train,
                      "train_env_steps_per_s": train_steps / t_train,
                      "ms_per_train_step": 1e3 * t_train / train_steps, "episodes": hook.ep - 1,
                      "best_episode": hook.bestepisode, "best_reward": hook.bestreward,
                      "evals": getattr(hook, "evals", []), **energies,
                      "ratio": energies["trained"] / energies["no action"],
                      "eval_seconds": t_eval, "K2_launches": k2_train_run, "card": card}))
    check(agent_state.update_step == train_steps and hook.ep - 1 >= train_steps // 300 > 0
          and np.isfinite(hook.bestreward), "the fluid training run is malformed")
    check(k2_train_run == 4 * FLUID_16_256.oversampling * (train_steps + 2 * n_steps),
          f"K2 launched {k2_train_run} times in {train_steps} train steps and two rollouts")
    check(energies["trained"] < 0.7 * energies["no action"],
          f"the port-trained controller's energy {energies['trained']} is not below 0.7 of no "
          f"action {energies['no action']}")


def fluid_train_rate(card: str) -> None:
    """Phase 21: fluid training throughput at 16 envs, nothing read back
    inside a chunk."""
    import torch

    from distributedconvrl_pde_control_torch.configs.fluid import FLUID_16_256
    from distributedconvrl_pde_control_torch.ops.kernels import ns_advection as k2
    from distributedconvrl_pde_control_torch.parallel.multichip import (
        ShardedFluidTrainer,
        ShardedTrainConfig,
    )

    dev = "cuda"
    phase(f"== 21. fluid training at {FLUID_TRAIN_ENVS} envs, learner batch {FLUID_TRAIN_BATCH}")
    btr = ShardedFluidTrainer(FLUID_16_256, (1, 1), ShardedTrainConfig(
        n_envs=FLUID_TRAIN_ENVS, batch_size=FLUID_TRAIN_BATCH), device=dev)
    chunk_len = btr.tcfg.chunk_len
    before = k2.NS_ADVECTION.launches
    torch.cuda.reset_peak_memory_stats()
    st = btr.init(torch.Generator(device=dev).manual_seed(1), seed=FLUID_16_256.seed)
    chunk_fn = btr.make_chunk_fn(chunk_len)
    st, packed = chunk_fn(st)  # warm-up
    torch.cuda.synchronize()
    # the train step reads nothing back inside a chunk: any synchronizing call raises
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        for _ in range(2):
            st, packed = chunk_fn(st)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rate = 2 * chunk_len * FLUID_TRAIN_ENVS / secs
    steps = 3 * chunk_len
    k2_steps = k2.NS_ADVECTION.launches - before
    push = FLUID_TRAIN_ENVS * btr.n_act
    print(json.dumps({"slice": "Fluid_16_256 training", "n_envs": FLUID_TRAIN_ENVS,
                      "env_steps_per_s": rate, "ms_per_train_step": 1e3 * secs / (2 * chunk_len),
                      "peak_mem_bytes": torch.cuda.max_memory_allocated(), "K2_launches": k2_steps,
                      "train_steps": steps, "replay_size": st.replay.size,
                      "replay_capacity": st.replay.capacity, "episodes": int(st.ep_count),
                      "card": card}))
    check(k2_steps == 4 * FLUID_16_256.oversampling * steps,
          f"K2 launched {k2_steps} times in {steps} train steps")
    check(bool(torch.isfinite(packed).all()), "fluid training records are not finite")
    check(st.replay.size == min(steps * push, st.replay.capacity) and st.agent.update_step == steps
          and st.global_step == steps, "fluid training state is malformed")


def fluid_train_profile(card: str) -> None:
    """Phase 22: the device time of one fluid train step by kernel group."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributedconvrl_pde_control_torch.configs.fluid import FLUID_16_256
    from distributedconvrl_pde_control_torch.ops.kernels import ns_advection as k2
    from distributedconvrl_pde_control_torch.parallel.multichip import (
        ShardedFluidTrainer,
        ShardedTrainConfig,
    )

    dev = "cuda"
    phase("== 22. device time of one fluid train step by kernel group (torch.profiler)")
    for n_envs in (1, FLUID_TRAIN_ENVS):
        tr = ShardedFluidTrainer(FLUID_16_256, (1, 1), ShardedTrainConfig(
            n_envs=n_envs, batch_size=FLUID_TRAIN_BATCH), device=dev)
        st = tr.init(torch.Generator(device=dev).manual_seed(2), seed=FLUID_16_256.seed)
        st, _ = tr.make_chunk_fn(12)(st)  # past the start policy and the learn gate
        three = tr.make_chunk_fn(3)
        counted = k2.NS_ADVECTION.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            three(st)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        counted = k2.NS_ADVECTION.launches - counted
        groups = profile_groups(prof)
        busy_us = sum(g[1] for g in groups.values())
        print(json.dumps({"profile": f"Fluid_16_256 train step, {n_envs} env(s), 3 steps under the "
                          "profiler, per step", "wall_us": wall_us / 3,
                          "device_busy_us": busy_us / 3 if groups else "not measured",
                          "idle_share": 1.0 - busy_us / wall_us if groups else "not measured",
                          "launches_per_train_step": sum(g[0] for g in groups.values()) / 3,
                          "groups": {k: {"launches": v[0] / 3, "device_us": v[1] / 3}
                                     for k, v in groups.items()}, "card": card}))
        # the library counts every launch it makes; the profiler may drop activity
        # records at K2's launch rate (24 of 972 in one run), so its count is bounded
        seen = groups.get("K2", [0])[0]
        profiled = not groups or 0.9 * counted <= seen <= counted
        check(counted == 3 * 4 * FLUID_16_256.oversampling and profiled,
              f"the library counted {counted} launches of K2 in 3 train steps and the profiler saw "
              f"{seen}")


# ------------------------------------------------------------- the fidelity loop (23-28)
FIDELITY_SEED = 609  # phase 24: the KS22 preset's seed, the CLI's default
# The fidelity loop is host-bound at 51-116 ms per env step on the H100 machines
# (PERF.md), so phases 24-26 are cut in depth only, never in width: phase 24's KS22 recipe
# (RESULTS.md) from 8 loops of 800 steps to 2 of 400 (2 x 800 gave 0.077 on the card; 2 x
# 400 gave 0.083 on the CPU; the whole smoke took 849 s of its 1200 s before phases 40-44),
# phase 25's restart protocol to 10-step episodes (te=1), phase 26's mono training from
# 8 x 8000 steps to 400
FIDELITY_LOOPS, FIDELITY_STEPS = 2, 400
FIDELITY_LIMIT = 0.25  # phase 24: RESULTS.md's band for the recipe: 1.6 %-19 % on CPU seeds
RESUME_STEPS, MULTI_EPISODES, MULTI_TE = 100, 50, 1.0  # phase 25 (train_multi runs whole 50-episode rounds)
# phase 26, cut for room: 100 steps (from 400), the search's episodes 2 (from 5)
MONO_STEPS, HYPEROPT_TRIALS, HYPEROPT_EPISODES = 100, 2, 2
# phase 27: reproduce_torch.JAX_KS_ROWS holds the suppression of every KS row of reproduce.py
# as the JAX package gives it; limit per row: |port - JAX| <= max(0.1 JAX, 0.0005)


def fidelity_vs_cpu(card: str) -> None:
    """Phase 23: one KS22 fidelity episode with learning on the card against
    the port on the CPU, every draw made once on the CPU and passed to both."""
    import dataclasses

    import numpy as np
    import torch

    from distributedconvrl_pde_control_torch.agents.replay import replay_init
    from distributedconvrl_pde_control_torch.configs.ks import KS22, build_ks
    from distributedconvrl_pde_control_torch.models.mlp import chain_to_numpy, copy_chain
    from distributedconvrl_pde_control_torch.ops.kernels import ks_kernel
    from distributedconvrl_pde_control_torch.train.batched import StepDraws
    from distributedconvrl_pde_control_torch.train.loop import TrainState, make_episode_fn

    n_steps = 30  # te=3: the start policy to step 6, learning from step 12 (81 rows > 80)
    phase(f"== 23. one KS22 fidelity episode with learning ({n_steps} steps) on the card against "
          "the CPU (K1 against its plain twin inside the loop)")
    cfg = dataclasses.replace(KS22, te=0.1 * n_steps)
    cpu_setup = build_ks(cfg, device="cpu")
    acfg = cpu_setup.agent.cfg
    gen = torch.Generator().manual_seed(23)
    # step i learns from a replay of 8 i rows, excluding the newest 8
    draws = [StepDraws(noise=torch.randn((1, cfg.n_actuators), generator=gen),
                       offs=torch.randint(0, max(8 * i - 8, 1), (acfg.update_loops, acfg.batch_size),
                                          generator=gen))
             for i in range(n_steps)]
    y0 = cpu_setup.random_init(torch.Generator().manual_seed(24), 1)[0]
    seed_state = cpu_setup.agent.init_state(torch.Generator().manual_seed(25), "cpu")
    outs = []
    for d in ("cuda", "cpu"):
        s = build_ks(cfg, device=d)
        ts = TrainState(agent=s.agent.make_state(copy_chain(seed_state.actor).to(d),
                                                 copy_chain(seed_state.critic).to(d)),
                        replay=replay_init(acfg.capacity, acfg.ns, acfg.na_rows, d), generator=None)
        before = ks_kernel.KS_CNAB2.launches
        ts, res = make_episode_fn(s.env, s.agent, learning=True, record=True)(
            ts, y0.to(d), [StepDraws(noise=x.noise.to(d), offs=x.offs.to(d)) for x in draws])
        outs.append((ts, res, ks_kernel.KS_CNAB2.launches - before))
    (ts_c, res_c, k1_c), (ts_h, res_h, k1_h) = outs
    p_err = max(float(np.abs(a[k] - b[k]).max())
                for name in ("actor", "critic", "target_actor", "target_critic")
                for a, b in zip(chain_to_numpy(getattr(ts_c.agent, name)),
                                chain_to_numpy(getattr(ts_h.agent, name))) for k in ("w", "b"))
    r_c, r_h = float(res_c.reward_sum), float(res_h.reward_sum)
    y_err = float((res_c.y_trace.cpu() - res_h.y_trace).abs().max())
    print(json.dumps({"phase": 23, "steps": [res_c.steps, res_h.steps],
                      "reward_sum": [r_c, r_h], "reward_sum_abs_diff": abs(r_c - r_h),
                      "parameters_max_abs_diff": p_err, "y_trace_max_abs_diff": y_err,
                      "replay_size": [ts_c.replay.size, ts_h.replay.size],
                      "K1_launches": [k1_c, k1_h], "card": card}))
    check(k1_c == res_c.steps == n_steps and k1_h == 0,
          f"K1 launches in the fidelity episode: card {k1_c}, CPU {k1_h}")
    check(res_c.steps == res_h.steps and ts_c.replay.size == ts_h.replay.size == 8 * n_steps,
          "card and CPU fidelity episodes count differently")
    check(p_err <= 1e-4 and abs(r_c - r_h) <= 1e-4 and np.isfinite(r_c),
          "card and CPU fidelity episodes disagree")


def fidelity_child(out_json: str) -> int:
    """Phases 24-27 in a process of their own, which has run no profiler
    session (PERF.md section 7): the KS22 fidelity recipe through the CLI, its
    resume and restart protocols, the mono ablation with its search, and every
    KS row of reproduce.py. Writes K1's launches by path and the results to
    `out_json`."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch

    import reproduce_torch
    from distributedconvrl_pde_control_torch.configs.ks import (
        KS22,
        KS22_GLOBAL,
        build_ks,
        build_ks_global,
    )
    from distributedconvrl_pde_control_torch.experiments import run
    from distributedconvrl_pde_control_torch.ops.kernels import ks_kernel
    from distributedconvrl_pde_control_torch.train import checkpoint

    def cli(argv):
        """The CLI's output (also printed) and K1's launches in one run of it."""
        ks_kernel.KS_CNAB2.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run.main(argv)
        print(buf.getvalue(), end="", flush=True)
        return buf.getvalue(), ks_kernel.KS_CNAB2.launches

    card = card_line()
    dev = "cuda"
    setup = build_ks(KS22, device=dev)
    out = {"K1_launches_by_path": {}}
    k1 = out["K1_launches_by_path"]
    run_dir = str(ROOT / "build" / "smoke_KS22_fidelity")
    for d in (run_dir, run_dir + "_resumed", run_dir + "_multi", run_dir + "_mono"):
        shutil.rmtree(d, ignore_errors=True)

    phase(f"== 24. the KS22 fidelity recipe through the CLI: seed {FIDELITY_SEED}, "
          f"{FIDELITY_LOOPS} loops x {FIDELITY_STEPS} steps, 20 learner updates per env step")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, launches = cli(["KS22", "--train", "--seed", str(FIDELITY_SEED), "--loops",
                       str(FIDELITY_LOOPS), "--no-steps", str(FIDELITY_STEPS), "--out", run_dir])
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    ts, hook = checkpoint.load(run_dir, setup.agent, device=dev)
    env_steps = ts.replay.size // KS22.n_actuators
    ks_kernel.KS_CNAB2.launches = 0
    actor = checkpoint.actor_from_jax(hook.best_actor).to(dev)
    supp = reproduce_torch.suppression(setup, actor, 200.0, 100.0, ndigits=None)
    k1["fidelity training (phase 24)"] = launches
    k1["fidelity-trained controller's rollout (phase 24)"] = ks_kernel.KS_CNAB2.launches
    row = {"row": "KS22 controller trained by the port's fidelity loop, te=200",
           "seed": FIDELITY_SEED, "loops": FIDELITY_LOOPS, "no_steps": FIDELITY_STEPS,
           "train_seconds": t_train, "env_steps": env_steps,
           "env_steps_per_s": env_steps / t_train, "ms_per_env_step": 1e3 * t_train / env_steps,
           "episodes": hook.ep - 1, "best_episode": hook.bestepisode,
           "best_reward": hook.bestreward, **supp, "K1_launches": launches, "card": card}
    print(json.dumps(row))
    out["fidelity"] = row
    check(launches == env_steps >= FIDELITY_LOOPS * FIDELITY_STEPS and ts.replay.size < ts.replay.capacity,
          f"K1 launched {launches} times in {env_steps} env steps of the fidelity loop")
    check(np.isfinite(hook.rewards).all() and np.isfinite(hook.bestreward)
          and ks_kernel.KS_CNAB2.launches == 2000, "the fidelity training run is malformed")
    check(supp["suppression"] < FIDELITY_LIMIT,
          f"the fidelity-trained controller's suppression {supp['suppression']} is not below "
          f"{FIDELITY_LIMIT}")

    phase(f"== 25. --resume for 1 loop x {RESUME_STEPS} steps, then --train-multi "
          f"(1 experiment, {MULTI_EPISODES} episodes of te={MULTI_TE})")
    count0 = int(checkpoint.agent_state_dict(ts.agent)["opt_actor"]["0"]["count"])
    _, launches = cli(["KS22", "--train", "--resume", "--load-from", run_dir, "--out",
                       run_dir + "_resumed", "--loops", "1", "--no-steps", str(RESUME_STEPS)])
    ts2, hook2 = checkpoint.load(run_dir + "_resumed", setup.agent, device=dev)
    count2 = int(checkpoint.agent_state_dict(ts2.agent)["opt_actor"]["0"]["count"])
    steps2 = (ts2.replay.size - ts.replay.size) // KS22.n_actuators
    k1["resume (phase 25)"] = launches
    _, launches_multi = cli(["KS22", "--train-multi", "--n-experiments", "1", "--no-episodes",
                             str(MULTI_EPISODES), "--config-overrides",
                             json.dumps({"te": MULTI_TE}), "--out", run_dir + "_multi"])
    saves = sorted(p.name for p in (Path(run_dir + "_multi") / "saves").iterdir())
    ts3, hook3 = checkpoint.load(run_dir + "_multi", setup.agent, number=1, device=dev)
    k1["train-multi (phase 25)"] = launches_multi
    res25 = {"resume": {"episodes": [hook.ep - 1, hook2.ep - 1],
                        "replay_size": [ts.replay.size, ts2.replay.size],
                        "adam_count": [count0, count2], "update_step": ts2.agent.update_step,
                        "env_steps": steps2, "K1_launches": launches},
             "train_multi": {"saves": saves, "episodes": hook3.ep - 1,
                             "best_reward": hook3.bestreward, "replay_size": ts3.replay.size,
                             "K1_launches": launches_multi}, "card": card}
    print(json.dumps(res25))
    # every resumed step learns (the replay is far past the gate): 20 Adam steps each
    check(hook2.ep - 1 >= hook.ep - 1 + RESUME_STEPS // 50 and steps2 >= RESUME_STEPS
          and launches == steps2 and count2 == count0 + 20 * steps2 and ts2.agent.update_step == 0
          and hook2.rewards[:len(hook.rewards)] == hook.rewards,
          "--resume did not continue the saved run")
    check(saves == ["agent1.msgpack", "hook1.npz"] and hook3.ep - 1 == MULTI_EPISODES
          and launches_multi == ts3.replay.size // KS22.n_actuators
          and np.isfinite(hook3.rewards).all(), "--train-multi's numbered saves are malformed")

    phase(f"== 26. the KS mono ablation: 1 loop x {MONO_STEPS} steps of KS22_global --train, "
          f"--hyperopt {HYPEROPT_TRIALS} (the shipped KS22_global actors: phase 27)")
    res26 = {"card": card}
    _, launches = cli(["KS22_global", "--train", "--loops", "1", "--no-steps", str(MONO_STEPS),
                       "--out", run_dir + "_mono"])
    mono = build_ks_global(KS22_GLOBAL, device=dev)
    ts4, hook4 = checkpoint.load(run_dir + "_mono", mono.agent, device=dev)
    k1["mono training (phase 26)"] = launches
    res26["train"] = {"env_steps": ts4.replay.size, "episodes": hook4.ep - 1,
                      "best_reward": hook4.bestreward, "K1_launches": launches}
    check(launches == ts4.replay.size >= MONO_STEPS and np.isfinite(hook4.rewards).all()
          and all(bool(torch.isfinite(p).all()) for p in ts4.agent.actor.parameters()),
          "the mono training run is malformed")
    text, launches = cli(["KS22_global", "--hyperopt", str(HYPEROPT_TRIALS), "--hyperopt-episodes",
                          str(HYPEROPT_EPISODES)])
    trials = [json.loads(line) for line in text.strip().splitlines() if line.startswith("{")]
    k1["hyperopt (phase 26)"] = launches
    res26["hyperopt"] = {"costs": [t["cost"] for t in trials[:HYPEROPT_TRIALS]],
                         "best_trial": trials[-1]["best_trial"], "K1_launches": launches}
    check(len(trials) == HYPEROPT_TRIALS + 1
          and all(t["cost"] is not None and "error" not in t for t in trials[:HYPEROPT_TRIALS])
          and 0 < launches <= HYPEROPT_TRIALS * HYPEROPT_EPISODES * 50
          and trials[-1]["best_cost"] == min(t["cost"] for t in trials[:HYPEROPT_TRIALS])
          == trials[trials[-1]["best_trial"]]["cost"],
          "the hyperopt search is malformed or did not select its cheapest trial")
    print(json.dumps(res26))

    phase("== 27. reproduce_torch.py on the card: every KS row of reproduce.py beside the JAX "
          "package's value")
    ks_kernel.KS_CNAB2.launches = 0
    rows, t0 = [], time.perf_counter()
    for name, s, a in reproduce_torch.ks_rows(dev):
        got = reproduce_torch.suppression(s, a, 200.0, 100.0, ndigits=None)
        want = reproduce_torch.JAX_KS_ROWS[name]
        limit = max(0.1 * want, 0.0005)
        rows.append({"row": name, **got, "jax": want, "abs_diff": abs(got["suppression"] - want),
                     "limit": limit})
        print(json.dumps(rows[-1]))
    t_rows = time.perf_counter() - t0
    k1["reproduce rows (phase 27)"] = ks_kernel.KS_CNAB2.launches
    print(json.dumps({"rows": len(rows), "seconds": t_rows,
                      "K1_launches": ks_kernel.KS_CNAB2.launches, "card": card}))
    out["rows"] = rows
    check([r["row"] for r in rows] == list(reproduce_torch.JAX_KS_ROWS) and ks_kernel.KS_CNAB2.launches == 2000 * len(rows),
          "reproduce_torch.py did not run every KS row once")
    bad = [r["row"] for r in rows if not r["abs_diff"] <= r["limit"]]
    check(not bad, f"rows off their JAX value: {bad}")
    out.update(phase25=res25, phase26=res26)
    Path(out_json).write_text(json.dumps(out))
    return 0


def fidelity_profile(card: str) -> None:
    """Phase 28: the device time of 5 fidelity env steps with learning by
    kernel group, launches per env step and the device's idle share."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributedconvrl_pde_control_torch.configs.ks import KS22, build_ks
    from distributedconvrl_pde_control_torch.train.loop import init_train_state, make_episode_fn

    phase("== 28. device time of 5 KS22 fidelity env steps with learning by kernel group "
          "(torch.profiler)")
    setup = build_ks(KS22, device="cuda")
    ts = init_train_state(setup.env, setup.agent, torch.Generator(device="cuda").manual_seed(28))
    ts, _ = make_episode_fn(setup.env, setup.agent, max_steps=15)(ts)  # past the learn gate
    five = make_episode_fn(setup.env, setup.agent, max_steps=5)
    ts, _ = five(ts)  # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, res = five(ts)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    groups = profile_groups(prof)
    busy_us = sum(g[1] for g in groups.values())
    k1 = groups.get("K1", [0, 0.0])
    print(json.dumps({"profile": "KS22 fidelity env step with 20 learner updates, 1 env, 5 steps "
                      "under the profiler, per step", "wall_us": wall_us / 5,
                      "device_busy_us": busy_us / 5 if groups else "not measured",
                      "idle_share": 1.0 - busy_us / wall_us if groups else "not measured",
                      "launches_per_env_step": sum(g[0] for g in groups.values()) / 5,
                      "K1_share_of_device_time": k1[1] / busy_us if groups else "not measured",
                      "groups": {k: {"launches": v[0] / 5, "device_us": v[1] / 5}
                                 for k, v in groups.items()}, "card": card}))
    check(res.steps == 5 and (not groups or k1[0] == 5),
          f"the profiler saw {k1[0]} launches of K1 in 5 fidelity env steps")


def fidelity_phases(card: str) -> dict:
    """Phases 23-28. Returns K1's launches on the fidelity paths (phases 24-27)."""
    fidelity_vs_cpu(card)
    phase("-- phases 24-27 in a process of their own")
    out_json = ROOT / "build" / "smoke_fidelity.json"
    out_json.unlink(missing_ok=True)
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--fidelity-child",
                           str(out_json)], cwd=str(ROOT), timeout=900)
    check(proc.returncode == 0 and out_json.exists(),
          f"phases 24-27 failed in their process (exit {proc.returncode})")
    fidelity_profile(card)
    return json.loads(out_json.read_text())["K1_launches_by_path"]


# ------------------------------------------ the fluid env and Keller-Segel (29-33)
FAMILY_TOY = dict(nx=32, sensors_per_axis=4)  # phase 29: card against the CPU
FLUID_STEPPERS = {  # phase 29: (label, FluidConfig overrides)
    "adaptive": dict(adaptive=True),
    "rk4": dict(adaptive=False, stepper="rk4"),
    "ifrk4": dict(adaptive=False, stepper="ifrk4"),
    "adaptive, |omega| channel and energy term": dict(adaptive=True, abs_sensor_channel=True,
                                                      energy_reward_weight=0.05),
}
# phase 32: the CLI's training paths at full width, cut in depth only (te shortened so that
# one episode is the loop's step budget; the searches' episodes likewise)
FLUID_TRAIN_TE, FLUID_TRAIN_STEPS = 1.0, 50  # Fluid_8 --train: 1 loop, one 50-step episode
# Fluid_8 --train --batched: 3 chunks of 20, 20-step episodes (te 0.4), so that episodes end
FLUID_BATCHED_ENVS, FLUID_BATCHED_STEPS, FLUID_BATCHED_TE = 16, 60, 0.4
# KellerSegel10_16_fast --train: one 100-step episode (cut from 500)
KSS_TRAIN_TE, KSS_TRAIN_STEPS = 0.6, 100
# --train --batched: 4 chunks of 50, 100-step episodes (te 0.6)
KSS_BATCHED_ENVS, KSS_BATCHED_STEPS, KSS_BATCHED_TE = 64, 200, 0.6
KSS_HYPEROPT_TE = 0.3  # --hyperopt 2 --hyperopt-episodes 2: 50-step episodes


def _rel(got, want) -> float:
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).abs().max() / want.abs().max())


def fluid_env_vs_cpu(card: str) -> None:
    """Phase 29: the 3/2-rule fluid env on the card against the port on the
    CPU on each stepper; per-env trial counts of the adaptive one."""
    import dataclasses

    import numpy as np
    import torch

    from distributedconvrl_pde_control_torch.configs.fluid import FLUID_8, build_fluid
    from distributedconvrl_pde_control_torch.ops.navier_stokes import initial_condition

    phase("== 29. the 3/2-rule fluid env (32x32, 4x4 actuators, 2 envs from different fields, "
          "6 steps, actuation from step 2) on the card against the CPU")
    rng = np.random.default_rng(29)
    y0 = torch.tensor(np.stack([np.fft.ifft2(initial_condition(4, 32, 32, 1.0, 1.0, rng)).real
                                for _ in range(2)]).astype(np.float32))
    actions = torch.rand((6, 2, 1, 16), generator=torch.Generator().manual_seed(29)) * 2 - 1
    actions[:2] = 0.0
    for label, over in FLUID_STEPPERS.items():
        cfg = dataclasses.replace(FLUID_8, **FAMILY_TOY, **over)
        setups = {d: build_fluid(cfg, device=d) for d in ("cuda", "cpu")}
        states = {d: s.env.reset(y0.to(d)) for d, s in setups.items()}
        errs, trials = {"y": 0.0, "obs": 0.0, "reward": 0.0}, {"cuda": [], "cpu": []}
        for i in range(6):
            for d, s in setups.items():
                states[d] = s.env.step(states[d], actions[i].to(d))
                if cfg.adaptive:
                    trials[d].append(s.env.step_fn.last_trials.tolist())
            for k in errs:
                errs[k] = max(errs[k], _rel(getattr(states["cuda"], k), getattr(states["cpu"], k)))
        row = {"phase": 29, "stepper": label, "max_rel_diff": errs, "card": card}
        if cfg.adaptive:
            row["trials_per_env_step"] = trials["cuda"]
        print(json.dumps(row))
        check(all(v <= 1e-4 for v in errs.values())
              and bool(torch.isfinite(states["cuda"].y).all()) and not states["cuda"].done.any(),
              f"the fluid env on the card disagrees with the CPU ({label}): {errs}")
        check(trials["cuda"] == trials["cpu"],
              f"the adaptive stepper's trial counts differ between card and CPU ({label})")


def keller_segel_vs_cpu(card: str) -> None:
    """Phase 30: the Keller-Segel env on the card against the CPU, and the
    step's CUDA graph against its eager launches on the card."""
    import torch

    from distributedconvrl_pde_control_torch.configs.keller_segel import (
        KELLER_SEGEL_10_16_FAST as cfg,
        build_keller_segel,
    )
    from distributedconvrl_pde_control_torch.ops.keller_segel import KellerSegelSolver

    phase("== 30. the Keller-Segel env (4 envs, 20 steps) on the card against the CPU; the step's "
          "CUDA graph against its eager launches")
    setups = {d: build_keller_segel(cfg, device=d) for d in ("cuda", "cpu")}
    y0 = setups["cpu"].random_init(torch.Generator().manual_seed(30), 4)
    actions = torch.rand((20, 4, 1, 16), generator=torch.Generator().manual_seed(31)) * 2 - 1
    states = {d: s.env.reset(y0.to(d)) for d, s in setups.items()}
    solver = KellerSegelSolver(nx=cfg.nx, lx=cfg.lx)
    graph_err, errs = 0.0, {"y": 0.0, "obs": 0.0, "reward": 0.0}
    for i in range(20):
        y, forcing = states["cuda"].y, setups["cuda"].env.prepare_action(actions[i].cuda())
        graph_err = max(graph_err, _rel(solver.step(y, forcing, cfg.dt, cfg.oversampling),
                                        solver.step_eager(y, forcing, cfg.dt, cfg.oversampling)))
        for d, s in setups.items():
            states[d] = s.env.step(states[d], actions[i].to(d))
        for k in errs:
            errs[k] = max(errs[k], _rel(getattr(states["cuda"], k), getattr(states["cpu"], k)))
    moved = float((states["cpu"].y - y0).abs().max())
    print(json.dumps({"phase": 30, "graph_vs_eager_max_rel": graph_err,
                      "card_vs_cpu_max_rel": errs, "field_moved_by": moved,
                      "graphs": len(solver.graphs), "card": card}))
    check(graph_err <= 1e-6, f"the Keller-Segel graph disagrees with the eager step: {graph_err}")
    check(all(v <= 1e-4 for v in errs.values()) and moved > 1e-2 and len(solver.graphs) == 1,
          f"the Keller-Segel env on the card disagrees with the CPU: {errs}")


def families_child(out_json: str) -> int:
    """Phases 31-32 in a process of their own, which has run no profiler
    session: the Keller-Segel and fluid rows of reproduce.py, and the new
    training entry points through the CLI."""
    import contextlib
    import dataclasses
    import io
    import shutil

    import numpy as np
    import torch

    import reproduce_torch
    from distributedconvrl_pde_control_torch.configs import fluid as F
    from distributedconvrl_pde_control_torch.configs import keller_segel as K
    from distributedconvrl_pde_control_torch.experiments import run
    from distributedconvrl_pde_control_torch.train import checkpoint

    card = card_line()
    out = {}

    phase("== 31. reproduce_torch.py on the card: the five Keller-Segel DDPG rows, then the "
          "fluid energy rows, each beside the JAX package's value")
    rows = []
    for name, setup, actor in reproduce_torch.keller_segel_rows("cuda"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = reproduce_torch.regulation(setup, actor, ndigits=None)
        secs = time.perf_counter() - t0
        want = reproduce_torch.JAX_KELLER_SEGEL_ROWS[name]
        steps = int(round(reproduce_torch.KELLER_SEGEL_TE / setup.env.dt))
        rows.append({"row": name, **got, "jax": want,
                     "ok": reproduce_torch.keller_segel_ok(got, want), "seconds": secs,
                     "ms_per_env_step": 1e3 * secs / steps})
        print(json.dumps(rows[-1]), flush=True)
    for name, setup, actor in reproduce_torch.fluid_rows("cuda"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = reproduce_torch.fluid_energies(setup, actor, ndigits=None)
        secs = time.perf_counter() - t0
        want = reproduce_torch.JAX_FLUID_ROWS[name]
        steps = 3 * int(round(reproduce_torch.FLUID_TE / setup.env.dt))
        rows.append({"row": name, **got, "jax": want, "ok": reproduce_torch.fluid_ok(got, want),
                     "seconds": secs, "ms_per_env_step": 1e3 * secs / steps})
        print(json.dumps(rows[-1]), flush=True)
    out["rows"] = rows
    check([r["row"] for r in rows] == list(reproduce_torch.JAX_KELLER_SEGEL_ROWS)
          + list(reproduce_torch.JAX_FLUID_ROWS), "reproduce_torch.py did not run every row")
    bad = [r["row"] for r in rows if not r["ok"]]
    check(not bad, f"rows off their JAX value: {bad}")

    def cli(argv):
        """The CLI's output (also printed), its seconds and the peak memory of one run."""
        buf = io.StringIO()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            run.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(buf.getvalue(), end="", flush=True)
        return buf.getvalue(), secs, torch.cuda.max_memory_allocated()

    phase("== 32. the new training entry points through the CLI at full width, cut in depth: "
          f"Fluid_8 --train ({FLUID_TRAIN_STEPS} steps) and --batched ({FLUID_BATCHED_ENVS} "
          f"envs), KellerSegel10_16_fast --train ({KSS_TRAIN_STEPS} steps), --batched "
          f"({KSS_BATCHED_ENVS} envs) and --hyperopt 2")
    base = str(ROOT / "build" / "smoke_families")
    shutil.rmtree(base, ignore_errors=True)
    res32 = {}
    fluid_over = {"te": FLUID_TRAIN_TE}
    _, secs, mem = cli(["Fluid_8", "--train", "--loops", "1", "--no-steps", str(FLUID_TRAIN_STEPS),
                        "--config-overrides", json.dumps(fluid_over), "--out", base + "/fluid"])
    fsetup = F.build_fluid(dataclasses.replace(F.FLUID_8, **fluid_over), device="cuda")
    ts, hook = checkpoint.load(base + "/fluid", fsetup.agent, device="cuda")
    steps = ts.replay.size // fsetup.agent.cfg.n_actuators
    res32["Fluid_8 --train"] = {"env_steps": steps, "seconds": secs, "env_steps_per_s": steps / secs,
                                "peak_mem_bytes": mem, "episodes": hook.ep - 1,
                                "best_reward": hook.bestreward}
    check(steps == FLUID_TRAIN_STEPS and np.isfinite(hook.rewards).all()
          and all(bool(torch.isfinite(p).all()) for p in ts.agent.actor.parameters()),
          "Fluid_8 --train is malformed")
    text, secs, mem = cli(["Fluid_8", "--train", "--batched", "--n-envs", str(FLUID_BATCHED_ENVS),
                           "--total-steps", str(FLUID_BATCHED_STEPS), "--chunk-len", "20",
                           "--capacity", "200000", "--config-overrides",
                           json.dumps({"te": FLUID_BATCHED_TE}), "--out", base + "/fluid_batched"])
    n = FLUID_BATCHED_ENVS * FLUID_BATCHED_STEPS
    res32["Fluid_8 --train --batched"] = batched_result(text, base + "/fluid_batched",
                                                        fsetup.agent, n, secs, mem)
    kss_over = {"te": KSS_TRAIN_TE}
    _, secs, mem = cli(["KellerSegel10_16_fast", "--train", "--loops", "1", "--no-steps",
                        str(KSS_TRAIN_STEPS), "--config-overrides", json.dumps(kss_over),
                        "--out", base + "/kss"])
    ksetup = K.build_keller_segel(K.KELLER_SEGEL_10_16_FAST, device="cuda")
    ts, hook = checkpoint.load(base + "/kss", ksetup.agent, device="cuda")
    steps = ts.replay.size // 16
    res32["KellerSegel10_16_fast --train"] = {
        "env_steps": steps, "seconds": secs, "env_steps_per_s": steps / secs,
        "ms_per_env_step": 1e3 * secs / steps, "peak_mem_bytes": mem, "episodes": hook.ep - 1,
        "best_reward": hook.bestreward}
    check(steps == KSS_TRAIN_STEPS and np.isfinite(hook.rewards).all()
          and all(bool(torch.isfinite(p).all()) for p in ts.agent.actor.parameters()),
          "KellerSegel10_16_fast --train is malformed")
    text, secs, mem = cli(["KellerSegel10_16_fast", "--train", "--batched", "--n-envs",
                           str(KSS_BATCHED_ENVS), "--total-steps", str(KSS_BATCHED_STEPS),
                           "--capacity", "200000", "--config-overrides",
                           json.dumps({"te": KSS_BATCHED_TE}), "--out", base + "/kss_batched"])
    n = KSS_BATCHED_ENVS * KSS_BATCHED_STEPS
    res32["KellerSegel10_16_fast --train --batched"] = batched_result(
        text, base + "/kss_batched", ksetup.agent, n, secs, mem)
    text, secs, mem = cli(["KellerSegel10_16_fast", "--hyperopt", "2", "--hyperopt-episodes", "2",
                           "--config-overrides", json.dumps({"te": KSS_HYPEROPT_TE})])
    trials = [json.loads(line) for line in text.strip().splitlines() if line.startswith("{")]
    res32["KellerSegel10_16_fast --hyperopt 2"] = {
        "costs": [t["cost"] for t in trials[:2]], "seconds": secs, "peak_mem_bytes": mem}
    check(len(trials) == 3 and all(t["cost"] is not None and np.isfinite(t["cost"])
                                   and "error" not in t for t in trials[:2])
          and trials[-1]["best_cost"] == min(t["cost"] for t in trials[:2])
          == trials[trials[-1]["best_trial"]]["cost"],
          "the Keller-Segel hyperopt search is malformed or did not select its cheapest trial")
    res32["card"] = card
    print(json.dumps({"phase": 32, **res32}))
    out["phase32"] = res32
    Path(out_json).write_text(json.dumps(out))
    return 0


def batched_result(text: str, run_dir: str, agent, n: int, secs: float, mem: int) -> dict:
    """Phase 32's numbers of a `--train --batched` run, read back through its
    light checkpoint; fails unless it took `n` env steps, finished episodes
    and kept every reward and parameter finite."""
    import re

    import numpy as np
    import torch

    from distributedconvrl_pde_control_torch.train import checkpoint

    ts, hook = checkpoint.load(run_dir, agent, device="cuda")
    final = re.search(r"final chunk mean (\S+)$", text.strip())
    check(f"{n} env steps" in text and final is not None and np.isfinite(float(final.group(1)))
          and hook.ep > 1 and np.isfinite(hook.rewards).all()
          and all(bool(torch.isfinite(p).all()) for p in ts.agent.actor.parameters()),
          f"the batched run in {run_dir} is malformed")
    return {"env_steps": n, "seconds": secs, "env_steps_per_s": n / secs, "peak_mem_bytes": mem,
            "episodes": hook.ep - 1, "best_reward": hook.bestreward,
            "final_chunk_mean": float(final.group(1))}


def host_launches(prof) -> dict:
    """Launch calls the host made under a profiler, by runtime function."""
    counts = {}
    for e in prof.key_averages():
        if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cudaGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync"):
            counts[e.key] = counts.get(e.key, 0) + e.count
    return counts


def family_groups(prof) -> dict:
    """{group: [kernels, device us]} of the families' env steps, by kernel name."""
    import torch

    groups = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        low = e.key.lower()
        group = ("cuFFT" if "fft" in low or "regular_fft" in low or "vector_fft" in low else
                 "gather/scatter" if "index" in low or "gather" in low or "scatter" in low else
                 "matmul" if "gemm" in low or "gemv" in low else
                 "copies" if low.startswith("memcpy") or low.startswith("memset") else
                 "elementwise and other")
        g = groups.setdefault(group, [0, 0.0])
        g[0] += e.count
        g[1] += e.self_device_time_total
    return groups


def families_profile(card: str) -> None:
    """Phase 33: the device time of one adaptive Fluid_8 env step (128x128,
    1 env) and one Keller-Segel env step (1 env) by kernel group, the host's
    launches per env step, trials per env step and the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributedconvrl_pde_control_torch.configs.fluid import FLUID_8, build_fluid
    from distributedconvrl_pde_control_torch.configs.keller_segel import (
        KELLER_SEGEL_10_16_FAST,
        build_keller_segel,
    )

    phase("== 33. device time of one adaptive Fluid_8 env step and one Keller-Segel env step by "
          "kernel group (torch.profiler)")
    for label, setup in (("Fluid_8 (128x128, adaptive RK4, 1 env)", build_fluid(FLUID_8, "cuda")),
                         ("KellerSegel10_16_fast (1 env, 10 RK4 substeps in one graph)",
                          build_keller_segel(KELLER_SEGEL_10_16_FAST, "cuda"))):
        env = setup.env
        action = torch.rand((1,) + tuple(env.action_shape), generator=torch.Generator()
                            .manual_seed(33)).cuda() * 2 - 1
        state = env.reset()
        for _ in range(3):  # warm: plans, the graph's capture
            state = env.step(state, action)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = env.step(state, action)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        groups = family_groups(prof)
        busy_us = sum(g[1] for g in groups.values())
        launches = host_launches(prof)
        row = {"profile": label, "wall_us": wall_us,
               "device_busy_us": busy_us if groups else "not measured",
               "idle_share": 1.0 - busy_us / wall_us if groups else "not measured",
               "host_launches_per_env_step": sum(launches.values()), "host_launches": launches,
               "device_kernels_per_env_step": sum(g[0] for g in groups.values()),
               "groups": {k: {"kernels": v[0], "device_us": v[1]} for k, v in groups.items()},
               "card": card}
        trials = getattr(env.step_fn, "last_trials", None)
        if trials is not None:
            row["trials_per_env_step"] = int(trials[0])
        print(json.dumps(row))
        check(bool(torch.isfinite(state.y).all()), f"the profiled env step is not finite ({label})")


def families_phases(card: str) -> None:
    """Phases 29-33."""
    fluid_env_vs_cpu(card)
    keller_segel_vs_cpu(card)
    phase("-- phases 31-32 in a process of their own")
    out_json = ROOT / "build" / "smoke_families.json"
    out_json.unlink(missing_ok=True)
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--families-child",
                           str(out_json)], cwd=str(ROOT), timeout=900)
    check(proc.returncode == 0 and out_json.exists(),
          f"phases 31-32 failed in their process (exit {proc.returncode})")
    families_profile(card)


# ------------------------------------------------------ PPO and populations (34-39)
PPO_TOY = dict(rollout_len=8, n_microbatches=4, n_epochs=2, learning_rate=3e-4)  # phase 34
# phase 35: the JAX package's values of the shipped PPO controllers: its `rollout` of each
# checkpoint's best params (the clipped mean action), as its CLI's `--eval --ppo` runs them, on
# the CPU (JAX 0.9.0, threefry keys). KS22: suppression at te=200 from actuation at t=100;
# Fluid_8: the mean energies at te=3 from t=0 (the protocol of RESULTS.md:436,439). Limits: KS
# within max(0.1 JAX, 0.0005), fluid within 2 %.
JAX_PPO_KS_ROWS = {"KS22_ppo": 0.009633589, "KS22_ppo_ref": 0.002444129,
                   "KS22_ppo_lh": 0.003433320, "KS22_ppo_ref_lh": 0.002444111}
JAX_PPO_FLUID_ROWS = {"Fluid_8_ppo": {"mean_energy": 7.433293, "no_action": 7.772954},
                      "Fluid_8_ppo_lh": {"mean_energy": 7.319664, "no_action": 7.772954}}
PPO_FLUID_TE = 3.0
# phase 36: the KS22_ppo_lh recipe (RESULTS.md: tuned config, 60 iterations, 8 envs, a 500-step
# eval every 5 iterations picks the best params), in full; the other families cut in depth
PPO_ITERS, PPO_EVAL_EVERY, PPO_EVAL_STEPS = 60, 5, 500
PPO_CUT = {"KellerSegel10_16_fast": ({"te": 0.6}, 3), "Fluid_8": ({"te": 1.0}, 2)}
PPO_LIMIT = 0.05  # phase 36: RESULTS.md gives 0.34 % for the artifact
POP_TOY_LRS, POP_TOY_NOISE = ([5e-4, 2e-3], [1e-3, 4e-3]), [0.4, 1.5]  # phase 37
POP_MEMBERS, POP_ENVS = 8, 256  # phases 38-39: the KS22_tp_pop8 study's width (RESULTS.md:32)
POP_LIMIT = 0.05  # phase 38: the median member; the JAX study gave 0.24-0.85 %
POP_SEARCH_STEPS, KSS_POP_ENVS, KSS_POP_STEPS, KSS_POP_TE = 200, 64, 200, 0.6  # phase 38, cut


def ppo_pair(devices=("cuda", "cpu")) -> dict:
    """Phase 34: one `collect_and_update` iteration of PPO on KS22 (2 envs,
    episodes of 5 steps inside the rollout of 8, 2 epochs x 4 microbatches)
    on each device from the same networks and the same draws, made once on
    the CPU. Returns the largest parameter difference of each tensor relative
    to its largest value, the mean rewards' difference, and K1's launches."""
    import dataclasses

    import numpy as np
    import torch

    from distributedconvrl_pde_control_torch.agents.ppo import (
        PPOAgent,
        PPOConfig,
        PPODraws,
        PPOTrainer,
        params_from_numpy,
        params_to_numpy,
    )
    from distributedconvrl_pde_control_torch.configs.ks import KS22, build_ks
    from distributedconvrl_pde_control_torch.ops.kernels import ks_kernel

    cfg = dataclasses.replace(KS22, te=0.5)
    n_envs, b, t = 2, 2 * KS22.n_actuators, PPO_TOY["rollout_len"]
    cpu = build_ks(cfg, device="cpu")
    agent = PPOAgent(PPOConfig(ns=cpu.agent.cfg.ns, na=1, **PPO_TOY))
    gen = torch.Generator().manual_seed(34)
    draws = PPODraws(y0s=cpu.random_init(gen, n_envs), eps=torch.randn((t, 1, b), generator=gen),
                     fresh=torch.stack([cpu.random_init(gen, n_envs) for _ in range(t)]),
                     perms=torch.argsort(torch.rand((PPO_TOY["n_epochs"], t * b), generator=gen)))
    params0 = params_to_numpy(agent._params(agent.init_state(torch.Generator().manual_seed(35),
                                                             "cpu")))
    outs = []
    for d in devices:
        setup = build_ks(cfg, device=d)
        trainer = PPOTrainer(setup.env, agent, n_envs=n_envs, random_init=setup.random_init)
        state = agent.make_state(params_from_numpy(params0, d))
        before = ks_kernel.KS_CNAB2.launches
        state, mean_r = trainer.make_train_iter()(
            state, torch.Generator().manual_seed(0),
            PPODraws(**{k: getattr(draws, k).to(d) for k in ("y0s", "eps", "fresh", "perms")}))
        outs.append((params_to_numpy(agent._params(state)), float(mean_r),
                     ks_kernel.KS_CNAB2.launches - before))
    (pa, ra, ka), (pb, rb, kb) = outs
    p_err = max(float(np.abs(x[k] - y[k]).max() / max(np.abs(y[k]).max(), 1e-30))
                for name in pa for x, y in zip(pa[name], pb[name]) for k in ("w", "b"))
    moved = max(float(np.abs(x["w"] - y["w"]).max()) for x, y in zip(pb["trunk"], params0["trunk"]))
    return {"params_max_err_of_scale": p_err, "mean_reward": [ra, rb],
            "mean_reward_err": abs(ra - rb), "K1_launches": [ka, kb], "env_steps": t,
            "trunk_moved": moved}


def population_pair(over: dict, devices=("cuda", "cpu")) -> dict:
    """Phase 37: one P=2 chunk of the fused population train step (4 envs per
    member, per-member learning rates and act_noise, 20 steps, learning from
    step 3, episodes ending at step 15) on each device from the same networks
    and the same draws, made once on the CPU; phase 14's measures."""
    import dataclasses

    import numpy as np
    import torch

    from distributedconvrl_pde_control_torch.configs.ks import KS22, build_ks
    from distributedconvrl_pde_control_torch.models.mlp import chain_to_numpy, copy_chain
    from distributedconvrl_pde_control_torch.ops.kernels import ks_kernel
    from distributedconvrl_pde_control_torch.train.batched import BatchedTrainerConfig, StepDraws
    from distributedconvrl_pde_control_torch.train.population import (
        PopulationTrainer,
        member_slot_indices,
    )

    p, n_envs, batch, n_pool, steps = 2, 4, 16, 6, 20
    block = n_envs * KS22.n_actuators
    gen = torch.Generator().manual_seed(37)
    draws = [dict(noise=torch.randn((1, p * block), generator=gen),
                  offs=member_slot_indices(gen, i + 1, p, block, batch)[None],
                  idx=torch.randint(0, n_pool, (p * n_envs,), generator=gen))
             for i in range(steps)]
    outs = []
    for d in devices:
        s = build_ks(dataclasses.replace(KS22, te=1.5, **over), device=d)
        pool = s.random_init(torch.Generator().manual_seed(15), n_pool)
        pop = PopulationTrainer(s.env, s.agent, BatchedTrainerConfig(n_envs=n_envs, batch_size=batch,
                                                                     min_best_episode=1),
                                p, y0_pool=pool, lr_actor=POP_TOY_LRS[0], lr_critic=POP_TOY_LRS[1])
        ts = pop.init(torch.Generator().manual_seed(16), idx=torch.arange(p * n_envs) % n_pool)
        seed_state = pop.agent.init_state(torch.Generator().manual_seed(17), "cpu")
        ts.agent = pop.agent.make_state(copy_chain(seed_state.actor).to(d),
                                        copy_chain(seed_state.critic).to(d))
        ts.agent.act_noise = torch.tensor(POP_TOY_NOISE, device=d)
        ts.best_actor = copy_chain(ts.agent.actor)
        before = ks_kernel.KS_CNAB2.launches
        ts, packed = pop.make_chunk_fn(steps)(
            ts, [StepDraws(**{k: v.to(d) for k, v in dr.items()}) for dr in draws])
        outs.append((ts, packed.cpu().numpy(), ks_kernel.KS_CNAB2.launches - before))
    (ts_a, rec_a, k_a), (ts_b, rec_b, k_b) = outs
    p_err = max(float(np.abs(x[k] - y[k]).max())
                for name in ("actor", "critic", "target_actor", "target_critic")
                for x, y in zip(chain_to_numpy(getattr(ts_a.agent, name)),
                                chain_to_numpy(getattr(ts_b.agent, name))) for k in ("w", "b"))
    return {"params_max_abs_err": p_err, "ep_reward_err": float(np.abs(rec_a[2] - rec_b[2]).max()),
            "mean_reward_err": float(np.abs(rec_a[4] - rec_b[4]).max()),
            "same_finishes": bool((rec_a[:2] == rec_b[:2]).all()),
            "finished": int(rec_b[0].sum()), "episodes": [int(ts_a.ep_count), int(ts_b.ep_count)],
            "adam_steps": [ts_a.agent.opt_actor.count, ts_b.agent.opt_actor.count],
            "finite": bool(np.isfinite(rec_a).all()), "K1_launches": [k_a, k_b], "steps": steps}


def ppo_controllers(card: str) -> int:
    """Phase 35: every shipped PPO controller on the card against the JAX
    package's value. Returns K1's launches on the KS rollouts."""
    import numpy as np
    import torch

    import reproduce_torch
    from distributedconvrl_pde_control_torch.agents.policies import ZeroPolicy
    from distributedconvrl_pde_control_torch.configs.fluid import FLUID_8, build_fluid
    from distributedconvrl_pde_control_torch.configs.ks import KS22, build_ks
    from distributedconvrl_pde_control_torch.experiments.run import suppression_of
    from distributedconvrl_pde_control_torch.ops.kernels import ks_kernel
    from distributedconvrl_pde_control_torch.train.eval import energy_eval, rollout

    phase("== 35. the shipped PPO controllers on the card: four KS22 (te=200, actuation from "
          "t=100), the Keller-Segel row of reproduce.py, two Fluid_8 (te=3)")
    setup = build_ks(KS22, device="cuda")
    bad = []
    ks_kernel.KS_CNAB2.launches = 0  # the PPO evaluation path starts here
    for name, want in JAX_PPO_KS_ROWS.items():
        policy = reproduce_torch.load_ppo_policy(setup, ROOT / "artifacts" / name, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = rollout(setup.env, policy, te=200.0, t_action=100.0)["y"]
        secs = time.perf_counter() - t0
        got = suppression_of(y, 100.0, setup.env.dt)["suppression"]
        ok = bool(np.isfinite(y).all()) and abs(got - want) <= max(0.1 * want, 0.0005)
        bad += [] if ok else [name]
        print(json.dumps({"row": f"{name} te=200", "suppression": got, "jax": want, "ok": ok,
                          "seconds": secs, "card": card}))
    k1 = ks_kernel.KS_CNAB2.launches  # the PPO evaluation path ends here
    check(k1 == 2000 * len(JAX_PPO_KS_ROWS), f"K1 launched {k1} times in the PPO rollouts")
    for row, kss, policy in reproduce_torch.ppo_rows("cuda"):
        got, want = reproduce_torch.ppo_regulation(kss, policy, ndigits=None), \
            reproduce_torch.JAX_PPO_ROWS[row]
        ok = reproduce_torch.keller_segel_ok(got, want)
        bad += [] if ok else [row]
        print(json.dumps({"row": row, **got, "jax": want, "ok": ok, "card": card}))
    fluid = build_fluid(FLUID_8, device="cuda")
    zero = energy_eval(fluid.env, ZeroPolicy(fluid.env.action_shape), te=PPO_FLUID_TE)
    for name, want in JAX_PPO_FLUID_ROWS.items():
        policy = reproduce_torch.load_ppo_policy(fluid, ROOT / "artifacts" / name, "cuda")
        tr = energy_eval(fluid.env, policy, te=PPO_FLUID_TE)
        got = {"mean_energy": tr["mean_energy"], "no_action": zero["mean_energy"]}
        ok = all(abs(got[k] - want[k]) <= 0.02 * want[k] for k in want)
        bad += [] if ok else [name]
        print(json.dumps({"row": f"{name} te={PPO_FLUID_TE:g}", **got,
                          "mean_step_reward": float(np.asarray(tr["reward"]).mean()), "jax": want,
                          "ok": ok, "card": card}))
    check(not bad, f"PPO controllers off their JAX value: {bad}")
    return k1


def agents_child(out_json: str) -> int:
    """Phases 36, 38 and 39's rates in a process of their own, which has run
    no profiler session: PPO and population training through the CLI, and
    the population's throughput against a solo run. Writes K1's launches by
    path and the results to `out_json`."""
    import contextlib
    import dataclasses
    import io
    import shutil

    import numpy as np
    import torch

    from distributedconvrl_pde_control_torch.agents.ppo import (
        PPOAgent,
        PPOTrainer,
        param_tensors,
        tuned_config,
    )
    from distributedconvrl_pde_control_torch.configs import keller_segel as K
    from distributedconvrl_pde_control_torch.configs.ks import KS22, build_ks
    from distributedconvrl_pde_control_torch.experiments import run
    from distributedconvrl_pde_control_torch.ops.kernels import ks_kernel
    from distributedconvrl_pde_control_torch.train import checkpoint
    from distributedconvrl_pde_control_torch.train.batched import (
        BatchedTrainer,
        BatchedTrainerConfig,
    )
    from distributedconvrl_pde_control_torch.train.population import PopulationTrainer

    card = card_line()
    out = {"K1_launches_by_path": {}}
    k1 = out["K1_launches_by_path"]
    base = str(ROOT / "build" / "smoke_agents")
    shutil.rmtree(base, ignore_errors=True)

    def cli(argv):
        """The CLI's output (also printed), its seconds, and K1's launches in it."""
        ks_kernel.KS_CNAB2.launches = 0
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            run.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(buf.getvalue(), end="", flush=True)
        return buf.getvalue(), secs, ks_kernel.KS_CNAB2.launches

    def last_json(text):
        return json.loads(text.strip().splitlines()[-1])

    def finite_ppo(run_dir, setup):
        acfg = setup.agent.cfg
        state, info = checkpoint.load_ppo(run_dir, PPOAgent(tuned_config(acfg.ns, acfg.na_rows)),
                                          device="cuda")
        return (bool(np.isfinite(info["rewards"]).all())
                and all(bool(torch.isfinite(t).all()) for t in param_tensors(
                    PPOAgent._params(state))), state, info)

    phase(f"== 36. PPO training through the CLI: the KS22_ppo_lh recipe ({PPO_ITERS} iterations, "
          f"8 envs, a {PPO_EVAL_STEPS}-step eval every {PPO_EVAL_EVERY}), then --eval at te=200; "
          "KellerSegel10_16_fast and Fluid_8 cut in depth")
    res36 = {}
    ks_dir = base + "/KS22_ppo_lh"
    _, secs, launches = cli(["KS22", "--train", "--ppo", "--iters", str(PPO_ITERS), "--eval-every",
                             str(PPO_EVAL_EVERY), "--eval-steps", str(PPO_EVAL_STEPS), "--out",
                             ks_dir])
    k1["PPO training (phase 36)"] = launches
    ks = build_ks(KS22, device="cuda")
    ok, _, info = finite_ppo(ks_dir, ks)
    text, _, launches = cli(["KS22", "--eval", "--ppo", "--load-from", ks_dir])
    k1["PPO-trained controller's rollout (phase 36)"] = launches
    supp = last_json(text)["suppression"]
    rollout_len, n_envs = tuned_config(1, 1).rollout_len, 8
    env_steps = PPO_ITERS * rollout_len * n_envs
    res36["KS22 --train --ppo"] = {
        "iters": PPO_ITERS, "seconds": secs, "ms_per_iteration_with_evals": 1e3 * secs / PPO_ITERS,
        "train_env_steps_per_s_with_evals": env_steps / secs, "best_iter": info["best_iter"],
        "evals": info["evals"], "suppression": supp, "K1_launches": k1["PPO training (phase 36)"]}
    check(ok and len(info["evals"]) == PPO_ITERS // PPO_EVAL_EVERY, "KS22 PPO training is malformed")
    check(k1["PPO-trained controller's rollout (phase 36)"] == 2000,
          "the PPO controller's rollout did not launch K1 once per step")
    # the iteration alone: the tuned config at 8 envs, no evals
    trainer = PPOTrainer(ks.env, PPOAgent(tuned_config(ks.agent.cfg.ns, 1)), n_envs=n_envs,
                         random_init=ks.random_init)
    gen = torch.Generator(device="cuda").manual_seed(36)
    state = trainer.agent.init_state(gen, "cuda")
    it = trainer.make_train_iter()
    state, r = it(state, gen)  # warm
    float(r)
    ks_kernel.KS_CNAB2.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        state, r = it(state, gen)
        float(r)
    secs = time.perf_counter() - t0
    res36["KS22 PPO iteration (tuned, 8 envs)"] = {
        "ms_per_iteration": 1e3 * secs / 5, "env_steps_per_s": 5 * rollout_len * n_envs / secs,
        "K1_launches_per_iteration": ks_kernel.KS_CNAB2.launches / 5}
    for preset, (over, iters) in PPO_CUT.items():
        run_dir = f"{base}/{preset}_ppo"
        _, secs, _ = cli([preset, "--train", "--ppo", "--iters", str(iters), "--config-overrides",
                          json.dumps(over), "--out", run_dir])
        cfg = run.fluid_config_for(preset) or K.PRESETS[preset]
        setup = run.build_setup(dataclasses.replace(cfg, **over), device="cuda")
        ok, _, info = finite_ppo(run_dir, setup)
        steps = iters * rollout_len * n_envs
        res36[f"{preset} --train --ppo"] = {"iters": iters, "seconds": secs,
                                            "ms_per_iteration": 1e3 * secs / iters,
                                            "env_steps_per_s": steps / secs,
                                            "rewards": info["rewards"].tolist()}
        check(ok and len(info["rewards"]) == iters, f"{preset} PPO training is malformed")
    res36["card"] = card
    print(json.dumps({"phase": 36, **res36}))
    check(supp < PPO_LIMIT, f"the PPO-trained KS22 controller's suppression {supp} is not below "
          f"{PPO_LIMIT}")
    out["phase36"] = res36

    phase(f"== 38. populations: a CNAB2 population at full width ({POP_MEMBERS} x {POP_ENVS}); "
          "--pop-search 4 --population 2 and KellerSegel10_16_fast --population 4, cut in depth "
          "(the study's recipe runs on KS22_tp in phase 42)")
    res38 = {}
    full = build_ks(KS22, device="cuda")
    pop = PopulationTrainer(full.env, full.agent,
                            BatchedTrainerConfig(n_envs=POP_ENVS, batch_size=256), POP_MEMBERS,
                            y0_pool=full.random_init(torch.Generator().manual_seed(full.seed), 32))
    ts = pop.init(torch.Generator(device="cuda").manual_seed(38))
    chunk = pop.make_chunk_fn(TRAIN_CHUNK)
    ks_kernel.KS_CNAB2.launches = 0  # the full-width population path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        ts, packed = chunk(ts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    k1["population at full width, CNAB2 (phase 38)"] = ks_kernel.KS_CNAB2.launches
    res38["CNAB2 population 8 x 256"] = {
        "train_steps": 2 * TRAIN_CHUNK, "env_steps_per_s": 2 * TRAIN_CHUNK * POP_MEMBERS * POP_ENVS / secs,
        "K1_launches": ks_kernel.KS_CNAB2.launches, "K1_rows": POP_MEMBERS * POP_ENVS}
    check(ks_kernel.KS_CNAB2.launches == 2 * TRAIN_CHUNK and bool(torch.isfinite(packed).all()),
          "the full-width CNAB2 population is malformed")

    search_dir = base + "/KS22_popsearch"
    text, secs, _ = cli(["KS22", "--train", "--batched", "--pop-search", "4", "--population", "2",
                         "--total-steps", str(POP_SEARCH_STEPS), "--eval-every", "100",
                         "--eval-steps", "100", "--capacity", "200000", "--config-overrides",
                         json.dumps(SF_TIER), "--out", search_dir])
    search = json.load(open(search_dir + "/search.json"))
    ts, hook = checkpoint.load(search_dir, ks.agent, device="cuda")
    res38["--pop-search 4 --population 2"] = {
        "seconds": secs, "trials": [t["eval_reward"] for t in search["trials"]],
        "best_trial": search["best"]["trial"]}
    check(len(search["trials"]) == 4 and np.isfinite(hook.bestreward)
          and all(bool(torch.isfinite(p).all()) for p in ts.agent.actor.parameters()),
          "the population search is malformed")
    kss_dir = base + "/KellerSegel_pop4"
    text, secs, _ = cli(["KellerSegel10_16_fast", "--train", "--batched", "--population", "4",
                         "--n-envs", str(KSS_POP_ENVS), "--total-steps", str(KSS_POP_STEPS),
                         "--capacity", "200000", "--config-overrides",
                         json.dumps({"te": KSS_POP_TE}), "--out", kss_dir])
    kss = K.build_keller_segel(K.KELLER_SEGEL_10_16_FAST, device="cuda")
    hooks = [checkpoint.load(f"{kss_dir}/member_{i:02d}", kss.agent, device="cuda") for i in range(4)]
    res38["KellerSegel10_16_fast --population 4"] = {
        "seconds": secs, "env_steps_per_s": KSS_POP_STEPS * 4 * KSS_POP_ENVS / secs,
        "episodes": [h.ep - 1 for _, h in hooks]}
    check(all(h.ep > 1 and np.isfinite(h.rewards).all()
              and all(bool(torch.isfinite(p).all()) for p in t.agent.actor.parameters())
              for t, h in hooks), "the Keller-Segel population is malformed")
    res38["card"] = card
    print(json.dumps({"phase": 38, **res38}))
    out["phase38"] = res38

    phase(f"== 39. the population's cost: {POP_MEMBERS} x {POP_ENVS} fused against a solo run at "
          f"{POP_ENVS} (sf tier, learner batch 256, chunks of {TRAIN_CHUNK})")
    sf = build_ks(dataclasses.replace(KS22, **SF_TIER), device="cuda")
    sf_pool = sf.random_init(torch.Generator().manual_seed(sf.seed), 32)
    tcfg = BatchedTrainerConfig(n_envs=POP_ENVS, batch_size=256)
    rates = {}
    for label, tr in (("solo", BatchedTrainer(sf.env, sf.agent, tcfg, y0_pool=sf_pool)),
                      ("population", PopulationTrainer(sf.env, sf.agent, tcfg, POP_MEMBERS,
                                                       y0_pool=sf_pool))):
        ts = tr.init(torch.Generator(device="cuda").manual_seed(39))
        chunk = tr.make_chunk_fn(TRAIN_CHUNK)
        ts, _ = chunk(ts)  # warm-up, past the learn gate
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            ts, packed = chunk(ts)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        width = POP_ENVS * (POP_MEMBERS if label == "population" else 1)
        rates[label] = {"env_steps_per_s": 3 * TRAIN_CHUNK * width / secs,
                        "ms_per_train_step": 1e3 * secs / (3 * TRAIN_CHUNK)}
    rates["study_speedup"] = rates["population"]["env_steps_per_s"] / rates["solo"]["env_steps_per_s"]
    rates["card"] = card
    print(json.dumps({"phase": 39, "rates": rates}))
    out["phase39"] = rates
    Path(out_json).write_text(json.dumps(out))
    return 0


def population_profile(card: str) -> None:
    """Phase 39's profile: launches per train step of the fused population
    (8 x 256) and of the solo run (256), sf tier, and the idle share."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributedconvrl_pde_control_torch.configs.ks import KS22, build_ks
    from distributedconvrl_pde_control_torch.train.batched import (
        BatchedTrainer,
        BatchedTrainerConfig,
    )
    from distributedconvrl_pde_control_torch.train.population import PopulationTrainer

    sf = build_ks(dataclasses.replace(KS22, **SF_TIER), device="cuda")
    pool = sf.random_init(torch.Generator().manual_seed(sf.seed), 32)
    tcfg = BatchedTrainerConfig(n_envs=POP_ENVS, batch_size=256)
    rows = {}
    for label, tr in (("solo", BatchedTrainer(sf.env, sf.agent, tcfg, y0_pool=pool)),
                      ("population", PopulationTrainer(sf.env, sf.agent, tcfg, POP_MEMBERS,
                                                       y0_pool=pool))):
        ts = tr.init(torch.Generator(device="cuda").manual_seed(2))
        ts, _ = tr.make_chunk_fn(10)(ts)  # past the warmup and the learn gate
        five = tr.make_chunk_fn(5)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            five(ts)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        groups = profile_groups(prof)
        busy_us = sum(g[1] for g in groups.values())
        rows[label] = {"wall_us": wall_us, "device_busy_us": busy_us if groups else "not measured",
                       "idle_share": 1.0 - busy_us / wall_us if groups else "not measured",
                       "host_launches_per_train_step": sum(host_launches(prof).values()) / 5,
                       "device_kernels_per_train_step": sum(g[0] for g in groups.values()) / 5,
                       "groups": {k: {"kernels": v[0], "device_us": v[1]} for k, v in groups.items()}}
    print(json.dumps({"profile": f"KS22 sf train step, {POP_MEMBERS} x {POP_ENVS} fused against "
                                 f"{POP_ENVS} solo, 5 steps each, under the profiler",
                      **rows, "card": card}))


def agents_phases(card: str) -> dict:
    """Phases 34-39. Returns K1's launches on the PPO and population paths."""
    phase("== 34. PPO on the card against the CPU: one collect_and_update iteration on KS22 "
          "(2 envs, rollout 8, 2 epochs x 4 microbatches), every draw made once on the CPU")
    res = ppo_pair()
    print(json.dumps({"phase": 34, **res, "card": card}))
    check(res["params_max_err_of_scale"] <= 1e-4 and res["mean_reward_err"] <= 1e-4
          and res["trunk_moved"] > 1e-5 and res["K1_launches"] == [res["env_steps"], 0],
          f"PPO on the card disagrees with the CPU: {res}")
    k1 = {"PPO evaluation: shipped controllers (phase 35)": ppo_controllers(card)}
    phase("== 37. the population chunk on the card against the CPU: P=2 x 4 envs, per-member "
          "learning rates and act_noise, 20 steps, on CNAB2 (K1 vs its plain twin) and the sf tier")
    for tier, over in (("cnab2", {}), ("spectral-featurize", SF_TIER)):
        res = population_pair(over)
        print(json.dumps({"phase": 37, "tier": tier, **res, "card": card}))
        check(res["params_max_abs_err"] <= 1e-4 and res["ep_reward_err"] <= 1e-3
              and res["mean_reward_err"] <= 1e-4 and res["same_finishes"] and res["finite"]
              and res["finished"] == 8 and res["episodes"] == [8, 8]
              and res["K1_launches"] == [0 if over else res["steps"], 0],
              f"the population chunk on the card disagrees with the CPU ({tier}): {res}")
    phase("-- phases 36, 38 and 39's rates in a process of their own")
    out_json = ROOT / "build" / "smoke_agents.json"
    out_json.unlink(missing_ok=True)
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--agents-child",
                           str(out_json)], cwd=str(ROOT), timeout=900)
    check(proc.returncode == 0 and out_json.exists(),
          f"phases 36, 38 and 39 failed in their process (exit {proc.returncode})")
    population_profile(card)
    k1.update(json.loads(out_json.read_text())["K1_launches_by_path"])
    return k1


# ------------------------------------------------------------ the transform tiers (40-44)
# phase 40: each tier's relative L2 error against a float64 transform of the same input,
# (floor, ceiling); matmul_fast's floor shows that the rounding happens. Calibrated on the
# CPU at these shapes: matmul 1.8e-7-4.0e-7, matmul_hi 3.2e-6-5.9e-6, matmul_fast
# 1.9e-3-3.2e-3. The card against the CPU: rel 1e-5 per pass (the same rounding, other sum
# orders), a 2D transform's second pass fed the card's first: a float32 intermediate one
# ulp apart can flip a bf16 rounding of the next pass (2^-9 of that operand at
# matmul_fast), so the chained 2D results of the two devices differ by up to ~6e-5 (seen)
TIER_ORACLE_LIMITS = {"matmul": (0.0, 2e-6), "matmul_hi": (0.0, 2e-5), "matmul_fast": (3e-4, 1e-2)}
TIER_CPU_RTOL = 1e-5
# phase 41: the TPU's accuracy (not speed) per KS22 ETDRK4 env step on attractor states
# against HIGHEST (PERFORMANCE.md:254-255); the port's must fall within 0.1x-3x of it.
# Calibrated on the CPU (512 states): 5.2e-6 and 1.7e-4
KS_TIER_LADDER = {"matmul_hi everywhere": ("matmul_hi", None, 2.0e-5),
                  "hi + nl matmul_fast": ("matmul_hi", "matmul_fast", 1.8e-4)}
KS_TIER_WARMUP = 500
FLUID_TIER_LIMIT = 1.1e-3  # phase 41: PERFORMANCE.md:270 (ifrk4@10/hi + nl); 6.2e-4 on the CPU
# the JAX study's members (RESULTS.md:32, KS22_tp_pop8 at te=200), beside phase 42's
JAX_TP_POP8 = [0.0024, 0.0024, 0.0024, 0.0024, 0.0044, 0.0044, 0.0067, 0.0085]
# phase 43, cut in depth: Fluid_8_tp's single-env loop for 20 env steps of te=0.2 episodes;
# Fluid_16_256_tp on --mesh 1x1 for 50 train steps (two chunks of 25) of te=0.5 episodes
F8_TP_STEPS, F8_TP_TE, MESH_TP_STEPS, MESH_TP_TE = 20, 0.2, 50, 0.5
BENCH_TIERS = ("sf", "tp")  # phase 44, in turns (cut from sf, tp, tp, sf for the mesh phases)


def _rel_np(got, want) -> float:
    import numpy as np

    got, want = np.asarray(got, np.complex128), np.asarray(want, np.complex128)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def tier_transforms(card: str) -> dict:
    """Phase 40: each tier's transforms at the slice's shapes on the card,
    against the port on the CPU and against a float64 transform; their times
    beside torch.fft's (cuFFT)."""
    import numpy as np
    import torch

    from distributedconvrl_pde_control_torch.configs.ks import KS22, build_ks
    from distributedconvrl_pde_control_torch.ops import fourier as F
    from distributedconvrl_pde_control_torch.ops.navier_stokes import NSSolver, initial_condition

    ys = build_ks(KS22, device="cpu").random_init(torch.Generator().manual_seed(40), N_ENVS)
    half = torch.fft.rfft(ys.double()).to(torch.complex64)
    rng = np.random.default_rng(40)
    # Fluid_8's advection inputs on the 3/2-padded 192^2 grid: the four spectra of a case-4
    # field, full and half, and a product field
    w8 = torch.fft.fft2(torch.tensor(np.fft.ifft2(initial_condition(4, 128, 128, 1.0, 1.0, rng)).real,
                                     dtype=torch.float32))[None]
    ns = NSSolver(nx=128, ny=128, device="cpu")
    full8 = ns._stage_spectra(w8, False).contiguous()
    half8 = ns._stage_spectra(w8[..., :65], True).contiguous()
    r8 = torch.fft.ifft2(full8).real
    prod8 = (-r8[:, 0] * r8[:, 2] - r8[:, 1] * r8[:, 3]).contiguous()
    f256 = torch.tensor(np.stack([np.fft.ifft2(initial_condition(4, 256, 256, 1.0, 1.0, rng)).real
                                  for _ in range(16)]), dtype=torch.float32)
    w256 = torch.fft.fft2(f256)
    c128 = np.complex128

    def inv_last(z, m):
        return F.ifft(z, axis=-1, mode=m)

    def fwd_last(x, m):
        return F.fft(x, axis=-1, mode=m)

    cases = {  # label -> (transform of (input, mode), input, float64 transform, its passes
        # (first, second) for a 2D transform)
        "rfft_ri 16384x192": (lambda x, m: torch.complex(*F.rfft_ri(x, m)), ys,
                              np.fft.rfft(ys.double().numpy()), None),
        "irfft_ri 16384x192": (lambda h, m: F.irfft_ri(h.real.contiguous(), h.imag.contiguous(), 192, m),
                               half, np.fft.irfft(half.numpy().astype(c128), 192), None),
        "Fluid_8 192^2 full inverse, 4 spectra": (
            lambda s, m: F.ifft2(s, mode=m).real, full8, np.fft.ifft2(full8.numpy().astype(c128)).real,
            (inv_last, lambda z, m: F.ifft(z, axis=-2, mode=m).real)),
        "Fluid_8 192^2 full forward": (lambda x, m: F.fft2(x, mode=m), prod8,
                                       np.fft.fft2(prod8.double().numpy()),
                                       (fwd_last, lambda z, m: F.fft(z, axis=-2, mode=m))),
        "Fluid_8 192^2 half inverse, 4 spectra": (
            lambda s, m: F.irfft2(s, 192, mode=m), half8,
            np.fft.irfft2(half8.numpy().astype(c128), s=(192, 192)),
            (lambda s, m: F.ifft(s, axis=-2, mode=m), lambda z, m: F.irfft(z, 192, mode=m))),
        "Fluid_8 192^2 half forward": (lambda x, m: F.rfft2(x, mode=m), prod8,
                                       np.fft.rfft2(prod8.double().numpy()),
                                       (lambda x, m: F.rfft(x, mode=m),
                                        lambda z, m: F.fft(z, axis=-2, mode=m))),
        "256^2 fft2_ri, 16 fields": (lambda x, m: torch.complex(*F.fft2_ri(x, None, m)), f256,
                                     np.fft.fft2(f256.double().numpy()),
                                     (fwd_last, lambda z, m: F.fft(z, axis=-2, mode=m))),
        "256^2 ifft2_ri_real, 16 spectra": (
            lambda w, m: F.ifft2_ri_real(w.real.contiguous(), w.imag.contiguous(), m), w256,
            np.fft.ifft2(w256.numpy().astype(c128)).real,
            (inv_last, lambda z, m: F.ifft(z, axis=-2, mode=m).real)),
    }
    mm = torch.backends.cuda.matmul
    flags = (mm.fp32_precision, torch.get_float32_matmul_precision())
    rows = []
    for label, (fn, x, exact, passes) in cases.items():
        xg = x.cuda()
        fft_ms = cuda_ms(lambda: fn(xg, "auto"), 20)
        for mode in F.TIERS:
            got = fn(xg, mode).cpu().numpy()
            # per pass: the CPU's transform of the input, or of the card's first pass
            cpu = (fn(x, mode) if passes is None
                   else passes[1](passes[0](xg, mode).cpu(), mode)).numpy()
            e_cpu, e_exact = _rel_np(got, cpu), _rel_np(got, exact)
            lo, hi = TIER_ORACLE_LIMITS[mode]
            rows.append({"transform": label, "shape": list(x.shape), "mode": mode,
                         "rel_to_cpu_per_pass": e_cpu,
                         "rel_to_cpu_chained": _rel_np(got, fn(x, mode).numpy()),
                         "rel_to_float64": e_exact, "limits": [lo, hi],
                         "ms": cuda_ms(lambda: fn(xg, mode), 20), "torch_fft_ms": fft_ms})
            print(json.dumps({"phase": 40, **rows[-1]}))
            check(e_cpu <= TIER_CPU_RTOL, f"{label} at {mode}: card against CPU {e_cpu:.2e}")
            check(lo <= e_exact <= hi, f"{label} at {mode}: {e_exact:.2e} against float64 is "
                                       f"outside [{lo}, {hi}]")
    check((mm.fp32_precision, torch.get_float32_matmul_precision()) == flags,
          "a tier call left cuBLAS's float32 precision changed")
    print(json.dumps({"phase": 40, "cases": len(rows), "card": card}))
    return {"rows": rows}


def tier_step_errors(card: str) -> dict:
    """Phase 41: the tiers' error per env step against the float32 step of the
    same stepper: KS22 ETDRK4 on 16384 attractor states, Fluid_8_tp's IF-RK4
    step against Fluid_8_fast's."""
    import torch

    from distributedconvrl_pde_control_torch.configs.fluid import build_fluid
    from distributedconvrl_pde_control_torch.configs.ks import KS22, build_ks
    from distributedconvrl_pde_control_torch.experiments.run import fluid_config_for
    from distributedconvrl_pde_control_torch.ops.ks import KSSolverETDRK4

    def rel(a, b):
        return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()

    setup = build_ks(KS22, device="cuda")
    y = setup.random_init(torch.Generator(device="cuda").manual_seed(41), N_ENVS)
    grid = dict(nx=KS22.nx, lx=KS22.lx, dt=KS22.dt, device="cuda")
    f32 = KSSolverETDRK4(**grid)
    zero = torch.zeros_like(y)
    for _ in range(KS_TIER_WARMUP):
        y = f32.step(y, zero)
    gen = torch.Generator(device="cuda").manual_seed(42)
    forcing = setup.env.prepare_action(
        torch.rand((N_ENVS, 1, KS22.n_actuators), generator=gen, device="cuda") * 2.0 - 1.0)
    ref = f32.step(y, forcing)
    res = {"states": N_ENVS, "warmup_steps": KS_TIER_WARMUP, "max_abs_y": y.abs().max().item()}
    check(bool(torch.isfinite(y).all()), "the KS warm-up left non-finite states")
    for label, (fm, nl, tpu) in KS_TIER_LADDER.items():
        err = rel(KSSolverETDRK4(**grid, fft_mode=fm, nl_fft_mode=nl).step(y, forcing), ref)
        res[label] = {"rel_err_per_env_step": err, "tpu_ladder": tpu, "ratio": err / tpu}
        check(0.1 * tpu <= err <= 3.0 * tpu,
              f"KS22 {label}: {err:.2e} per env step, outside 0.1x-3x of the TPU's {tpu:.1e}")
    res["matmul_fast everywhere (reported)"] = rel(
        KSSolverETDRK4(**grid, fft_mode="matmul_fast").step(y, forcing), ref)
    steps = {}
    for name in ("Fluid_8_fast", "Fluid_8_tp"):
        fl = build_fluid(fluid_config_for(name), device="cuda")
        act = torch.rand((1, 1, fl.env.action_shape[-1]), generator=torch.Generator().manual_seed(43))
        steps[name] = fl.env.step_fn(fl.env.y0[None], fl.env.prepare_action(act.cuda() * 2.0 - 1.0))
    err = rel(steps["Fluid_8_tp"], steps["Fluid_8_fast"])
    res["Fluid_8_tp against Fluid_8_fast"] = {"rel_err_per_env_step": err, "limit": FLUID_TIER_LIMIT}
    print(json.dumps({"phase": 41, **res, "card": card}))
    check(bool(torch.isfinite(steps["Fluid_8_tp"]).all()) and 0.0 < err <= FLUID_TIER_LIMIT,
          f"Fluid_8_tp's step is {err:.2e} off Fluid_8_fast's (limit {FLUID_TIER_LIMIT})")
    return res


def tiers_child(out_json: str) -> int:
    """Phases 42 and 43 in a process of their own, which has run no profiler
    session: the KS22_tp population study and the fluid `_tp` training CLIs.
    Writes K1's and K2's launches by path to `out_json`."""
    import contextlib
    import dataclasses
    import io
    import shutil

    import numpy as np
    import torch

    from distributedconvrl_pde_control_torch.configs.ks import KS22, build_ks
    from distributedconvrl_pde_control_torch.experiments import run
    from distributedconvrl_pde_control_torch.ops.kernels import ks_kernel
    from distributedconvrl_pde_control_torch.ops.kernels import ns_advection as k2
    from distributedconvrl_pde_control_torch.parallel.multichip import (
        ShardedFluidTrainer,
        ShardedTrainConfig,
        load_sharded,
    )
    from distributedconvrl_pde_control_torch.train import checkpoint
    from distributedconvrl_pde_control_torch.train.eval import actor_policy, rollout

    card = card_line()
    k1, k2_paths = {}, {}
    base = ROOT / "build" / "smoke_tiers"
    shutil.rmtree(base, ignore_errors=True)

    def cli(argv):
        """The CLI's output (also printed), its seconds, and K1's and K2's launches in it."""
        ks_kernel.KS_CNAB2.launches = k2.NS_ADVECTION.launches = 0
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            run.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(buf.getvalue(), end="", flush=True)
        return secs, ks_kernel.KS_CNAB2.launches, k2.NS_ADVECTION.launches

    def finite(chain):
        return all(bool(torch.isfinite(p).all()) for p in chain.parameters())

    phase(f"== 42. KS22_tp --train --batched --population {POP_MEMBERS} on phase 15's recipe "
          f"({POP_ENVS} envs per member, 3000 steps), every member te=200 on the CNAB2 env (K1)")
    pop_dir = str(base / "KS22_tp_pop8")
    secs, launches, _ = cli([
        "KS22_tp", "--train", "--batched", "--population", str(POP_MEMBERS), "--n-envs",
        str(POP_ENVS), "--total-steps", "3000", "--noise-every", "1000", "--noise-decay", "0.5",
        "--eval-every", str(POP_EVAL_EVERY), "--eval-steps", "500", "--capacity", "1000000", "--seed",
        str(TRAIN_SEED), "--out", pop_dir])
    check(launches == 0, "the KS22_tp population launched K1")
    ranking = json.load(open(pop_dir + "/population.json"))["ranking"]
    ks = build_ks(KS22, device="cuda")
    ks_kernel.KS_CNAB2.launches = 0
    members = []
    for i in range(POP_MEMBERS):
        _, hook = checkpoint.load(f"{pop_dir}/member_{i:02d}", ks.agent, device="cuda")
        actor = checkpoint.actor_from_jax(hook.best_actor).to("cuda")
        y = rollout(ks.env, actor_policy(ks.agent, actor), te=200.0, t_action=100.0)["y"]
        members.append(run.suppression_of(y, 100.0, ks.env.dt)["suppression"]
                       if np.isfinite(y).all() else float("nan"))
    k1["KS22_tp population members' rollouts (phase 42)"] = ks_kernel.KS_CNAB2.launches
    res42 = {"seconds": secs, "env_steps_per_s": 3000 * POP_MEMBERS * POP_ENVS / secs,
             "suppression_by_member": members, "median": float(np.median(members)),
             "jax_study_by_member": JAX_TP_POP8, "jax_study_median": float(np.median(JAX_TP_POP8)),
             "ranking": [(r["dir"], r["best_reward"]) for r in ranking]}
    print(json.dumps({"row": "KS22_tp --population 8, every member te=200 on CNAB2", **res42,
                      "card": card}))
    check(len(ranking) == POP_MEMBERS and np.isfinite(members).all()
          and ks_kernel.KS_CNAB2.launches == 2000 * POP_MEMBERS, "the KS22_tp population is malformed")
    check(res42["median"] < POP_LIMIT,
          f"the median KS22_tp member's suppression {res42['median']} is not below {POP_LIMIT}")

    phase(f"== 43. Fluid_8_tp --train ({F8_TP_STEPS} env steps of te={F8_TP_TE}) and "
          f"Fluid_16_256_tp --train --mesh 1x1 ({MESH_TP_STEPS} train steps of te={MESH_TP_TE}), "
          "cut in depth")
    res43 = {}
    f8_dir = str(base / "Fluid_8_tp")
    secs, _, launches = cli(["Fluid_8_tp", "--train", "--loops", "1", "--no-steps", str(F8_TP_STEPS),
                             "--config-overrides", json.dumps({"te": F8_TP_TE}), "--out", f8_dir])
    f8 = run.build_setup(dataclasses.replace(run.fluid_config_for("Fluid_8_tp"), te=F8_TP_TE),
                         device="cuda")
    ts, hook = checkpoint.load(f8_dir, f8.agent, device="cuda")
    res43["Fluid_8_tp --train"] = {"seconds": secs, "ms_per_env_step": 1e3 * secs / F8_TP_STEPS,
                                   "episodes": hook.ep - 1, "rewards": hook.rewards,
                                   "best_reward": hook.bestreward, "K2_launches": launches}
    check(hook.ep > 1 and np.isfinite(hook.rewards).all() and hook.best_actor is not None
          and finite(ts.agent.actor) and finite(ts.agent.critic)
          and finite(checkpoint.actor_from_jax(hook.best_actor)) and launches == 0,
          "Fluid_8_tp --train is malformed")
    mesh_dir = str(base / "Fluid_16_256_tp")
    secs, _, launches = cli(["Fluid_16_256_tp", "--train", "--mesh", "1x1", "--loops", "1",
                             "--no-steps", str(MESH_TP_STEPS), "--horizon", str(MESH_TP_TE),
                             "--out", mesh_dir])
    k2_paths["Fluid_16_256_tp --mesh 1x1 training (phase 43)"] = launches
    cfg = run.fluid_config_for("Fluid_16_256_tp")
    trainer = ShardedFluidTrainer(cfg, (1, 1), ShardedTrainConfig(n_envs=1), device="cuda")
    agent_state, mhook = load_sharded(mesh_dir, trainer)
    want = 4 * cfg.fast_oversampling_eff * MESH_TP_STEPS
    res43["Fluid_16_256_tp --train --mesh 1x1"] = {
        "seconds": secs, "ms_per_train_step": 1e3 * secs / MESH_TP_STEPS,
        "substeps_per_env_step": cfg.fast_oversampling_eff, "K2_launches": launches,
        "K2_launches_expected": want, "episodes": mhook.ep - 1, "best_reward": mhook.bestreward}
    res43["card"] = card
    print(json.dumps({"phase": 43, **res43}))
    check(launches == want, f"K2 launched {launches} times in {MESH_TP_STEPS} Fluid_16_256_tp train "
                            f"steps, expected {want} (4 per IF-RK4 substep)")
    check(mhook.best_actor is not None and np.isfinite(mhook.rewards).all()
          and finite(agent_state.actor) and finite(agent_state.critic)
          and finite(checkpoint.actor_from_jax(mhook.best_actor)),
          "Fluid_16_256_tp --mesh 1x1 --train is malformed")
    Path(out_json).write_text(json.dumps({"K1": k1, "K2": k2_paths}))
    return 0


def bench_tiers(card: str) -> dict:
    """Phase 44: bench_torch.py at the sf and the tp tier, each in a process of
    its own (no profiler session before it), in turns."""
    rates = {}
    for tier in BENCH_TIERS:
        proc = subprocess.run([sys.executable, str(ROOT / "bench_torch.py"), "--tier", tier],
                              cwd=str(ROOT), capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"bench_torch.py --tier {tier} failed: {proc.stderr[-2000:]}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        check(line["tier"] == tier and line["value"] > 0, f"bench_torch.py printed {line}")
        rates.setdefault(tier, []).append(line["value"])
    res = {"train_env_steps_per_s": rates,
           "tp_over_sf": max(rates["tp"]) / max(rates["sf"]), "card": card}
    print(json.dumps({"phase": 44, **res}))
    return res


def tiers_phases(card: str) -> dict:
    """Phases 40-44. Returns K1's and K2's launches on the tier paths."""
    phase("== 40. each tier's transforms at the slice's shapes, card against the CPU and against "
          "float64")
    tier_transforms(card)
    phase(f"== 41. the tiers' error per env step: KS22 ETDRK4 on {N_ENVS} states after "
          f"{KS_TIER_WARMUP} steps, Fluid_8_tp against Fluid_8_fast")
    tier_step_errors(card)
    phase("-- phases 42-43 in a process of their own")
    out_json = ROOT / "build" / "smoke_tiers.json"
    out_json.unlink(missing_ok=True)
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--tiers-child",
                           str(out_json)], cwd=str(ROOT), timeout=900)
    check(proc.returncode == 0 and out_json.exists(),
          f"phases 42 and 43 failed in their process (exit {proc.returncode})")
    phase("== 44. bench_torch.py at the sf and the tp tier, in turns, each in its own process")
    bench_tiers(card)
    return json.loads(out_json.read_text())


# ------------------------------------------- deployment and tooling (45-50)
SERVE_KEYS = {"preset", "latency_ms_p50", "latency_ms_p99", "control_interval_ms", "headroom_x"}
SERVED = [("KS22", "artifacts/KS22"),  # phases 45-46: one shipped controller of each family
          ("KellerSegel10_16_fast", "artifacts/KellerSegel_popsearch_pop8/member_00"),
          ("Fluid_8", "artifacts/Fluid_8")]
LIVE_STEPS = 2000  # phase 47: the KS22 protocol's te=200
KSS_POP_DIR, KSS_POP_SEEDS = "artifacts/KellerSegel_popsearch_pop8", (7, 8, 9, 10)  # phase 48
# phase 48: eval_kss_pop.py's lines on the CPU (JAX 0.9.0, threefry keys), as printed: the
# post-control mean |u - 1| of each member from keys 7, 8, 9, 10 (RESULTS.md:504-513 prints the
# same values to 2-4 digits). Limit: max(0.1 JAX, 0.0005)
JAX_KSS_POP = {0: (0.0097, 0.0064, 0.0133, 0.0143), 1: (0.0852, 0.0893, 0.0821, 0.0797),
               2: (0.0308, 0.0306, 0.0283, 0.0282), 3: (0.0284, 0.0288, 0.0388, 0.0399),
               4: (0.054, 0.0546, 0.0652, 0.0661), 5: (0.0249, 0.0235, 0.5678, 0.6133),
               6: (0.1557, 0.869, 0.8626, 0.8625), 7: (0.0903, 0.0914, 0.0891, 0.0884)}
FLUID_POP_DIR, FLUID_POP_PRESET = "artifacts/Fluid_8_tp_pop8", "Fluid_8"  # phase 49
# phase 49: eval_fluid_pop.py's lines on the CPU, as printed: the mean energy over the te=2, 3
# and 6 prefixes of each member and of the two baselines (RESULTS.md:89-100 prints them to 2
# digits; four of its cells differ from these by one in the last digit). Limit: 2 %
JAX_FLUID_POP = {0: (7.917, 7.078, 5.384), 1: (9.179, 8.624, 7.859), 2: (7.802, 6.895, 5.163),
                 3: (7.862, 6.964, 5.22), 4: (7.748, 6.843, 5.165), 5: (9.012, 8.031, 6.402),
                 6: (7.791, 6.93, 5.281), 7: (7.933, 7.058, 5.338),
                 "negate": (7.613, 6.38, 4.469), "no_action": (8.731, 7.773, 6.026)}
PROFILE_STEPS, PROFILE_TE = 30, 3.0  # phase 50: one loop of one 30-step episode (te cut from 5)

# phase 46: the exported controllers reloaded by `load_exported`'s own source in a process
# where neither package (nor JAX) can be imported, on the card and moved to the CPU
EXPORT_LOADER = """
import json, os, sys
for name in ("distributedconvrl_pde_control_torch", "distributedconvrl_pde_control_tpu", "jax"):
    sys.modules[name] = None
import numpy as np
import torch
ARTIFACT, MANIFEST = {artifact!r}, {manifest!r}
{source}
for out in sys.argv[1:]:
    x = np.load(os.path.join(out, "inputs.npz"))
    for device in ("cuda", "cpu"):
        program, manifest = load_exported(out, device=device)
        with torch.no_grad():
            action, next_obs = program(torch.from_numpy(x["y"]).to(device),
                                       torch.from_numpy(x["obs"]).to(device))
        assert action.device.type == device, action.device
        np.savez(os.path.join(out, "outputs_" + device + ".npz"), action=action.cpu().numpy(),
                 next_obs=next_obs.cpu().numpy())
    print(manifest["preset"], "reloaded")
"""


def tools_child(out_json: str) -> int:
    """Phases 45-50 in a process of their own: 45-49 before any profiler
    session (45 and 46 time latencies on the host's clock), then 50, which
    profiles, last. Writes K1's launches by path to `out_json`."""
    import contextlib
    import inspect
    import io
    import shutil

    import numpy as np
    import torch

    import eval_fluid_pop_torch
    import eval_kss_pop_torch
    from distributedconvrl_pde_control_torch.experiments import export_controller as ec
    from distributedconvrl_pde_control_torch.experiments import run, serve
    from distributedconvrl_pde_control_torch.ops.kernels import ks_kernel
    from distributedconvrl_pde_control_torch.ops.kernels import ns_advection as k2
    from distributedconvrl_pde_control_torch.train import checkpoint
    from distributedconvrl_pde_control_torch.utils.profiling import TRACE_FILE

    card = card_line()
    base = ROOT / "build" / "smoke_tools"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    k1 = {}

    def cli(main, argv):
        """An entry point's output, its seconds, and K1's and K2's launches in
        one run of it."""
        ks_kernel.KS_CNAB2.launches = k2.NS_ADVECTION.launches = 0
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            main(argv)
        torch.cuda.synchronize()
        return (buf.getvalue(), ks_kernel.KS_CNAB2.launches, time.perf_counter() - t0,
                k2.NS_ADVECTION.launches)

    phase("== 45. run.py --eval --serve: KS22, KellerSegel10_16_fast (popsearch member 0), Fluid_8; "
          "200 control steps each, each timed to the end of its device work")
    res45 = {}
    for preset, run_dir in SERVED:
        text, launches, _, launches_k2 = cli(run.main, [preset, "--eval", "--serve",
                                                        "--load-from", str(ROOT / run_dir)])
        line = json.loads(text.strip().splitlines()[-1])
        res45[preset] = line
        check(set(line) == SERVE_KEYS and launches == launches_k2 == 0 and line["headroom_x"] > 1,
              f"the serving probe on {preset} is malformed or slower than real time: {line}")
    print(json.dumps({"phase": 45, "serve": res45, "card": card}))

    phase("== 46. export round trips on the card: exported on cuda, bit-equal to the live step there "
          "and, moved to the CPU, to the port's live CPU step, reloaded without the port; then "
          "serve --from-export")
    outs, live = [], {}
    for preset, run_dir in SERVED:
        out = base / f"export_{preset}"
        text, launches, secs, launches_k2 = cli(run.main, [
            preset, "--eval", "--export-controller", str(out), "--load-from", str(ROOT / run_dir)])
        manifest = json.loads((out / ec.MANIFEST).read_text())
        check(manifest["exported_on"] == "cuda" and (out / ec.ARTIFACT).exists()
              and launches == launches_k2 == 0,
              f"the {preset} export is malformed: {manifest}")
        rng = np.random.default_rng(46)
        for device in ("cuda", "cpu"):
            setup = run.build_setup(run.preset_config(preset), device=device)
            step = ec.build_control_step(setup, checkpoint.load_actor(str(ROOT / run_dir),
                                                                      setup.agent, device=device))
            if device == "cuda":
                est = setup.env.reset()
                y0 = est.y.cpu().numpy()
                y = (y0 + 0.1 * np.abs(y0).max() * rng.standard_normal(y0.shape)).astype(np.float32)
                obs = rng.uniform(-1, 1, tuple(est.obs.shape)).astype(np.float32)
                np.savez(out / "inputs.npz", y=y, obs=obs)
            with torch.no_grad():
                a, o = step(torch.from_numpy(y).to(device), torch.from_numpy(obs).to(device))
            live[(preset, device)] = (a.cpu().numpy(), o.cpu().numpy())
        print(f"{preset}: exported in {secs:.1f} s, {(out / ec.ARTIFACT).stat().st_size} B, "
              f"args {manifest['args']}")
        outs.append(str(out))
    code = EXPORT_LOADER.format(artifact=ec.ARTIFACT, manifest=ec.MANIFEST,
                                source=inspect.getsource(ec.load_exported))
    proc = subprocess.run([sys.executable, "-c", code, *outs], capture_output=True, text=True,
                          timeout=300, cwd=str(base))
    print(proc.stdout, end="")
    check(proc.returncode == 0, f"reloading the exports without the port failed: {proc.stderr[-3000:]}")
    res46 = {}
    for (preset, _), out in zip(SERVED, outs):
        row = {}
        for device in ("cuda", "cpu"):
            got = np.load(Path(out) / f"outputs_{device}.npz")
            want_a, want_o = live[(preset, device)]
            row[f"bit_equal_{device}"] = bool(np.array_equal(got["action"], want_a)
                                              and np.array_equal(got["next_obs"], want_o))
        text, launches, _, launches_k2 = cli(serve.main, [preset, "--from-export", out])
        row["serve_from_export"] = json.loads(text.strip().splitlines()[-1])
        res46[preset] = row
        check(row["bit_equal_cuda"] and row["bit_equal_cpu"] and launches == launches_k2 == 0
              and set(row["serve_from_export"]) == SERVE_KEYS,
              f"the {preset} export round trip is not the live step: {row}")
    print(json.dumps({"phase": 46, "exports": res46, "card": card}))

    phase(f"== 47. run.py KS22 --eval --live (te=200: {LIVE_STEPS} env steps) to a non-TTY stream")
    live_dir = base / "live"
    text, launches, secs, _ = cli(run.main, ["KS22", "--eval", "--live", "--load-from",
                                             str(ROOT / "artifacts" / "KS22"), "--out", str(live_dir)])
    lines = text.splitlines()
    frames = [i for i, line in enumerate(lines) if line.startswith("step ")]
    supp = next(json.loads(line) for line in lines if line.startswith("{"))
    plotted = all((live_dir / f).exists() for f in ("heat.png", "sums.png", "actions.png"))
    k1["live eval (phase 47)"] = launches
    print("\n".join(lines[frames[-1]:frames[-1] + 4]) if frames else "(no frame)")
    res47 = {"frames": len(frames), "K1_launches": launches, "seconds": secs, **supp,
             "plots": "written" if plotted else next(
                 (line for line in lines if line.startswith("plots not written")), None)}
    print(json.dumps({"phase": 47, **res47, "card": card}))
    check(len(frames) == LIVE_STEPS == launches and supp["suppression"] < 0.05
          and res47["plots"] is not None, f"the live eval is malformed: {res47}")

    phase(f"== 48. eval_kss_pop_torch.py on {KSS_POP_DIR}: 8 members x keys {KSS_POP_SEEDS}, "
          "te=12, each member's seeds one batch")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = list(eval_kss_pop_torch.evaluate(str(ROOT / KSS_POP_DIR), 8, list(KSS_POP_SEEDS)))
    secs = time.perf_counter() - t0
    worst = 0.0
    for member, row in rows:
        want = dict(zip(KSS_POP_SEEDS, JAX_KSS_POP[member]))
        ok = all(abs(row[s]["post"] - want[s]) <= max(0.1 * want[s], 0.0005) for s in KSS_POP_SEEDS)
        worst = max([worst] + [abs(row[s]["post"] - want[s]) / max(0.1 * want[s], 0.0005)
                               for s in KSS_POP_SEEDS])
        print(json.dumps({**eval_kss_pop_torch.printed_row(member, row), "jax": want, "ok": ok}))
        check(ok, f"Keller-Segel member {member} disagrees with eval_kss_pop.py")
    print(json.dumps({"phase": 48, "members": len(rows), "seconds": secs,
                      "worst_error_of_limit": worst, "card": card}))

    phase(f"== 49. eval_fluid_pop_torch.py on {FLUID_POP_DIR} ({FLUID_POP_PRESET}, te=6): 8 members "
          "and the 2 baselines, one batch of 10 envs")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = eval_fluid_pop_torch.evaluate(str(ROOT / FLUID_POP_DIR), FLUID_POP_PRESET, 8)
    secs = time.perf_counter() - t0
    worst = 0.0
    for label, row in rows:
        want = dict(zip(("te2", "te3", "te6"), JAX_FLUID_POP[label[1]]))
        errs = {k: abs(row[k] - w) / w for k, w in want.items()}
        worst = max([worst, *errs.values()])
        ok = all(e <= 0.02 for e in errs.values())
        print(json.dumps({**eval_fluid_pop_torch.printed_row(label, row), "jax": want, "ok": ok}))
        check(ok, f"fluid {label} disagrees with eval_fluid_pop.py")
    print(json.dumps({"phase": 49, "rollouts": len(rows), "seconds": secs,
                      "ms_per_env_step_of_the_batch": 1e3 * secs / 300, "worst_rel_error": worst,
                      "card": card}))

    phase(f"== 50. KS22 --train --profile: one loop of one {PROFILE_STEPS}-step episode (te="
          f"{PROFILE_TE}) under torch.profiler, last in its process")
    for attempt in (1, 2):
        out = base / "profiled"
        shutil.rmtree(out, ignore_errors=True)
        text, launches, secs, _ = cli(run.main, [
            "KS22", "--train", "--profile", "--loops", "1", "--no-steps", str(PROFILE_STEPS),
            "--config-overrides", json.dumps({"te": PROFILE_TE}), "--out", str(out)])
        trace_path = out / "profile" / TRACE_FILE
        events = json.loads(trace_path.read_text())["traceEvents"] if trace_path.exists() else []
        kernels = [e for e in events if e.get("cat") == "kernel"]
        k1_seen = sum("ks_cnab2" in e.get("name", "") for e in kernels)
        # a session can lose records (as phase 18 allows for): the library counts every
        # launch, so a session that saw fewer is measured again
        if k1_seen == launches:
            break
        print(f"attempt {attempt}: the trace holds {k1_seen} K1 launches, the library counted "
              f"{launches}")
    print("\n".join(line for line in text.splitlines() if "ms/call" in line or "trace ->" in line))
    k1["profiled fidelity training (phase 50)"] = launches
    res50 = {"env_steps": launches, "K1_in_trace": k1_seen, "kernels_in_trace": len(kernels),
             "kernels_per_env_step": len(kernels) / max(launches, 1),
             "trace_bytes": trace_path.stat().st_size if trace_path.exists() else 0,
             "seconds": secs, "attempts": attempt, "card": card}
    print(json.dumps({"phase": 50, **res50}))
    check(trace_path.exists() and launches == PROFILE_STEPS and k1_seen == launches
          and "first_loop" in text, f"the profiled training run is malformed: {res50}")
    Path(out_json).write_text(json.dumps({"K1_launches_by_path": k1}))
    return 0


def tools_phases(card: str) -> dict:
    """Phases 45-50, in a process of their own. Returns K1's launches on the
    tooling paths."""
    phase("-- phases 45-50 in a process of their own")
    out_json = ROOT / "build" / "smoke_tools.json"
    out_json.unlink(missing_ok=True)
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--tools-child",
                           str(out_json)], cwd=str(ROOT), timeout=900)
    check(proc.returncode == 0 and out_json.exists(),
          f"phases 45-50 failed in their process (exit {proc.returncode})")
    return json.loads(out_json.read_text())["K1_launches_by_path"]


# ----------------------------------------------------- the rank mesh (51-54)
MESH_EVAL_STEPS = 20  # phase 51: env steps of phase 9's protocol (te cut from 2 to 0.4)
MESH_TRAIN_STEPS = 50  # phase 52: train steps through the CLI (2 chunks of 25)
MESH_CPU_TE = 0.02  # phase 53: 1 env step at 256^2 on 4 CPU ranks
MESH_REL = {"phase 9": 1e-6, "2x2 CPU ranks": 1e-4}
KSS_MESH_DIR = "artifacts/KellerSegel10_16_fast"
KSS_CPU_TE = 5.0  # phase 54's CPU row: the protocol cut from te=12 to 5, for room


def _fluid_eval_on(mesh, n_steps: int) -> dict:
    """Phase 9's protocol cut to `n_steps` on `mesh` (a rank mesh, or (1, 1)
    for no group): per-step energies of the trained actor, its seconds after
    a 2-step warm-up, and K2's launches in the timed run."""
    import torch

    from distributedconvrl_pde_control_torch.configs.fluid import FLUID_16_256
    from distributedconvrl_pde_control_torch.ops.kernels import ns_advection as k2
    from distributedconvrl_pde_control_torch.parallel.multichip import (
        ShardedFluidTrainer,
        ShardedTrainConfig,
        load_actor_for_eval,
    )

    tr = ShardedFluidTrainer(FLUID_16_256, mesh, ShardedTrainConfig(n_envs=1), device="cuda")
    actor = load_actor_for_eval(str(ROOT / "artifacts" / "Fluid_16_256"), tr)
    w0 = tr.eval_w0()
    tr.make_eval_fn(2)(actor, w0)
    torch.cuda.synchronize()
    before = k2.NS_ADVECTION.launches
    t0 = time.perf_counter()
    recs = tr.make_eval_fn(n_steps)(actor, w0)
    torch.cuda.synchronize()
    return {"energy": recs["energy"][:, 0].tolist(), "active": bool(recs["active"].all()),
            "seconds": time.perf_counter() - t0, "K2": k2.NS_ADVECTION.launches - before,
            "backend": getattr(mesh, "backend", None)}


def _fluid_chunks_on(mesh) -> dict:
    """Phase 52's no-read check: 1 env of Fluid_16_256 on `mesh`, a warm-up
    chunk of 25 train steps, then 2 chunks under set_sync_debug_mode("error")."""
    import torch

    from distributedconvrl_pde_control_torch.configs.fluid import FLUID_16_256
    from distributedconvrl_pde_control_torch.parallel.multichip import (
        ShardedFluidTrainer,
        ShardedTrainConfig,
    )

    tr = ShardedFluidTrainer(FLUID_16_256, mesh, ShardedTrainConfig(n_envs=1), device="cuda")
    st = tr.init(torch.Generator(device="cuda").manual_seed(FLUID_TRAIN_SEED), seed=FLUID_TRAIN_SEED)
    chunk = tr.make_chunk_fn(FLUID_TRAIN_CHUNK)
    st, _ = chunk(st)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            st, packed = chunk(st)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return {"ms_per_train_step": 1e3 * (time.perf_counter() - t0) / (2 * FLUID_TRAIN_CHUNK),
            "finite": bool(torch.isfinite(packed).all()), "backend": mesh.backend}


def _kss_regulation_on(mesh, te: float = 12.0) -> dict:
    """reproduce.py's Keller-Segel row (KellerSegel10_16_fast from the JAX
    package's key-8 field, te=12 or `te`, actuation from t=4) through the
    sharded trainer's evaluation rollout on `mesh`: mean |u - 1| over the 100
    steps before actuation and over the last tenth, and the seconds."""
    import torch

    from distributedconvrl_pde_control_torch.configs.keller_segel import (
        KELLER_SEGEL_10_16_FAST,
        keller_segel_y0_key8,
    )
    from distributedconvrl_pde_control_torch.parallel.multichip import (
        ShardedTrainConfig,
        load_actor_for_eval,
    )
    from distributedconvrl_pde_control_torch.parallel.multichip_keller_segel import (
        ShardedKellerSegelTrainer,
    )

    if mesh.device == "cpu":
        torch.set_num_threads(1)  # 100-point fields: more threads only add overhead
    cfg = KELLER_SEGEL_10_16_FAST
    tr = ShardedKellerSegelTrainer(cfg, mesh, ShardedTrainConfig(n_envs=1), device=mesh.device)
    actor = load_actor_for_eval(str(ROOT / KSS_MESH_DIR), tr)
    w0 = tr._t(tr._local_rows(keller_segel_y0_key8()[None]))
    n, a0 = int(round(te / cfg.dt)), int(round(4.0 / cfg.dt))
    t0 = time.perf_counter()
    recs = tr.make_eval_fn(n, a0)(actor, w0)
    if mesh.device != "cpu":
        torch.cuda.synchronize()
    e = recs["energy"][:, 0]
    return {"pre": float(e[max(0, a0 - 100):a0].mean()), "post": float(e[-(n // 10):].mean()),
            "active": bool(recs["active"].all()), "seconds": time.perf_counter() - t0,
            "steps": n, "backend": mesh.backend}


def _peak(device_phase: bool) -> dict:
    """The phase's peak memory: the card's allocator peak, or on CPU ranks the
    largest finished child process's resident set."""
    import resource

    import torch

    if device_phase:
        return {"peak_device_mb": torch.cuda.max_memory_allocated() / 2**20}
    return {"peak_rank_rss_mb (largest CPU rank)":
            resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 1024}


def mesh_child(out_json: str) -> int:
    """Phases 51-54 in a process of their own (no profiler session): the rank
    mesh. The card's 1x1 runs through an NCCL process group of one rank; the
    larger meshes run on gloo CPU ranks. Writes K2's launches by path, the
    phases' seconds and peak memory to `out_json`."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch

    import reproduce_torch
    from distributedconvrl_pde_control_torch.configs.fluid import FLUID_16_256
    from distributedconvrl_pde_control_torch.configs.keller_segel import (
        KELLER_SEGEL_10_16_FAST,
        build_keller_segel,
    )
    from distributedconvrl_pde_control_torch.experiments import run
    from distributedconvrl_pde_control_torch.ops.kernels import ns_advection as k2
    from distributedconvrl_pde_control_torch.parallel.mesh import launch

    card = card_line()
    base = ROOT / "build" / "smoke_mesh"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    k2_paths, record = {}, {"card": card}

    def cli(argv):
        """The CLI's output (also printed), its seconds and K2's launches in it."""
        k2.NS_ADVECTION.launches = 0
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            run.main(argv)
        torch.cuda.synchronize()
        print(buf.getvalue(), end="", flush=True)
        return buf.getvalue(), time.perf_counter() - t0, k2.NS_ADVECTION.launches

    def nccl(fn, *args):
        return launch(fn, 1, 1, *args, backend="nccl", store_dir=str(base))

    substeps = FLUID_16_256.oversampling
    phase(f"== 51. Fluid_16_256 --eval --mesh 1x1 on an NCCL group of one: 256^2, {substeps} RK4 "
          f"substeps, {MESH_EVAL_STEPS} env steps of phase 9's protocol, against the same code "
          "without a group and phase 9's energies")
    torch.cuda.reset_peak_memory_stats()
    k2.NS_ADVECTION.launches = 0
    on_nccl = nccl(_fluid_eval_on, MESH_EVAL_STEPS)
    k2_paths["mesh 1x1 evaluation on NCCL (phase 51)"] = k2.NS_ADVECTION.launches
    alone = _fluid_eval_on((1, 1), MESH_EVAL_STEPS)
    want_k2 = 4 * substeps * MESH_EVAL_STEPS
    e_nccl, e_alone = on_nccl["energy"], alone["energy"]
    rel_alone = max(abs(a - b) / abs(b) for a, b in zip(e_nccl, e_alone))
    res51 = {"backend": on_nccl["backend"], "energy_per_step": e_nccl,
             "rel_to_no_group": rel_alone, "K2_launches_timed": on_nccl["K2"],
             "K2_launches_expected": want_k2,
             "ms_per_env_step_nccl": 1e3 * on_nccl["seconds"] / MESH_EVAL_STEPS,
             "ms_per_env_step_no_group": 1e3 * alone["seconds"] / MESH_EVAL_STEPS}
    p9 = ROOT / "build" / "smoke_phase9.json"
    if p9.exists():
        ref = json.loads(p9.read_text())
        res51["rel_to_phase_9"] = max(abs(a - b) / abs(b) for a, b in
                                      zip(e_nccl, ref["energy_per_step"][:MESH_EVAL_STEPS]))
        res51["phase_9_ms_per_env_step"] = ref["ms_per_env_step"]
    else:
        res51["rel_to_phase_9"] = "not run (phase 9 is not in this run)"
    cli_out, secs, launches = cli(["Fluid_16_256", "--eval", "--mesh", "1x1", "--load-from",
                                   str(ROOT / "artifacts" / "Fluid_16_256"), "--p-te",
                                   str(MESH_EVAL_STEPS * FLUID_16_256.dt), "--out", str(base / "eval")])
    line = json.loads(cli_out.strip().splitlines()[-1])
    res51["cli"] = {**line, "seconds": secs, "K2_launches": launches}
    k2_paths["mesh 1x1 evaluation on NCCL (phase 51)"] += launches
    res51.update(_peak(True))
    print(json.dumps({"phase": 51, **res51, "card": card}), flush=True)
    record["51"] = res51
    check(on_nccl["backend"] == "nccl", f"the 1x1 mesh ran on {on_nccl['backend']}, not nccl")
    check(on_nccl["active"] and rel_alone <= MESH_REL["phase 9"],
          f"the 1x1 NCCL energies differ from the no-group run by rel {rel_alone}")
    check(not isinstance(res51["rel_to_phase_9"], float) or res51["rel_to_phase_9"] <= MESH_REL["phase 9"],
          f"the 1x1 NCCL energies differ from phase 9's by rel {res51['rel_to_phase_9']}")
    check(on_nccl["K2"] == want_k2 and launches == 2 * want_k2,
          f"K2 launched {on_nccl['K2']} / {launches} times, expected {want_k2} / {2 * want_k2}")
    check(line["mesh"] == "1x1" and abs(line["trained"] - sum(e_nccl) / len(e_nccl))
          <= 1e-6 * abs(line["trained"]), "the CLI's 1x1 eval is not the mesh's rollout")

    phase(f"== 52. Fluid_16_256 --train --mesh 1x1 on an NCCL group of one ({MESH_TRAIN_STEPS} train "
          "steps, 1 env), chunks without device-to-host reads, the save read by the single-device "
          "--eval")
    torch.cuda.reset_peak_memory_stats()
    train_dir = str(base / "train")
    _, secs, launches = cli(["Fluid_16_256", "--train", "--mesh", "1x1", "--loops", "1",
                             "--no-steps", str(MESH_TRAIN_STEPS), "--chunk-len",
                             str(FLUID_TRAIN_CHUNK), "--out", train_dir])
    k2_paths["mesh 1x1 training on NCCL (phase 52)"] = launches
    chunks = nccl(_fluid_chunks_on)
    single, _, _ = cli(["Fluid_16_256", "--eval", "--load-from", train_dir, "--p-te", "0.1"])
    single = json.loads(single.strip().splitlines()[-1])
    res52 = {"cli_seconds (trainer construction and save included)": secs,
             "K2_launches": launches, "K2_launches_expected": 4 * substeps * MESH_TRAIN_STEPS,
             "no_read_chunks": chunks, "single_device_eval_of_the_save": single, **_peak(True)}
    print(json.dumps({"phase": 52, **res52, "card": card}), flush=True)
    record["52"] = res52
    check(launches == 4 * substeps * MESH_TRAIN_STEPS,
          f"K2 launched {launches} times in {MESH_TRAIN_STEPS} train steps")
    check(chunks["backend"] == "nccl" and chunks["finite"], "the NCCL chunks are malformed")
    check(all(np.isfinite(v) for v in single.values()), "the single-device eval of the save failed")

    phase(f"== 53. Fluid_16_256 --eval --virtual-devices 4 --mesh 2x2 on gloo CPU ranks at 256^2 "
          f"(te={MESH_CPU_TE}), against phase 51's card energies on the same steps")
    cpu_out, secs, _ = cli(["Fluid_16_256", "--eval", "--virtual-devices", "4", "--mesh", "2x2",
                            "--load-from", str(ROOT / "artifacts" / "Fluid_16_256"), "--p-te",
                            str(MESH_CPU_TE), "--out", str(base / "cpu2x2")])
    line = json.loads(cpu_out.strip().splitlines()[-1])
    n_cpu = int(round(MESH_CPU_TE / FLUID_16_256.dt))
    want = sum(e_nccl[:n_cpu]) / n_cpu
    rel = abs(line["trained"] - want) / abs(want)
    res53 = {**line, "card_mean_energy_same_steps": want, "rel": rel,
             "cpu_seconds (4 gloo ranks, not a speed of the port)": secs, **_peak(False)}
    print(json.dumps({"phase": 53, **res53, "card": card}), flush=True)
    record["53"] = res53
    check(line["mesh"] == "2x2" and rel <= MESH_REL["2x2 CPU ranks"],
          f"the 2x2 CPU ranks' energy is rel {rel} from the card's")

    phase("== 54. KellerSegel10_16_fast --mesh 1x1 --eval on NCCL and the reproduce.py row on the "
          f"1x1 NCCL mesh and, cut to te={KSS_CPU_TE}, on 2 gloo CPU ranks (1x2), against the "
          "single-device port's row")
    torch.cuda.reset_peak_memory_stats()
    _, secs, _ = cli(["KellerSegel10_16_fast", "--eval", "--mesh", "1x1", "--load-from",
                      str(ROOT / KSS_MESH_DIR), "--p-te", "0.3", "--out", str(base / "kss")])
    setup = build_keller_segel(KELLER_SEGEL_10_16_FAST, device="cuda")
    _, actor = reproduce_torch.load_actor(lambda: setup, ROOT / KSS_MESH_DIR)
    t0 = time.perf_counter()
    single = reproduce_torch.regulation(setup, actor, ndigits=None)
    single_secs = time.perf_counter() - t0
    single_cut = reproduce_torch.regulation(setup, actor, te=KSS_CPU_TE, ndigits=None)
    jax_row = reproduce_torch.JAX_KELLER_SEGEL_ROWS["KellerSegel10_16_fast regulation"]
    rows = {"1x1 NCCL": nccl(_kss_regulation_on)}
    # last: the CPU ranks' row, its seconds CPU seconds, with nothing of the card's beside it
    rows[f"1x2 gloo CPU ranks, te={KSS_CPU_TE}"] = launch(_kss_regulation_on, 1, 2, KSS_CPU_TE,
                                                          backend="gloo", store_dir=str(base))
    res54 = {"single_device_row": single, "single_device_seconds": single_secs,
             f"single_device_row_te{KSS_CPU_TE}": single_cut, "jax_row": jax_row,
             "cli_1x1_seconds": secs, **rows, **_peak(True)}
    print(json.dumps({"phase": 54, **res54, "card": card}), flush=True)
    record["54"] = res54
    for (name, row), want in zip(rows.items(), (single, single_cut)):
        check(row["active"] and abs(row["pre"] - want["pre"]) <= 1e-3
              and abs(row["post"] - want["post"]) <= max(0.1 * jax_row["post"], 0.0005),
              f"the Keller-Segel row on {name} ({row}) is outside the limits of {want}")
    check(rows["1x1 NCCL"]["backend"] == "nccl", "the Keller-Segel 1x1 mesh did not run on NCCL")
    Path(out_json).write_text(json.dumps({"K2": k2_paths, "record": record}))
    return 0


def mesh_phases(card: str) -> dict:
    """Phases 51-54, in a process of their own. Returns K2's launches on the
    mesh paths."""
    phase("-- phases 51-54 in a process of their own")
    out_json = ROOT / "build" / "smoke_mesh.json"
    out_json.unlink(missing_ok=True)
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-child",
                           str(out_json)], cwd=str(ROOT), timeout=900)
    check(proc.returncode == 0 and out_json.exists(),
          f"phases 51-54 failed in their process (exit {proc.returncode})")
    return json.loads(out_json.read_text())["K2"]


# ------------------------------------- data and tensor parallelism (55-60)
DP_SMALL = dict(n_envs=4, batch=8, steps=20, seed=3, draw_seed=29, pool=6)  # phases 55, 60
DP_SMALL_KS = dict(SF_TIER, te=1.5, update_after=0)  # episodes end at step 15, learning from 1
DP_CLI = dict(steps=200, eval_every=100, eval_steps=50)  # phase 56
POP_CLI = dict(steps=100, eval_every=50, eval_steps=20)  # phase 57
POP_CHUNK = 20  # phase 57's routing chunk
BENCH_FLUID = dict(steps=50, chunk=10, substeps=4)  # phase 59: bench_multichip_torch's defaults
NETS = ("actor", "critic", "target_actor", "target_critic")


def _nets(agent) -> dict:
    from distributedconvrl_pde_control_torch.models.mlp import chain_to_numpy

    return {n: chain_to_numpy(getattr(agent, n)) for n in NETS}


def _net_err(a: dict, b: dict, of_max: bool = False) -> float:
    """The largest difference of two agents' networks (of each tensor's
    largest value with `of_max`)."""
    import numpy as np

    return max(float(np.abs(x[k] - y[k]).max() / (max(np.abs(y[k]).max(), 1e-30) if of_max else 1))
               for n in a for x, y in zip(a[n], b[n]) for k in ("w", "b"))


def _dp_full_width(mesh) -> dict:
    """Phase 55 at bench.py's shape: `BatchedTrainer` and `DPBatchedTrainer`
    on `mesh`, each from the same generator and a warm-up chunk, then timed
    in turns (no group, group, group, no group; 2 chunks each, under
    set_sync_debug_mode("error")); the last records, obs_flat, networks and
    the rate of each."""
    import dataclasses

    import torch

    from distributedconvrl_pde_control_torch.configs.ks import KS22, build_ks
    from distributedconvrl_pde_control_torch.parallel.batched_dp import DPBatchedTrainer
    from distributedconvrl_pde_control_torch.train.batched import (
        BatchedTrainer,
        BatchedTrainerConfig,
    )

    setup = build_ks(dataclasses.replace(KS22, **SF_TIER), device="cuda")
    cfg = BatchedTrainerConfig(n_envs=N_ENVS, batch_size=LEARNER_BATCH)
    runs = {"no group": BatchedTrainer(setup.env, setup.agent, cfg, random_init=setup.random_init),
            "NCCL group of one": DPBatchedTrainer(setup.env, setup.agent, cfg, mesh,
                                                  random_init=setup.random_init)}
    state = {}
    for name, tr in runs.items():
        ts = tr.init(torch.Generator(device="cuda").manual_seed(TRAIN_SEED))
        chunk = tr.make_chunk_fn(TRAIN_CHUNK)
        ts, _ = chunk(ts)  # warm-up: cuFFT plans, the allocator, past the learn gate
        state[name] = [ts, chunk, None, []]
    for name in ("no group", "NCCL group of one", "NCCL group of one", "no group"):
        ts, chunk = state[name][:2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(2):
                ts, packed = chunk(ts)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        state[name][0], state[name][2] = ts, packed
        state[name][3].append(1e3 * (time.perf_counter() - t0) / (2 * TRAIN_CHUNK))
    # the host's cost of one collective on the group: 200 scalar all_reduces
    # (the hook scalars' form), ended by a synchronize
    x = torch.zeros((), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        x = mesh.psum(x, "dp")
    torch.cuda.synchronize()
    out = {"backend": mesh.backend, "us_per_scalar_all_reduce": 1e6 * (time.perf_counter() - t0) / 200}
    for name, (ts, _, packed, ms) in state.items():
        out[name] = {"ms_per_train_step_in_turns": ms,
                     "env_steps_per_s": 1e3 * N_ENVS * len(ms) / sum(ms),
                     "packed": packed.cpu().numpy(), "obs_flat": ts.obs_flat.cpu().numpy(),
                     "nets": _nets(ts.agent), "total_env_steps": ts.total_env_steps}
    return out


def _dp_small_inputs():
    """Phase 55's small run: the pool, the fresh state's pool rows and each of
    2 ranks' draws, from one CPU generator."""
    import torch

    from distributedconvrl_pde_control_torch.configs.ks import KS22, ks_random_init
    from distributedconvrl_pde_control_torch.train.batched import StepDraws

    c = DP_SMALL
    g = torch.Generator().manual_seed(c["draw_seed"])
    nl = c["n_envs"] // 2
    push = nl * KS22.n_actuators
    pool = ks_random_init(KS22, "cpu")(g, c["pool"])
    idx0 = torch.randint(0, c["pool"], (c["n_envs"],), generator=g)
    draws = [[StepDraws(noise=torch.randn((1, push), generator=g),
                        offs=torch.randint(0, (i + 1) * push, (1, c["batch"]), generator=g),
                        idx=torch.randint(0, c["pool"], (nl,), generator=g))
              for i in range(c["steps"])] for _ in range(2)]
    return pool, idx0, draws, push


def _dp_small_run(mesh) -> dict:
    """Phase 55's small run on a dp mesh of 1 rank (the 2 ranks' draws merged
    at twice the learner batch) or of 2 (each rank's own draws), from the same
    state: the records and the networks."""
    import dataclasses

    import torch

    from distributedconvrl_pde_control_torch.configs.ks import KS22, build_ks
    from distributedconvrl_pde_control_torch.parallel.batched_dp import (
        DPBatchedTrainer,
        merge_rank_draws,
    )
    from distributedconvrl_pde_control_torch.train.batched import BatchedTrainerConfig, StepDraws

    if mesh.device == "cpu":
        torch.set_num_threads(1)  # 2 envs a rank: more threads only add overhead
    dev = mesh.device
    pool, idx0, draws, push = _dp_small_inputs()
    setup = build_ks(dataclasses.replace(KS22, **DP_SMALL_KS), device=dev)
    tr = DPBatchedTrainer(setup.env, setup.agent,
                          BatchedTrainerConfig(n_envs=DP_SMALL["n_envs"],
                                               batch_size=DP_SMALL["batch"] * 2 // mesh.dp),
                          mesh, y0_pool=pool.to(dev))
    ts = tr.init(torch.Generator().manual_seed(DP_SMALL["seed"]), idx=idx0)
    mine = merge_rank_draws(draws, push) if mesh.dp == 1 else draws[mesh.dp_idx]
    mine = [StepDraws(**{k: getattr(d, k).to(dev) for k in ("noise", "offs", "idx")})
            for d in mine]
    ts, packed = tr.make_chunk_fn(DP_SMALL["steps"])(ts, mine)
    return {"packed": packed.cpu().numpy(), "nets": _nets(ts.agent), "backend": mesh.backend}


def _pop_routing(mesh) -> dict:
    """Phase 57's routing check: a P=2 chunk at 2 x 4 envs (CNAB2, per-member
    learning rates) on `mesh` and unsharded, from the same state."""
    import numpy as np
    import torch

    from distributedconvrl_pde_control_torch.configs.ks import KS22, build_ks
    from distributedconvrl_pde_control_torch.train.batched import BatchedTrainerConfig
    from distributedconvrl_pde_control_torch.train.hooks import unpack_records
    from distributedconvrl_pde_control_torch.train.population import PopulationTrainer

    setup = build_ks(KS22, device="cuda")
    pool = setup.random_init(torch.Generator().manual_seed(1), 6)
    cfg = BatchedTrainerConfig(n_envs=4, batch_size=16)
    lrs = dict(lr_actor=[5e-4, 2e-3], lr_critic=[1e-3, 4e-3])
    pops = [PopulationTrainer(setup.env, setup.agent, cfg, 2, y0_pool=pool, **lrs),
            PopulationTrainer(setup.env, setup.agent, cfg, 2, y0_pool=pool, mesh=mesh, **lrs)]
    out = []
    for pop in pops:
        ts = pop.init(torch.Generator(device="cuda").manual_seed(5))
        ts, packed = pop.make_chunk_fn(POP_CHUNK)(ts)
        recs = unpack_records(packed.cpu())
        out.append({"packed": packed.cpu().numpy(), "nets": _nets(ts.agent),
                    "members": [pop.member_records(recs, i) for i in range(2)]})
    same = all(np.array_equal(a[k], b[k]) for a, b in zip(out[0]["members"], out[1]["members"])
               for k in a)
    return {"records_equal": bool(np.array_equal(out[0]["packed"], out[1]["packed"])),
            "members_routed_equal": same, "net_err": _net_err(out[1]["nets"], out[0]["nets"]),
            "finite": bool(np.isfinite(out[1]["packed"]).all()), "backend": mesh.backend}


def _tp_one(mesh) -> dict:
    """Phase 58: one TP learn step at tp = 1 on the group against
    `learn_batch` (KS22's agent, a batch of LEARNER_BATCH)."""
    import torch

    from distributedconvrl_pde_control_torch.configs.ks import KS22, build_ks
    from distributedconvrl_pde_control_torch.parallel.tp import make_tp_learn_step, make_tp_mesh

    agent = build_ks(KS22, device="cuda").agent
    state = agent.init_state(torch.Generator(device="cuda").manual_seed(0), "cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    ns, na, b = agent.cfg.ns, agent.cfg.na_rows, LEARNER_BATCH

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    batch = (randn(ns, b), randn(na, b).clamp(-1, 1), randn(b),
             (torch.rand(b, generator=g, device="cuda") < 0.02).float(), randn(ns, b))
    tp_mesh = make_tp_mesh(1, "cuda")
    got = make_tp_learn_step(agent, tp_mesh)(state, batch)
    agent.learn_batch(state, batch)
    return {"max_abs_err": _net_err(_nets(got), _nets(state)), "backend": mesh.backend,
            "tp_group_backend": torch.distributed.get_backend(tp_mesh.group)}


def dp_child(out_json: str) -> int:
    """Phases 55-60 in a process of their own (no profiler session): data and
    tensor parallelism. The card's runs use NCCL process groups of one rank;
    phase 60's 2 ranks are gloo CPU ranks, last and alone. Writes K1's and K2's
    launches by path, the phases' seconds and records to `out_json`."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch

    import bench_multichip_torch
    from distributedconvrl_pde_control_torch.experiments import run
    from distributedconvrl_pde_control_torch.ops.kernels import ks_kernel
    from distributedconvrl_pde_control_torch.ops.kernels import ns_advection as k2
    from distributedconvrl_pde_control_torch.parallel.mesh import launch
    from distributedconvrl_pde_control_torch.train import checkpoint

    card = card_line()
    base = ROOT / "build" / "smoke_dp"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    k1_paths, k2_paths, record = {}, {}, {"card": card}

    def counted(fn, *args):
        """fn(*args) (its printed output captured and printed), its seconds and
        K1's and K2's launches in it."""
        ks_kernel.KS_CNAB2.launches = k2.NS_ADVECTION.launches = 0
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            result = fn(*args)
        torch.cuda.synchronize()
        print(buf.getvalue(), end="", flush=True)
        return (result, buf.getvalue(), time.perf_counter() - t0, ks_kernel.KS_CNAB2.launches,
                k2.NS_ADVECTION.launches)

    def nccl(fn, *args):
        return launch(fn, 1, 1, *args, backend="nccl", store_dir=str(base))

    def last_json(text):
        return json.loads(text.strip().splitlines()[-1])

    phase(f"== 55. DPBatchedTrainer on an NCCL group of one at bench.py's shape (KS22 sf tier, "
          f"{N_ENVS} envs, learner batch {LEARNER_BATCH}) against BatchedTrainer from the same "
          "state, chunks without device-to-host reads; then at 4 envs on merged rank draws")
    torch.cuda.reset_peak_memory_stats()
    full = nccl(_dp_full_width)
    a, b = full["no group"], full["NCCL group of one"]
    small = nccl(_dp_small_run)
    res55 = {"backend": full["backend"],
             "records_equal": bool(np.array_equal(a["packed"], b["packed"])),
             "obs_flat_equal": bool(np.array_equal(a["obs_flat"], b["obs_flat"])),
             "net_max_abs_err": _net_err(b["nets"], a["nets"]),
             "total_env_steps": b["total_env_steps"],
             "env_steps_per_s_no_group": a["env_steps_per_s"],
             "env_steps_per_s_nccl_group": b["env_steps_per_s"],
             "ms_per_train_step_no_group (turns 1, 4)": a["ms_per_train_step_in_turns"],
             "ms_per_train_step_nccl_group (turns 2, 3)": b["ms_per_train_step_in_turns"],
             "us_per_scalar_all_reduce": full["us_per_scalar_all_reduce"],
             "small_run_backend": small["backend"], **_peak(True)}
    print(json.dumps({"phase": 55, **res55, "card": card}), flush=True)
    record["55"] = res55
    np.savez(base / "small_card.npz", packed=small["packed"])
    check(full["backend"] == "nccl" and small["backend"] == "nccl",
          "the dp runs did not run on NCCL")
    check(res55["records_equal"] and res55["obs_flat_equal"] and res55["net_max_abs_err"] <= 1e-7,
          f"the NCCL dp 1 trainer differs from the single-device one: {res55}")
    check(res55["total_env_steps"] == 5 * TRAIN_CHUNK * N_ENVS, "the env steps are miscounted")
    del full, a, b

    phase(f"== 56. run.py KS22 --train --batched --mesh 1 on NCCL (CNAB2, 256 envs, "
          f"{DP_CLI['steps']} steps, an eval of {DP_CLI['eval_steps']} steps every "
          f"{DP_CLI['eval_every']}): K1 per train and eval step; the save read by the "
          "single-device --eval")
    torch.cuda.reset_peak_memory_stats()
    train_dir = str(base / "dp1")
    _, text, secs, k1, _ = counted(run.main, [
        "KS22", "--train", "--batched", "--mesh", "1", "--n-envs", "256", "--total-steps",
        str(DP_CLI["steps"]), "--chunk-len", "50", "--learner-batch", "256", "--eval-every",
        str(DP_CLI["eval_every"]), "--eval-steps", str(DP_CLI["eval_steps"]), "--out", train_dir])
    want_k1 = DP_CLI["steps"] + DP_CLI["steps"] // DP_CLI["eval_every"] * DP_CLI["eval_steps"]
    k1_paths["dp batched training on NCCL: train and eval steps (phase 56)"] = k1
    _, eval_text, eval_secs, eval_k1, _ = counted(run.main, [
        "KS22", "--eval", "--load-from", train_dir, "--p-te", "20", "--p-t-action", "10",
        "--out", str(base / "dp1_eval")])
    k1_paths["the dp save's single-device eval (phase 56)"] = eval_k1
    ev = last_json(eval_text)
    res56 = {"cli_seconds (setup and save included)": secs, "K1_launches": k1,
             "K1_launches_expected": want_k1, "summary": text.strip().splitlines()[-1],
             "single_device_eval": ev, "eval_K1_launches": eval_k1, "eval_seconds": eval_secs,
             **_peak(True)}
    print(json.dumps({"phase": 56, **res56, "card": card}), flush=True)
    record["56"] = res56
    check(k1 == want_k1, f"K1 launched {k1} times in the dp training, expected {want_k1}")
    check("over dp=1" in text and eval_k1 == 200 and all(np.isfinite(v) for v in ev.values()),
          f"the dp save's single-device eval failed: {ev}, K1 {eval_k1}")

    phase(f"== 57. run.py KS22 --train --batched --population 2 --mesh 1 on NCCL (CNAB2, 2 x 128 "
          f"envs, {POP_CLI['steps']} steps, an eval of {POP_CLI['eval_steps']} steps every "
          f"{POP_CLI['eval_every']}); a P=2 chunk on the group against the unsharded population")
    pop_dir = base / "pop"
    _, text, secs, k1, _ = counted(run.main, [
        "KS22", "--train", "--batched", "--population", "2", "--mesh", "1", "--n-envs", "128",
        "--total-steps", str(POP_CLI["steps"]), "--chunk-len", "50", "--learner-batch", "256",
        "--eval-every", str(POP_CLI["eval_every"]), "--eval-steps", str(POP_CLI["eval_steps"]),
        "--out", str(pop_dir)])
    want_k1 = POP_CLI["steps"] + POP_CLI["steps"] // POP_CLI["eval_every"] * POP_CLI["eval_steps"]
    k1_paths["population x dp training on NCCL: train and eval steps (phase 57)"] = k1
    members = [checkpoint.load_best_actor(str(pop_dir / f"member_0{i}")) for i in range(2)]
    finite = all(np.isfinite(l[k]).all() for m in members for l in m for k in ("w", "b"))
    routing, _, rsecs, rk1, _ = counted(nccl, _pop_routing)
    k1_paths["population x dp routing chunks on NCCL and unsharded (phase 57)"] = rk1
    res57 = {"cli_seconds": secs, "K1_launches": k1, "K1_launches_expected": want_k1,
             "members_finite": finite, "population_json": json.loads(
                 (pop_dir / "population.json").read_text())["ranking"][0]["best_reward"],
             "routing": routing, "routing_K1_launches": rk1}
    print(json.dumps({"phase": 57, **res57, "card": card}), flush=True)
    record["57"] = res57
    check(k1 == want_k1, f"K1 launched {k1} times in the population x dp run, expected {want_k1}")
    check(finite, "a member's best actor is not finite")
    check(routing["backend"] == "nccl" and routing["records_equal"]
          and routing["members_routed_equal"] and routing["finite"]
          and routing["net_err"] <= 1e-7 and rk1 == 2 * POP_CHUNK,
          f"the population over the NCCL group differs from the unsharded one: {routing}, K1 {rk1}")

    phase("== 58. make_tp_learn_step at tp = 1 on an NCCL group against learn_batch")
    tp = nccl(_tp_one)
    print(json.dumps({"phase": 58, **tp, "card": card}), flush=True)
    record["58"] = tp
    check(tp["backend"] == "nccl" and tp["tp_group_backend"] == "nccl"
          and tp["max_abs_err"] <= 1e-5, f"the TP step differs from learn_batch: {tp}")

    phase("== 59. bench_multichip_torch.py --meshes 1x1 --nx 256 (fluid) and --family ks-dp "
          f"--meshes 1x1 --n-envs {N_ENVS}")
    lines = {}
    for family, argv in (("fluid", ["--meshes", "1x1", "--nx", "256"]),
                         ("ks-dp", ["--family", "ks-dp", "--meshes", "1x1", "--n-envs",
                                    str(N_ENVS)])):
        rc, text, secs, k1, k2n = counted(bench_multichip_torch.main, argv)
        check(rc == 0, f"bench_multichip_torch.py {' '.join(argv)} exited {rc}")
        lines[family] = {"line": last_json(text), "seconds": secs, "K1": k1, "K2": k2n}
    c = BENCH_FLUID
    train_steps = c["chunk"] + 2 * (c["chunk"] + 2 * c["steps"])  # warm-up + 2 modes x (warm + 2)
    want_k2 = 4 * c["substeps"] * train_steps
    k2_paths["bench_multichip_torch.py fluid 1x1 on NCCL (phase 59)"] = lines["fluid"]["K2"]
    res59 = {f: {"seconds": v["seconds"], "K2_launches": v["K2"]} for f, v in lines.items()}
    res59["fluid"]["K2_launches_expected"] = want_k2
    print(json.dumps({"phase": 59, **res59, "card": card}), flush=True)
    record["59"] = {**res59, "lines": {f: v["line"] for f, v in lines.items()}}
    check(all(v["line"]["backend"] == "nccl" for v in lines.values()),
          f"the bench did not run on NCCL: {lines}")
    check(lines["fluid"]["K2"] == want_k2 and lines["ks-dp"]["K2"] == 0
          and lines["ks-dp"]["K1"] == 0,
          f"K2 launched {lines['fluid']['K2']} times in the bench's fluid run, expected {want_k2}")

    # last and alone: CPU ranks, whose seconds are CPU seconds
    phase("== 60. DPBatchedTrainer on 2 gloo CPU ranks against phase 55's small card run")
    t0 = time.perf_counter()
    cpu = launch(_dp_small_run, 2, 1, backend="gloo", store_dir=str(base))
    cpu_secs = time.perf_counter() - t0
    got, want = cpu["packed"], small["packed"]
    res60 = {"backend": cpu["backend"],
             "finished_equal": bool(np.array_equal(got[[0, 1, 3]], want[[0, 1, 3]])),
             "episodes": float(want[0].sum()),
             "ep_reward_max_abs_err": float(np.abs(got[2] - want[2]).max()),
             "mean_reward_max_abs_err": float(np.abs(got[4] - want[4]).max()),
             "net_err_of_max": _net_err(cpu["nets"], small["nets"], of_max=True),
             "cpu_seconds (2 gloo ranks, not a speed of the port)": cpu_secs,
             **_peak(False)}
    print(json.dumps({"phase": 60, **res60, "card": card}), flush=True)
    record["60"] = res60
    check(res60["backend"] == "gloo" and res60["finished_equal"]
          and res60["episodes"] == DP_SMALL["n_envs"] and res60["ep_reward_max_abs_err"] <= 1e-3
          and res60["mean_reward_max_abs_err"] <= 1e-4 and res60["net_err_of_max"] <= 1e-4,
          f"the 2 CPU ranks' run is outside the limits of the card's: {res60}")
    Path(out_json).write_text(json.dumps({"K1": k1_paths, "K2": k2_paths, "record": record},
                                         default=str))
    return 0


def dp_phases(card: str) -> dict:
    """Phases 55-60, in a process of their own. Returns K1's and K2's
    launches on the data-parallel paths."""
    phase("-- phases 55-60 in a process of their own")
    out_json = ROOT / "build" / "smoke_dp.json"
    out_json.unlink(missing_ok=True)
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--dp-child",
                           str(out_json)], cwd=str(ROOT), timeout=600)
    check(proc.returncode == 0 and out_json.exists(),
          f"phases 55-60 failed in their process (exit {proc.returncode})")
    got = json.loads(out_json.read_text())
    return {"K1": got["K1"], "K2": got["K2"]}


# ------------------------------------------------- every grid the JAX package steps (61)
# phase 61: K2 against its plain version at grids other than the fluid path's 256^2, powers of
# two or not, odd ones included (label, n, batch), and K1 at grids that are not multiples of 4
# (label, nx, batch; 30 substeps, ||y|| ~ 30 as phase 3's larger shapes); the tolerances of
# phases 3 and 8 (K1 1e-3 absolute, K2 1e-4 of max|want|)
# the grids above the block route's shared-memory limits take the device route: K2 at n = 4097
# (17 x 241), 4099 (prime: Bluestein over 8640), 6144, 6561 (3^8) and 8192; K1 at nx = 4320,
# 4327 (prime: Bluestein over 8748) and 8192 at 2 and 64 rows
GRID_K2_SHAPES = [("n24_b4", 24, 4), ("n45_b2", 45, 2), ("n96_b16", 96, 16), ("n176_b4", 176, 4),
                  ("n384_b16", 384, 16), ("n2048_b1", 2048, 1), ("n4096_b1", 4096, 1),
                  ("n4097_b1", 4097, 1), ("n4099_b1", 4099, 1), ("n6144_b1", 6144, 1),
                  ("n6561_b1", 6561, 1), ("n8192_b1", 8192, 1)]
GRID_K1_SHAPES = [("nx45_b33", 45, 33), ("nx50_b7", 50, 7), ("nx190_b16384", 190, N_ENVS),
                  ("nx250_b37", 250, 37), ("nx4320_b2", 4320, 2), ("nx4320_b64", 4320, 64),
                  ("nx4327_b2", 4327, 2), ("nx4327_b64", 4327, 64), ("nx8192_b2", 8192, 2),
                  ("nx8192_b64", 8192, 64)]
# timed shapes beside their bounds, with the iterations of the kernel's and the plain timing
GRID_K2_TIMED = [(96, 1, 200, 50), (96, 16, 200, 50), (384, 1, 200, 50), (384, 16, 100, 20),
                 (2048, 1, 20, 5), (2048, 16, 5, 3), (4096, 1, 10, 3), (4096, 16, 3, 2),
                 (4097, 1, 3, 2), (4099, 1, 3, 2), (6144, 1, 3, 2), (6561, 1, 3, 2),
                 (8192, 1, 3, 2)]
GRID_K1_TIMED = [(190, N_ENVS, 20, 5), (190, 1, 200, 5), (250, N_ENVS, 20, 5), (250, 1, 200, 5),
                 (45, N_ENVS, 20, 5), (45, 1, 200, 5), (4320, 2, 20, 5), (4320, 64, 10, 5),
                 (4327, 2, 10, 5), (4327, 64, 10, 5), (8192, 2, 20, 5), (8192, 64, 10, 5)]
# the device route forced at the main paths' shapes: both wrappers' SMEM_LIMIT patched to a
# value that no block-route line of 96^2, 192 or 256^2 fits
FORCED_SMEM_LIMIT = 4096
FORCED_K2_SUBSTEPS = 2
GRID_FLUID_NX, GRID_FLUID_P_TE = 96, 0.05  # --mesh 1x1 --eval: 2 env steps at 96^2
GRID_KS_NX, GRID_KS_P_TE = 190, 20.0  # KS22 --eval: 200 env steps at nx = 190
# the paper's zero-shot transfer at 10x KS500's domain (reproduce.py:124-158 does KS200 -> KS500)
TRANSFER_OVERRIDES = {"lx": 5000.0, "nx": 6000, "n_actuators": 2000}
TRANSFER_P_TE = 20.0
GRID_REL = 1e-4  # the card's CLI run against its --cpu run


@contextlib.contextmanager
def device_route_forced():
    """Inside it, both wrappers take the device route at every grid of the main paths."""
    from distributedconvrl_pde_control_torch.ops.kernels import ks_kernel
    from distributedconvrl_pde_control_torch.ops.kernels import ns_advection as k2

    saved = (ks_kernel.SMEM_LIMIT, k2.SMEM_LIMIT)
    ks_kernel.SMEM_LIMIT = k2.SMEM_LIMIT = FORCED_SMEM_LIMIT
    try:
        yield
    finally:
        ks_kernel.SMEM_LIMIT, k2.SMEM_LIMIT = saved


@contextlib.contextmanager
def no_plain_route():
    """Inside it, torch.fft and both kernels' plain versions raise: a wrapper
    that reached any of them on a CUDA tensor fails the phase."""
    import torch

    from distributedconvrl_pde_control_torch.ops.kernels import ks_kernel
    from distributedconvrl_pde_control_torch.ops.kernels import ns_advection as k2

    def refuse(*args, **kwargs):
        raise RuntimeError("a plain route was taken on the card")

    patched = [(torch.fft, name) for name in ("fft", "ifft", "fft2", "ifft2", "rfft", "irfft",
                                               "rfft2", "irfft2", "fftn", "ifftn")]
    patched += [(k2, "ns_advection_plain"), (k2, "ns_rhs_plain"), (k2, "ns_rk4_plain"),
                (ks_kernel, "ks_cnab2_plain")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in patched]
    for mod, name in patched:
        setattr(mod, name, refuse)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def grids_child(out_json: str) -> int:
    """Phase 61 in a process of its own (no profiler session): both kernels
    on every grid the JAX package steps. Writes the kernels' launches by
    path and the new shapes' times to `out_json`."""
    import dataclasses
    import io

    import numpy as np
    import torch

    from distributedconvrl_pde_control_torch.configs.fluid import FLUID_16_256
    from distributedconvrl_pde_control_torch.configs.ks import KS22, KS500
    from distributedconvrl_pde_control_torch.experiments import run
    from distributedconvrl_pde_control_torch.ops.kernels import device_route, ks_kernel
    from distributedconvrl_pde_control_torch.ops.kernels import ns_advection as k2
    from distributedconvrl_pde_control_torch.ops.ks import KSSolver
    from distributedconvrl_pde_control_torch.parallel.ns_sharded import make_sharded_ops

    card = card_line()
    base = ROOT / "build" / "smoke_grids"
    base.mkdir(parents=True, exist_ok=True)
    record = {"card": card}

    phase("== 61. K1 and K2 on every grid: each against its plain version at grids that are not "
          "the main paths' (mixed radix, odd, above 1024, and on the device route above the "
          "shared-memory limits), the device route forced at the main shapes, each timed beside "
          "its bound, the CLIs at such grids card vs CPU (the KS transfer to Lx = 5000 among "
          "them), and bench_decomp_torch.py / bench_population_torch.py cut in depth")
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(61)
    k2_inputs, parity = {}, {}
    for label, n, batch in GRID_K2_SHAPES:
        w = torch.fft.fft2(torch.tensor(rng.standard_normal((batch, n, n)), dtype=torch.float32,
                                        device="cuda"))
        consts = make_sharded_ops(n, n, device="cuda")  # the fluid path's constants
        k2_inputs[(n, batch)] = (w, consts)
        before = k2.NS_ADVECTION.launches
        with no_plain_route():
            got = k2.ns_advection(w, consts)
        torch.cuda.synchronize()
        launched = k2.NS_ADVECTION.launches - before
        want = k2.ns_advection_plain(w, consts)
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        parity[f"K2 {label}"] = {"max_abs_err": err, "err_of_scale": err / scale,
                                 "route": k2.route(n)}
        print(f"K2 {label} ({k2.route(n)} route): max_abs_err {err:.3e} = {err / scale:.2e} of "
              f"max|want| {scale:.4e} (rtol {K2_RTOL:.0e} of it), {launched} launch", flush=True)
        check(launched == 1 and bool(torch.isfinite(torch.view_as_real(got)).all())
              and err <= K2_RTOL * scale, f"K2 disagrees at {label}")
        del want, got
    for label, nx, batch in GRID_K1_SHAPES:
        solver = KSSolver(nx=nx, lx=22.0, dt=0.1, oversampling=30, mu=0.02, device="cuda")
        y = torch.tensor(3.0 * rng.standard_normal((batch, nx)), dtype=torch.float32, device="cuda")
        f = torch.tensor(rng.standard_normal((batch, nx)), dtype=torch.float32, device="cuda")
        before = ks_kernel.KS_CNAB2.launches
        with no_plain_route():
            got = ks_kernel.ks_cnab2_step(y, f, solver)
        torch.cuda.synchronize()
        launched = ks_kernel.KS_CNAB2.launches - before
        want = ks_kernel.ks_cnab2_plain(y, f, solver)
        err = (got - want).abs().max().item()
        parity[f"K1 {label}"] = {"max_abs_err": err, "route": ks_kernel.route(nx)}
        print(f"K1 {label} ({ks_kernel.route(nx)} route): max_abs_err {err:.3e} (atol 1e-3), "
              f"max|y'| {want.abs().max().item():.3f}, stages {ks_kernel.factor_radices(nx)}, "
              f"{launched} launch", flush=True)
        check(launched == 1 and bool(torch.isfinite(got).all()) and err <= 1e-3,
              f"K1 disagrees at {label}")
    record["parity"] = parity

    # the device route forced at the main paths' shapes, against the block route
    forced, k2_times, k1_times = {}, {}, {}
    solver = KSSolver(nx=192, lx=22.0, dt=0.1, oversampling=30, mu=0.02, device="cuda")
    y = torch.tensor(3.0 * rng.standard_normal((N_ENVS, 192)), dtype=torch.float32, device="cuda")
    f = torch.tensor(rng.standard_normal((N_ENVS, 192)), dtype=torch.float32, device="cuda")
    want = ks_kernel.ks_cnab2_step(y, f, solver)
    with device_route_forced():
        check(ks_kernel.route(192) == "device", "K1's device route was not forced at nx = 192")
        before = ks_kernel.KS_CNAB2.launches
        with no_plain_route():
            got = ks_kernel.ks_cnab2_step(y, f, solver)
        torch.cuda.synchronize()
        launched = ks_kernel.KS_CNAB2.launches - before
        err = (got - want).abs().max().item()
        forced["K1 16384x192"] = {"max_abs_err_vs_block": err, "launches": launched}
        device_ms = cuda_ms(lambda: ks_kernel.ks_cnab2_step(y, f, solver), 5)
    k1_times["16384x192 device route (forced)"] = {
        "ms": device_ms, "block_ms": cuda_ms(lambda: ks_kernel.ks_cnab2_step(y, f, solver), 20)}
    check(launched == 1 and err <= 1e-3, f"K1's device route differs from its block route: {err}")
    consts = make_sharded_ops(256, 256, device="cuda")
    lin = (-5e-5 * consts.k2).contiguous()
    for batch in (1, 16):
        w = torch.fft.fft2(torch.tensor(rng.standard_normal((batch, 256, 256)),
                                        dtype=torch.float32, device="cuda"))
        fw = (0.01 * w).contiguous()
        want = k2.ns_rk4_substeps(w, consts, lin, fw, 2.5e-4, FORCED_K2_SUBSTEPS)
        block_ms = cuda_ms(lambda: k2.ns_rk4_substeps(w, consts, lin, fw, 2.5e-4, 20), 3) / 80
        with device_route_forced():
            check(k2.route(256) == "device", "K2's device route was not forced at n = 256")
            before = k2.NS_ADVECTION.launches
            with no_plain_route():
                got = k2.ns_rk4_substeps(w, consts, lin, fw, 2.5e-4, FORCED_K2_SUBSTEPS)
            torch.cuda.synchronize()
            launched = k2.NS_ADVECTION.launches - before
            err, scale = (got - want).abs().max().item(), want.abs().max().item()
            stage_ms = cuda_ms(lambda: k2.ns_rk4_substeps(w, consts, lin, fw, 2.5e-4, 20), 3) / 80
        forced[f"K2 rk4 256^2 b{batch}"] = {"err_of_scale_vs_block": err / scale,
                                            "launches": launched}
        k2_times[f"n256_b{batch} stage, device route (forced)"] = {"ms": stage_ms,
                                                                  "block_ms": block_ms}
        check(launched == 4 * FORCED_K2_SUBSTEPS and err <= K2_RTOL * scale,
              f"K2's device route differs from its block route at batch {batch}: {err / scale}")
    print(json.dumps({"device route forced at the main shapes": forced,
                      "K1": k1_times, "K2": k2_times, "card": card}), flush=True)
    record["forced"] = forced

    # times beside the bounds
    for n, batch, iters, plain_iters in GRID_K2_TIMED:
        w, consts = k2_inputs.get((n, batch)) or (None, make_sharded_ops(n, n, device="cuda"))
        if w is None:
            w = torch.fft.fft2(torch.tensor(rng.standard_normal((batch, n, n)),
                                            dtype=torch.float32, device="cuda"))
        b_ms = 1e3 * k2.min_bytes(n, batch) / PEAK_BYTES_PER_S
        o_ms = 1e3 * k2.flops(n, batch) / PEAK_F32_FLOPS
        k2_times[f"n{n}_b{batch}"] = t = {
            "ms": cuda_ms(lambda: k2.ns_advection(w, consts), iters),
            "plain_ms": cuda_ms(lambda: k2.ns_advection_plain(w, consts), plain_iters),
            "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms > o_ms else "operations",
            "library_ms": None, "route": k2.route(n)}
        if k2.route(n) == "block":
            t.update(column_tile=k2.column_tile(n, batch), row_pairs=k2.row_pairs(n, batch))
        else:
            t["levels"] = list(device_route.device_plan(n, k2.SMEM_LIMIT).levels)
        print(f"K2 n={n} batch {batch} ({t['route']} route): {t['ms']:.4f} ms/call, plain "
              f"{t['plain_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']}; x{t['ms'] / t['bound_ms']:.1f}); {card}",
              flush=True)
        del w
    for nx, batch, iters, plain_iters in GRID_K1_TIMED:
        solver = KSSolver(nx=nx, lx=22.0, dt=0.1, oversampling=30, device="cuda")
        y = torch.tensor(3.0 * rng.standard_normal((batch, nx)), dtype=torch.float32, device="cuda")
        f = torch.tensor(rng.standard_normal((batch, nx)), dtype=torch.float32, device="cuda")
        b_ms = 1e3 * 3 * batch * nx * 4 / PEAK_BYTES_PER_S
        o_ms = 1e3 * ks_kernel.flops_per_row(nx, 30) * batch / PEAK_F32_FLOPS
        k1_times[f"{batch}x{nx}"] = t = {
            "ms": cuda_ms(lambda: ks_kernel.ks_cnab2_step(y, f, solver), iters),
            "plain_ms": cuda_ms(lambda: ks_kernel.ks_cnab2_plain(y, f, solver), plain_iters),
            "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms > o_ms else "operations",
            "library_ms": None, "route": ks_kernel.route(nx)}
        if ks_kernel.route(nx) == "block":
            t["launch_shape"] = list(ks_kernel.launch_shape(nx, batch))
        else:
            plan = device_route.device_plan(nx, ks_kernel.SMEM_LIMIT)
            t["levels"], t["bluestein_m"] = list(plan.levels), plan.m if plan.bluestein else None
        print(f"K1 {batch}x{nx}, 30 substeps ({t['route']} route): {t['ms']:.4f} ms/launch, plain "
              f"{t['plain_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.6f} ms ({t['bound_by']}; x{t['ms'] / t['bound_ms']:.1f}); {card}",
              flush=True)
    record["K2_times"], record["K1_times"] = k2_times, k1_times

    def cli(argv):
        """The CLI's last line, and the kernels' launches in it."""
        k1_0, k2_0 = ks_kernel.KS_CNAB2.launches, k2.NS_ADVECTION.launches
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run.main(argv)
        print(buf.getvalue(), end="", flush=True)
        return (json.loads(buf.getvalue().strip().splitlines()[-1]),
                ks_kernel.KS_CNAB2.launches - k1_0, k2.NS_ADVECTION.launches - k2_0)

    fluid = ["Fluid_16_256", "--mesh", "1x1", "--eval", "--load-from",
             str(ROOT / "artifacts" / "Fluid_16_256"), "--nx", str(GRID_FLUID_NX), "--p-te",
             str(GRID_FLUID_P_TE)]
    got, _, k2_fluid = cli(fluid + ["--out", str(base / "fluid_card")])
    want, _, _ = cli(fluid + ["--cpu", "--out", str(base / "fluid_cpu")])
    n_steps = int(round(GRID_FLUID_P_TE / FLUID_16_256.dt))
    substeps = dataclasses.replace(FLUID_16_256, nx=GRID_FLUID_NX).oversampling  # 16 nx dt
    k2_want = 2 * 4 * substeps * n_steps  # trained and no action
    rel = max(abs(got[k] - want[k]) / abs(want[k]) for k in ("trained", "no action"))
    record["fluid_cli"] = {"card": got, "cpu": want, "rel": rel, "K2_launches": k2_fluid,
                           "K2_launches_expected": k2_want}
    print(json.dumps({"phase": 61, "fluid --mesh 1x1 --eval --nx": GRID_FLUID_NX,
                      **record["fluid_cli"]}), flush=True)
    check(got["grid"] == GRID_FLUID_NX and rel <= GRID_REL,
          f"the fluid eval at {GRID_FLUID_NX}^2 differs card vs CPU by rel {rel}")
    check(k2_fluid == k2_want, f"K2 launched {k2_fluid} times in the fluid eval, expected {k2_want}")
    with device_route_forced():  # the same eval with every K2 stage on the device route
        check(k2.route(GRID_FLUID_NX) == "device", "K2's device route was not forced at 96^2")
        got_dm, _, k2_fluid_dm = cli(fluid + ["--out", str(base / "fluid_card_device_route")])
    rel_dm = max(abs(got_dm[k] - want[k]) / abs(want[k]) for k in ("trained", "no action"))
    record["fluid_cli_device_route"] = {"card": got_dm, "rel": rel_dm, "K2_launches": k2_fluid_dm}
    print(json.dumps({"phase": 61, "fluid --mesh 1x1 --eval --nx, K2's device route forced":
                      GRID_FLUID_NX, **record["fluid_cli_device_route"]}), flush=True)
    check(rel_dm <= GRID_REL and k2_fluid_dm == k2_want,
          f"the fluid eval on K2's device route differs card vs CPU by rel {rel_dm} "
          f"({k2_fluid_dm} launches)")

    ks = ["KS22", "--eval", "--load-from", str(ROOT / "artifacts" / "KS22"), "--config-overrides",
          json.dumps({"nx": GRID_KS_NX}), "--p-te", str(GRID_KS_P_TE)]
    got, k1_ks, _ = cli(ks + ["--out", str(base / "ks_card")])
    want, _, _ = cli(ks + ["--cpu", "--out", str(base / "ks_cpu")])
    k1_want = int(round(GRID_KS_P_TE / KS22.dt))
    diff = abs(got["suppression"] - want["suppression"])
    record["ks_cli"] = {"card": got, "cpu": want, "abs_diff": diff, "K1_launches": k1_ks,
                        "K1_launches_expected": k1_want}
    print(json.dumps({"phase": 61, "KS22 --eval nx": GRID_KS_NX, **record["ks_cli"]}), flush=True)
    check(diff <= GRID_REL, f"the KS22 nx={GRID_KS_NX} suppression differs card vs CPU by {diff}")
    check(k1_ks == k1_want, f"K1 launched {k1_ks} times in the KS eval, expected {k1_want}")

    # the paper's zero-shot transfer, to a domain 10x KS500's (K1's device route at nx = 6000)
    transfer = ["KS500", "--eval", "--load-from", str(ROOT / "artifacts" / "KS200_batched_lh"),
                "--config-overrides", json.dumps(TRANSFER_OVERRIDES), "--p-te", str(TRANSFER_P_TE)]
    check(ks_kernel.route(TRANSFER_OVERRIDES["nx"]) == "device",
          "the transfer's grid is on the block route")
    t0 = time.perf_counter()
    got, k1_transfer, _ = cli(transfer + ["--out", str(base / "transfer_card")])
    card_s = time.perf_counter() - t0
    want, _, _ = cli(transfer + ["--cpu", "--out", str(base / "transfer_cpu")])
    k1_transfer_want = int(round(TRANSFER_P_TE / KS500.dt))
    diff = abs(got["suppression"] - want["suppression"])
    record["transfer_cli"] = {"card": got, "cpu": want, "abs_diff": diff, "seconds_card": card_s,
                              "K1_launches": k1_transfer, "K1_launches_expected": k1_transfer_want}
    print(json.dumps({"phase": 61, "KS500 --eval transfer": TRANSFER_OVERRIDES,
                      **record["transfer_cli"]}), flush=True)
    check(diff <= GRID_REL, f"the transfer's suppression differs card vs CPU by {diff}")
    check(k1_transfer == k1_transfer_want,
          f"K1 launched {k1_transfer} times in the transfer, expected {k1_transfer_want}")

    # the two root scripts through their entry points, cut in depth only
    import bench_decomp_torch
    import bench_population_torch

    benches = {}
    for script, args in ((bench_decomp_torch, ["--chunks", "1", "--chunk-len", "5",
                                               "--driver-chunks", "1"]),
                         (bench_population_torch, ["--chunks", "1", "--chunk-len", "5"])):
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = script.main(args)
        print(buf.getvalue(), end="", flush=True)
        check(rc == 0, f"{script.__name__} failed (exit {rc})")
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        benches[script.__name__] = {**line, "seconds": time.perf_counter() - t0}
        check(line["device"] == torch.cuda.get_device_name(0)
              and all(r > 0 for r in line["env_steps_per_s"].values()),
              f"{script.__name__}'s line is malformed: {line}")
    record["benches"] = {k: {"seconds": v["seconds"]} for k, v in benches.items()}
    record["peak_device_mb"] = torch.cuda.max_memory_allocated() / 2**20
    Path(out_json).write_text(json.dumps({
        "K1": {"KS22 nx=190 --eval (phase 61)": k1_ks,
               "KS500 Lx=5000 nx=6000 transfer --eval (phase 61)": k1_transfer},
        "K2": {"Fluid_16_256 --mesh 1x1 --eval --nx 96 (phase 61)": k2_fluid,
               "the same on the device route (phase 61)": k2_fluid_dm},
        "K1_times": k1_times, "K2_times": k2_times,
        "K1_max_abs_err": max(v["max_abs_err"] for k, v in parity.items() if k.startswith("K1")),
        "K2_max_err_of_scale": max(v["err_of_scale"] for k, v in parity.items()
                                   if k.startswith("K2")),
        "record": record}))
    return 0


def grids_phases(card: str) -> dict:
    """Phase 61, in a process of its own. Returns what grids_child wrote."""
    phase("-- phase 61 in a process of its own")
    out_json = ROOT / "build" / "smoke_grids.json"
    out_json.unlink(missing_ok=True)
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--grids-child",
                           str(out_json)], cwd=str(ROOT), timeout=600)
    check(proc.returncode == 0 and out_json.exists(),
          f"phase 61 failed in its process (exit {proc.returncode})")
    return json.loads(out_json.read_text())


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--train-only", action="store_true",
                        help="run phases 1, 2 and 14-22 and print no result line")
    parser.add_argument("--times-only", action="store_true",
                        help="time both kernels through their wrappers and stop")
    parser.add_argument("--fidelity-only", action="store_true",
                        help="run phases 1, 2 and 23-28 and print no result line")
    parser.add_argument("--tree", default=None,
                        help="with --times-only: checkout to import the port from")
    parser.add_argument("--families-only", action="store_true",
                        help="run phases 1, 2 and 29-33 and print no result line")
    parser.add_argument("--agents-only", action="store_true",
                        help="run phases 1, 2 and 34-39 and print no result line")
    parser.add_argument("--tiers-only", action="store_true",
                        help="run phases 1, 2 and 40-44 and end with the ok line")
    parser.add_argument("--tools-only", action="store_true",
                        help="run phases 1, 2 and 45-50 and end with the ok line")
    parser.add_argument("--mesh-only", action="store_true",
                        help="run phases 1, 2 and 51-54 and end with the ok line")
    parser.add_argument("--dp-only", action="store_true",
                        help="run phases 1, 2 and 55-60 and end with the ok line")
    parser.add_argument("--grids-only", action="store_true",
                        help="run phases 1, 2 and 61 and end with the ok line")
    parser.add_argument("--fidelity-child", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--agents-child", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--families-child", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--tiers-child", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--tools-child", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--mesh-child", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--dp-child", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--grids-child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "distributedconvrl_pde_control_torch" / "__init__.py").exists():
        print(f"chip_smoke: the port's package is not beside this script in {ROOT}; run it from "
              "the repository's root", file=sys.stderr)
        return 1
    children = {"fidelity_child": fidelity_child, "families_child": families_child,
                "agents_child": agents_child, "tiers_child": tiers_child,
                "tools_child": tools_child, "mesh_child": mesh_child, "dp_child": dp_child,
                "grids_child": grids_child}
    for name, child in children.items():
        if getattr(args, name):
            rc = child(getattr(args, name))
            print_phase_seconds()
            return rc
    if args.times_only:
        return times_only(args.tree)
    if args.tree:
        parser.error("--tree needs --times-only")
    import numpy as np

    import dataclasses
    from concurrent.futures import ThreadPoolExecutor

    from distributedconvrl_pde_control_torch.configs.fluid import FLUID_16_256
    from distributedconvrl_pde_control_torch.configs.ks import KS22, build_ks
    from distributedconvrl_pde_control_torch.ops.kernels import build, ks_kernel
    from distributedconvrl_pde_control_torch.ops.kernels import ns_advection as k2
    from distributedconvrl_pde_control_torch.ops.ks import KSSolver
    from distributedconvrl_pde_control_torch.ops.navier_stokes import initial_condition
    from distributedconvrl_pde_control_torch.parallel.multichip import (
        ShardedFluidTrainer,
        ShardedTrainConfig,
        load_actor_for_eval,
    )
    from distributedconvrl_pde_control_torch.parallel.ns_sharded import make_sharded_ops
    from distributedconvrl_pde_control_torch.train.batched import BatchedTrainer, BatchedTrainerConfig
    from distributedconvrl_pde_control_torch.train.checkpoint import actor_from_jax, load_best_actor
    from distributedconvrl_pde_control_torch.train.eval import actor_policy, rollout

    dev = "cuda"
    phase("== 1. device")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    phase("== 2. build")
    t0 = time.perf_counter()
    sources = (ks_kernel.SOURCE, k2.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, started together
        logs = list(pool.map(build.build, sources))
    print(f"built {', '.join(sources)} in {time.perf_counter() - t0:.1f} s")
    for source, log in zip(sources, logs):
        for line in log.splitlines():
            if "ptxas" in line:
                print(f"{source}: {line.strip()}")
    pairs, threads = ks_kernel.launch_shape(192, N_ENVS)
    print(f"K1 at 192 points x {N_ENVS} rows: stages {ks_kernel.factor_radices(192)}, {pairs} row "
          f"pairs and {threads} threads per CTA, {ks_kernel.smem_bytes(192, pairs)} B of dynamic "
          f"shared memory")
    print(f"K2 at 256^2: batch 1 column tile {k2.column_tile(256, 1)}, {k2.row_pairs(256, 1)} row "
          f"pair(s) per block; batch 16 column tile {k2.column_tile(256, 16)}, "
          f"{k2.row_pairs(256, 16)} row pairs per block")

    if args.fidelity_only:
        print(json.dumps({"K1_launches_on_the_fidelity_paths": fidelity_phases(card)}))
        return 0
    if args.families_only:
        families_phases(card)
        return 0
    if args.agents_only:
        print(json.dumps({"K1_launches_on_the_agent_paths": agents_phases(card)}))
        return 0
    if args.tiers_only or args.tools_only or args.mesh_only or args.dp_only or args.grids_only:
        if args.grids_only:
            got = grids_phases(card)
            launches = {"K1": got["K1"], "K2": got["K2"]}
        else:
            launches = (tiers_phases(card) if args.tiers_only else {"K1": tools_phases(card)}
                        if args.tools_only else {"K2": mesh_phases(card)} if args.mesh_only
                        else dp_phases(card))
        print_phase_seconds()
        print(json.dumps({"launches_on_the_tier_paths" if args.tiers_only
                          else "launches_on_the_tool_paths" if args.tools_only
                          else "launches_on_the_mesh_paths" if args.mesh_only
                          else "launches_on_the_grid_paths" if args.grids_only
                          else "launches_on_the_dp_paths": launches}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if args.train_only:
        k1_training = train_phases(card)
        print(json.dumps({"K1_launches_on_the_training_path": k1_training,
                          "K2_launches_on_the_training_path": fluid_train_phases(card)}))
        return 0

    phase("== 3. K1 against its plain version")
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
            amp_y, amp_f = {8: (0.4, 0.2), 4: (0.0, 0.0), 512: (0.3, 0.1), 33: (3.0, 1.0),
                            37: (3.0, 1.0)}[batch]
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

    phase("== 4. KS22 reproduce protocol (te=200, actuation from t=100)")
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

    phase(f"== 5. batched eval: {N_ENVS} envs, {EVAL_STEPS} steps after {EVAL_WARMUP} warm-up steps")
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

    phase("== 6. K1 time at the slice's shapes")
    solver = KSSolver(nx=192, lx=22.0, dt=0.1, oversampling=30, device=dev)
    k_ms = cuda_ms(lambda: ks_kernel.ks_cnab2_step(slice_y, slice_f, solver), 20)
    plain_ms = cuda_ms(lambda: ks_kernel.ks_cnab2_plain(slice_y, slice_f, solver), 5)
    n_bytes = 3 * N_ENVS * 192 * 4
    flops = ks_kernel.flops_per_row(192, 30) * N_ENVS
    bytes_ms, ops_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_F32_FLOPS
    bound_ms = max(bytes_ms, ops_ms)
    step_ms = 1e3 * N_ENVS / rates["min"]
    print(f"K1 {k_ms:.4f} ms/launch (first design {FIRST_DESIGN_MS['K1 16384x192']} ms), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"(bytes {bytes_ms:.4f} ms for {n_bytes} B, operations {ops_ms:.4f} ms for {flops:.0f} flop: FFT count); "
          f"K1 is {100 * k_ms / step_ms:.1f}% of the {step_ms:.4f} ms batched env step; {card}")
    one_y, one_f = slice_y[:1].contiguous(), slice_f[:1].contiguous()
    k1_one = {"ms": cuda_ms(lambda: ks_kernel.ks_cnab2_step(one_y, one_f, solver), 200),
              "plain_ms": cuda_ms(lambda: ks_kernel.ks_cnab2_plain(one_y, one_f, solver), 5),
              "bound_ms": max(1e3 * 3 * 192 * 4 / PEAK_BYTES_PER_S,
                              1e3 * ks_kernel.flops_per_row(192, 30) / PEAK_F32_FLOPS),
              "bound_by": "operations"}
    print(f"K1 at 1x192 (the rollout's shape): {k1_one['ms']:.4f} ms/launch (first design "
          f"{FIRST_DESIGN_MS['K1 1x192']} ms), plain {k1_one['plain_ms']:.4f} ms, bound "
          f"{k1_one['bound_ms']:.7f} ms (operations: one row's FFT count; one CTA runs 64 "
          f"dependent transforms, so the launch is latency, not work); {card}")
    print(json.dumps({"slice": "KS22 batched eval", "n_envs": N_ENVS, "env_steps_per_s": rates["min"],
                      "env_steps_per_s_first_call": rates["mean"], "peak_mem_bytes": peak_mem,
                      "rollout_seconds": t_roll, "card": card}))

    phase("== 7. device time of 5 batched env steps by kernel (torch.profiler)")
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

    phase("== 8. K2 against its plain version")
    fluid_ops = make_sharded_ops(256, 256, device=dev)  # the fluid path's constants
    k2_inputs, k2_errs, k2_rel_errs = {}, {}, {}
    for label, n, batch, kind, consts_kind in K2_SHAPES:
        if kind == "normal":  # the Pallas test's inputs
            rng = np.random.default_rng(0)
            w = torch.fft.fft2(torch.tensor(rng.standard_normal((batch, n, n)), dtype=torch.float32,
                                            device=dev))
        else:
            rng = np.random.default_rng(76)
            w = torch.tensor(np.stack([initial_condition(4, n, n, 1.0, 1.0, rng)
                                       for _ in range(batch)]).astype(np.complex64), device=dev)
        consts = (k2.fftfreq_constants(n, device=dev) if consts_kind == "fftfreq" else
                  fluid_ops if n == 256 else make_sharded_ops(n, n, device=dev))
        k2_inputs[label] = w
        got = k2.ns_advection(w, consts)
        want = k2.ns_advection_plain(w, consts)
        torch.cuda.synchronize()
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        k2_errs[label], k2_rel_errs[label] = err, err / scale
        print(f"{label}: max_abs_err {err:.3e} = {err / scale:.2e} of max|want| {scale:.4e} "
              f"(rtol {K2_RTOL:.0e} of it)")
        check(bool(torch.isfinite(torch.view_as_real(got)).all()) and scale > 0
              and err <= K2_RTOL * scale, f"K2 disagrees at {label}")

    def k2_check(label, got, want):
        torch.cuda.synchronize()
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        print(f"{label}: max_abs_err {err:.3e} = {err / scale:.2e} of max|want| {scale:.4e} "
              f"(rtol {K2_RTOL:.0e} of it)")
        check(bool(torch.isfinite(torch.view_as_real(got)).all()) and scale > 0
              and err <= K2_RTOL * scale, f"K2 disagrees at {label}")
        return err / scale

    fluid_lin = (-FLUID_16_256.nu * fluid_ops.k2).contiguous()  # the solver's -nu k^2
    rng = np.random.default_rng(3)

    def complex_noise(batch, scale, keep=None):
        z = rng.standard_normal((batch, 256, 256)) + 1j * rng.standard_normal((batch, 256, 256))
        return torch.tensor(scale * (z if keep is None else z * keep), dtype=torch.complex64, device=dev)

    nyquist = np.zeros((256, 256))
    nyquist[128, :] = nyquist[:, 128] = 1.0
    k2_fused_errs = {}
    for label in K2_TIMED_SHAPES:
        w = k2_inputs[label]
        batch, amp = w.shape[0], w.abs().max().item()
        # non-Hermitian content on the Nyquist row and column, as large as the spectrum's peak:
        # a kernel that packed its inverses without symmetrising would leak it
        w_ny = (w + complex_noise(batch, amp, nyquist)).contiguous()
        want = k2.ns_advection_plain(w_ny, fluid_ops)
        for chain in (False, True):
            form = "chain of three launches" if chain else "one cooperative launch"
            k2_check(f"{label} non-Hermitian Nyquist, {form}",
                     k2.NS_ADVECTION(w_ny, fluid_ops, chain=chain), want)
        f_hat = complex_noise(batch, 0.1 * amp)
        k2_fused_errs[f"{label} rhs"] = k2_check(
            f"{label} fused right-hand side (lin, f)",
            k2.ns_advection(w, fluid_ops, lin=fluid_lin, f=f_hat),
            k2.ns_rhs_plain(w, fluid_ops, lin=fluid_lin, f=f_hat))
        # the stage state and the RK4 combination exist only inside the library's loop; a
        # substep 10x the path's gives their terms weight against the rounding
        dt_os = 10.0 * FLUID_16_256.dt / FLUID_16_256.oversampling
        before = k2.NS_ADVECTION.launches
        got = k2.ns_rk4_substeps(w, fluid_ops, fluid_lin, f_hat, dt_os, 3)
        check(k2.NS_ADVECTION.launches - before == 12,
              f"the library reports {k2.NS_ADVECTION.launches - before} launches for 3 RK4 substeps")
        want = k2.ns_rk4_plain(w, fluid_ops, fluid_lin, f_hat, dt_os, 3)
        k2_fused_errs[f"{label} rk4"] = k2_check(f"{label} 3 RK4 substeps in the library's loop",
                                                 got, want)
        moved = (want - w).abs().max().item() / amp
        print(f"{label}: those substeps moved the state by {moved:.2e} of its peak")
        check(moved > 1e-3, "the RK4 comparison's substeps did not move the state")

    fluid_dir = str(ROOT / "artifacts" / "Fluid_16_256")
    n_steps = int(round(FLUID_P_TE / FLUID_16_256.dt))
    k2.NS_ADVECTION.launches = 0  # the fluid path starts here

    phase(f"== 9. Fluid_16_256 protocol (1 env, te={FLUID_P_TE}: {n_steps} env steps of "
          f"{FLUID_16_256.oversampling} RK4 substeps)")
    ftrainer = ShardedFluidTrainer(FLUID_16_256, (1, 1), ShardedTrainConfig(n_envs=1), device=dev)
    factor = load_actor_for_eval(fluid_dir, ftrainer)
    fw0 = ftrainer.eval_w0()
    energies, fluid_secs = {}, {}
    for label, t_act in (("trained", 0), ("no action", n_steps)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs = ftrainer.make_eval_fn(n_steps, t_action_steps=t_act)(factor, fw0)
        torch.cuda.synchronize()
        fluid_secs[label] = time.perf_counter() - t0
        check(recs["energy"].shape == (n_steps, 1) and bool(recs["active"].all()),
              f"fluid rollout ({label}) did not keep every step active")
        check(bool(np.isfinite(recs["energy"]).all() and np.isfinite(recs["reward_mean"]).all()),
              f"fluid rollout ({label}) is not finite")
        energies[label] = float(recs["energy"][recs["active"]].mean())
        if label == "trained":  # phase 51 holds the 1x1 NCCL mesh to these
            (ROOT / "build" / "smoke_phase9.json").write_text(json.dumps({
                "energy_per_step": recs["energy"][:, 0].tolist(),
                "ms_per_env_step": 1e3 * fluid_secs[label] / n_steps}))
    launches_protocol = k2.NS_ADVECTION.launches
    print(json.dumps({"row": "Fluid_16_256 te=2 on the 2/3-rule solver", "mesh": "1x1", "grid": 256,
                      **energies, "ratio": energies["trained"] / energies["no action"],
                      "p_te": FLUID_P_TE, "steps": n_steps, "seconds": fluid_secs,
                      "K2_calls": launches_protocol}))
    check(energies["trained"] < 0.7 * energies["no action"],
          f"trained energy {energies['trained']} not below 0.7 of no action {energies['no action']}")

    phase(f"== 10. batched width: {FLUID_BATCH} envs, {FLUID_BATCH_STEPS} steps")
    btrainer = ShardedFluidTrainer(FLUID_16_256, (1, 1), ShardedTrainConfig(n_envs=FLUID_BATCH),
                                   device=dev)
    bw0 = btrainer.eval_w0()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    brecs = btrainer.make_eval_fn(FLUID_BATCH_STEPS)(factor, bw0)
    torch.cuda.synchronize()
    bsecs = time.perf_counter() - t0
    fluid_peak = torch.cuda.max_memory_allocated()
    k2_launches = k2.NS_ADVECTION.launches  # the fluid path ends here
    fluid_rate = FLUID_BATCH * FLUID_BATCH_STEPS / bsecs
    print(json.dumps({"slice": "Fluid_16_256 batched eval", "n_envs": FLUID_BATCH,
                      "steps": FLUID_BATCH_STEPS, "seconds": bsecs, "env_steps_per_s": fluid_rate,
                      "env_steps_per_s_1env": n_steps / fluid_secs["trained"],
                      "peak_mem_bytes": fluid_peak, "K2_calls": k2_launches - launches_protocol,
                      "card": card}))
    check(brecs["energy"].shape == (FLUID_BATCH_STEPS, FLUID_BATCH) and bool(brecs["active"].all())
          and bool(np.isfinite(brecs["energy"]).all()), "batched fluid eval malformed")
    # every env starts from the same field: its records agree with the 1-env rollout's
    check(bool(np.allclose(brecs["energy"], brecs["energy"][:, :1], rtol=1e-5)),
          "batched fluid envs from one field disagree with each other")
    check(launches_protocol > 0 and k2_launches - launches_protocol > 0,
          "K2 was not launched on the fluid path")

    phase("== 11. the fluid slice on the card against the CPU (32x32, 2 envs, 6 steps)")
    rng = np.random.default_rng(5)
    small_w0 = torch.tensor(np.stack([
        np.fft.ifft2(initial_condition(4, 32, 32, 1.0, 1.0, rng)).real for _ in range(2)
    ]).astype(np.float32))
    for stepper, over in (("fixed-step rk4", {}), ("adaptive rk4", {"adaptive": True})):
        small = dataclasses.replace(FLUID_16_256, nx=32, sensors_per_axis=4, **over)
        small_recs = []
        for d in (dev, "cpu"):
            tr = ShardedFluidTrainer(small, (1, 1), ShardedTrainConfig(n_envs=2), device=d)
            small_recs.append(tr.make_eval_fn(6, t_action_steps=2)(load_actor_for_eval(fluid_dir, tr),
                                                                   small_w0))
        check(bool((small_recs[0]["active"] == small_recs[1]["active"]).all()
                   and small_recs[1]["active"].all()),
              f"card and CPU fluid evals differ in active steps ({stepper})")
        for key in ("energy", "reward_mean"):
            rel = float(np.abs(small_recs[0][key] / small_recs[1][key] - 1.0).max())
            print(f"{stepper}, {key}: max rel difference card vs CPU {rel:.2e} (rtol 1e-4)")
            check(rel <= 1e-4, f"card and CPU fluid evals disagree ({stepper}, {key})")
    # an adaptive preset at its own width: Fluid_8 (128x128, 8x8 actuators, do_step2), 10 steps
    from distributedconvrl_pde_control_torch.configs.fluid import FLUID_8

    atrainer = ShardedFluidTrainer(FLUID_8, (1, 1), ShardedTrainConfig(n_envs=1), device=dev)
    aactor = load_actor_for_eval(str(ROOT / "artifacts" / "Fluid_8"), atrainer)
    before = k2.NS_ADVECTION.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arecs = atrainer.make_eval_fn(10)(aactor, atrainer.eval_w0())
    torch.cuda.synchronize()
    print(json.dumps({"row": "Fluid_8 (adaptive do_step2, 128x128), 10 steps", "energy_first":
                      float(arecs["energy"][0, 0]), "energy_last": float(arecs["energy"][-1, 0]),
                      "seconds": time.perf_counter() - t0,
                      "K2_calls": k2.NS_ADVECTION.launches - before}))
    check(bool(arecs["active"].all() and np.isfinite(arecs["energy"]).all()),
          "adaptive fluid rollout malformed")

    phase("== 12. K2 time at the fluid path's shapes")
    k2_times = {}
    for label in K2_TIMED_SHAPES:
        w = k2_inputs[label]
        batch = w.shape[0]
        f_hat = complex_noise(batch, 1.0)
        ms = cuda_ms(lambda: k2.ns_advection(w, fluid_ops), 200)
        chain_ms = cuda_ms(lambda: k2.NS_ADVECTION(w, fluid_ops, chain=True), 200)
        rhs_ms = cuda_ms(lambda: k2.ns_advection(w, fluid_ops, lin=fluid_lin, f=f_hat), 200)
        subs = 20
        loop_ms = cuda_ms(lambda: k2.ns_rk4_substeps(w, fluid_ops, fluid_lin, f_hat, 1e-6, subs),
                          5) / (4 * subs)
        # the same loop in the chain form: the library queues the launches back to back, so
        # the two forms are compared on the device's pace and not on the host's
        chain_loop_ms = cuda_ms(lambda: k2.NS_ADVECTION.rk4(w, fluid_ops, fluid_lin, f_hat, 1e-6,
                                                            subs, chain=True), 5) / (4 * subs)
        pms = cuda_ms(lambda: k2.ns_advection_plain(w, fluid_ops), 50)
        b_ms = 1e3 * k2.min_bytes(256, batch) / PEAK_BYTES_PER_S
        o_ms = 1e3 * k2.flops(256, batch) / PEAK_F32_FLOPS
        k2_times[label] = {"ms": ms, "plain_ms": pms, "bound_ms": max(b_ms, o_ms),
                           "bound_by": "bytes" if b_ms > o_ms else "operations", "chain_ms": chain_ms,
                           "rhs_ms": rhs_ms, "stage_in_loop_ms": loop_ms,
                           "chain_stage_in_loop_ms": chain_loop_ms}
        print(f"K2 {label}: {ms:.4f} ms/call as one cooperative launch (the main path's form), "
              f"{chain_ms:.4f} ms as the chain of three launches, first design "
              f"{FIRST_DESIGN_MS['K2 ' + label]} ms; with lin and f {rhs_ms:.4f} ms; a stage "
              f"{loop_ms:.4f} ms inside the library's substep loop ({chain_loop_ms:.4f} ms as the "
              f"chain there); plain {pms:.4f} ms, "
              f"bound {max(b_ms, o_ms):.6f} ms (bytes {b_ms:.6f} ms for {k2.min_bytes(256, batch)} B, "
              f"operations {o_ms:.6f} ms for {k2.flops(256, batch):.0f} flop); {card}")
    step_ms_1 = 1e3 * fluid_secs["trained"] / n_steps
    calls_per_step = 4 * FLUID_16_256.oversampling
    k2_step_ms = calls_per_step * k2_times["n256_b1"]["stage_in_loop_ms"]
    print(f"at 1 env an env step takes {step_ms_1:.3f} ms on the host clock and launches K2 "
          f"{calls_per_step} times from one call into its library: {k2_step_ms:.3f} ms of K2 "
          f"device time ({100 * k2_step_ms / step_ms_1:.1f}%); the bound of one launch at batch 1 "
          f"is below the cost of a launch; {card}")

    phase("== 13. device time of one fluid env step by kernel group (torch.profiler)")
    one_step = ftrainer.make_eval_fn(1)
    one_step(factor, fw0)
    counted = k2.NS_ADVECTION.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step(factor, fw0)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    counted = k2.NS_ADVECTION.launches - counted
    kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    groups = {}
    for e in kern:
        name = e.key
        group = ("K2" if "ns_adv" in name else
                 "fft (boundary transforms)" if "fft" in name.lower() else
                 "matmul (sensors, forcing, actor)" if "gemm" in name.lower() or "gemv" in name.lower()
                 else "elementwise and other")
        g = groups.setdefault(group, [0, 0.0])
        g[0] += e.count
        g[1] += e.self_device_time_total
    busy_us = sum(g[1] for g in groups.values())
    print(json.dumps({"profile": "Fluid_16_256, 1 env, 1 env step, under the profiler",
                      "wall_us": wall_us, "device_busy_us": busy_us if kern else "not measured",
                      "idle_share": 1.0 - busy_us / wall_us if kern else "not measured",
                      "launches": sum(g[0] for g in groups.values()),
                      "groups": {k: {"launches": v[0], "device_us": v[1]} for k, v in groups.items()}}))
    k2_group = groups.get("K2", [0, 0.0])
    print(f"launches per env step {sum(g[0] for g in groups.values())} (the first design: 2,377), of "
          f"which K2 {k2_group[0]}: {k2_group[0] / FLUID_16_256.oversampling:.1f} per RK4 substep "
          f"(the first design: 28 launches per substep, 12 of them K2's)")
    check(k2_group[0] == 4 * FLUID_16_256.oversampling and counted == k2_group[0],
          f"the profiler saw {k2_group[0]} launches of K2 in one env step and its library counted "
          f"{counted}; expected 4 per substep")

    k1_training = train_phases(card)
    k2_training = fluid_train_phases(card)
    k1_fidelity = fidelity_phases(card)
    families_phases(card)
    k1_agents = agents_phases(card)
    k_tiers = tiers_phases(card)
    k1_tools = tools_phases(card)
    k2_mesh = mesh_phases(card)
    k_dp = dp_phases(card)
    grids = grids_phases(card)
    print_phase_seconds()

    print(json.dumps({"kernels": [{
        "name": "ks_cnab2", "route": "cuda",
        "source": "distributedconvrl_pde_control_torch/csrc/" + ks_kernel.SOURCE,
        "replaces": ks_kernel.REPLACES,
        "launches": (launches + sum(k1_training.values()) + sum(k1_fidelity.values())
                     + sum(k1_agents.values()) + sum(k_tiers["K1"].values())
                     + sum(k1_tools.values()) + sum(k_dp["K1"].values())
                     + sum(grids["K1"].values())),
        "launches_by_path": {"evaluation (phases 4-5)": launches,
                             "training: trained controller's rollout (phase 15)": k1_training["rollout"],
                             "training: train steps (phase 16)": k1_training["train_steps"],
                             **k1_fidelity, **k1_agents, **k_tiers["K1"], **k1_tools,
                             **k_dp["K1"], **grids["K1"]},
        "max_abs_err": max(errs[k] for k in MAIN_PATH_SHAPES), "ms": k_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "library_ms": None, "status": "ok", "shape": "16384x192, 30 substeps",
        "at_1x192": k1_one, "other_grids": grids["K1_times"],
        "other_grids_max_abs_err": grids["K1_max_abs_err"]}, {
        "name": "ns_advection", "route": "cuda",
        "source": "distributedconvrl_pde_control_torch/csrc/" + k2.SOURCE,
        "replaces": k2.REPLACES,
        "launches": (k2_launches + k2_training + sum(k_tiers["K2"].values())
                     + sum(k2_mesh.values()) + sum(k_dp["K2"].values())
                     + sum(grids["K2"].values())),
        "launches_by_path": {"evaluation (phases 9-10)": k2_launches,
                             "training (phases 20-21)": k2_training, **k_tiers["K2"], **k2_mesh,
                             **k_dp["K2"], **grids["K2"]},
        "max_abs_err": max(k2_errs[k] for k in K2_MAIN_PATH_SHAPES),
        "max_err_of_scale": max(k2_rel_errs[k] for k in K2_MAIN_PATH_SHAPES),
        "max_fused_err_of_scale": max(k2_fused_errs.values()),
        **k2_times["n256_b1"], "library_ms": None, "status": "ok",
        "shape": "n256_b1", "at_n256_b16": k2_times["n256_b16"],
        "other_grids": grids["K2_times"],
        "other_grids_max_err_of_scale": grids["K2_max_err_of_scale"]}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
