"""Command-line entry point: train and evaluate KS and fluid controllers.

Counterpart of the single-device `--train`, `--train-multi`, `--hyperopt`,
`--train --batched` (with `--population` and `--pop-search`), `--ppo` and
`--eval` branches and of the `--mesh DPxSP` branch of
``distributedconvrl_pde_control_tpu/experiments/run.py``, for the KS,
Keller-Segel (`KellerSegel10_16[_fast]`) and fluid families. The `_tp`
presets (`KS22_tp`, `KS200_tp`, `KS500_tp`, `KS22_64_tp` and every
`Fluid_*_tp`) run every branch their base preset runs: ETDRK4 (KS, with the
spectral carry at nx >= 192) or IF-RK4 (fluid) with the transforms at the
JAX package's bf16 tiers, `matmul_hi` at the boundaries and `matmul_fast`
in the nonlinear term (``ops/fourier.py``).

KS presets, the fidelity loop (one env, 20 learner updates per env step):

    python -m distributedconvrl_pde_control_torch.experiments.run KS22 --train \\
        [--loops 8 --no-steps 800 --seed 609 --resume --load-from DIR] --out runs/KS22 [--cpu]

trains with `drivers.train` (`KS22_global` is the mono-agent ablation) and
writes the full checkpoint `saves/agent.msgpack` (agent, replay, key) and
`saves/hook.npz`; `--resume` continues from the checkpoint in --load-from
(or --out). `--train-multi [--no-episodes 2800 --n-experiments 2]` runs the
restart protocol with numbered saves (`agent{n}.msgpack`, `hook{n}.npz`).
`--hyperopt N [--hyperopt-episodes 30 --hyperopt-robust K]` runs N trials of
the random search (KS22_global, KS22, KS200 and both Keller-Segel presets),
one JSON line each. The Keller-Segel presets and the fluid presets without
`--mesh` (the single-device env on the 3/2-rule solver, adaptive RK4 by
default) train the same ways, `--train --batched` included.

Batched training (the throughput configuration), any family:

    python -m distributedconvrl_pde_control_torch.experiments.run KS22 --train --batched \\
        --n-envs 256 --total-steps 3000 --eval-every 500 --eval-steps 500 \\
        --config-overrides '{"stepper": "etdrk4", "spectral_carry": true}' \\
        --out runs/KS22 [--cpu]

trains with `train_batched` from a pool of 32 `random_init` fields drawn
from the preset's seed, prints the reward curve, the evals and a summary line, and
writes `saves/hook.npz` (best actor, reward history), the light agent
checkpoint `saves/agent_light.msgpack` and `config_overrides.json` into
--out, which `--eval --load-from` reads back.

Populations and their schedule search, any family:

    python -m distributedconvrl_pde_control_torch.experiments.run KS22 --train --batched \\
        --population 8 [--pop-overrides '{"act_noise": [...8 values]}'] --out runs/KS22_pop8
    python -m distributedconvrl_pde_control_torch.experiments.run KS22 --train --batched \\
        --pop-search 16 --population 8 --eval-every 500 --eval-steps 500 --out runs/KS22_search

train P members as one fused program (`train/population.py`) and write each
member's light checkpoint under OUT/member_XX beside population.json, or run
a schedule search in fused rounds and write search.json and the winner's
checkpoint.

PPO, any family (`agents/ppo.py`; the tuned light config, `--ppo-ref` the
reference's):

    python -m distributedconvrl_pde_control_torch.experiments.run KS22 --train --ppo \\
        [--iters 60 --eval-every 5 --eval-steps 500 --n-envs 8] --out runs/KS22_ppo
    python -m distributedconvrl_pde_control_torch.experiments.run KS22 --eval --ppo \\
        --load-from artifacts/KS22_ppo_lh

write saves/ppo.msgpack and saves/ppo_info.npz, and roll the best params as
the DDPG eval does, printing the JAX CLI's keys ("agent": "ppo" first).

KS and Keller-Segel presets (the plot_heat protocol):

    python -m distributedconvrl_pde_control_torch.experiments.run KS22 --eval \\
        --load-from artifacts/KS22 --p-te 200 --p-t-action 100 [--cpu]

loads the checkpoint in --load-from (default --out), rolls its best actor
(else its current one) on the preset's env
from the standard initial field, and prints one JSON line with the mean |y|
over the last 100 uncontrolled steps, over the last tenth of the run, and
their ratio; for Keller-Segel the deviation |u - 1| from the controlled
state (default te 12, actuation from te/2), and writes heat.png, sums.png and
actions.png into --out (`--plot-separate`, `--from-step`, `--to-step`);
`--plot-best` draws the stored best episode instead, `--live` animates the
rollout in the terminal, `--video` writes its frames (and an mp4 with ffmpeg).
`--import-jld2 SAVES_DIR` converts a reference JLD2 save into --out first.
Every branch that plots writes the JAX CLI's file names when matplotlib is
installed and says in one line that it did not otherwise.

Deployment (experiments/serve.py, experiments/export_controller.py):

    python -m distributedconvrl_pde_control_torch.experiments.run KS22 --eval \\
        --load-from artifacts/KS22 (--serve | --export-controller DIR) [--cpu]

prints the serving probe's latency line, or exports the controller with
torch.export. `--train --profile` traces the first loop of the single-env
training into <out>/profile/trace.json and prints per-phase timings.

Fluid presets on the single-device env (the testrun protocol, energy.png):

    python -m distributedconvrl_pde_control_torch.experiments.run Fluid_8 --eval \\
        --load-from artifacts/Fluid_8 [--p-te 6] [--cpu]

rolls the best actor, corrected opposition control and no action from the
preset's initial field and prints one JSON line with their mean energies
sum|omega|/n^2 over the active steps (keys trained, negate, no action).

Fluid presets on the 2/3-rule solver and KellerSegel10_16[_fast] over a dp x
sp mesh of ranks (`run_sharded`, `--mesh DPxSP`): one NCCL rank per card (the
1x1 mesh on one card is an NCCL group of one), or with `--virtual-devices N`
N gloo ranks on the CPU (`--cpu` gives one); the ranks beyond one are
spawned and rank 0's output is printed when they end:

    python -m distributedconvrl_pde_control_torch.experiments.run Fluid_16_256 --train \\
        --mesh 1x1 [--loops 10 --no-steps 580 --n-envs 1 --resume] [--cpu]
    python -m distributedconvrl_pde_control_torch.experiments.run Fluid_16_256 --eval \\
        --virtual-devices 4 --mesh 2x2 --load-from artifacts/Fluid_16_256 --nx 32 --p-te 0.1

trains the preset's recipe with `train_sharded` (learner batch 32, one
update per step, capacity 100,000, chunks of 25), prints the per-loop lines,
the reward curve and a summary line, and writes `saves/hook.npz` and
`saves/agent_light.msgpack` (the JAX package's light checkpoint) into --out;
`--resume` continues from the checkpoint in --load-from (or --out).
`--train-multi` runs the restart protocol with numbered saves.

    python -m distributedconvrl_pde_control_torch.experiments.run Fluid_16_256 --eval \\
        --mesh 1x1 --load-from artifacts/Fluid_16_256 [--p-te 2] [--n-envs 1] [--cpu]

rolls the best actor (the current one when the run kept no best) and a
no-action baseline from the preset's evaluation field and prints one JSON
line with the mesh, the grid and the two mean energies sum|omega|/n^2 over
the active steps.

Data-parallel batched training over a pure-dp mesh of ranks (`--batched
--mesh N` or `Nx1`, any preset; `parallel/batched_dp.py`), and a population
over one (`--population P` / `--pop-search N` with `--mesh N`), on the same
ranks as `--mesh DPxSP`:

    python -m distributedconvrl_pde_control_torch.experiments.run KS22 --train --batched \
        --mesh 1 --n-envs 16384 --learner-batch 4096 [--population 2] [--virtual-devices 2]

--n-envs is the global env count (per member for a population), split over
dp; --learner-batch is per rank. The checkpoint is the single-device one
(`--eval` reads it without `--mesh`); a population writes its members as
`--population` does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

# suffix tiers derivable from any fluid base preset:
#   _fast      = integrating-factor RK4 throughput tier
#   _tp        = _fast + the bf16 transform tiers (3-pass at the boundaries, 1-pass
#                in the advection, whose error enters scaled by dt_os); on --mesh
#                the advection is kernel K2, float32 under every tier
#   _fixedstep = the reference's do_step fixed-step RK4 (FluidSetup.jl:163-172;
#                the single-grid presets default to the adaptive do_step2)
#   _eval      = evaluation protocol (nx=256, seed 76; FluidSetup.jl:32-37)
_FLUID_TIERS = {
    "_fast": dict(adaptive=False, stepper="ifrk4"),
    "_tp": dict(adaptive=False, stepper="ifrk4", fft_mode="matmul_hi",
                nl_fft_mode="matmul_fast"),
    "_fixedstep": dict(adaptive=False),
    "_eval": dict(evaluation=True),
}


# the KS `_tp` tier (JAX run.py:77-120), `bench.py`'s configuration: ETDRK4, 3-pass bf16
# transforms at the boundaries and 1-pass bf16 in the nonlinear term, and the spectral
# carry where it pays (nx >= 192; the JAX package measured it slower on the 64-point grid)
_KS_TP = dict(stepper="etdrk4", fft_mode="matmul_hi", nl_fft_mode="matmul_fast")
# the presets `--hyperopt` searches around (JAX run.py:615-633) and, as an extension of the
# JAX CLI, their `_tp` tiers
HYPEROPT_PRESETS = ("KS200", "KS22", "KS22_global", "KellerSegel10_16", "KellerSegel10_16_fast",
                    "KS200_tp", "KS22_tp")


def ks_presets() -> dict:
    """name -> (KSConfig, setup builder) of every KS preset the port runs,
    the JAX CLI's table (run.py:96-120): `build_ks_global` builds the mono
    agent of KS22_global, `build_ks` the distributed agent of the others,
    the `_tp` tiers of KS22, KS200, KS500 and KS22_64 included."""
    from distributedconvrl_pde_control_torch.configs import ks as C

    table = {"KS22": (C.KS22, C.build_ks), "KS200": (C.KS200, C.build_ks),
             "KS500": (C.KS500, C.build_ks), "KS200_disturbed": (C.KS200_DISTURBED, C.build_ks),
             "KS22_64": (C.KS22_64, C.build_ks),
             "KS22_global": (C.KS22_GLOBAL, C.build_ks_global)}
    for name in ("KS22", "KS200", "KS500", "KS22_64"):
        cfg = table[name][0]
        table[name + "_tp"] = (dataclasses.replace(cfg, name=name + "_tp", **_KS_TP,
                                                   spectral_carry=cfg.nx >= 192), C.build_ks)
    return table


def presets() -> dict:
    """name -> (config, setup builder) of every KS and Keller-Segel preset;
    the fluid presets and their tiers come from `fluid_config_for`."""
    from distributedconvrl_pde_control_torch.configs import keller_segel as K

    return {**ks_presets(),
            **{name: (cfg, K.build_keller_segel) for name, cfg in K.PRESETS.items()}}


def ks_setup(cfg, device: str = "cuda"):
    """The setup of a KS config (a preset's, overrides applied) from its
    preset's builder."""
    return ks_presets()[cfg.name][1](cfg, device=device)


def build_setup(cfg, device: str = "cuda"):
    """The setup of any preset's config (overrides applied): `build_fluid`
    for a FluidConfig, `build_keller_segel` for a KellerSegelConfig, the KS
    preset's builder otherwise."""
    from distributedconvrl_pde_control_torch.configs.fluid import FluidConfig, build_fluid
    from distributedconvrl_pde_control_torch.configs.keller_segel import (
        KellerSegelConfig,
        build_keller_segel,
    )

    if isinstance(cfg, FluidConfig):
        return build_fluid(cfg, device=device)
    if isinstance(cfg, KellerSegelConfig):
        return build_keller_segel(cfg, device=device)
    return ks_setup(cfg, device)


def fluid_config_for(name: str):
    """The FluidConfig behind a fluid preset name - base presets plus any
    `_fast`/`_tp`/`_fixedstep`/`_eval` tier of them; None for other names."""
    from distributedconvrl_pde_control_torch.configs.fluid import PRESETS

    if name in PRESETS:
        return PRESETS[name]
    for suffix, over in _FLUID_TIERS.items():
        if name.endswith(suffix) and name[: -len(suffix)] in PRESETS:
            return dataclasses.replace(PRESETS[name[: -len(suffix)]], name=name, **over)
    return None


def preset_config(name: str):
    """The config of any preset name the CLI takes: a fluid preset or tier,
    else a KS or Keller-Segel preset."""
    cfg = fluid_config_for(name)
    return cfg if cfg is not None else presets()[name][0]


def sharded_config_for(name: str):
    """The config `--mesh` runs: a fluid preset or tier, or KellerSegel10_16[_fast];
    None for other names."""
    from distributedconvrl_pde_control_torch.configs.keller_segel import PRESETS

    cfg = fluid_config_for(name)
    return cfg if cfg is not None else PRESETS.get(name)


def run_sharded(args, cfg, device: str) -> None:
    """`--mesh DPxSP` path (parallel.multichip, parallel.multichip_keller_segel):
    the fluid preset (on the 2/3-rule solver) or the Keller-Segel preset
    trains (`--train`, `--train-multi`, `--resume`) or evaluates on a dp x sp
    mesh of ranks, checkpointing in the standard light format so that both
    packages' eval and resume paths read the runs at any mesh.

    The ranks: with `--virtual-devices N`, N gloo ranks on the CPU; on the
    card, one NCCL rank per card (a 1x1 mesh is an NCCL group of one); with
    `--cpu`, one gloo rank. A mesh of one rank runs in this process; larger
    meshes are spawned (`parallel.mesh.launch`), and rank 0's lines are
    printed as it writes them. The run has no wall-clock limit: a rank that
    waits on a collective its peers never reach fails by the group's
    timeout."""
    from distributedconvrl_pde_control_torch.parallel.mesh import launch

    if args.nx:
        cfg = dataclasses.replace(cfg, nx=args.nx)
    if args.horizon:
        cfg = dataclasses.replace(cfg, te=args.horizon)
    try:
        dp, sp = (int(x) for x in args.mesh.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh wants DPxSP (e.g. 4x2), got {args.mesh!r}")
    backend = mesh_backend(args, device, dp, sp)
    out_dir = args.out or os.path.join("runs", args.preset)
    os.makedirs(out_dir, exist_ok=True)
    launch(_run_on_mesh, dp, sp, args, cfg, out_dir, backend=backend, store_dir=out_dir)


def mesh_backend(args, device: str, dp: int, sp: int) -> str:
    """The backend of a dp x sp mesh of ranks: with `--virtual-devices N`, N gloo
    ranks on the CPU; on the card, one NCCL rank per card; with `--cpu`, one
    gloo rank. Refused, as the JAX CLI refuses it, when there are fewer."""
    import torch

    if args.virtual_devices:
        have, backend = args.virtual_devices, "gloo"
    elif device == "cuda":
        have, backend = torch.cuda.device_count(), "nccl"
    else:
        have, backend = 1, "gloo"
    if have < dp * sp:
        raise SystemExit(f"mesh {dp}x{sp} needs {dp * sp} devices, have {have} "
                         "(hint: --virtual-devices N)")
    return backend


def dp_of(args, device: str, flag: str) -> tuple:
    """(n_dp, backend) of `--batched --mesh N[x1]`, refused with the JAX CLI's
    messages: a mesh with an sp axis, too few devices, --n-envs that dp does
    not divide."""
    spec = args.mesh.lower().split("x")
    try:
        n_dp, sp = int(spec[0]), int(spec[1]) if len(spec) > 1 else 1
    except ValueError:
        raise SystemExit(f"--mesh wants N or Nx1 with {flag}, got {args.mesh!r}")
    if sp != 1:
        raise SystemExit(f"{flag} shards over dp only; use --mesh {n_dp} or {n_dp}x1, "
                         f"got {args.mesh!r}")
    backend = mesh_backend(args, device, n_dp, 1)
    n_envs = args.n_envs or 256
    if n_envs % n_dp:
        per = " (per member)" if flag == "--population" else ""
        raise SystemExit(f"--n-envs {n_envs}{per} must divide by dp={n_dp}")
    return n_dp, backend


def _run_on_mesh(mesh, args, cfg, out_dir: str) -> None:
    """One rank of `run_sharded`; rank 0 alone prints and saves."""
    import torch

    from distributedconvrl_pde_control_torch.configs.keller_segel import KellerSegelConfig
    from distributedconvrl_pde_control_torch.parallel.multichip import (
        ShardedFluidTrainer,
        ShardedTrainConfig,
        load_actor_for_eval,
        load_sharded,
        save_sharded,
        train_multi_sharded,
        train_sharded,
    )
    from distributedconvrl_pde_control_torch.parallel.multichip_keller_segel import (
        ShardedKellerSegelTrainer,
    )
    from distributedconvrl_pde_control_torch.train.checkpoint import actor_from_jax

    dp, sp = mesh.shape
    tcfg = ShardedTrainConfig(n_envs=args.n_envs or dp, batch_size=args.learner_batch or 32,
                              update_loops=1, capacity_per_dp=args.capacity_per_dp or 100_000,
                              chunk_len=args.chunk_len or 25)
    kind = ShardedKellerSegelTrainer if isinstance(cfg, KellerSegelConfig) else ShardedFluidTrainer
    trainer = kind(cfg, mesh, tcfg, device=mesh.device)
    seed = args.seed if args.seed is not None else cfg.seed
    grid = getattr(cfg, "grid_nx", cfg.nx)
    root = mesh.rank == 0

    if args.train_multi:
        # the restart protocol (FluidSetup.jl:559-601), numbered saves per experiment
        best = train_multi_sharded(
            trainer, no_episodes=args.no_episodes or 17, n_experiments=args.n_experiments,
            seed=seed, save_fn=lambda n, state, hook: save_sharded(out_dir, trainer, state, hook,
                                                                   number=n))
        if root:
            print("best rewards per experiment:", best)
        return

    if args.train:
        state = hook = None
        if args.resume:
            # the light checkpoint's networks, Adam states and counters, the
            # hook's accounting and best actor (read on rank 0, broadcast);
            # fields, pool and replay start afresh
            agent_state, hook = load_sharded(args.load_from or out_dir, trainer)
            # as the JAX CLI: `init(PRNGKey(args.seed or cfg.seed))` with the
            # pool of init's default seed 0 (`--seed 0` means the preset's seed)
            state = trainer.init(torch.Generator(device=trainer.device).manual_seed(
                args.seed or cfg.seed))
            state.agent = agent_state
            state.ep_count.fill_(hook.ep - 1)
            state.best_reward.fill_(hook.bestreward)
            state.best_episode.fill_(hook.bestepisode)
            if hook.best_actor is not None:
                state.best_actor = actor_from_jax(hook.best_actor).to(trainer.device)
            if root:
                print(f"resuming from ep {hook.ep - 1}, best {hook.bestreward:.4f}")
        state, hook = train_sharded(trainer, loops=args.loops, no_steps=args.no_steps, seed=seed,
                                    state=state, hook=hook, eval_every=args.eval_every,
                                    eval_steps=args.eval_steps)
        save_sharded(out_dir, trainer, state, hook)
        if root:
            print(hook.ascii_curve())
            if getattr(hook, "evals", None):
                print("evals:", [(s, round(r, 4)) for s, r in hook.evals])
            print(f"saved to {out_dir}; best reward {hook.bestreward:.4f} @ ep "
                  f"{hook.bestepisode} (mesh {dp}x{sp}, grid {grid})")
        return

    # --eval: the sharded testrun, trained policy vs no action, masked energies
    actor = load_actor_for_eval(args.load_from or out_dir, trainer)
    n_steps = int(round((args.p_te or cfg.te) / cfg.dt))
    t_act = int(round((args.p_t_action or 0.0) / cfg.dt))
    w0 = trainer.eval_w0()
    energies = {}
    for label, ta in [("trained", t_act), ("no action", n_steps)]:
        recs = trainer.make_eval_fn(n_steps, t_action_steps=ta)(actor, w0)
        e, m = recs["energy"], recs["active"]
        energies[label] = float(e[m].mean()) if m.any() else float("nan")
    if root:
        print(json.dumps({"mesh": f"{dp}x{sp}", "grid": grid, **energies}))


def held_out_eval_pool(setup, n: int) -> "torch.Tensor":
    """Held-out generator ICs for the delayed-actuation selection eval
    (`--eval-warmup`): a stream disjoint from the 32-field training pool's,
    so the selection metric never scores on training-seen fields. Widening
    `--eval-pool N` extends the narrower pool and never reshuffles it: the
    coefficients are drawn row by row from one CPU generator, so
    pool(N)[:M] == pool(M)."""
    import torch

    return setup.random_init(torch.Generator().manual_seed(setup.seed + 7777), n)


def run_train_batched(args, cfg, overrides, device: str) -> None:
    """`--train --batched`: `train_batched` from a pool of 32 `random_init`
    fields drawn from the preset's seed (JAX run.py:808-813, every family),
    warm-started with `--import-jld2` from a reference JLD2 save's networks
    (JAX run.py:958-965), then the hook's checkpoint into --out. With
    `--mesh N[x1]` the same on each rank of a pure-dp mesh (JAX run.py's
    `run_dp_batched`): the global env batch split over dp, the gradients
    averaged, the single-device checkpoint written by rank 0."""
    out_dir = args.out or os.path.join("runs", args.preset)
    os.makedirs(out_dir, exist_ok=True)
    if not args.mesh:
        return _train_batched_on(None, args, cfg, overrides, out_dir, device)
    from distributedconvrl_pde_control_torch.parallel.mesh import launch

    n_dp, backend = dp_of(args, device, "--batched")
    launch(_train_batched_on, n_dp, 1, args, cfg, overrides, out_dir, backend=backend,
           store_dir=out_dir)


def _setup_and_pools(args, cfg, device: str):
    """The batched branches' setup (`--capacity` applied), the host-drawn pool
    of 32 fresh ICs and, for --eval-warmup, the held-out pool."""
    import torch

    from distributedconvrl_pde_control_torch.agents.ddpg import DDPGAgent

    setup = build_setup(cfg, device=device)
    if args.capacity:
        setup = dataclasses.replace(
            setup, agent=DDPGAgent(dataclasses.replace(setup.agent.cfg, capacity=args.capacity)))
    pool = setup.random_init(torch.Generator().manual_seed(setup.seed), 32)
    eval_pool = held_out_eval_pool(setup, args.eval_pool) if args.eval_warmup else None
    return setup, pool, eval_pool


def _train_batched_on(mesh, args, cfg, overrides, out_dir: str, device: str = "cpu") -> None:
    """`run_train_batched` on one device (`mesh` None) or on one rank of a
    pure-dp mesh; rank 0 alone prints and saves."""
    import torch

    from distributedconvrl_pde_control_torch.parallel.batched_dp import DPBatchedTrainer
    from distributedconvrl_pde_control_torch.train import checkpoint
    from distributedconvrl_pde_control_torch.train.batched import (
        BatchedTrainer,
        BatchedTrainerConfig,
        train_batched,
    )
    from distributedconvrl_pde_control_torch.train.loop import TrainState

    root = mesh is None or mesh.rank == 0
    device = device if mesh is None else mesh.device
    setup, pool, eval_pool = _setup_and_pools(args, cfg, device)
    if overrides and root:
        print(f"applied config overrides: {sorted(overrides)}")
    tcfg = BatchedTrainerConfig(n_envs=args.n_envs or 256, batch_size=args.learner_batch or 256,
                                update_loops=args.update_loops,
                                min_best_episode=setup.min_best_episode)
    trainer = (BatchedTrainer(setup.env, setup.agent, tcfg, y0_pool=pool, eval_y0_pool=eval_pool)
               if mesh is None else
               DPBatchedTrainer(setup.env, setup.agent, tcfg, mesh, y0_pool=pool,
                                eval_y0_pool=eval_pool))
    seed = args.seed if args.seed is not None else setup.seed
    warm = None
    if args.import_jld2:
        from distributedconvrl_pde_control_torch.train.reference_import import load_warm_start

        warm = load_warm_start(args.import_jld2)
        print(f"warm-starting from imported reference JLD2 {args.import_jld2} ({sorted(warm)})")
    ts, hook, means = train_batched(
        trainer, total_steps=args.total_steps,
        generator=torch.Generator(device=device).manual_seed(seed),
        noise_decay_every=args.noise_every or max(1, args.total_steps // setup.loops),
        noise_decay=args.noise_decay if args.noise_decay is not None else setup.noise_decay,
        chunk_len=args.chunk_len or 50, verbose=root, eval_every=args.eval_every,
        eval_steps=args.eval_steps, eval_warmup_steps=args.eval_warmup,
        eval_score=args.eval_score, warm_start=warm)
    if not root:
        return
    checkpoint.save(out_dir, TrainState(ts.agent, None, ts.generator), hook,
                    include_replay=False, config_overrides=overrides)
    print(hook.ascii_curve())
    if hook.evals:
        print("evals:", [(s, round(r, 4)) for s, r in hook.evals])
    over = "" if mesh is None else f" over dp={mesh.dp}"
    print(f"saved to {out_dir}; best reward {hook.bestreward:.4f} @ ep "
          f"{hook.bestepisode}; {ts.total_env_steps} env steps{over}, "
          f"final chunk mean {means[-1]:.4f}")


POP_OVERRIDE_KEYS = ("act_noise", "noise_decay", "learning_rate", "learning_rate_critic")
SEARCH_NOTES = {
    "seed_discipline_note": (
        "trials within one fused round share per-step key draws across the member axis "
        "(train/population.py ARCHITECTURE note), so a trial's score can depend on which "
        "round-mates it was batched with in a way serial trials don't; winners should be "
        "independently re-validated (the KS22 winner was, at 0.24% - RESULTS.md)"),
    "search_space_note": (
        "SCHEDULE_SPACE covers per-member state axes only (act_noise/decay/lrs); structural "
        "axes (network scale, batch size) stay with the serial --hyperopt search"),
}


def pop_overrides(raw: str, n_members: int) -> dict:
    """--pop-overrides: an inline JSON object or a .json path of P-length
    lists for any of POP_OVERRIDE_KEYS; refused otherwise with the JAX CLI's
    messages."""
    pov = _read_overrides(raw)
    bad = set(pov) - set(POP_OVERRIDE_KEYS)
    if bad:
        raise SystemExit(f"--pop-overrides supports {sorted(POP_OVERRIDE_KEYS)}, got {sorted(bad)}")
    for k, v in pov.items():
        if len(v) != n_members:
            raise SystemExit(f"--pop-overrides[{k}] needs {n_members} values, got {len(v)}")
    return pov


def run_population(args, cfg, overrides, device: str) -> None:
    """`--train --batched --population P` (JAX run.py:893-946): P members as
    one fused program from the batched branch's pools, members varied by
    --pop-overrides; each member saved as a light checkpoint under
    OUT/member_XX beside population.json. With `--pop-search N`: N schedule
    trials in fused rounds of --population (default 8) members, search.json
    and the winner's light checkpoint in OUT (JAX run.py:840-891). With
    `--mesh N[x1]` on each rank of a pure-dp mesh (JAX run.py:820-840):
    every rank a local mini-population of --n-envs / N envs per member."""
    pov = pop_overrides(args.pop_overrides, args.population) if (
        args.pop_overrides and not args.pop_search) else {}
    out_dir = args.out or os.path.join("runs", args.preset)
    os.makedirs(out_dir, exist_ok=True)
    if not args.mesh:
        return _population_on(None, args, cfg, overrides, pov, out_dir, device)
    from distributedconvrl_pde_control_torch.parallel.mesh import launch

    n_dp, backend = dp_of(args, device, "--population")
    launch(_population_on, n_dp, 1, args, cfg, overrides, pov, out_dir, backend=backend,
           store_dir=out_dir)


def _population_on(mesh, args, cfg, overrides, pov: dict, out_dir: str,
                   device: str = "cpu") -> None:
    """`run_population` on one device (`mesh` None) or on one rank of a
    pure-dp mesh; rank 0 alone prints and saves."""
    import torch

    from distributedconvrl_pde_control_torch.train import checkpoint
    from distributedconvrl_pde_control_torch.train.batched import BatchedTrainerConfig
    from distributedconvrl_pde_control_torch.train.loop import TrainState
    from distributedconvrl_pde_control_torch.train.population import (
        PopulationTrainer,
        population_search,
        save_population,
        train_population,
    )

    root = mesh is None or mesh.rank == 0
    device = device if mesh is None else mesh.device
    setup, pool, eval_pool = _setup_and_pools(args, cfg, device)
    if overrides and root:
        print(f"applied config overrides: {sorted(overrides)}")
    tcfg = BatchedTrainerConfig(n_envs=args.n_envs or 256, batch_size=args.learner_batch or 256,
                                update_loops=args.update_loops,
                                min_best_episode=setup.min_best_episode)
    seed = args.seed if args.seed is not None else setup.seed
    if args.pop_search:
        best, trials, best_hook, best_state = population_search(
            setup.env, setup.agent, tcfg, args.pop_search, total_steps=args.total_steps,
            members_per_round=args.population or 8, seed=seed,
            noise_decay_every=args.noise_every or 0, eval_every=args.eval_every or 50,
            eval_steps=args.eval_steps, eval_warmup_steps=args.eval_warmup,
            eval_score=args.eval_score, chunk_len=args.chunk_len or 50, y0_pool=pool,
            eval_y0_pool=eval_pool, verbose=root, mesh=mesh)
        if not root:
            return
        with open(os.path.join(out_dir, "search.json"), "w") as f:
            json.dump({"best": best, "trials": trials, **SEARCH_NOTES}, f, indent=1)
        if best_state is not None:
            checkpoint.save(out_dir, TrainState(best_state, None, None, checkpoint.jax_key(seed)),
                            best_hook, include_replay=False, config_overrides=overrides)
        print(f"saved search.json + winner checkpoint to {out_dir}")
        return
    p = args.population
    pop = PopulationTrainer(setup.env, setup.agent, tcfg, p, y0_pool=pool,
                            eval_y0_pool=eval_pool, lr_actor=pov.get("learning_rate"),
                            lr_critic=pov.get("learning_rate_critic"), mesh=mesh)
    decay = pov.get("noise_decay",
                    args.noise_decay if args.noise_decay is not None else setup.noise_decay)
    ts, hooks, _ = train_population(
        pop, total_steps=args.total_steps,
        generator=torch.Generator(device=device).manual_seed(seed),
        act_noise=pov.get("act_noise"),
        noise_decay_every=args.noise_every or max(1, args.total_steps // setup.loops),
        noise_decay=decay, chunk_len=args.chunk_len or 50, verbose=root,
        eval_every=args.eval_every, eval_steps=args.eval_steps,
        eval_warmup_steps=args.eval_warmup, eval_score=args.eval_score)
    if not root:
        return
    summary = save_population(out_dir, pop, ts, hooks, overrides=overrides)
    for row in summary["ranking"]:
        print(f"  {row['dir']}: best {row['best_reward']:.4f} @ ep {row['best_episode']} "
              f"({row['episodes']} eps)")
    print(f"saved {p} members + population.json to {out_dir}")


def run_train(args, cfg, overrides, device: str) -> None:
    """`--train` (the single-env loop, `drivers.train`; `--resume` continues
    the checkpoint in --load-from or --out, or with `--import-jld2` a
    reference JLD2 save; `--profile` traces the first loop) and
    `--train-multi` (the restart protocol with numbered saves); the full
    checkpoint with its replay and rewards.png go into --out."""
    from distributedconvrl_pde_control_torch.train import checkpoint
    from distributedconvrl_pde_control_torch.train.drivers import train, train_multi
    from distributedconvrl_pde_control_torch.viz import plotting

    setup = build_setup(cfg, device=device)
    if overrides:
        print(f"applied config overrides: {sorted(overrides)}")
    out_dir = args.out or os.path.join("runs", args.preset)
    os.makedirs(out_dir, exist_ok=True)
    if args.train_multi:
        best = train_multi(setup, no_episodes=args.no_episodes or 2800,
                           n_experiments=args.n_experiments,
                           save_fn=lambda n, ts, hook: checkpoint.save(
                               out_dir, ts, hook, n, config_overrides=overrides))
        print("best rewards per experiment:", best)
        return
    ts = hook = None
    if args.resume and args.import_jld2:
        # the reference's own load(); train() continuation (KS22.jl:26-32) from its JLD2
        # saves, with a fresh replay as after a light checkpoint
        from distributedconvrl_pde_control_torch.train.reference_import import (
            import_reference_checkpoint,
        )

        ts, hook = import_reference_checkpoint(args.import_jld2, setup)
        print(f"resuming from imported reference JLD2 {args.import_jld2} (ep {hook.ep - 1}, "
              f"best {hook.bestreward:.4f})")
    elif args.resume:
        ts, hook = checkpoint.load(args.load_from or out_dir, setup.agent, device=device)
        print(f"resuming from ep {hook.ep - 1}, best {hook.bestreward:.4f}")
    if args.profile:
        from distributedconvrl_pde_control_torch.utils.profiling import StepTimer, trace

        timer = StepTimer()
        profile_dir = os.path.join(out_dir, "profile")
        with trace(profile_dir):
            with timer.phase("first_loop(train)"):
                ts, hook = train(setup, loops=1, no_steps=args.no_steps, seed=args.seed, ts=ts,
                                 hook=hook, verbose=False)
        remaining = (args.loops if args.loops is not None else setup.loops) - 1
        if remaining > 0:
            with timer.phase("steady_loops"):
                ts, hook = train(setup, loops=remaining, no_steps=args.no_steps, seed=args.seed,
                                 ts=ts, hook=hook, verbose=False)
        print(timer.summary())
        print(f"profiler trace -> {profile_dir}")
    else:
        ts, hook = train(setup, loops=args.loops, no_steps=args.no_steps, seed=args.seed, ts=ts,
                         hook=hook)
    checkpoint.save(out_dir, ts, hook, config_overrides=overrides)
    plots(lambda: plotting.plot_rewards_curve(hook.rewards, os.path.join(out_dir, "rewards.png"),
                                              hook.bestepisode))
    print(hook.ascii_curve())
    print(f"saved to {out_dir}; best reward {hook.bestreward:.4f} @ ep {hook.bestepisode}")


def run_hyperopt(args, device: str) -> None:
    """`--hyperopt N`: random search over the preset's hyperparameters, each
    trial a fresh setup scored by the reference's `test_setup` cost or, with
    `--hyperopt-robust K`, by deterministic rollouts from K held-out fields."""
    import functools

    from distributedconvrl_pde_control_torch.train.drivers import hyperopt_objective_robust
    from distributedconvrl_pde_control_torch.train.hyperopt import search

    if args.preset not in HYPEROPT_PRESETS:
        raise SystemExit(f"--hyperopt supports {list(HYPEROPT_PRESETS)}")
    cfg, build_fn = presets()[args.preset]
    if args.config_overrides:
        # an extension of the JAX CLI, whose search ignores --config-overrides:
        # the base configuration the trials vary (say a shorter te, which cuts
        # a search in depth)
        cfg = dataclasses.replace(cfg, **_read_overrides(args.config_overrides))
    objective = None
    if args.hyperopt_robust:
        objective = functools.partial(hyperopt_objective_robust,
                                      n_eval_inits=args.hyperopt_robust)
    search(cfg, functools.partial(build_fn, device=device), n_trials=args.hyperopt,
           seed=args.seed if args.seed is not None else 0, n_episodes=args.hyperopt_episodes,
           objective=objective)


def run_eval(args, cfg, device: str) -> None:
    """`--eval`: the checkpoint in --load-from (default --out) as
    `checkpoint.load` reads it, or a reference JLD2 save converted into --out
    (`--import-jld2`), its best actor (else its current one). KS and
    Keller-Segel presets: the plot_heat protocol's suppression (of |u - 1|
    for Keller-Segel) and heat.png, sums.png, actions.png; fluid presets: the
    testrun's masked mean energies of the actor, corrected opposition control
    and no action, and energy.png (JAX run.py:1045-1142). `--serve` and
    `--export-controller` deploy the checkpoint instead; `--plot-best` draws
    the stored best episode; `--live` animates the rollout in the terminal,
    `--video` writes its frames and an mp4."""
    from distributedconvrl_pde_control_torch.configs.fluid import FluidConfig
    from distributedconvrl_pde_control_torch.configs.keller_segel import KellerSegelConfig
    from distributedconvrl_pde_control_torch.train import checkpoint
    from distributedconvrl_pde_control_torch.train.eval import actor_policy, energy_eval, rollout
    from distributedconvrl_pde_control_torch.viz import plotting

    out_dir = args.out or os.path.join("runs", args.preset)
    load_dir = args.load_from or out_dir
    if args.serve:
        from distributedconvrl_pde_control_torch.experiments import serve

        return serve.main([args.preset, "--load-from", load_dir] + (["--cpu"] if args.cpu else []))
    fluid, chemo = isinstance(cfg, FluidConfig), isinstance(cfg, KellerSegelConfig)
    p_te, t_action = eval_times(args, cfg)
    setup = build_setup(cfg, device=device)
    if args.export_controller:
        from distributedconvrl_pde_control_torch.experiments.export_controller import (
            export_controller,
        )

        manifest = export_controller(setup, checkpoint.load_actor(load_dir, setup.agent, device),
                                     args.export_controller, preset=args.preset)
        print(f"exported the controller ({manifest['exported_on']}; serves on "
              f"{manifest['platforms']}) to {args.export_controller} (args: {manifest['args']})")
        return
    os.makedirs(out_dir, exist_ok=True)
    if args.import_jld2:
        from distributedconvrl_pde_control_torch.train.reference_import import (
            import_reference_checkpoint,
        )

        ts, hook = import_reference_checkpoint(args.import_jld2, setup, out_dir=out_dir)
        print(f"imported reference JLD2 saves {args.import_jld2} -> {out_dir} (standard light "
              f"checkpoint; reference bestreward {hook.bestreward:.4f} @ ep {hook.bestepisode})")
    else:
        ts, hook = checkpoint.load(load_dir, setup.agent, device=device)
    if args.plot_best:
        if hook.best_trace is None:
            raise SystemExit("checkpoint has no stored best-episode trace")
        path = os.path.join(out_dir, "heat_best.png")
        plotting.plot_heat(hook.best_trace, path, title=f"{args.preset} best episode")
        print(f"rendered stored best episode (ep {hook.bestepisode}, reward "
              f"{hook.bestreward:.4f}) -> {path}")
        return
    actor = checkpoint.eval_actor(ts, hook, device)
    policy = actor_policy(setup.agent, actor)
    y0 = random_init_field(args, setup)
    if fluid:
        from distributedconvrl_pde_control_torch.agents.policies import (
            NegatePolicy,
            ZeroPolicy,
            negate_center_row,
        )

        env = setup.env
        negate = NegatePolicy(env.action_shape, center_row=negate_center_row(env.featurize))
        runs = {"trained": (policy, t_action), "negate": (negate, t_action),
                "no action": (ZeroPolicy(env.action_shape), 0.0)}
        # as the JAX CLI: the --random-init field starts the trained rollout only
        evals = {k: energy_eval(env, pol, y0=y0 if k == "trained" else None, te=p_te, t_action=ta)
                 for k, (pol, ta) in runs.items()}
        plots(lambda: plotting.plot_energy({k: tr["energy"] for k, tr in evals.items()},
                                           os.path.join(out_dir, "energy.png")))
        print(json.dumps({k: tr["mean_energy"] for k, tr in evals.items()}))
        traces = evals["trained"]
    else:
        traces = rollout(setup.env, policy, y0=y0, te=p_te, t_action=t_action)

        def draw():
            plotting.plot_heat(traces, os.path.join(out_dir, "heat.png"), title=args.preset,
                               plot_separate=args.plot_separate, from_step=args.from_step,
                               to_step=args.to_step)
            plotting.plot_sums(traces, os.path.join(out_dir, "sums.png"))
            plotting.plot_actions(traces, os.path.join(out_dir, "actions.png"))

        plots(draw)
        y = traces["y"][:, 0] - 1.0 if chemo else traces["y"]
        print(json.dumps(suppression_of(y, t_action, setup.env.dt)))
    show(args, traces, out_dir)


def plots(draw) -> None:
    """Run `draw()`, which writes the branch's plots, when matplotlib is
    installed; otherwise say in one line that they were not written."""
    from distributedconvrl_pde_control_torch.viz import plotting

    if plotting.have_matplotlib():
        draw()
    else:
        print(f"plots not written: {plotting.MATPLOTLIB_MISSING}")


def show(args, traces: dict, out_dir: str) -> None:
    """`--live`: the rollout as a live terminal animation; `--video`: its
    frames under OUT/frames and, with ffmpeg, OUT/output.mp4."""
    from distributedconvrl_pde_control_torch.viz import plotting

    if args.live:
        plotting.live_view(traces, fps=args.fps)
    if args.video:
        out = plotting.render_animation(traces, out_dir, fps=int(args.fps))
        print("video:", out if out else f"None (ffmpeg not found; frames in "
                                         f"{os.path.join(out_dir, 'frames')})")


def eval_times(args, cfg) -> tuple:
    """(te, actuation start) of an --eval: --p-te / --p-t-action, by default
    200 and te/2 for KS presets, 12 and te/2 for Keller-Segel, 6 and 0 for
    fluid (JAX run.py:664-669)."""
    from distributedconvrl_pde_control_torch.configs.fluid import FluidConfig
    from distributedconvrl_pde_control_torch.configs.keller_segel import KellerSegelConfig

    fluid, chemo = isinstance(cfg, FluidConfig), isinstance(cfg, KellerSegelConfig)
    p_te = args.p_te if args.p_te is not None else (6.0 if fluid else 12.0 if chemo else 200.0)
    t_action = args.p_t_action if args.p_t_action is not None else (0.0 if fluid else p_te / 2.0)
    return p_te, t_action


def random_init_field(args, setup):
    """--random-init: the eval's initial field, one draw of the preset's
    `random_init` from a CPU generator seeded --seed (default the preset's
    seed); None without the flag. The port's generator shares no stream with
    `jax.random`, so the field differs from the JAX CLI's for the same seed."""
    import torch

    if not args.random_init or setup.random_init is None:
        return None
    seed = args.seed if args.seed is not None else setup.seed
    return setup.random_init(torch.Generator().manual_seed(seed), 1)[0]


def run_ppo(args, cfg, overrides, device: str) -> None:
    """`--ppo` (JAX run.py:682-785): `--train` runs `train_ppo` (the tuned
    light config, or with --ppo-ref the factory-default `PPOConfig`) from the
    preset's `random_init` fields, for fluid presets from a pool of 16 fields
    of the preset's seed (and under --eval-warmup a held-out eval pool), and
    writes saves/ppo.msgpack and saves/ppo_info.npz; `--eval` rolls the best
    params (else the current ones) as the DDPG eval does: the suppression of
    |y| (|u - 1| for Keller-Segel), or for fluid presets the mean energies of
    the PPO policy and of no action."""
    import torch

    from distributedconvrl_pde_control_torch.agents.ppo import (
        PPOAgent,
        PPOConfig,
        PPOTrainer,
        params_from_numpy,
        ppo_policy,
        train_ppo,
        tuned_config,
    )
    from distributedconvrl_pde_control_torch.configs.fluid import FluidConfig
    from distributedconvrl_pde_control_torch.configs.keller_segel import KellerSegelConfig
    from distributedconvrl_pde_control_torch.train import checkpoint

    setup = build_setup(cfg, device=device)
    if overrides:
        print(f"applied config overrides: {sorted(overrides)}")
    out_dir = args.out or os.path.join("runs", args.preset)
    os.makedirs(out_dir, exist_ok=True)
    fluid, chemo = isinstance(cfg, FluidConfig), isinstance(cfg, KellerSegelConfig)
    acfg = setup.agent.cfg
    pcfg = (PPOConfig(ns=acfg.ns, na=acfg.na_rows) if args.ppo_ref
            else tuned_config(acfg.ns, acfg.na_rows))
    pagent = PPOAgent(pcfg)
    if args.train:
        pool = eval_pool = None
        if fluid:  # fluid fields are made on the host: a pool, as the JAX CLI does
            pool = setup.random_init(torch.Generator().manual_seed(setup.seed), 16)
            if args.eval_warmup:
                eval_pool = held_out_eval_pool(setup, args.eval_pool)
        trainer = PPOTrainer(setup.env, pagent, n_envs=args.n_envs or 8,
                             random_init=None if fluid else setup.random_init, y0_pool=pool,
                             eval_y0_pool=eval_pool)
        seed = args.seed if args.seed is not None else setup.seed
        pstate, info = train_ppo(trainer, iters=args.iters,
                                 generator=torch.Generator(device=device).manual_seed(seed),
                                 eval_every=args.eval_every, eval_steps=args.eval_steps,
                                 eval_warmup_steps=args.eval_warmup)
        checkpoint.save_ppo(out_dir, pstate, info)
        if overrides:
            checkpoint.save_config_overrides(out_dir, overrides)
        metric = "deterministic eval" if info["selection"] == "eval" else "mean step"
        print(f"saved PPO to {out_dir}; best {metric} reward {info['best_reward']:.4f} @ iter "
              f"{info['best_iter']}")
        return
    from distributedconvrl_pde_control_torch.train.eval import energy_eval, rollout
    from distributedconvrl_pde_control_torch.viz import plotting

    pstate, info = checkpoint.load_ppo(args.load_from or out_dir, pagent, device=device)
    params = (params_from_numpy(info["best_params"], device) if info.get("best_params")
              else pagent._params(pstate))
    policy = ppo_policy(pagent, params)
    y0 = random_init_field(args, setup)
    p_te, t_action = eval_times(args, cfg)
    if fluid:
        from distributedconvrl_pde_control_torch.agents.policies import ZeroPolicy

        tr = energy_eval(setup.env, policy, y0=y0, te=p_te, t_action=t_action)
        zero = energy_eval(setup.env, ZeroPolicy(setup.env.action_shape), te=p_te)
        plots(lambda: plotting.plot_energy({"ppo": tr["energy"], "no action": zero["energy"]},
                                           os.path.join(out_dir, "energy_ppo.png")))
        print(json.dumps({"agent": "ppo", "mean_energy": tr["mean_energy"],
                          "no_action": zero["mean_energy"],
                          "mean_step_reward": float(np.asarray(tr["reward"]).mean())}))
        if args.live:
            plotting.live_view(tr, fps=args.fps)
        return
    traces = rollout(setup.env, policy, y0=y0, te=p_te, t_action=t_action)
    plots(lambda: plotting.plot_heat(traces, os.path.join(out_dir, "heat_ppo.png"),
                                     title=f"{args.preset} PPO"))
    y = traces["y"][:, 0] - 1.0 if chemo else traces["y"]
    print(json.dumps({"agent": "ppo", **suppression_of(y, t_action, setup.env.dt)}))
    if args.live:
        plotting.live_view(traces, fps=args.fps)


def suppression_of(y: np.ndarray, t_action: float, dt: float) -> dict:
    """The plot_heat protocol's numbers of a (steps, ...) trace: mean |y| over
    the last 100 uncontrolled steps, over the last tenth of the run, and
    their ratio."""
    act_start = int(round(t_action / dt))
    pre = float(np.abs(y[max(0, act_start - 100):act_start]).mean())
    post = float(np.abs(y[-max(1, y.shape[0] // 10):]).mean())
    return {"pre_control_mean_abs_dev": pre, "post_control_mean_abs_dev": post,
            "suppression": post / pre if pre else None}


def _read_overrides(raw: str) -> dict:
    """--config-overrides: an inline JSON object or the path of a .json file."""
    if raw.lstrip().startswith("{"):
        return json.loads(raw)
    with open(raw) as f:
        return json.load(f)


def refuse_missing(args) -> None:
    """Refuse, naming what is missing, a flag this installation cannot run:
    orbax checkpoints (never in the port), --import-jld2 without h5py or on a
    branch that does not read it, --plot-best/--video, which exist only to
    draw, without matplotlib; --profile outside the single-env --train loop
    it traces."""
    import importlib.util

    from distributedconvrl_pde_control_torch.viz import plotting

    if args.ckpt_backend == "orbax":
        raise SystemExit("--ckpt-backend orbax: orbax is not installed and the port writes flax "
                         "msgpack checkpoints only (--ckpt-backend msgpack)")
    if args.import_jld2 and (args.ppo or args.mesh or args.population or args.pop_search or not (
            args.eval or (args.train and (args.resume or args.batched)))):
        raise SystemExit("--import-jld2 is read by --eval, --train --resume and --train --batched "
                         "(DDPG, without --mesh or a population)")
    if args.import_jld2 and importlib.util.find_spec("h5py") is None:
        raise SystemExit("--import-jld2: h5py is not installed; the JLD2 reader needs it")
    for flag, on in (("--plot-best", args.plot_best), ("--video", args.video)):
        if on and not plotting.have_matplotlib():
            raise SystemExit(f"{flag}: {plotting.MATPLOTLIB_MISSING}; it draws with it")
    if args.profile and not (args.train and not (args.batched or args.ppo or args.mesh)):
        raise SystemExit("--profile traces the single-env --train loop (KS, Keller-Segel and "
                         "fluid presets without --batched, --ppo or --mesh)")


def main(argv=None):
    from distributedconvrl_pde_control_torch.configs.fluid import PRESETS as FLUID_PRESETS

    table = presets()

    fluid_names = sorted(FLUID_PRESETS) + sorted(b + s for b in FLUID_PRESETS for s in _FLUID_TIERS)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("preset", choices=sorted(table) + fluid_names, metavar="preset",
                    help="a KS or Keller-Segel preset (%s) or a fluid preset (%s, each with an "
                         "optional _fast/_tp/_fixedstep/_eval tier)" % (
                             ", ".join(sorted(table)), ", ".join(sorted(FLUID_PRESETS))))
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--eval", action="store_true", help="evaluate a trained actor")
    mode.add_argument("--train", action="store_true",
                      help="train: the single-env loop, or batched with --batched; fluid presets "
                           "and Keller-Segel with --mesh DPxSP (fluid on the 2/3-rule solver)")
    mode.add_argument("--train-multi", action="store_true",
                      help="the restart protocol with numbered saves")
    mode.add_argument("--hyperopt", type=int, metavar="N_TRIALS", default=None,
                      help="random hyperparameter search (%s): N trials scored by the "
                           "test_setup objective (KSglobalSetup.jl:405)" % ", ".join(
                               HYPEROPT_PRESETS))
    ap.add_argument("--hyperopt-episodes", type=int, default=30,
                    help="episodes per hyperopt trial (the reference uses 100)")
    ap.add_argument("--hyperopt-robust", type=int, metavar="N_INITS", default=None,
                    help="score trials by deterministic rollouts of the trained policy from "
                         "N_INITS held-out random initial fields instead of test_setup's cost")
    ap.add_argument("--load-from", default=None,
                    help="run directory holding saves/hook.npz and saves/agent.msgpack or "
                         "saves/agent_light.msgpack (default --out)")
    ap.add_argument("--out", default=None, help="run directory (default runs/<preset>)")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--config-overrides", default=None, metavar="JSON",
                    help="config-dataclass overrides applied to the preset before building: "
                         "an inline JSON object or a path to a .json file. Saved checkpoints "
                         "ship the deltas as config_overrides.json so --load-from rebuilds "
                         "the matching env; with --hyperopt they change the searched base")
    ap.add_argument("--p-te", type=float, default=None,
                    help="eval horizon (default 200 for KS presets, 12 for Keller-Segel, 6 for "
                         "fluid without --mesh, the preset's te with --mesh)")
    ap.add_argument("--p-t-action", type=float, default=None,
                    help="actuation start time (default p_te/2 for KS and Keller-Segel presets, "
                         "0 for fluid)")
    ap.add_argument("--mesh", default=None,
                    help="train or evaluate a fluid preset (on the 2/3-rule solver) or "
                         "KellerSegel10_16[_fast] over a DPxSP mesh of ranks; with --batched "
                         "(any preset, populations too), N or Nx1 ranks of data parallelism")
    ap.add_argument("--n-envs", type=int, default=None,
                    help="env batch for --batched (default 256) and --mesh runs (default: dp)")
    ap.add_argument("--loops", type=int, default=None,
                    help="training rounds of --train (default the preset's loops)")
    ap.add_argument("--no-steps", type=int, default=None,
                    help="env steps per round of --train (default the preset's no_steps)")
    ap.add_argument("--capacity-per-dp", type=int, default=None,
                    help="--mesh replay capacity per dp group (default 100,000)")
    ap.add_argument("--no-episodes", type=int, default=None,
                    help="--train-multi episodes per experiment (default 2800 for KS presets, "
                         "KSSetup.jl:325; 17 with --mesh, FluidSetup.jl:559)")
    ap.add_argument("--n-experiments", type=int, default=2,
                    help="--train-multi experiments; 0 restarts endlessly")
    ap.add_argument("--nx", type=int, default=None,
                    help="override the fluid grid size for --mesh runs")
    ap.add_argument("--horizon", type=float, default=None,
                    help="override the episode horizon te for --mesh runs")
    ap.add_argument("--batched", action="store_true",
                    help="train with the throughput configuration (env batch, chunks of "
                         "steps), any family without --mesh; saves saves/hook.npz and "
                         "saves/agent_light.msgpack")
    ap.add_argument("--total-steps", type=int, default=2000,
                    help="train steps for --batched training")
    ap.add_argument("--chunk-len", type=int, default=None,
                    help="train steps per record read (default 50 --batched, 25 --mesh)")
    ap.add_argument("--learner-batch", type=int, default=None,
                    help="DDPG learner batch (default 256 --batched, 32 --mesh)")
    ap.add_argument("--update-loops", type=int, default=1,
                    help="--batched gradient steps per train step")
    ap.add_argument("--eval-steps", type=int, default=50,
                    help="deterministic-eval rollout length (env steps) for --eval-every "
                         "runs; beyond te/dt a --batched eval runs on a horizon-overridden "
                         "clone of the env, a --mesh eval has no te cap")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="deterministic eval cadence for training (train steps); evals "
                         "drive best-actor selection")
    ap.add_argument("--eval-warmup", type=int, default=0, metavar="K",
                    help="--batched: evolve the eval IC batch uncontrolled for K steps before "
                         "the actor engages, scoring only the controlled segment, on "
                         "held-out ICs")
    ap.add_argument("--eval-pool", type=int, default=32, metavar="N",
                    help="--eval-warmup: how many held-out generator ICs the eval pool draws")
    ap.add_argument("--eval-score", choices=["mean", "min"], default="mean",
                    help="--batched eval reduction: pooled mean step reward, or the min over "
                         "per-env masked means")
    ap.add_argument("--noise-every", type=int, default=None,
                    help="--batched noise-decay cadence in steps (default total_steps/loops)")
    ap.add_argument("--noise-decay", type=float, default=None,
                    help="--batched noise-decay factor (default the preset's per-loop decay)")
    ap.add_argument("--capacity", type=int, default=None,
                    help="--batched replay capacity override (the preset's single-env size "
                         "wraps quickly at batched push rates: n_envs*n_act per step)")
    ap.add_argument("--ppo", action="store_true",
                    help="the PPO agent instead of DDPG: --train writes saves/ppo.msgpack and "
                         "saves/ppo_info.npz, --eval rolls the deterministic mean policy")
    ap.add_argument("--iters", type=int, default=60,
                    help="PPO collect-and-update iterations of --ppo --train")
    ap.add_argument("--ppo-ref", action="store_true",
                    help="with --ppo: the reference protocol (PPOConfig's defaults, "
                         "PDEagent.jl:462-512: 10 epochs x 32 microbatches, lr 1e-3, rollout 64) "
                         "instead of the tuned light config")
    ap.add_argument("--population", type=int, default=None, metavar="P",
                    help="--train --batched: P members as one fused program (members flattened "
                         "member-major into the env axis); each saves a light checkpoint under "
                         "OUT/member_XX beside population.json")
    ap.add_argument("--pop-overrides", default=None, metavar="JSON",
                    help="per-member variation for --population: a JSON object (inline or a "
                         "file path) of P-length lists for any of %s" % ", ".join(POP_OVERRIDE_KEYS))
    ap.add_argument("--pop-search", type=int, default=None, metavar="N",
                    help="--train --batched: random search over act_noise, noise_decay and the "
                         "actor and critic learning rates, N trials in fused rounds of "
                         "--population (default 8) members, each scored by its eval-driven best; "
                         "writes search.json and the winner's checkpoint into --out")
    ap.add_argument("--random-init", action="store_true",
                    help="--eval from one field of the preset's random_init (the port's "
                         "generator, seeded --seed) instead of the standard y0")
    ap.add_argument("--import-jld2", default=None, metavar="SAVES_DIR",
                    help="a reference-format JLD2 save directory (agent.jld2/hook.jld2, "
                         "KSSetup.jl:378-402): --eval converts it to the light checkpoint in "
                         "--out and evaluates it, --train --resume continues it, --train "
                         "--batched warm-starts from its networks (needs h5py)")
    ap.add_argument("--ckpt-backend", choices=("msgpack", "orbax"), default="msgpack",
                    help="checkpoint format of --train saves: flax msgpack (orbax is refused: "
                         "the port writes msgpack only)")
    ap.add_argument("--serve", action="store_true",
                    help="with --eval: run the closed-loop serving probe (experiments/serve.py) "
                         "on the checkpoint instead of the protocol")
    ap.add_argument("--export-controller", metavar="DIR", default=None,
                    help="with --eval: export the deployed obs->action program (weights as "
                         "buffers) with torch.export into DIR (experiments/export_controller.py)")
    ap.add_argument("--plot-best", action="store_true",
                    help="with --eval: draw the stored best-episode trace (heat_best.png) instead "
                         "of a fresh rollout (needs matplotlib)")
    ap.add_argument("--plot-separate", action="store_true",
                    help="write each heat panel as its own figure (plot_heat plot_separate)")
    ap.add_argument("--from-step", type=int, default=0,
                    help="heatmap window start (plot_heat `from`)")
    ap.add_argument("--to-step", type=int, default=None,
                    help="heatmap window end (plot_heat `to`)")
    ap.add_argument("--live", action="store_true",
                    help="animate the eval rollout live in the terminal (numpy only)")
    ap.add_argument("--video", action="store_true",
                    help="write the eval rollout's frames and, with ffmpeg, an mp4 (needs "
                         "matplotlib)")
    ap.add_argument("--fps", type=float, default=16.0, help="--live/--video frame rate")
    ap.add_argument("--profile", action="store_true",
                    help="with --train (the single-env loop): trace the first loop with "
                         "torch.profiler into <out>/profile/trace.json and print per-phase "
                         "timings")
    ap.add_argument("--virtual-devices", type=int, default=None,
                    help="N gloo ranks on the CPU for --mesh; without --mesh, run on the CPU")
    ap.add_argument("--resume", action="store_true",
                    help="--train: continue from the checkpoint in --load-from (default --out); "
                         "--batched ignores it, as the JAX CLI does")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    args = ap.parse_args(argv)
    # --virtual-devices without --mesh runs on the CPU, as the JAX CLI's does
    device = "cpu" if args.cpu or (args.virtual_devices and not args.mesh) else "cuda"

    # what this installation cannot run, each named
    refuse_missing(args)
    fluid_cfg = fluid_config_for(args.preset)
    if args.batched and args.mesh:
        # data-parallel batched training and populations (JAX run.py:595-606)
        if args.train_multi:
            raise SystemExit("--train-multi --mesh drives the sharded trainers; combine it with a "
                             "plain --mesh, not --batched")
        if not args.train:
            raise SystemExit("--batched --mesh is a training mode; the saved checkpoint is "
                             "standard single-chip format — eval it without --mesh")
    if fluid_cfg is not None and args.hyperopt:
        raise SystemExit(f"--hyperopt supports {list(HYPEROPT_PRESETS)}")
    if args.mesh and not args.batched:
        mesh_cfg = sharded_config_for(args.preset)
        if mesh_cfg is None:
            raise SystemExit("--mesh supports fluid presets (with their _fast/_tp/_fixedstep/"
                             f"_eval tiers) and KellerSegel10_16[_fast], not {args.preset}")
        return run_sharded(args, mesh_cfg, device)
    if args.hyperopt:
        return run_hyperopt(args, device)

    # artifacts trained off-preset ship a config_overrides.json; honoring it
    # makes them loadable through --load-from. --config-overrides (inline
    # JSON or a file path) layers on top
    from distributedconvrl_pde_control_torch.train import checkpoint

    overrides = checkpoint.load_config_overrides(args.load_from) if args.load_from else None
    if args.config_overrides:
        overrides = {**(overrides or {}), **_read_overrides(args.config_overrides)}
    if overrides and overrides.get("spectral_featurize") and not args.train:
        # trainer-only tier: it leaves EnvState.y at the reset field by
        # design, so eval rollouts rebuild without it to record real fields;
        # the policy itself sees the same observations either way
        overrides = {k: v for k, v in overrides.items() if k != "spectral_featurize"}
    cfg = fluid_cfg if fluid_cfg is not None else table[args.preset][0]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if args.ppo:
        return run_ppo(args, cfg, overrides, device)
    if args.train and args.batched:
        if args.population or args.pop_search:
            return run_population(args, cfg, overrides, device)
        if args.resume:
            print("--resume: --batched training starts afresh (the JAX CLI's batched branch "
                  "does not read --resume either)")
        return run_train_batched(args, cfg, overrides, device)
    if args.train or args.train_multi:
        return run_train(args, cfg, overrides, device)
    return run_eval(args, cfg, device)


if __name__ == "__main__":
    main()
