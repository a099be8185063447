"""One step of every multi-rank training program, on gloo CPU ranks.

Counterpart of ``__graft_entry__.py::dryrun_multichip`` of the JAX package:
`dryrun_multichip(n)` starts n gloo CPU ranks (`parallel.mesh.launch`) and
runs, at tiny shapes, the four multi-rank programs of the port, asserting
that each gives finite values:

  1. one train step of the sharded fluid trainer (`parallel/multichip.py`:
     FLUID_8 at a 16^2 grid, 4x4 actuators) on the (dp, sp) mesh of
     `make_dp_sp_mesh(n)`: the transpose FFT, the sp sensor sums and the dp
     gradient mean;
  2. one train step of the sharded Keller-Segel trainer
     (`parallel/multichip_keller_segel.py`) on the same mesh: the halo
     exchange;
  3. one 2-step chunk of `DPBatchedTrainer` on an n x 1 mesh (KS22 on ETDRK4
     with the spectral carry and spectral featurization, the configuration
     `bench.py` measures);
  4. a 2-member population x dp chunk on that mesh (per-member learning
     rates), then its per-member eval and its delayed-actuation (OOD) eval.

    python -c "from distributedconvrl_pde_control_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(8)"
"""

from __future__ import annotations

import dataclasses
import math
import tempfile
from typing import Optional

import torch

from distributedconvrl_pde_control_torch.parallel.mesh import (
    launch,
    make_dp_sp_mesh,
    make_rank_mesh,
)


def _dryrun_rank(mesh, n: int) -> dict:
    """The four sections on this rank; every rank checks its own values."""
    from distributedconvrl_pde_control_torch.configs.fluid import FLUID_8
    from distributedconvrl_pde_control_torch.configs.keller_segel import KELLER_SEGEL_10_16
    from distributedconvrl_pde_control_torch.configs.ks import KS22, build_ks, ks_random_init
    from distributedconvrl_pde_control_torch.parallel.batched_dp import DPBatchedTrainer
    from distributedconvrl_pde_control_torch.parallel.multichip import (
        ShardedFluidTrainer,
        ShardedTrainConfig,
    )
    from distributedconvrl_pde_control_torch.parallel.multichip_keller_segel import (
        ShardedKellerSegelTrainer,
    )
    from distributedconvrl_pde_control_torch.train.batched import BatchedTrainerConfig
    from distributedconvrl_pde_control_torch.train.population import PopulationTrainer

    n_dp, n_sp = mesh.shape
    dp = make_rank_mesh(n, 1, "cpu")
    tcfg = ShardedTrainConfig(n_envs=2 * n_dp, batch_size=8, capacity_per_dp=1024,
                              y0_pool_size=2, chunk_len=1)
    out = {}

    # 1) the transpose-FFT family: one train step of the preset-driven fluid trainer
    cfg = dataclasses.replace(FLUID_8, nx=16, sensors_per_axis=4)
    trainer = ShardedFluidTrainer(cfg, mesh, tcfg, device="cpu")
    state = trainer.init(torch.Generator().manual_seed(0))
    state, _ = trainer.make_chunk_fn(1)(state)
    out["fluid_mean_reward"] = float(state.mean_reward)
    assert math.isfinite(out["fluid_mean_reward"]), "multichip step produced non-finite reward"

    # 2) the halo-exchange family: one train step of the Keller-Segel trainer
    ks_nx = -(-KELLER_SEGEL_10_16.nx // n_sp) * n_sp  # the grid must divide over sp
    kcfg = dataclasses.replace(KELLER_SEGEL_10_16, nx=ks_nx, te=0.06, oversampling=5)
    ktrainer = ShardedKellerSegelTrainer(kcfg, mesh, tcfg, device="cpu")
    kstate = ktrainer.init(torch.Generator().manual_seed(1))
    kstate, _ = ktrainer.make_chunk_fn(1)(kstate)
    out["keller_segel_mean_reward"] = float(kstate.mean_reward)
    assert math.isfinite(out["keller_segel_mean_reward"]), (
        "keller-segel multichip step produced non-finite reward")

    # 3) the batched trainer, data-parallel, on the spectral-carry and
    # spectral-featurize tier
    ks_cfg = dataclasses.replace(KS22, stepper="etdrk4", spectral_carry=True,
                                 spectral_featurize=True)
    setup = build_ks(ks_cfg, device="cpu")
    dp_trainer = DPBatchedTrainer(setup.env, setup.agent,
                                  BatchedTrainerConfig(n_envs=2 * n, batch_size=8, update_loops=1),
                                  dp, random_init=ks_random_init(KS22, "cpu"))
    dp_state = dp_trainer.init(torch.Generator().manual_seed(2))
    _, recs = dp_trainer.make_chunk_fn(2)(dp_state)
    out["dp_records"] = tuple(recs.shape)
    assert bool(torch.isfinite(recs).all()), "dp-batched chunk produced non-finite records"

    # 4) population x dp: a local mini-population on every rank, per-member
    # gradients averaged over dp; one chunk, the per-member eval and the
    # delayed-actuation eval
    pop = PopulationTrainer(setup.env, setup.agent,
                            BatchedTrainerConfig(n_envs=n, batch_size=8, update_loops=1),
                            n_members=2, random_init=ks_random_init(KS22, "cpu"),
                            lr_actor=[5e-4, 1e-4], lr_critic=[1e-3, 1e-3], mesh=dp)
    pop_state = pop.init(torch.Generator().manual_seed(3))
    pop_state, pop_recs = pop.make_chunk_fn(2)(pop_state)
    assert bool(torch.isfinite(pop_recs).all()), (
        "population x dp chunk produced non-finite records")
    rs = pop.eval_mean_rewards(pop_state.agent.actor, n_steps=2)
    assert all(r == r for r in rs.tolist()), "population x dp eval produced NaN member rewards"
    rs_ood = pop.eval_mean_rewards(pop_state.agent.actor, n_steps=2, warmup_steps=2)
    assert all(r == r for r in rs_ood.tolist()), (
        "population x dp OOD eval produced NaN member rewards")
    out["population_evals"] = (rs.tolist(), rs_ood.tolist())
    return out


def dryrun_multichip(n_devices: int, deadline_s: Optional[float] = None) -> dict:
    """The four sections on `n_devices` gloo CPU ranks (the group's store in
    a temporary directory); rank 0's values. `deadline_s` (default none)
    bounds the whole run, the launcher's group timeout every collective."""
    dp, sp = make_dp_sp_mesh(n_devices)
    with tempfile.TemporaryDirectory() as store_dir:
        return launch(_dryrun_rank, dp, sp, n_devices, backend="gloo", store_dir=store_dir,
                      deadline_s=deadline_s)
