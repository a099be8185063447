"""Data and tensor parallelism on the card: NCCL process groups of one rank.

Tests marked `gpu` need a CUDA device; they decide inside the test whether
there is one and skip without it. They import nothing of JAX:

    python -m pytest --noconftest tests/test_torch_dp_gpu.py -m gpu

At one rank every collective of `DPBatchedTrainer` (the hook scalars, the
gradient mean, the record gather) and of the TP learn step (the Megatron
operators, the gathers) runs through NCCL on CUDA tensors and is the
identity, so the results must equal the single-device step's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from distributedconvrl_pde_control_torch.agents.ddpg import DDPGAgent, DDPGConfig
from distributedconvrl_pde_control_torch.configs.ks import KS22, build_ks
from distributedconvrl_pde_control_torch.ops.kernels import ks_kernel
from distributedconvrl_pde_control_torch.parallel.batched_dp import DPBatchedTrainer
from distributedconvrl_pde_control_torch.parallel.mesh import launch
from distributedconvrl_pde_control_torch.parallel.tp import make_tp_learn_step, make_tp_mesh
from distributedconvrl_pde_control_torch.train.batched import BatchedTrainer, BatchedTrainerConfig

STEPS = 12  # learning from step 7


def _on_nccl(mesh):
    assert mesh.backend == "nccl" and mesh.device == "cuda"
    setup = build_ks(dataclasses.replace(KS22, te=1.0), device="cuda")  # an episode end at 10
    cfg = BatchedTrainerConfig(n_envs=4, batch_size=16)
    single = BatchedTrainer(setup.env, setup.agent, cfg, random_init=setup.random_init)
    dp = DPBatchedTrainer(setup.env, setup.agent, cfg, mesh, random_init=setup.random_init)
    t1, t2 = (tr.init(torch.Generator(device="cuda").manual_seed(7)) for tr in (single, dp))
    before = ks_kernel.KS_CNAB2.launches
    (t1, r1), (t2, r2) = single.make_chunk_fn(STEPS)(t1), dp.make_chunk_fn(STEPS)(t2)
    launches = ks_kernel.KS_CNAB2.launches - before
    nets = [(a.detach().cpu().numpy(), b.detach().cpu().numpy())
            for name in ("actor", "critic")
            for a, b in zip(getattr(t1.agent, name).parameters(),
                            getattr(t2.agent, name).parameters())]

    agent = DDPGAgent(DDPGConfig(ns=4, na_rows=1, n_actuators=8, batch_size=16, nna_scale=1.6,
                                 nna_scale_critic=8.0))
    state = agent.init_state(torch.Generator(device="cuda").manual_seed(0), "cuda")
    g = torch.Generator().manual_seed(1)
    batch = tuple(x.cuda() for x in (torch.randn(4, 16, generator=g),
                                     torch.randn(1, 16, generator=g), torch.randn(16, generator=g),
                                     torch.zeros(16), torch.randn(4, 16, generator=g)))
    got = make_tp_learn_step(agent, make_tp_mesh(1, "cuda"))(state, batch)
    agent.learn_batch(state, batch)
    tp = [(a.detach().cpu().numpy(), b.detach().cpu().numpy())
          for name in ("actor", "critic", "target_critic")
          for a, b in zip(getattr(got, name).parameters(), getattr(state, name).parameters())]
    return (r1.cpu().numpy(), r2.cpu().numpy(), t1.obs_flat.cpu().numpy(),
            t2.obs_flat.cpu().numpy(), nets, launches, tp)


@pytest.mark.gpu
def test_dp1_and_tp1_on_nccl_match_the_single_device_step(tmp_path):
    """A 12-step chunk of `DPBatchedTrainer` on an NCCL group of one against
    `BatchedTrainer` from the same generator (K1 once per train step each):
    records and obs_flat equal, parameters within 1e-7; one TP learn step on
    the group against `learn_batch`: networks within 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r1, r2, o1, o2, nets, launches, tp = launch(_on_nccl, 1, 1, backend="nccl",
                                                store_dir=str(tmp_path))
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(o1, o2)
    assert r1[0].sum() == 4  # every env finished at step 10
    for a, b in nets:
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)
    assert launches == 2 * STEPS
    for a, b in tp:
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
