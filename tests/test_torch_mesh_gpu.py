"""The rank mesh on the card: an NCCL process group of one rank.

Tests marked `gpu` need a CUDA device; they decide inside the test whether
there is one and skip without it. They import nothing of JAX:

    python -m pytest --noconftest tests/test_torch_mesh_gpu.py -m gpu

A mesh of one rank on the card runs every collective call site of the
sharded code through NCCL on CUDA tensors (`parallel.mesh.launch` with the
nccl backend, in this process); each is the identity at one rank, so the
results must equal the same code on the CPU without a group.
"""

import dataclasses

import numpy as np
import pytest
import torch

from distributedconvrl_pde_control_torch.configs.fluid import FLUID_16_256
from distributedconvrl_pde_control_torch.models.mlp import chain_to_numpy
from distributedconvrl_pde_control_torch.ops.kernels import ns_advection as k2
from distributedconvrl_pde_control_torch.parallel import dfft
from distributedconvrl_pde_control_torch.parallel.mesh import launch
from distributedconvrl_pde_control_torch.parallel.multichip import (
    ShardedFluidTrainer,
    ShardedTrainConfig,
)
from distributedconvrl_pde_control_torch.train.batched import StepDraws

SMALL = dataclasses.replace(FLUID_16_256, nx=32, sensors_per_axis=4, te=0.3, start_steps=2,
                            update_after=4)  # episodes end at step 15, learning from step 3
TCFG = ShardedTrainConfig(n_envs=2, batch_size=16, capacity_per_dp=4096)
STEPS = 16


def _draws():
    gen = torch.Generator().manual_seed(19)
    return [dict(noise=torch.randn((1, 32), generator=gen),
                 offs=torch.randint(0, (i + 1) * 32, (1, 16), generator=gen),
                 idx=torch.randint(0, TCFG.y0_pool_size, (2,), generator=gen))
            for i in range(STEPS)]


def _chunk(mesh, device):
    tr = ShardedFluidTrainer(SMALL, mesh, TCFG, device=device)
    st = tr.init(torch.Generator().manual_seed(20), seed=21)  # the same nets and pool everywhere
    st, packed = tr.make_chunk_fn(STEPS)(
        st, [StepDraws(**{k: v.to(device) for k, v in d.items()}) for d in _draws()])
    return {name: chain_to_numpy(getattr(st.agent, name)) for name in ("actor", "critic")}, \
        packed.cpu().numpy(), int(st.ep_count)


def _on_nccl(mesh):
    assert mesh.backend == "nccl" and mesh.device == "cuda"
    x = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(0)).cuda()
    w = torch.complex(x, x.flip(-1))
    checks = {
        "psum": torch.equal(mesh.psum(x, "sp"), x),
        "pmax_bool": torch.equal(mesh.pmax(x > 0, "dp"), x > 0),
        "all_to_all": torch.equal(mesh.all_to_all(w, "sp", -1, -2), w),
        "ppermute": torch.equal(mesh.ppermute(x, "sp", 1), x),
        "broadcast": mesh.broadcast_object({"a": 1}) == {"a": 1},
        "dfft2": bool(torch.allclose(dfft.dfft2(x, mesh).cpu(), dfft.dfft2(x.cpu()), rtol=0,
                                     atol=1e-4)),
    }
    before = k2.NS_ADVECTION.launches
    chunk = _chunk(mesh, "cuda")
    return checks, chunk, k2.NS_ADVECTION.launches - before


@pytest.mark.gpu
def test_nccl_group_of_one_matches_the_cpu_without_a_group(tmp_path):
    """The collectives, the transforms and a 16-step fluid train chunk (32^2,
    2 envs, K2 on every stage) on an NCCL group of one against the CPU:
    parameters within 1e-4 of each tensor's maximum, the same finished steps
    and episode counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    checks, (params, packed, eps), launches = launch(_on_nccl, 1, 1, backend="nccl",
                                                     store_dir=str(tmp_path))
    assert all(checks.values()), checks
    assert launches == STEPS * 4 * SMALL.oversampling
    want_params, want_packed, want_eps = _chunk((1, 1), "cpu")
    for name in params:
        for g, w in zip(params[name], want_params[name]):
            for k in ("w", "b"):
                np.testing.assert_allclose(g[k], w[k], rtol=0,
                                           atol=1e-4 * max(np.abs(w[k]).max(), 1e-3))
    np.testing.assert_array_equal(packed[[0, 1]], want_packed[[0, 1]])
    np.testing.assert_allclose(packed[2], want_packed[2], atol=1e-3, rtol=0)
    assert eps == want_eps == 2
