"""The single-device fluid env and the Keller-Segel env on the card against
the port on the CPU, and the Keller-Segel step's routes (K3 and the CUDA
graph) against its eager launches.

Tests marked `gpu` need a CUDA device; they decide inside the test whether
there is one and skip without it. They import nothing of JAX:

    python -m pytest --noconftest tests/test_torch_families_gpu.py -m gpu
"""

import dataclasses

import numpy as np
import pytest
import torch

from distributedconvrl_pde_control_torch.configs import fluid as F
from distributedconvrl_pde_control_torch.configs import keller_segel as K
from distributedconvrl_pde_control_torch.ops import keller_segel as ksg_ops
from distributedconvrl_pde_control_torch.ops.navier_stokes import initial_condition


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _rel(got, want):
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.gpu
def test_keller_segel_graph_matches_eager_and_cpu(monkeypatch):
    """4 envs, 20 env steps: the solver's route at the preset's 100 points,
    K3, against the eager step on the card (2e-6 of the field's scale:
    float32 rounding, K3 contracts products and sums), the captured graph,
    pinned, against the eager step (1e-6: the same kernels in the same
    order), and the env on the card against the env on the CPU (1e-4)."""
    _need_cuda()
    cfg = K.KELLER_SEGEL_10_16_FAST
    setups = {d: K.build_keller_segel(cfg, device=d) for d in ("cuda", "cpu")}
    y0 = setups["cpu"].random_init(torch.Generator().manual_seed(3), 4)
    actions = torch.rand((20, 4, 1, 16), generator=torch.Generator().manual_seed(4)) * 2 - 1
    states = {d: s.env.reset(y0.to(d)) for d, s in setups.items()}
    solver = K.KellerSegelSolver(nx=cfg.nx, lx=cfg.lx)
    pinned = K.KellerSegelSolver(nx=cfg.nx, lx=cfg.lx)
    kernel_steps = ksg_ops.KELLER_SEGEL_STEPS.kernel_steps
    for i in range(20):
        y, forcing = states["cuda"].y, setups["cuda"].env.prepare_action(actions[i].cuda())
        eager = solver.step_eager(y, forcing, cfg.dt, cfg.oversampling)
        assert _rel(solver.step(y, forcing, cfg.dt, cfg.oversampling), eager) <= 2e-6
        with monkeypatch.context() as m:
            m.setattr(ksg_ops, "_route", lambda y, nx: "graph")
            assert _rel(pinned.step(y, forcing, cfg.dt, cfg.oversampling), eager) <= 1e-6
        for d, s in setups.items():
            states[d] = s.env.step(states[d], actions[i].to(d))
        for name in ("y", "obs", "reward"):
            assert _rel(getattr(states["cuda"], name), getattr(states["cpu"], name)) <= 1e-4, name
    # the solver's 20 steps and the env's 20, all by K3
    assert ksg_ops.KELLER_SEGEL_STEPS.kernel_steps == kernel_steps + 40
    assert not solver.graphs and len(pinned.graphs) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("over", [dict(adaptive=True), dict(adaptive=False, stepper="rk4"),
                                  dict(adaptive=False, stepper="ifrk4"),
                                  dict(adaptive=True, abs_sensor_channel=True,
                                       energy_reward_weight=0.05)])
def test_fluid_env_on_gpu_matches_cpu(over):
    """32x32 grid, 4x4 actuators, 2 envs from different fields, 6 steps."""
    _need_cuda()
    cfg = dataclasses.replace(F.FLUID_8, nx=32, sensors_per_axis=4, **over)
    rng = np.random.default_rng(5)
    y0 = torch.tensor(np.stack([np.fft.ifft2(initial_condition(4, 32, 32, 1.0, 1.0, rng)).real
                                for _ in range(2)]).astype(np.float32))
    actions = torch.rand((6, 2, 1, 16), generator=torch.Generator().manual_seed(6)) * 2 - 1
    setups = {d: F.build_fluid(cfg, device=d) for d in ("cuda", "cpu")}
    states = {d: s.env.reset(y0.to(d)) for d, s in setups.items()}
    for i in range(6):
        for d, s in setups.items():
            states[d] = s.env.step(states[d], actions[i].to(d))
        for name in ("y", "obs", "reward"):
            assert _rel(getattr(states["cuda"], name), getattr(states["cpu"], name)) <= 1e-4, name
    if cfg.adaptive:
        assert (setups["cuda"].env.step_fn.last_trials
                == setups["cpu"].env.step_fn.last_trials).all()
