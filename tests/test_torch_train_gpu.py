"""The port's training paths on the card against the port on the CPU.

Tests marked `gpu` need a CUDA device (K1 is built with nvcc at first use);
they decide inside the test whether there is one and skip without it. They
import nothing of JAX, so they run where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_train_gpu.py -m gpu
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke

from distributedconvrl_pde_control_torch.configs.fluid import FLUID_16_256
from distributedconvrl_pde_control_torch.configs.ks import KS22, build_ks
from distributedconvrl_pde_control_torch.models.mlp import chain_to_numpy, copy_chain
from distributedconvrl_pde_control_torch.ops.kernels import ks_kernel
from distributedconvrl_pde_control_torch.ops.kernels import ns_advection as k2
from distributedconvrl_pde_control_torch.parallel import multichip
from distributedconvrl_pde_control_torch.train.batched import (
    BatchedTrainer,
    BatchedTrainerConfig,
    StepDraws,
)

SF = dict(stepper="etdrk4", spectral_carry=True, spectral_featurize=True)
TP = dict(stepper="etdrk4", fft_mode="matmul_hi", nl_fft_mode="matmul_fast", spectral_carry=True)
TIERS = [pytest.param({}, id="cnab2"), pytest.param(dict(stepper="etdrk4"), id="etdrk4"),
         pytest.param(dict(stepper="etdrk4", spectral_carry=True), id="carry"),
         pytest.param(SF, id="sf"), pytest.param(TP, id="tp")]
N_ENVS, BATCH, POOL = 4, 16, 6


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def small_trainer(over, device, **cfg_kw):
    setup = build_ks(dataclasses.replace(KS22, te=1.5, **over), device=device)
    pool = setup.random_init(torch.Generator().manual_seed(15), POOL)
    return BatchedTrainer(setup.env, setup.agent,
                          BatchedTrainerConfig(n_envs=N_ENVS, batch_size=BATCH, min_best_episode=1,
                                               **cfg_kw), y0_pool=pool)


@pytest.mark.gpu
@pytest.mark.parametrize("over", TIERS)
def test_env_tier_on_gpu_matches_cpu(over):
    """12 forced env steps of each tier: obs and reward atol 1e-5, the carry
    1e-5 of its max (float32 cuFFT against the CPU's FFT; CNAB2 is K1
    against its plain twin). The tp tier: obs and reward 1e-4, the carry
    1e-3 of its max, since a float32 sum in another order can flip a bf16
    rounding in the next pass (2^-9 of that operand at matmul_fast), which
    moves a step by up to the tier's own error (1.7e-4 of the field), and
    the steps carry it on (1.7e-5 in obs, 1.4e-4 of the carry's max seen)."""
    _need_cuda()
    rng = np.random.default_rng(0)
    states = []
    for d in ("cuda", "cpu"):
        setup = build_ks(dataclasses.replace(KS22, **over), device=d)
        st = setup.env.reset(setup.random_init(torch.Generator().manual_seed(1), 3))
        states.append((setup.env, st))
    for _ in range(12):
        a = torch.tensor(rng.uniform(-1, 1, (3, 1, 8)), dtype=torch.float32)
        states = [(env, env.step(st, a.to(st.obs.device))) for env, st in states]
    (_, g), (_, c) = states
    tol, carry_tol = (1e-4, 1e-3) if over.get("nl_fft_mode") else (1e-5, 1e-5)
    np.testing.assert_allclose(g.obs.cpu().numpy(), c.obs.numpy(), atol=tol)
    np.testing.assert_allclose(g.reward.cpu().numpy(), c.reward.numpy(), atol=tol)
    assert g.done.cpu().tolist() == c.done.tolist()
    if c.carry is not None:
        diff = (g.carry.cpu() - c.carry).abs().max().item()
        assert diff <= carry_tol * c.carry.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("over", [pytest.param({}, id="cnab2"), pytest.param(SF, id="sf"),
                                  pytest.param(TP, id="tp")])
def test_train_chunk_on_gpu_matches_cpu(over):
    """20 train steps (learning from step 3, the episode boundary at step
    15) with every draw made once on the CPU: parameters atol 1e-4, records
    atol 1e-3; on CNAB2 the card launches K1 once per train step."""
    _need_cuda()
    gen = torch.Generator().manual_seed(14)
    draws = [dict(noise=torch.randn((1, N_ENVS * 8), generator=gen),
                  offs=torch.randint(0, (i + 1) * N_ENVS * 8, (1, BATCH), generator=gen),
                  idx=torch.randint(0, POOL, (N_ENVS,), generator=gen)) for i in range(20)]
    outs = []
    for d in ("cuda", "cpu"):
        tr = small_trainer(over, d)
        ts = tr.init(torch.Generator().manual_seed(16), idx=torch.arange(N_ENVS))
        seed_state = tr.agent.init_state(torch.Generator().manual_seed(17), "cpu")
        ts.agent = tr.agent.make_state(copy_chain(seed_state.actor).to(d),
                                       copy_chain(seed_state.critic).to(d))
        before = ks_kernel.KS_CNAB2.launches
        ts, packed = tr.make_chunk_fn(20)(
            ts, [StepDraws(**{k: v.to(d) for k, v in dr.items()}) for dr in draws])
        outs.append((ts, packed.cpu().numpy(), ks_kernel.KS_CNAB2.launches - before))
    (ts_g, rec_g, k1_g), (ts_c, rec_c, k1_c) = outs
    assert k1_c == 0 and k1_g == (0 if over else 20)
    np.testing.assert_array_equal(rec_g[:2], rec_c[:2])
    assert rec_c[0, 14].all() and rec_c[0].sum() == N_ENVS
    np.testing.assert_allclose(rec_g, rec_c, atol=1e-3)
    for name in ("actor", "critic", "target_actor", "target_critic"):
        for a, b in zip(chain_to_numpy(getattr(ts_g.agent, name)),
                        chain_to_numpy(getattr(ts_c.agent, name))):
            np.testing.assert_allclose(a["w"], b["w"], atol=1e-4)
            np.testing.assert_allclose(a["b"], b["b"], atol=1e-4)
    assert int(ts_g.ep_count) == int(ts_c.ep_count) == N_ENVS


@pytest.mark.gpu
def test_chunk_reads_nothing_back_and_cuda_draws_repeat():
    """A chunk whose draws come from a CUDA generator runs under
    `set_sync_debug_mode("error")`, and the same seed gives the same chunk."""
    _need_cuda()
    packs = []
    for _ in range(2):
        tr = small_trainer(SF, "cuda")
        ts = tr.init(torch.Generator(device="cuda").manual_seed(3))
        chunk = tr.make_chunk_fn(20)
        ts, _ = chunk(ts)  # past the learn gate, cuFFT plans made
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ts, packed = chunk(ts)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        packs.append(packed.cpu())
        assert ts.generator.device.type == "cuda" and ts.agent.update_step == 40
    assert torch.isfinite(packs[0]).all() and torch.equal(packs[0], packs[1])


@pytest.mark.gpu
def test_fluid_train_chunk_on_gpu_matches_cpu():
    """20 fluid train steps at 32x32, 4x4 actuators, 2 envs (learning from
    step 3, episodes ending at step 15), every draw made once on the CPU:
    parameters rel 1e-4, ep_reward atol 1e-3, mean_reward atol 1e-4, the
    same finished steps; the card launches K2 4 x 5 times per train step."""
    _need_cuda()
    cfg = dataclasses.replace(FLUID_16_256, nx=32, sensors_per_axis=4, te=0.3, start_steps=2,
                              update_after=4)
    tcfg = multichip.ShardedTrainConfig(n_envs=2, batch_size=16, capacity_per_dp=4096)
    gen = torch.Generator().manual_seed(19)
    draws = [StepDraws(noise=torch.randn((1, 32), generator=gen),
                                 offs=torch.randint(0, (i + 1) * 32, (1, 16), generator=gen),
                                 idx=torch.randint(0, tcfg.y0_pool_size, (2,), generator=gen))
             for i in range(20)]
    outs = []
    for d in ("cuda", "cpu"):
        tr = multichip.ShardedFluidTrainer(cfg, (1, 1), tcfg, device=d)
        st = tr.init(torch.Generator().manual_seed(20), seed=21)  # same nets and pool on both
        before = k2.NS_ADVECTION.launches
        st, packed = tr.make_chunk_fn(20)(st, [StepDraws(
            **{k: getattr(dr, k).to(d) for k in ("noise", "offs", "idx")}) for dr in draws])
        outs.append((st, packed.cpu().numpy(), k2.NS_ADVECTION.launches - before))
    (st_g, rec_g, k2_g), (st_c, rec_c, k2_c) = outs
    assert k2_c == 0 and k2_g == 20 * 4 * cfg.oversampling
    np.testing.assert_array_equal(rec_g[:2], rec_c[:2])
    assert rec_c[0, 14].all() and rec_c[0].sum() == 2
    np.testing.assert_allclose(rec_g[2], rec_c[2], atol=1e-3)
    np.testing.assert_allclose(rec_g[4], rec_c[4], atol=1e-4)
    for name in ("actor", "critic", "target_actor", "target_critic"):
        for a, b in zip(chain_to_numpy(getattr(st_g.agent, name)),
                        chain_to_numpy(getattr(st_c.agent, name))):
            for k in ("w", "b"):
                assert np.abs(a[k] - b[k]).max() <= 1e-4 * max(np.abs(b[k]).max(), 1e-3)
    assert int(st_g.ep_count) == int(st_c.ep_count) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("mono", [pytest.param(False, id="ks22"), pytest.param(True, id="mono")])
def test_fidelity_episode_on_gpu_matches_cpu(mono):
    """One fidelity episode with learning (20 steps, learning from step 12)
    on the card against the CPU on the same draws: K1 against its plain
    twin inside the loop, parameters atol 1e-4, reward_sum atol 1e-4, the
    same steps and replay rows; K1 launched once per env step."""
    _need_cuda()
    from distributedconvrl_pde_control_torch.agents.replay import replay_init
    from distributedconvrl_pde_control_torch.configs.ks import KS22_GLOBAL, build_ks_global
    from distributedconvrl_pde_control_torch.train.loop import TrainState, make_episode_fn

    build, base = (build_ks_global, KS22_GLOBAL) if mono else (build_ks, KS22)
    cfg = dataclasses.replace(base, te=2.0, capacity=4000)
    acfg = build(cfg, device="cpu").agent.cfg
    gen = torch.Generator().manual_seed(5)
    n_cols = 1 if mono else KS22.n_actuators
    draws = [StepDraws(noise=torch.randn((acfg.na_rows, n_cols), generator=gen),
                       offs=torch.randint(0, max(acfg.interleave * (i - 1), 1),
                                          (acfg.update_loops, acfg.batch_size), generator=gen))
             for i in range(20)]
    seed = build(cfg, device="cpu").agent.init_state(torch.Generator().manual_seed(6), "cpu")
    y0 = build(cfg, device="cpu").random_init(torch.Generator().manual_seed(7), 1)[0]
    outs = []
    for d in ("cuda", "cpu"):
        s = build(cfg, device=d)
        ts = TrainState(agent=s.agent.make_state(copy_chain(seed.actor).to(d),
                                                 copy_chain(seed.critic).to(d)),
                        replay=replay_init(acfg.capacity, acfg.ns, acfg.na_rows, d), generator=None)
        before = ks_kernel.KS_CNAB2.launches
        ts, res = make_episode_fn(s.env, s.agent, learning=True)(
            ts, y0.to(d), [StepDraws(noise=x.noise.to(d), offs=x.offs.to(d)) for x in draws])
        outs.append((ts, res, ks_kernel.KS_CNAB2.launches - before))
    (ts_c, res_c, k1_c), (ts_h, res_h, k1_h) = outs
    assert res_c.steps == res_h.steps == 20 == k1_c and k1_h == 0
    assert ts_c.replay.size == ts_h.replay.size == 20 * acfg.interleave
    np.testing.assert_allclose(ts_c.replay.buf[:ts_c.replay.size].cpu().numpy(),
                               ts_h.replay.buf[:ts_h.replay.size].numpy(), atol=1e-4, rtol=0)
    assert abs(float(res_c.reward_sum) - float(res_h.reward_sum)) <= 1e-4
    for name in ("actor", "critic", "target_actor", "target_critic"):
        for a, b in zip(chain_to_numpy(getattr(ts_c.agent, name)),
                        chain_to_numpy(getattr(ts_h.agent, name))):
            np.testing.assert_allclose(a["w"], b["w"], atol=1e-4, rtol=0)
            np.testing.assert_allclose(a["b"], b["b"], atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_ppo_iteration_on_gpu_matches_cpu():
    """One PPO iteration on KS22 (chip_smoke.py phase 34): parameters within
    1e-4 of each tensor's largest value, the mean reward within 1e-4, and K1
    launched once per env step on the card."""
    _need_cuda()
    res = chip_smoke.ppo_pair()
    assert res["params_max_err_of_scale"] <= 1e-4 and res["mean_reward_err"] <= 1e-4, res
    assert res["K1_launches"] == [res["env_steps"], 0] and res["trunk_moved"] > 1e-5


@pytest.mark.gpu
def test_ppo_iteration_reads_nothing_back():
    """A PPO iteration (tuned config, 8 envs) whose draws come from a CUDA
    generator runs under `set_sync_debug_mode("error")`."""
    _need_cuda()
    from distributedconvrl_pde_control_torch.agents.ppo import PPOAgent, PPOTrainer, tuned_config

    setup = build_ks(KS22, device="cuda")
    trainer = PPOTrainer(setup.env, PPOAgent(tuned_config(setup.agent.cfg.ns, 1)), n_envs=8,
                         random_init=setup.random_init)
    gen = torch.Generator(device="cuda").manual_seed(4)
    state = trainer.agent.init_state(gen, "cuda")
    it = trainer.make_train_iter()
    state, r0 = it(state, gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, r1 = it(state, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(r0)) and np.isfinite(float(r1)) and state.update_count == 2


@pytest.mark.gpu
@pytest.mark.parametrize("over", [pytest.param({}, id="cnab2"), pytest.param(SF, id="sf")])
def test_population_chunk_on_gpu_matches_cpu(over):
    """A P=2 population chunk (chip_smoke.py phase 37) with per-member
    learning rates and act_noise: phase 14's limits; on CNAB2 the card
    launches K1 once per train step."""
    _need_cuda()
    res = chip_smoke.population_pair(over)
    assert res["params_max_abs_err"] <= 1e-4 and res["ep_reward_err"] <= 1e-3, res
    assert res["mean_reward_err"] <= 1e-4 and res["same_finishes"] and res["finite"]
    assert res["K1_launches"] == [0 if over else res["steps"], 0]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["matmul", "matmul_hi", "matmul_fast"])
def test_tier_transforms_on_gpu_match_cpu(mode):
    """Every transform of ops/fourier.py at each tier on the card against
    the CPU: rel 1e-5 per pass (the same bf16 rounding, float32 sums in
    another order), a 2D transform's second pass fed the card's first (a
    float32 intermediate one ulp apart can flip a bf16 rounding of the next
    pass); cuBLAS's float32 precision is as it was after."""
    _need_cuda()
    from distributedconvrl_pde_control_torch.ops import fourier as F

    rng = np.random.default_rng(44)
    real = torch.tensor(rng.standard_normal((4, 64, 48)), dtype=torch.float32)
    cplx = torch.complex(real, torch.tensor(rng.standard_normal((4, 64, 48)), dtype=torch.float32))
    half, half2 = torch.fft.rfft(real), torch.fft.rfft2(real)
    # name -> (the transform, its input, and for a 2D transform its two passes)
    cases = {
        "rfft": (lambda x: F.rfft(x, mode=mode), real, None),
        "irfft": (lambda h: F.irfft(h, 48, mode=mode), half, None),
        "fft axis -2": (lambda z: F.fft(z, axis=-2, mode=mode), cplx, None),
        "ifft": (lambda z: F.ifft(z, mode=mode), cplx, None),
        "fft2": (lambda x: F.fft2(x, mode=mode), real,
                 (lambda x: F.fft(x, mode=mode), lambda z: F.fft(z, axis=-2, mode=mode))),
        "ifft2": (lambda z: F.ifft2(z, mode=mode), cplx,
                  (lambda z: F.ifft(z, mode=mode), lambda z: F.ifft(z, axis=-2, mode=mode))),
        "rfft2": (lambda x: F.rfft2(x, mode=mode), real,
                  (lambda x: F.rfft(x, mode=mode), lambda z: F.fft(z, axis=-2, mode=mode))),
        "irfft2": (lambda h: F.irfft2(h, 48, mode=mode), half2,
                   (lambda h: F.ifft(h, axis=-2, mode=mode), lambda z: F.irfft(z, 48, mode=mode))),
    }
    m = torch.backends.cuda.matmul
    before = (m.fp32_precision, torch.get_float32_matmul_precision())
    for name, (fn, x, passes) in cases.items():
        got = fn(x.cuda()).cpu()
        want = fn(x) if passes is None else passes[1](passes[0](x.cuda()).cpu())
        rel = (torch.linalg.norm(got - want) / torch.linalg.norm(want)).item()
        assert rel <= 1e-5, f"{name}: rel {rel:.2e}"
    assert (m.fp32_precision, torch.get_float32_matmul_precision()) == before
