"""The port's ETDRK4 stepper and spectral-carry / spectral-featurize env tiers
against the JAX package on the CPU.

The same numpy inputs go through `KSSolverETDRK4`, `build_ks` and `PDEEnv` of
both packages (the JAX side at fft_mode="native", float32 XLA FFTs; the port
on complex float32 torch.fft). The JAX package carries the half-spectrum as a
(re, im) pair, the port as one complex64 tensor: `.real`/`.imag` are held
against the pair. Every case runs at batch > 1 with rows that differ.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedconvrl_pde_control_tpu.configs import ks as jks
from distributedconvrl_pde_control_tpu.ops.ks import KSSolver as JaxKSSolver
from distributedconvrl_pde_control_tpu.ops.ks import KSSolverETDRK4 as JaxETDRK4
from distributedconvrl_pde_control_torch.configs import ks as tks
from distributedconvrl_pde_control_torch.envs.pde_env import where_state
from distributedconvrl_pde_control_torch.ops.ks import KSSolver, KSSolverETDRK4

NX, LX, DT = 192, 22.0, 0.1
B = 3
ETD = dict(stepper="etdrk4")
CARRY = dict(stepper="etdrk4", spectral_carry=True)
SF = dict(stepper="etdrk4", spectral_carry=True, spectral_featurize=True)


def jax_cfg(**kw):
    return dataclasses.replace(jks.KS22, fft_mode="native", **kw)


def torch_cfg(**kw):
    return dataclasses.replace(tks.KS22, **kw)


@pytest.fixture(scope="module")
def attractor():
    """(B, nx) attractor states: the standard y0 and two scaled copies of it
    spun up for 200 env steps with the JAX CNAB2 stepper, and forcings."""
    ref = JaxKSSolver(nx=NX, lx=LX, dt=DT, oversampling=30, fft_mode="native")
    y0 = jks.ks_standard_y0(NX)
    y = jnp.asarray(np.stack([y0, 0.7 * np.roll(y0, 40), -1.3 * np.roll(y0, 90)]))
    f0 = jnp.zeros((B, NX), jnp.float32)
    for _ in range(200):
        y = ref.step(y, f0)
    f = 0.2 * np.random.default_rng(0).standard_normal((B, NX)).astype(np.float32)
    return np.array(y), f


def random_y0s(n, seed=1):
    init = jks.ks_random_init(jks.KS22)
    return np.stack([np.asarray(init(k)) for k in jax.random.split(jax.random.PRNGKey(seed), n)])


@pytest.mark.parametrize("nx,dt,os_,mu", [(192, 0.1, 1, 0.0), (64, 0.05, 2, 0.02), (240, 0.1, 1, 0.02)])
def test_phi_weights_match_jax(nx, dt, os_, mu):
    """The float64 host-side Kassam-Trefethen weights, cast to float32: bit
    equal or 1 ulp (both sides run the same numpy code)."""
    lx = 22.0 if nx != 240 else 200.0
    js = JaxETDRK4(nx=nx, lx=lx, dt=dt, oversampling=os_, mu=mu, fft_mode="native")
    ts = KSSolverETDRK4(nx=nx, lx=lx, dt=dt, oversampling=os_, mu=mu, device="cpu")
    for name in ("e_full", "e_half", "q_w", "f1_w", "f2_w", "f3_w", "g_alpha", "dist_re", "dist_im"):
        want, got = np.asarray(getattr(js, name)), getattr(ts, name).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape == (nx // 2 + 1,)
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
    np.testing.assert_array_equal(ts.f2_twice.numpy(), 2.0 * ts.f2_w.numpy())
    np.testing.assert_array_equal(ts.g_op.imag.numpy(), -ts.g_alpha.numpy())
    np.testing.assert_array_equal(ts.dist.real.numpy(), ts.dist_re.numpy())


def test_step_matches_jax_on_attractor(attractor):
    """One forced step from attractor states: rel 1e-5 of max|y'|."""
    y, f = attractor
    want = np.asarray(JaxETDRK4(nx=NX, lx=LX, dt=DT, fft_mode="native").step(
        jnp.asarray(y), jnp.asarray(f)))
    got = KSSolverETDRK4(nx=NX, lx=LX, dt=DT, device="cpu").step(
        torch.from_numpy(y), torch.from_numpy(f)).numpy()
    assert got.shape == (B, NX) and got.dtype == np.float32
    assert np.abs(got[0] - got[1]).max() > 0.1  # the rows differ
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_spectral_api_matches_jax_and_step(attractor):
    """init_carry / step_spectral / step_spectral_only against the JAX pair,
    and against the port's own `step` (same math minus boundary transforms)."""
    y, f = attractor
    js = JaxETDRK4(nx=NX, lx=LX, dt=DT, fft_mode="native")
    ts = KSSolverETDRK4(nx=NX, lx=LX, dt=DT, device="cpu")
    ty, tf = torch.from_numpy(y), torch.from_numpy(f)
    jcarry = js.init_carry(jnp.asarray(y))
    tcarry = ts.init_carry(ty)
    assert tcarry.dtype == torch.complex64 and tcarry.shape == (B, NX // 2 + 1)
    scale = np.abs(np.asarray(jcarry[0])).max()
    np.testing.assert_allclose(tcarry.real.numpy(), np.asarray(jcarry[0]), atol=2e-6 * scale)
    np.testing.assert_allclose(tcarry.imag.numpy(), np.asarray(jcarry[1]), atol=2e-6 * scale)
    f_hat = torch.fft.rfft(tf)
    (jvr, jvi), jy = js.step_spectral(jcarry, jnp.asarray(f_hat.real.numpy()),
                                      jnp.asarray(f_hat.imag.numpy()))
    tv, ty1 = ts.step_spectral(tcarry, f_hat)
    np.testing.assert_allclose(tv.real.numpy(), np.asarray(jvr), atol=1e-5 * scale)
    np.testing.assert_allclose(tv.imag.numpy(), np.asarray(jvi), atol=1e-5 * scale)
    np.testing.assert_allclose(ty1.numpy(), np.asarray(jy), atol=1e-5 * np.abs(np.asarray(jy)).max())
    assert torch.equal(ts.step_spectral_only(tcarry, f_hat), tv)
    assert torch.equal(ts.step(ty, tf), ty1)


def test_etdrk4_matches_cnab2_on_attractor(attractor):
    """tests/test_ks_solver.py:86-114 on the port: one ETDRK4 step against a
    600-substep CNAB2 oracle, err < 5e-4 of max and < 2x the 30-substep
    CNAB2's own error."""
    y, f = (torch.from_numpy(a) for a in attractor)
    oracle = KSSolver(nx=NX, lx=LX, dt=DT, oversampling=600, device="cpu").step(y, f)
    cnab = KSSolver(nx=NX, lx=LX, dt=DT, oversampling=30, device="cpu").step(y, f)
    etd = KSSolverETDRK4(nx=NX, lx=LX, dt=DT, oversampling=1, device="cpu").step(y, f)
    scale = oracle.abs().max().item()
    err_etd = (etd - oracle).abs().max().item() / scale
    err_cnab = (cnab - oracle).abs().max().item() / scale
    assert err_etd < 5e-4, err_etd
    assert err_etd < 2.0 * err_cnab, (err_etd, err_cnab)


def test_etdrk4_with_disturbance_matches_cnab2():
    """mu*cos disturbance parity between the steppers (KSSetup.jl:155),
    tests/test_ks_solver.py:117-131 on the port, at batch 2."""
    nx, lx, dt, mu = 64, 22.0, 0.05, 0.02
    y = torch.zeros((2, nx))
    f = torch.stack([torch.zeros(nx), 0.05 * torch.sin(2 * torch.pi * torch.arange(nx) / nx)])
    a = KSSolver(nx=nx, lx=lx, dt=dt, oversampling=60, mu=mu, device="cpu").step(y, f)
    b = KSSolverETDRK4(nx=nx, lx=lx, dt=dt, oversampling=2, mu=mu, device="cpu").step(y, f)
    assert a.abs().max() > 1e-4
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=2e-4)


def run_both(kw, n_steps, seed=3):
    """Both packages' envs of one tier from the same random ICs under the
    same random actions; yields (step, jax state, port state)."""
    jenv = jks.build_ks(jax_cfg(**kw)).env
    tenv = tks.build_ks(torch_cfg(**kw), device="cpu").env
    y0 = random_y0s(B)
    jst = jax.vmap(jenv.reset)(jnp.asarray(y0))
    tst = tenv.reset(torch.from_numpy(y0))
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(seed)
    yield -1, jst, tst
    for i in range(n_steps):
        a = rng.uniform(-1.0, 1.0, (B, 1, 8)).astype(np.float32)
        jst, tst = jstep(jst, jnp.asarray(a)), tenv.step(tst, torch.from_numpy(a))
        yield i, jst, tst


def check_states(jst, tst, carry: bool, y_atol):
    np.testing.assert_allclose(tst.obs.numpy(), np.asarray(jst.obs), atol=2e-6)
    np.testing.assert_allclose(tst.reward.numpy(), np.asarray(jst.reward), atol=2e-6)
    np.testing.assert_allclose(tst.y.numpy(), np.asarray(jst.y), atol=y_atol)
    np.testing.assert_array_equal(tst.done.numpy(), np.asarray(jst.done))
    np.testing.assert_array_equal(tst.steps.numpy(), np.asarray(jst.steps))
    np.testing.assert_array_equal(tst.time.numpy(), np.asarray(jst.time))
    np.testing.assert_allclose(tst.forcing.numpy(), np.asarray(jst.forcing), rtol=1e-6, atol=1e-6)
    if carry:
        scale = np.abs(np.asarray(jst.carry[0])).max()
        np.testing.assert_allclose(tst.carry.real.numpy(), np.asarray(jst.carry[0]), atol=2e-6 * scale)
        np.testing.assert_allclose(tst.carry.imag.numpy(), np.asarray(jst.carry[1]), atol=2e-6 * scale)
    else:
        assert tst.carry is None and jst.carry is None


@pytest.mark.parametrize("kw,n_steps", [(ETD, 12), (CARRY, 12), (SF, 30)], ids=["etdrk4", "carry", "sf"])
def test_env_tier_matches_jax(kw, n_steps):
    """The etdrk4, carry and sf envs against their JAX twins under forcing:
    obs and reward atol 2e-6 (values of order 0.1), y atol 5e-5 (fields of
    order 5 after chaotic steps), carry 2e-6 of its max. On the sf tier
    `EnvState.y` stays the reset field, on both sides."""
    carry = "spectral_carry" in kw
    y_first = None
    for i, jst, tst in run_both(kw, n_steps):
        if i == -1:
            y_first = tst.y.clone()
        check_states(jst, tst, carry, y_atol=5e-5)
    if "spectral_featurize" in kw:
        assert torch.equal(tst.y, y_first)  # stale by contract
    else:
        assert not torch.equal(tst.y, y_first)
    assert int(tst.steps[0]) == n_steps


def test_carry_and_sf_tiers_advance_the_same_carry():
    """Inside the port: `step_spectral_only` is `step_spectral` minus the
    synthesis, so the two tiers' carries are bit-equal over a forced rollout
    (tests/test_ks_solver.py:311-312), and obs / reward agree to the
    contraction-reordering tolerance there (2e-5)."""
    env_c = tks.build_ks(torch_cfg(**CARRY), device="cpu").env
    env_sf = tks.build_ks(torch_cfg(**SF), device="cpu").env
    y0 = torch.from_numpy(random_y0s(B))
    s_c, s_sf = env_c.reset(y0), env_sf.reset(y0)
    np.testing.assert_allclose(s_sf.obs.numpy(), s_c.obs.numpy(), atol=2e-6)
    rng = np.random.default_rng(3)
    for _ in range(30):
        a = torch.from_numpy(rng.uniform(-1.0, 1.0, (B, 1, 8)).astype(np.float32))
        s_c, s_sf = env_c.step(s_c, a), env_sf.step(s_sf, a)
        assert torch.equal(s_c.carry, s_sf.carry)
        np.testing.assert_allclose(s_sf.obs.numpy(), s_c.obs.numpy(), atol=2e-5)
        np.testing.assert_allclose(s_sf.reward.numpy(), s_c.reward.numpy(), atol=2e-5)
        assert torch.equal(s_sf.done, s_c.done)
    assert torch.equal(s_sf.y, y0)


def test_sf_guard_is_sound_parseval_rms():
    """tests/test_ks_solver.py:322-352 on the port, per env row: (a) the
    guard's Parseval mean square equals the real-space rms, (b) a scaled-up
    carry ends that env's episode and no other's, (c) so does a NaN carry
    (the non-finite guard reads the carry, since y is stale)."""
    env = tks.build_ks(torch_cfg(**SF), device="cpu").env
    y0 = torch.from_numpy(random_y0s(B))
    s = env.reset(y0)
    nxh = NX // 2 + 1
    w = np.full(nxh, 2.0 / NX)
    w[0] = w[-1] = 1.0 / NX
    c = s.carry.numpy()
    rms_spec = np.sqrt((c.real ** 2 + c.imag ** 2) @ w / NX)
    np.testing.assert_allclose(rms_spec, np.sqrt((y0.numpy() ** 2).mean(axis=1)), rtol=1e-5)
    assert not env.carry_guard(s.carry).any()  # ||y0|| = 30 over 192 points: rms 2.2
    assert env.carry_guard(s.carry * 14.0).all() and not env.carry_guard(s.carry * 13.0).any()
    a0 = torch.zeros((B, 1, 8))
    row = torch.tensor([False, True, False])
    for bad in (s.carry * 1e4, s.carry * float("nan")):
        hit = dataclasses.replace(s, carry=torch.where(row[:, None], bad, s.carry))
        assert env.step(hit, a0).done.tolist() == [False, True, False]
    # where_state selects the carry with the rest of the state
    mixed = where_state(row, dataclasses.replace(s, carry=s.carry * 2.0), s)
    assert torch.equal(mixed.carry[1], s.carry[1] * 2.0) and torch.equal(mixed.carry[0], s.carry[0])


def test_build_ks_guards_and_tiers():
    """The ValueError guards of configs/ks.py:212-216 stay; the float32
    ETDRK4 tiers build; the reduced-precision transform tiers build (CNAB2's
    K1 keeps float32), and an unknown transform mode raises."""
    with pytest.raises(ValueError, match="spectral_featurize requires spectral_carry"):
        tks.build_ks(torch_cfg(stepper="etdrk4", spectral_featurize=True), device="cpu")
    with pytest.raises(ValueError, match="spectral_carry requires stepper='etdrk4'"):
        tks.build_ks(torch_cfg(spectral_carry=True), device="cpu")
    with pytest.raises(ValueError, match="unknown stepper"):
        tks.build_ks(torch_cfg(stepper="rk4"), device="cpu")
    assert isinstance(tks.build_ks(torch_cfg(fft_mode="matmul_hi"), device="cpu").env.step_fn.__self__,
                      KSSolver)
    solver = tks.build_ks(torch_cfg(stepper="etdrk4", nl_fft_mode="matmul_fast"),
                          device="cpu").env.step_fn.__self__
    assert (solver.fft_mode, solver.nl_mode) == ("auto", "matmul_fast")
    for kw in ({"fft_mode": "bf16"}, {"stepper": "etdrk4", "nl_fft_mode": "bf16"}):
        with pytest.raises(ValueError, match="unknown fft mode"):
            tks.build_ks(torch_cfg(**kw), device="cpu")
    env = tks.build_ks(torch_cfg(**ETD), device="cpu").env
    assert isinstance(env.step_fn.__self__, KSSolverETDRK4) and env.init_carry is None
    env = tks.build_ks(torch_cfg(**CARRY), device="cpu").env
    assert env.step_carry_fn is not None and env.featurize_carry is None
    env = tks.build_ks(torch_cfg(**SF), device="cpu").env
    assert None not in (env.step_carry_only, env.featurize_carry, env.reward_carry_fn, env.carry_guard)
