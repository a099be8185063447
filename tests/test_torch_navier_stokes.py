"""The port's single-device fluid path against the JAX package on the CPU.

The 3/2-rule re-gridding (`pad_32`, `chop_32` and their half-spectrum
forms), the `ops/fourier.py` call surface, every method of `NSSolver` and the
env of `build_fluid` (each stepper, and the |omega| channel with the
energy term) get the same numpy inputs on both sides. The JAX env is one env
under `jax.vmap`; the port's is the batch itself.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedconvrl_pde_control_tpu.configs import fluid as jfluid
from distributedconvrl_pde_control_tpu.ops import fourier as jfourier
from distributedconvrl_pde_control_tpu.ops import navier_stokes as jns
from distributedconvrl_pde_control_tpu.ops import spectral as jspec
from distributedconvrl_pde_control_torch.configs import fluid as tfluid
from distributedconvrl_pde_control_torch.ops import fourier as tfourier
from distributedconvrl_pde_control_torch.ops import navier_stokes as tns
from distributedconvrl_pde_control_torch.ops import spectral as tspec

# float32 transforms of 32^2..48^2 points on both sides, rounded in another
# order by pocketfft than by XLA: ~1e-7 of the largest value per transform
FFT_RTOL = 1e-5
# the solver's methods: a few transforms and up to 8 RK4 substeps
SOLVER_RTOL = 1e-5
# 5 closed-loop env steps (adaptive: each env's own trials)
ENV_RTOL = 1e-4
N = 32


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _vortex_fields(n_fields, n=N, seed=5):
    rng = np.random.default_rng(seed)
    return np.stack([np.fft.ifft2(jns.initial_condition(4, n, n, 1.0, 1.0, rng)).real
                     for _ in range(n_fields)]).astype(np.float32)


def _close(got, want, rtol, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rtol * scale, f"{what}: max abs err {err:.3e} > {rtol:.0e} of {scale:.3e}"


# --------------------------------------------------------------- re-gridding
@pytest.mark.parametrize("n", [8, 16, 32])
def test_pad_and_chop_match_exactly(n):
    """Non-Hermitian input, so the Nyquist row and column, which go to the
    positive block only, show any misplacement; the port takes a batch."""
    m = 3 * n // 2
    f = _complex((2, n, n), n)
    got = tspec.pad_32(torch.from_numpy(f), m, m).numpy()
    for b in range(2):
        np.testing.assert_array_equal(got[b], np.asarray(jspec.pad_32(jnp.asarray(f[b]), m, m)))
    fp = _complex((2, m, m), n + 1)
    got = tspec.chop_32(torch.from_numpy(fp), n, n).numpy()
    for b in range(2):
        np.testing.assert_array_equal(got[b], np.asarray(jspec.chop_32(jnp.asarray(fp[b]), n, n)))
    # the Nyquist row lands in the positive block, and nowhere else
    pad = tspec.pad_32(torch.from_numpy(f), m, m).numpy()
    np.testing.assert_array_equal(pad[:, n // 2, : n // 2 + 1], f[:, n // 2, : n // 2 + 1])
    assert not pad[:, m - n // 2].any()


@pytest.mark.parametrize("n", [8, 16, 32])
def test_half_pad_and_chop_match_exactly(n):
    m = 3 * n // 2
    f = _complex((2, n, n // 2 + 1), n)
    np.testing.assert_array_equal(tspec.pad_32_half(torch.from_numpy(f), m, m).numpy(),
                                  np.asarray(jspec.pad_32_half(jnp.asarray(f), m, m)))
    fp = _complex((2, m, m // 2 + 1), n + 1)
    np.testing.assert_array_equal(tspec.chop_32_half(torch.from_numpy(fp), n, n).numpy(),
                                  np.asarray(jspec.chop_32_half(jnp.asarray(fp), n, n)))


# ------------------------------------------------------------ fourier surface
def test_fourier_call_surface_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 24, 24)).astype(np.float32)
    z = _complex((3, 24, 24), 1)
    h = _complex((3, 24, 13), 2)
    tx, tz, th = (torch.from_numpy(a) for a in (x, z, h))
    jx, jz, jh = (jnp.asarray(a) for a in (x, z, h))
    pairs = [
        (tfourier.fft(tz), jfourier.fft(jz)), (tfourier.ifft(tz), jfourier.ifft(jz)),
        (tfourier.rfft(tx), jfourier.rfft(jx)), (tfourier.irfft(th, 24), jfourier.irfft(jh, 24)),
        (tfourier.fft2(tz), jfourier.fft2(jz)), (tfourier.ifft2(tz), jfourier.ifft2(jz)),
        (tfourier.irfft_ri(th.real, th.imag, 24), jfourier.irfft_ri(jh.real, jh.imag, 24)),
        (tfourier.ifft2_ri_real(tz.real, tz.imag), jfourier.ifft2_ri_real(jz.real, jz.imag)),
        (tfourier.irfft2_ri_real(th.real, th.imag, 24),
         jfourier.irfft2_ri_real(jh.real, jh.imag, 24)),
    ]
    for got, want in (
        (tfourier.rfft_ri(tx), jfourier.rfft_ri(jx)),
        (tfourier.fft2_ri(tx), jfourier.fft2_ri(jx)),
        (tfourier.fft2_ri(tz.real, tz.imag), jfourier.fft2_ri(jz.real, jz.imag)),
        (tfourier.ifft2_ri(tz.real, tz.imag), jfourier.ifft2_ri(jz.real, jz.imag)),
        (tfourier.rfft2_ri(tx), jfourier.rfft2_ri(jx)),
    ):
        pairs += list(zip(got, want))
    for i, (got, want) in enumerate(pairs):
        want = np.asarray(want)
        got = got.numpy()
        if np.iscomplexobj(want):
            got, want = np.stack([got.real, got.imag]), np.stack([want.real, want.imag])
        _close(got, want, FFT_RTOL, f"transform {i}")


def test_fourier_matmul_modes_name_their_queue():
    """The matmul tiers run (their queue item is done): the 2D transform at
    matmul agrees with torch.fft; an unknown mode raises in the transform and
    in the solver."""
    x = torch.tensor(np.random.default_rng(0).standard_normal((4, 8)), dtype=torch.float32)
    _close(tfourier.fft2(x, mode="matmul").numpy(), torch.fft.fft2(x).numpy(), FFT_RTOL)
    tns.NSSolver(8, 8, fft_mode="matmul_hi", nl_fft_mode="matmul_fast", device="cpu")
    with pytest.raises(ValueError, match="unknown fft mode"):
        tfourier.fft2(torch.zeros(4, 4), mode="bf16")
    with pytest.raises(ValueError, match="unknown fft mode"):
        tns.NSSolver(8, 8, fft_mode="bf16", device="cpu")


# ------------------------------------------------------------------ NSSolver
@pytest.fixture(scope="module")
def solvers():
    return {half: (jns.NSSolver(N, N, nu=1e-3, half_spectrum=half),
                   tns.NSSolver(N, N, nu=1e-3, half_spectrum=half, device="cpu"))
            for half in (False, True)}


@pytest.fixture(scope="module")
def fields():
    w = _vortex_fields(2)
    f = 0.3 * _vortex_fields(2, seed=9)
    return w, f


def test_solver_tables_match(solvers):
    js, ts = solvers[False]
    for name in ("kx_row", "ky_col", "k2", "inv_k2"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))


@pytest.mark.parametrize("method", ["advection", "rhs", "step", "step_if", "omg2vel"])
def test_complex_methods_match(solvers, fields, method):
    js, ts = solvers[False]
    w = np.fft.fft2(fields[0]).astype(np.complex64)
    fh = np.fft.fft2(fields[1]).astype(np.complex64)
    tw, tf = torch.from_numpy(w), torch.from_numpy(fh)
    for b in range(2):
        jw, jf = jnp.asarray(w[b]), jnp.asarray(fh[b])
        if method == "advection":
            got, want = ts.advection(tw)[b], js.advection(jw)
        elif method == "rhs":
            got, want = ts.rhs(tw, tf)[b], js.rhs(jw, jf)
        elif method == "step":
            got, want = ts.step(tw, tf, 0.02, 4)[b], js.step(jw, jf, 0.02, 4)
        elif method == "step_if":
            got, want = ts.step_if(tw, tf, 0.02, 2)[b], js.step_if(jw, jf, 0.02, 2)
        else:
            for g, wnt in zip(ts.omg2vel(tw), js.omg2vel(jw)):
                _close(g[b], wnt, SOLVER_RTOL, method)
            continue
        _close(torch.view_as_real(got), np.stack([np.real(want), np.imag(want)], -1),
               SOLVER_RTOL, method)


@pytest.mark.parametrize("half", [False, True])
def test_ri_methods_match(solvers, fields, half):
    js, ts = solvers[half]
    y, f = fields
    w = np.fft.rfft2(y) if half else np.fft.fft2(y)
    wr, wi = w.real.astype(np.float32), w.imag.astype(np.float32)
    t_adv = ts._advection_ri(torch.from_numpy(wr), torch.from_numpy(wi))
    t_rhs = ts._rhs_ri(*(torch.from_numpy(a) for a in (wr, wi, 0.5 * wr, 0.5 * wi)))
    for b in range(2):  # the JAX package's full-spectrum pad takes one field
        j_adv = js._advection_ri(jnp.asarray(wr[b]), jnp.asarray(wi[b]))
        j_rhs = js._rhs_ri(*(jnp.asarray(a[b]) for a in (wr, wi, 0.5 * wr, 0.5 * wi)))
        for g, wnt in zip(t_adv, j_adv):
            _close(g[b], wnt, SOLVER_RTOL, "advection_ri")
        for g, wnt in zip(t_rhs, j_rhs):
            _close(g[b], wnt, SOLVER_RTOL, "rhs_ri")
    for name, os_ in (("step_real", 4), ("step_real_if", 2)):
        got = getattr(ts, name)(torch.from_numpy(y), torch.from_numpy(f), 0.02, os_)
        for b in range(2):
            want = getattr(js, name)(jnp.asarray(y[b]), jnp.asarray(f[b]), 0.02, os_)
            _close(got[b], want, SOLVER_RTOL, name)


# ---------------------------------------------------------------- build_fluid
VARIANTS = {
    "adaptive": dict(adaptive=True),
    "rk4": dict(adaptive=False, stepper="rk4"),
    "ifrk4": dict(adaptive=False, stepper="ifrk4"),
    "abs_energy": dict(adaptive=True, abs_sensor_channel=True, energy_reward_weight=0.05),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_build_fluid_env_matches(variant):
    """5 env steps of 2 envs from different fields under shared actions."""
    over = dict(nx=N, sensors_per_axis=4, **VARIANTS[variant])
    jsetup = jfluid.build_fluid(dataclasses.replace(jfluid.FLUID_8, **over))
    tsetup = tfluid.build_fluid(dataclasses.replace(tfluid.FLUID_8, **over), device="cpu")
    je, te = jsetup.env, tsetup.env
    np.testing.assert_array_equal(te.y0.numpy(), np.asarray(je.y0))
    y0 = _vortex_fields(2, seed=11)
    rng = np.random.default_rng(3)
    actions = rng.uniform(-1, 1, (5, 2) + tuple(je.action_shape)).astype(np.float32)
    js = jax.vmap(je.reset)(jnp.asarray(y0))
    ts = te.reset(torch.from_numpy(y0))
    _close(ts.obs, js.obs, ENV_RTOL, "reset obs")
    jstep = jax.jit(jax.vmap(je.step))
    for i in range(5):
        js = jstep(js, jnp.asarray(actions[i]))
        ts = te.step(ts, torch.from_numpy(actions[i]))
        for name in ("y", "obs", "reward", "forcing"):
            _close(getattr(ts, name), getattr(js, name), ENV_RTOL, f"{variant} {name} step {i}")
        np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
    if variant == "adaptive":
        trials = te.step_fn.last_trials
        assert trials.shape == (2,) and (trials >= 1).all()


def test_build_fluid_setup_matches():
    cfg = dict(nx=N, sensors_per_axis=4)
    jsetup = jfluid.build_fluid(dataclasses.replace(jfluid.FLUID_16, **cfg))
    tsetup = tfluid.build_fluid(dataclasses.replace(tfluid.FLUID_16, **cfg), device="cpu")
    assert tsetup.agent.cfg.__dict__ == {k: v for k, v in jsetup.agent.cfg.__dict__.items()
                                        if k in tsetup.agent.cfg.__dict__}
    for k in ("name", "seed", "loops", "no_steps", "noise_decay", "min_best_episode", "record",
              "reward_clamp"):
        assert getattr(tsetup, k) == getattr(jsetup, k), k
    assert tsetup.error_detection is tfluid.fluid_error_detection
    assert tsetup.env.max_steps == jsetup.env.max_steps == 300
    # random_init: the JAX package's field for the seed its key draws
    key = jax.random.PRNGKey(4)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    np.testing.assert_allclose(tfluid.fluid_random_field(dataclasses.replace(
        tfluid.FLUID_16, **cfg), seed), np.asarray(jsetup.random_init(key)), rtol=0, atol=1e-6)
    fields = tsetup.random_init(torch.Generator().manual_seed(0), 3)
    assert fields.shape == (3, N, N) and fields.dtype == torch.float32
