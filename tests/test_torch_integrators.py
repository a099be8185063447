"""The port's integrators (`ops/integrators.py`) against the JAX package.

Every JAX integrator steps one state; the port's step a batch whose leading
axis holds the envs. Each env of the port's batch is held to JAX's result for
that env alone, and `rk4_adaptive` also to JAX's `vmap` over the batch, whose
vmapped `while_loop` gives every env its own t, h and trial count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedconvrl_pde_control_tpu.ops import integrators as jint
from distributedconvrl_pde_control_tpu.ops import navier_stokes as jns
from distributedconvrl_pde_control_torch.ops import integrators as tint
from distributedconvrl_pde_control_torch.ops import navier_stokes as tns

# float32 on both sides; the fixed-step schemes are a few dozen elementwise
# operations per step, the adaptive one up to ~10 trials of 12 right-hand
# sides of 32^2 transforms
RTOL = 1e-5
N = 32


def _close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, f"{what}: max abs err {err:.3e} > {rtol:.0e} of {scale:.3e}"


def _cubic_j(y, forcing):
    return -y**3 + jnp.roll(y, 1) - y + forcing


def _cubic_t(y, forcing):
    return -y**3 + torch.roll(y, 1, dims=-1) - y + forcing


@pytest.fixture(scope="module")
def small_states():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((2, 6)).astype(np.float32),
            (0.3 * rng.standard_normal((2, 6))).astype(np.float32))


@pytest.mark.parametrize("name,args", [("midpoint_oversampled", (0.1, 5)),
                                       ("rk4_oversampled", (0.1, 5)),
                                       ("implicit_trapezoid", (0.2, 3))])
def test_fixed_step_integrators_match(small_states, name, args):
    y, f = small_states
    got = getattr(tint, name)(_cubic_t, torch.from_numpy(y), torch.from_numpy(f), *args)
    for b in range(2):
        want = getattr(jint, name)(_cubic_j, jnp.asarray(y[b]), jnp.asarray(f[b]), *args)
        _close(got[b].numpy(), want, what=f"{name} env {b}")


def test_rk4_adaptive_matches_on_a_small_system(small_states):
    y, f = small_states
    info = {}
    got = tint.rk4_adaptive(_cubic_t, torch.from_numpy(y), torch.from_numpy(f), 0.5, rtol=1e-4,
                            atol=1e-4, info=info)
    for b in range(2):
        want = jint.rk4_adaptive(_cubic_j, jnp.asarray(y[b]), jnp.asarray(f[b]), 0.5, rtol=1e-4,
                                 atol=1e-4)
        _close(got[b].numpy(), want, what=f"env {b}")
    assert (info["trials"] > 1).all()


def test_rk4_adaptive_on_fluid_fields_is_per_env():
    """Two different fluid fields at 32^2 under do_step2's settings (tol 1,
    at most 256 trials): the second is 4x stronger, so it needs more trials
    than the first, and each env of the port's batch equals JAX's result for
    it alone and under `vmap`."""
    rng = np.random.default_rng(7)
    fields = np.stack([np.fft.ifft2(jns.initial_condition(4, N, N, 1.0, 1.0, rng)).real * amp
                       for amp in (1.0, 4.0)]).astype(np.float32)
    forcing = (0.5 * rng.standard_normal((2, N, N))).astype(np.float32)
    js = jns.NSSolver(N, N)
    ts = tns.NSSolver(N, N, device="cpu")

    def jax_env(y, frc):
        fr, fi = jnp.real(jnp.fft.fft2(frc)), jnp.imag(jnp.fft.fft2(frc))
        w = jnp.fft.fft2(y)

        def rhs(z, _):
            return jnp.stack(js._rhs_ri(z[0], z[1], fr, fi))

        return jint.rk4_adaptive(rhs, jnp.stack([jnp.real(w), jnp.imag(w)]), None, 0.02,
                                 rtol=1.0, atol=1.0, max_steps=256)

    alone = [np.asarray(jax.jit(jax_env)(jnp.asarray(fields[b]), jnp.asarray(forcing[b])))
             for b in range(2)]
    vmapped = np.asarray(jax.jit(jax.vmap(jax_env))(jnp.asarray(fields), jnp.asarray(forcing)))
    info = {}
    got = tint.rk4_adaptive(lambda z, f_: ts.rhs_real_layout(z, f_),
                            torch.fft.fft2(torch.from_numpy(fields)),
                            torch.fft.fft2(torch.from_numpy(forcing)), 0.02, rtol=1.0, atol=1.0,
                            max_steps=256, info=info)
    got = torch.view_as_real(got).permute(0, 3, 1, 2).numpy()
    for b in range(2):
        _close(got[b], alone[b], what=f"env {b} against JAX alone")
        _close(got[b], vmapped[b], what=f"env {b} against JAX's vmap")
    trials = info["trials"]
    assert trials[1] > trials[0] >= 1, trials
    # one env stepped with the other's sequence would differ: the envs are not coupled
    single = tint.rk4_adaptive(lambda z, f_: ts.rhs_real_layout(z, f_),
                               torch.fft.fft2(torch.from_numpy(fields[:1])),
                               torch.fft.fft2(torch.from_numpy(forcing[:1])), 0.02, rtol=1.0,
                               atol=1.0, max_steps=256)
    assert torch.equal(torch.view_as_real(single)[0].permute(2, 0, 1), torch.from_numpy(got[0]))


def test_rk4_adaptive_freezes_envs_at_max_steps():
    """An env that runs out of trials keeps the state of its last accepted
    trial, while the other runs to dt."""
    y = torch.tensor([[0.1], [30.0]])
    info = {}
    out = tint.rk4_adaptive(lambda z, f: -z**3, y, None, 1.0, rtol=1e-9, atol=1e-9,
                            max_steps=12, info=info)
    assert info["trials"].tolist()[1] == 12
    want = jint.rk4_adaptive(lambda z, f: -z**3, jnp.asarray([30.0]), None, 1.0, rtol=1e-9,
                             atol=1e-9, max_steps=12)
    _close(out[1].numpy(), want)
