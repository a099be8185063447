"""The reduced-precision transform tiers of the port (`ops/fourier.py`) and
the `_tp` presets, against the JAX package on the CPU and against an
independent float64 emulation of the TPU's bf16 passes.

XLA on the CPU ignores a matmul's precision, so the JAX package computes
every tier in float32 here: it is the reference for the function (within
the tier's own error), and the numpy emulation below, which rounds to bf16
with integer arithmetic on the float32 bits, is the reference for the
rounding. Inputs are drawn once with numpy and passed to both packages.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedconvrl_pde_control_tpu.experiments import run as jrun
from distributedconvrl_pde_control_tpu.ops import fourier as jf
from distributedconvrl_pde_control_tpu.ops import keller_segel as jkss
from distributedconvrl_pde_control_tpu.ops import navier_stokes as jns
from distributedconvrl_pde_control_tpu.ops.ks import KSSolverETDRK4 as JaxETDRK4
from distributedconvrl_pde_control_tpu.parallel import ns_sharded as jsh
from distributedconvrl_pde_control_torch.configs import fluid as tfluid
from distributedconvrl_pde_control_torch.configs import ks as tks
from distributedconvrl_pde_control_torch.experiments import run as trun
from distributedconvrl_pde_control_torch.models.mlp import chain_to_numpy
from distributedconvrl_pde_control_torch.ops import fourier as tf
from distributedconvrl_pde_control_torch.ops import keller_segel as tkss
from distributedconvrl_pde_control_torch.ops import navier_stokes as tns
from distributedconvrl_pde_control_torch.ops.ks import KSSolverETDRK4
from distributedconvrl_pde_control_torch.parallel import ns_sharded as tsh
from distributedconvrl_pde_control_torch.train import checkpoint
from distributedconvrl_pde_control_torch.train.eval import actor_policy
from jax import shard_map
from jax.sharding import PartitionSpec as P

from test_torch_fluid import _one_device_mesh, _solver_inputs
from test_torch_train import jax_chunk, torch_chunk

# the tier's own error against float32 (relative L2), the tolerance against JAX's float32
# result: PERFORMANCE.md's ladder and this file's calibration give ~5e-6 (hi) and ~3e-3
# (fast) for one transform; the limits leave 4x
JAX_RTOL = {"matmul": 1e-5, "matmul_hi": 3e-5, "matmul_fast": 1.2e-2}
EMU_RTOL = 1e-6  # against the float64 emulation: float32 sums in another order


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.complex128), np.asarray(want, np.complex128)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# -------------------------------------------------- the float64 emulation
def bf16(a):
    """float32 -> nearest bfloat16 (ties to even), as float32, on the bits."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32).view(np.float32)


def tier_mm(x, m, mode):
    """x @ m of float32 operands as the TPU's passes form it, summed in float64."""
    x, m = np.asarray(x, np.float32), np.asarray(m, np.float32)
    if mode == "matmul":
        return x.astype(np.float64) @ m
    xh, mh = bf16(x), bf16(m)
    out = xh.astype(np.float64) @ mh
    if mode == "matmul_hi":
        out += xh.astype(np.float64) @ bf16(m - mh) + bf16(x - xh).astype(np.float64) @ mh
    return out


def emu_rfft(y, mode):
    c, s = jf._rdft_mats_np(y.shape[-1])
    return tier_mm(y, c, mode) - 1j * tier_mm(y, s, mode)


def emu_irfft(h, n, mode):
    ci, si = jf._irdft_mats_np(n)
    h = np.asarray(h, np.complex64)
    return tier_mm(h.real, ci, mode) - tier_mm(h.imag, si, mode)


def emu_fft(x, axis, sign, mode):
    """The complex DFT along `axis` as JAX's `_cmatmul_right` forms it."""
    x = np.moveaxis(np.asarray(x, np.complex64), axis, -1)
    n = x.shape[-1]
    c, s = jf._dft_mats_np(n)
    zr = tier_mm(x.real, c, mode) - sign * tier_mm(x.imag, s, mode)
    zi = tier_mm(x.imag, c, mode) + sign * tier_mm(x.real, s, mode)
    z = (zr + 1j * zi) / (n if sign > 0 else 1)
    return np.moveaxis(z, -1, axis)


# ------------------------------------------------------------ the surface
RNG = np.random.default_rng(40)
REAL = RNG.standard_normal((3, 24, 48)).astype(np.float32)
CPLX = (RNG.standard_normal((3, 24, 40)) + 1j * RNG.standard_normal((3, 24, 40))).astype(np.complex64)
HALF = np.fft.rfft(REAL).astype(np.complex64)  # (3, 24, 25): the half spectrum of a real field
HALF2 = np.fft.rfft2(REAL).astype(np.complex64)


def _c(z):
    return torch.complex(torch.from_numpy(np.ascontiguousarray(z.real)),
                         torch.from_numpy(np.ascontiguousarray(z.imag)))


def _jc(z):
    return jax.lax.complex(jnp.asarray(z.real), jnp.asarray(z.imag))


# name -> (port call, JAX call, emulation), each of mode; a complex result is compared as
# complex, a pair (re, im) as re + i im. The 2D emulations take the port's first pass as
# their input: the bf16 split is discontinuous, so an intermediate one float32 ulp apart
# (another summation order) moves the next pass by up to 2^-16 of a term, and the TPU's
# own order is a third one (rel ~1.3e-6 when the chain starts from float64)
SURFACE = {
    "rfft": (lambda m: tf.rfft(torch.from_numpy(REAL), mode=m),
             lambda m: jf.rfft(jnp.asarray(REAL), mode=m),
             lambda m: emu_rfft(REAL, m)),
    "irfft": (lambda m: tf.irfft(_c(HALF), 48, mode=m),
              lambda m: jf.irfft(_jc(HALF), 48, mode=m),
              lambda m: emu_irfft(HALF, 48, m)),
    "fft": (lambda m: tf.fft(_c(CPLX), mode=m),
            lambda m: jf.fft(_jc(CPLX), mode=m),
            lambda m: emu_fft(CPLX, -1, -1.0, m)),
    "fft axis -2": (lambda m: tf.fft(_c(CPLX), axis=-2, mode=m),
                    lambda m: jf.fft(_jc(CPLX), axis=-2, mode=m),
                    lambda m: emu_fft(CPLX, -2, -1.0, m)),
    "ifft": (lambda m: tf.ifft(_c(CPLX), mode=m),
             lambda m: jf.ifft(_jc(CPLX), mode=m),
             lambda m: emu_fft(CPLX, -1, 1.0, m)),
    "ifft axis 0": (lambda m: tf.ifft(_c(CPLX), axis=0, mode=m),
                    lambda m: jf.ifft(_jc(CPLX), axis=0, mode=m),
                    lambda m: emu_fft(CPLX, 0, 1.0, m)),
    "fft2": (lambda m: tf.fft2(_c(CPLX), mode=m),
             lambda m: jf.fft2(_jc(CPLX), mode=m),
             lambda m: emu_fft(tf.fft(_c(CPLX), mode=m).numpy(), -2, -1.0, m)),
    "fft2 of a real field": (lambda m: tf.fft2(torch.from_numpy(REAL), mode=m),
                             lambda m: jf.fft2(jnp.asarray(REAL), mode=m),
                             lambda m: emu_fft(tf.fft(torch.from_numpy(REAL), mode=m).numpy(), -2,
                                               -1.0, m)),
    "ifft2": (lambda m: tf.ifft2(_c(CPLX), mode=m),
              lambda m: jf.ifft2(_jc(CPLX), mode=m),
              lambda m: emu_fft(tf.ifft(_c(CPLX), mode=m).numpy(), -2, 1.0, m)),
    "rfft_ri": (lambda m: tf.rfft_ri(torch.from_numpy(REAL), mode=m),
                lambda m: jf.rfft_ri(jnp.asarray(REAL), mode=m),
                lambda m: emu_rfft(REAL, m)),
    "irfft_ri": (lambda m: tf.irfft_ri(torch.from_numpy(HALF.real), torch.from_numpy(HALF.imag),
                                       48, mode=m),
                 lambda m: jf.irfft_ri(jnp.asarray(HALF.real), jnp.asarray(HALF.imag), 48, mode=m),
                 lambda m: emu_irfft(HALF, 48, m)),
    "_fft_ri_axis": (lambda m: tf._fft_ri_axis(torch.from_numpy(CPLX.real), torch.from_numpy(CPLX.imag),
                                               -2, -1.0, m),
                     lambda m: jf._fft_ri_axis(jnp.asarray(CPLX.real), jnp.asarray(CPLX.imag), -2,
                                               -1.0, m),
                     lambda m: emu_fft(CPLX, -2, -1.0, m)),
    "fft2_ri": (lambda m: tf.fft2_ri(torch.from_numpy(REAL), None, mode=m),
                lambda m: jf.fft2_ri(jnp.asarray(REAL), None, mode=m),
                lambda m: emu_fft(tf.fft(torch.from_numpy(REAL), mode=m).numpy(), -2, -1.0, m)),
    "ifft2_ri": (lambda m: tf.ifft2_ri(torch.from_numpy(CPLX.real), torch.from_numpy(CPLX.imag),
                                       mode=m),
                 lambda m: jf.ifft2_ri(jnp.asarray(CPLX.real), jnp.asarray(CPLX.imag), mode=m),
                 lambda m: emu_fft(tf.ifft(_c(CPLX), mode=m).numpy(), -2, 1.0, m)),
    "ifft2_ri_real": (lambda m: tf.ifft2_ri_real(torch.from_numpy(CPLX.real),
                                                 torch.from_numpy(CPLX.imag), mode=m),
                      lambda m: jf.ifft2_ri_real(jnp.asarray(CPLX.real), jnp.asarray(CPLX.imag),
                                                 mode=m),
                      lambda m: emu_fft(tf.ifft(_c(CPLX), mode=m).numpy(), -2, 1.0, m).real),
    "rfft2_ri": (lambda m: tf.rfft2_ri(torch.from_numpy(REAL), mode=m),
                 lambda m: jf.rfft2_ri(jnp.asarray(REAL), mode=m),
                 lambda m: emu_fft(tf.rfft(torch.from_numpy(REAL), mode=m).numpy(), -2, -1.0, m)),
    "irfft2_ri_real": (lambda m: tf.irfft2_ri_real(torch.from_numpy(HALF2.real),
                                                   torch.from_numpy(HALF2.imag), 48, mode=m),
                       lambda m: jf.irfft2_ri_real(jnp.asarray(HALF2.real),
                                                   jnp.asarray(HALF2.imag), 48, mode=m),
                       lambda m: emu_irfft(tf.ifft(_c(HALF2), axis=-2, mode=m).numpy(), 48, m)),
}


def _value(out):
    if isinstance(out, tuple):
        re, im = (np.asarray(t) for t in out)
        return re + 1j * im
    return np.asarray(out)


@pytest.mark.parametrize("mode", tf.TIERS)
@pytest.mark.parametrize("name", list(SURFACE))
def test_tier_transform_matches_jax(name, mode):
    """Each function at each tier against JAX's (float32 on the CPU): matmul
    within rel 1e-5, the bf16 tiers within their own error (`JAX_RTOL`)."""
    port, jax_fn, _ = SURFACE[name]
    assert _rel(_value(port(mode)), _value(jax_fn(mode))) <= JAX_RTOL[mode]


@pytest.mark.parametrize("mode", tf.TIERS)
@pytest.mark.parametrize("name", list(SURFACE))
def test_tier_transform_matches_the_float64_emulation(name, mode):
    """Each function at each tier against the float64 emulation of the TPU's
    passes: rel 1e-6 (the float32 sums' order)."""
    port, _, emulation = SURFACE[name]
    assert _rel(_value(port(mode)), emulation(mode)) <= EMU_RTOL


def test_matmul_fast_really_rounds():
    """matmul_fast differs from float32 by more than 3e-4 (rel L2), matmul_hi
    by more than float32's own 1e-6 and less than 3e-5: the rounding happens."""
    y = torch.from_numpy(REAL)
    exact = torch.fft.rfft(y.double())
    errs = {m: _rel(tf.rfft(y, mode=m).numpy(), exact.numpy()) for m in tf.TIERS}
    assert errs["matmul"] < 1e-6 < errs["matmul_hi"] < 3e-5 and errs["matmul_fast"] > 3e-4
    assert _rel(tf.fft2(_c(CPLX), mode="matmul_fast").numpy(), np.fft.fft2(CPLX)) > 3e-4


def test_tier_calls_leave_the_tf32_flags_unchanged():
    """No tier call changes cuBLAS's float32 precision; the switch the card
    uses sets TF32 (or IEEE) inside its block and restores the flag."""
    m = torch.backends.cuda.matmul

    def flags():
        return m.fp32_precision, torch.get_float32_matmul_precision()

    before = flags()
    for port, _, _ in SURFACE.values():
        for mode in tf.TIERS:
            port(mode)
    assert flags() == before
    for tf32, want in ((True, "tf32"), (False, "ieee")):
        with tf._cublas_fp32(tf32):
            assert m.fp32_precision == want
        assert flags() == before


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown fft mode"):
        tf.rfft(torch.zeros(8), mode="bf16")
    with pytest.raises(ValueError, match="unknown fft mode"):
        KSSolverETDRK4(nx=16, lx=22.0, dt=0.1, nl_fft_mode="hi", device="cpu")


# ---------------------------------------------------------------- KS tiers
@pytest.fixture(scope="module")
def ks_states():
    """16 KS22 fields after 100 float32 ETDRK4 steps from random sines, and a
    forcing of random actions."""
    setup = tks.build_ks(tks.KS22, device="cpu")
    y = setup.random_init(torch.Generator().manual_seed(41), 16)
    solver = KSSolverETDRK4(nx=192, lx=22.0, dt=0.1, device="cpu")
    for _ in range(100):
        y = solver.step(y, torch.zeros_like(y))
    a = torch.tensor(np.random.default_rng(42).uniform(-1, 1, (16, 1, 8)), dtype=torch.float32)
    return y, setup.env.prepare_action(a)


@pytest.mark.parametrize("fft_mode,nl_mode,rtol", [
    ("matmul", None, 1e-5), ("matmul_hi", None, 3e-5), ("matmul_hi", "matmul_fast", 1e-3)])
def test_ks_etdrk4_tier_step_matches_jax(ks_states, fft_mode, nl_mode, rtol):
    """One env step and one spectral-carry step of KS22 ETDRK4 at the tier
    against JAX at the same config (float32 on the CPU): within the tier's
    error per step (hi + nl fast: 1.7e-4 here, 1.8e-4 on the TPU's ladder)."""
    y, f = ks_states
    port = KSSolverETDRK4(nx=192, lx=22.0, dt=0.1, fft_mode=fft_mode, nl_fft_mode=nl_mode,
                          device="cpu")
    jax_solver = JaxETDRK4(nx=192, lx=22.0, dt=0.1, fft_mode=fft_mode, nl_fft_mode=nl_mode)
    want = np.asarray(jax_solver.step(jnp.asarray(y.numpy()), jnp.asarray(f.numpy())))
    assert _rel(port.step(y, f).numpy(), want) <= rtol
    carry, y1 = port.step_spectral(port.init_carry(y), tf.rfft(f, mode="matmul"))
    jcarry, jy1 = jax_solver.step_spectral(jax_solver.init_carry(jnp.asarray(y.numpy())),
                                           *jf.rfft_ri(jnp.asarray(f.numpy()), mode="matmul"))
    assert _rel(y1.numpy(), jy1) <= rtol
    assert _rel(carry.numpy(), _value(jcarry)) <= rtol
    if fft_mode != "matmul":  # the tier moved the step off float32
        f32 = KSSolverETDRK4(nx=192, lx=22.0, dt=0.1, device="cpu").step(y, f)
        assert _rel(port.step(y, f).numpy(), f32.numpy()) > 1e-6


@pytest.mark.parametrize("case", ["tp-matmul", "tp"])
def test_ks22_tp_train_chunk_matches_jax(case):
    """60 train steps of KS22_tp at 4 envs (learning from step 3, every env
    finishing at step 50) on JAX's initial state and draws (JAX computes in
    float32 here), the same finishes in both. With the preset's tiers set to
    matmul the chunk matches as the float32 tiers do (sums atol 1e-4,
    networks atol 1e-4); at the preset's own tiers the per-step error
    (~1.7e-4 of the field) moves rewards and episode sums by up to 2e-3 of
    their size, and 58 learner steps amplify it in the networks to up to
    5e-2 of each tensor's largest value (3.6e-2 seen, in one critic bias)."""
    _, _, _, jts1, jpacked = jax_chunk(case)
    trainer, tts, tpacked = torch_chunk(case)
    solver = trainer.env.step_fn.__self__
    assert isinstance(solver, KSSolverETDRK4) and trainer.env.init_carry is not None
    assert solver.nl_mode == ("matmul_fast" if case == "tp" else "matmul")
    got = tpacked.numpy()
    np.testing.assert_array_equal(got[:2], jpacked[:2])
    assert got[0].sum() == 4 and got[0, 49].all()
    tight = case == "tp-matmul"
    for row in (2, 4):
        np.testing.assert_allclose(got[row], jpacked[row], rtol=0 if tight else 2e-3,
                                   atol=1e-4 if tight else 1e-5)
    for name in ("actor", "critic", "target_actor", "target_critic"):
        for g, w in zip(chain_to_numpy(getattr(tts.agent, name)), getattr(jts1.agent, name)):
            for k in ("w", "b"):
                atol = 1e-4 if tight else 5e-2 * np.abs(w[k]).max()
                np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=0)
    assert tts.agent.update_step == int(jts1.agent.update_step) == 60
    assert int(tts.ep_count) == int(jts1.ep_count) == 4


# ------------------------------------------------------------- fluid tiers
@pytest.mark.parametrize("half", [False, True], ids=["full", "half"])
@pytest.mark.parametrize("method", ["step_real", "step_real_if"])
def test_ns_solver_tier_step_matches_jax(method, half):
    """NSSolver (3/2 padding) at the _tp tiers, 32^2, 2 substeps: against
    JAX's at the same tiers (float32 on the CPU) within 2e-3 of the field's
    scale (the advection's 1-pass error enters scaled by dt)."""
    n, nu, dt = 32, 5e-4, 0.01
    omg, forcing = _solver_inputs(n)
    kw = dict(nx=n, ny=n, nu=nu, fft_mode="matmul_hi", nl_fft_mode="matmul_fast",
              half_spectrum=half)
    port = getattr(tns.NSSolver(**kw, device="cpu"), method)(
        torch.from_numpy(omg), torch.from_numpy(forcing), dt, 2).numpy()
    jsolver = jns.NSSolver(**kw)  # its full-spectrum padding takes one field at a time
    want = np.stack([np.asarray(getattr(jsolver, method)(jnp.asarray(o), jnp.asarray(f), dt, 2))
                     for o, f in zip(omg, forcing)])
    f32 = getattr(tns.NSSolver(nx=n, ny=n, nu=nu, half_spectrum=half, device="cpu"), method)(
        torch.from_numpy(omg), torch.from_numpy(forcing), dt, 2).numpy()
    scale = np.abs(want).max()
    assert np.abs(port - want).max() <= 2e-3 * scale
    assert np.abs(port - f32).max() > 1e-6 * scale  # the tier rounded


@pytest.mark.parametrize("method", ["step_real", "step_real_if"])
def test_ns_sharded_solver_tier_step_matches_jax(method):
    """The 2/3-rule solver at the _tp tiers, 32^2: the boundary transforms
    round at matmul_hi and the advection (K2's plain twin here) stays
    float32, against JAX's sharded solver at the same tiers (float32 on the
    CPU) within 1e-4 of the field's scale."""
    n, nu, dt = 32, 5e-4, 0.01
    omg, forcing = _solver_inputs(n)
    jops = jsh.make_sharded_ops(n, n)
    jsolver = jsh.NSShardedSolverRI(nu=nu, sp_axis="sp", fft_mode="matmul_hi",
                                    nl_fft_mode="matmul_fast")
    step = shard_map(
        lambda wb, fb, ob: getattr(jsolver, method)(wb, fb, ob, dt, 2),
        mesh=_one_device_mesh(("sp",)),
        in_specs=(P(None, "sp", None), P(None, "sp", None), jax.tree.map(lambda _: P(None, "sp"), jops)),
        out_specs=P(None, "sp", None), check_vma=False)
    want = np.asarray(jax.jit(step)(jnp.asarray(omg), jnp.asarray(forcing), jops))
    tops = tsh.make_sharded_ops(n, n, device="cpu")
    got = getattr(tsh.NSShardedSolverRI(nu=nu, fft_mode="matmul_hi", nl_fft_mode="matmul_fast"),
                  method)(torch.from_numpy(omg), torch.from_numpy(forcing), tops, dt, 2).numpy()
    f32 = getattr(tsh.NSShardedSolverRI(nu=nu), method)(
        torch.from_numpy(omg), torch.from_numpy(forcing), tops, dt, 2).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-4 * scale
    assert np.abs(got - f32).max() > 1e-7 * scale


def test_keller_segel_legacy_at_a_tier_matches_jax():
    """The legacy spectral Keller-Segel stepper reaches the tiers through
    ops/fourier.py: against JAX's at the same mode (float32 on the CPU),
    matmul within 1e-5; matmul_hi within 1e-3, since the legacy operators'
    growth (the reference's "wrong" scheme) amplifies the transforms' 5e-6
    ~60x over 5 substeps (measured 3.1e-4)."""
    rng = np.random.default_rng(43)
    y = (1.0 + 0.01 * rng.standard_normal((2, 2, 100))).astype(np.float32)
    f = (0.1 * rng.standard_normal((2, 100))).astype(np.float32)
    for mode, rtol in (("matmul", 1e-5), ("matmul_hi", 1e-3)):
        js = jkss.KellerSegelSpectralLegacy(100, 10.0, fft_mode=mode)
        ts = tkss.KellerSegelSpectralLegacy(100, 10.0, fft_mode=mode)
        got = ts.step(torch.from_numpy(y), torch.from_numpy(f), 0.006, 5).numpy()
        want = np.stack([np.asarray(js.step(jnp.asarray(y[b]), jnp.asarray(f[b]), 0.006, 5))
                         for b in range(2)])
        assert _rel(got - 1.0, want - 1.0) <= rtol


# ---------------------------------------------------- artifacts and the CLI
@pytest.mark.parametrize("preset,artifact", [("KS22_tp", "artifacts/KS22_tp_lh"),
                                             ("Fluid_8_tp", "artifacts/Fluid_8_tp")])
def test_tp_artifact_loads_and_steps(preset, artifact):
    """A shipped `_tp` checkpoint (the light file the JAX package wrote)
    loads into its preset's setup, its best actor is hook.npz's, and its
    action steps the env once at the tiers."""
    cfg = trun.fluid_config_for(preset) or trun.ks_presets()[preset][0]
    setup = trun.build_setup(cfg, device="cpu")
    _, hook = checkpoint.load(artifact, setup.agent, device="cpu")
    actor = checkpoint.actor_from_jax(hook.best_actor)
    for g, w in zip(chain_to_numpy(actor), checkpoint.load_best_actor(artifact)):
        np.testing.assert_array_equal(g["w"], w["w"])
    env = setup.env
    state = env.reset()
    nxt = env.step(state, actor_policy(setup.agent, actor)(state.obs))
    assert bool(torch.isfinite(nxt.reward).all()) and bool(torch.isfinite(nxt.obs).all())
    assert not torch.equal(nxt.obs, state.obs)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_ks22_tp_train_batched_then_eval(tmp_path, capsys):
    out = str(tmp_path / "run")
    trun.main(["KS22_tp", "--train", "--batched", "--cpu", "--n-envs", "4", "--total-steps", "20",
               "--chunk-len", "10", "--learner-batch", "8", "--capacity", "4096", "--out", out])
    capsys.readouterr()
    trun.main(["KS22_tp", "--eval", "--cpu", "--load-from", out, "--p-te", "3", "--p-t-action", "1"])
    res = _last_json(capsys)
    assert np.isfinite(res["suppression"])


def test_cli_ks22_64_tp_eval_matches_jax(tmp_path, capsys):
    """KS22_64_tp (no spectral carry on the 64-point grid) rolls the shipped
    KS22_64 actor; the suppression agrees with the JAX CLI's (float32 on
    the CPU) within 1 %: the tier's per-step error is ~1e-4."""
    argv = ["KS22_64_tp", "--eval", "--load-from", "artifacts/KS22_64", "--p-te", "20",
            "--p-t-action", "10"]
    trun.main(argv + ["--cpu"])
    got = _last_json(capsys)
    assert trun.ks_presets()["KS22_64_tp"][0].spectral_carry is False
    jrun.main(argv + ["--cpu", "--out", str(tmp_path / "jax_eval")])
    want = json.loads([ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")][-1])
    assert abs(got["suppression"] / want["suppression"] - 1.0) <= 1e-2


def test_cli_fluid_8_tp_train(tmp_path, capsys):
    out = str(tmp_path / "f8tp")
    trun.main(["Fluid_8_tp", "--train", "--cpu", "--loops", "1", "--no-steps", "6", "--out", out,
               "--config-overrides", json.dumps({"nx": 32, "sensors_per_axis": 4, "te": 0.06,
                                                 "capacity": 2048})])
    assert "saved to" in capsys.readouterr().out
    _, hook = checkpoint.load(out, trun.build_setup(dataclasses.replace(
        trun.fluid_config_for("Fluid_8_tp"), nx=32, sensors_per_axis=4, capacity=2048),
        device="cpu").agent, device="cpu")
    assert hook.ep > 1 and np.isfinite(hook.rewards).all()


@pytest.mark.parametrize("argv", [
    ["Fluid_8_tp", "--eval", "--mesh", "1x1", "--nx", "16", "--load-from", "artifacts/Fluid_8_tp",
     "--p-te", "0.06"],
    ["Fluid_8_tp", "--eval", "--ppo", "--load-from", "artifacts/Fluid_8_ppo", "--p-te", "0.06",
     "--config-overrides", '{"nx": 32}'],
], ids=["mesh-eval", "ppo-eval"])
def test_cli_fluid_8_tp_evals(argv, capsys):
    """The two `Fluid_8_tp` evaluations the CLI refused before the tiers
    were ported: both print finite energies."""
    trun.main(argv + ["--cpu"])
    res = _last_json(capsys)
    assert all(np.isfinite(v) for k, v in res.items() if isinstance(v, float))
