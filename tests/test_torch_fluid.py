"""The port's fluid evaluation slice (2/3-rule solver, 1x1 mesh) against the
JAX package.

The same numpy inputs go through the JAX functions and their counterparts
in the port on the CPU (kernel K2's plain torch.fft version). Where the JAX
side needs a mesh it gets a one-device one, as the `--mesh 1x1` CLI builds.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from distributedconvrl_pde_control_tpu.configs import fluid as jfluid
from distributedconvrl_pde_control_tpu.envs import features as jfeat
from distributedconvrl_pde_control_tpu.experiments import run as jrun
from distributedconvrl_pde_control_tpu.ops import navier_stokes as jns
from distributedconvrl_pde_control_tpu.ops.spectral import fft_wavenumbers as jax_fft_wavenumbers
from distributedconvrl_pde_control_tpu.parallel import multichip as jmc
from distributedconvrl_pde_control_tpu.parallel import ns_sharded as jsh
from distributedconvrl_pde_control_torch.configs import fluid as tfluid
from distributedconvrl_pde_control_torch.envs import features as tfeat
from distributedconvrl_pde_control_torch.experiments import run as trun
from distributedconvrl_pde_control_torch.ops import navier_stokes as tns
from distributedconvrl_pde_control_torch.ops.spectral import fft_wavenumbers
from distributedconvrl_pde_control_torch.parallel import dfft as tdfft
from distributedconvrl_pde_control_torch.parallel.mesh import RankMesh
from distributedconvrl_pde_control_torch.parallel import multichip as tmc
from distributedconvrl_pde_control_torch.parallel import ns_sharded as tsh
from distributedconvrl_pde_control_torch.train.checkpoint import actor_from_jax, load_best_actor

ARTIFACT = "artifacts/Fluid_16_256"
# float32 on both sides; torch.fft and XLA's FFT round in different orders.
# A few RK4 substeps at 32^2 differ by ~1e-6 of the field's scale; the
# reference's own solver test allows 5e-3 against a float64 oracle.
STEP_RTOL = 2e-5
# 6 env steps of 5 substeps at 16^2 in closed loop, relative to each record
# (observed 6e-7; 20x room)
SLICE_RTOL = 1e-5


def _one_device_mesh(names):
    shape = (1,) * len(names)
    return Mesh(np.asarray(jax.devices()[:1]).reshape(shape), names)


# ------------------------------------------------------------- host side
def test_fft_wavenumbers_match():
    for n, length in ((16, 1.0), (32, 2.5), (256, 1.0)):
        np.testing.assert_array_equal(fft_wavenumbers(n, length), jax_fft_wavenumbers(n, length))
    assert fft_wavenumbers(16, 1.0)[8] > 0  # the Nyquist entry is positive


@pytest.mark.parametrize("case", [1, 2, 3, 4])
def test_initial_condition_matches(case):
    got = tns.initial_condition(case, 32, 32, 1.0, 1.0, np.random.default_rng(5))
    want = jns.initial_condition(case, 32, 32, 1.0, 1.0, np.random.default_rng(5))
    assert got.dtype == want.dtype == np.complex128
    np.testing.assert_array_equal(got, want)


def test_initial_condition_refuses_unknown_case():
    with pytest.raises(ValueError):
        tns.initial_condition(5, 8, 8, 1.0, 1.0, np.random.default_rng(0))


@pytest.mark.parametrize("norm_mode", [1, 2])
def test_taylor_kernels_2d_match(norm_mode):
    pos = [(1, 1), (9, 17), (25, 9)]
    got = tfeat.taylor_kernels_2d(pos, 32, 32, 1.0, 1.0, 0.08, norm_mode)
    want = jfeat.taylor_kernels_2d(pos, 32, 32, 1.0, 1.0, 0.08, norm_mode)
    np.testing.assert_array_equal(got, want)


def test_fluid_config_and_kernels_match():
    assert set(tfluid.PRESETS) == {"Fluid_8", "Fluid_16", "Fluid_32", "Fluid_8_256", "Fluid_16_256"}
    for name, tcfg in tfluid.PRESETS.items():
        jcfg = getattr(jfluid, name.upper())
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        for prop in ("grid_nx", "grid_seed", "oversampling", "fast_oversampling_eff"):
            assert getattr(tcfg, prop) == getattr(jcfg, prop), (name, prop)
    assert tfluid.FLUID_16_256.oversampling == 81 and tfluid.FLUID_16_256.grid_nx == 256
    ev = dataclasses.replace(tfluid.FLUID_8, evaluation=True)
    assert (ev.grid_nx, ev.grid_seed) == (256, 76)
    tcfg = dataclasses.replace(tfluid.FLUID_16_256, nx=32, sensors_per_axis=4)
    jcfg = dataclasses.replace(jfluid.FLUID_16_256, nx=32, sensors_per_axis=4)
    assert tcfg.positions == jcfg.positions
    for got, want in zip(tfluid.fluid_kernels(tcfg), jfluid.fluid_kernels(jcfg)):
        np.testing.assert_array_equal(got, want)
    assert tfluid.fluid_agent_config(tcfg, 9).__dict__ == {
        k: v for k, v in jfluid.fluid_agent_config(jcfg, 9).__dict__.items()
        if k in tfluid.fluid_agent_config(tcfg, 9).__dict__}


def test_fluid_error_detection_matches():
    rng = np.random.default_rng(0)
    smooth = rng.standard_normal((8, 8))
    jump = smooth.copy()
    jump[3, 4] += 30.0
    for y in (smooth, jump):
        assert tfluid.fluid_error_detection(y) == jfluid.fluid_error_detection(y)
    assert tfluid.fluid_error_detection(jump) and not tfluid.fluid_error_detection(smooth)


def test_build_fluid_names_its_queue():
    """`build_fluid` builds the float32 tiers and the reduced-precision
    transform tiers, whose queue item is done, and refuses an unknown mode."""
    with pytest.raises(ValueError, match="unknown fft mode"):
        tfluid.build_fluid(dataclasses.replace(tfluid.FLUID_8, nx=16, fft_mode="bf16"),
                           device="cpu")
    tp = tfluid.build_fluid(dataclasses.replace(trun.fluid_config_for("Fluid_8_tp"), nx=16,
                                                sensors_per_axis=4), device="cpu")
    y = tp.env.step_fn(tp.env.y0[None], torch.zeros(1, 16, 16))
    assert y.shape == (1, 16, 16) and bool(torch.isfinite(y).all())
    setup = tfluid.build_fluid(dataclasses.replace(tfluid.FLUID_8, nx=16, sensors_per_axis=4),
                               device="cpu")
    assert setup.env.y0.shape == (16, 16) and setup.agent.cfg.ns == 9


def test_fluid_config_for_matches():
    for name in ("Fluid_16_256", "Fluid_8_fast", "Fluid_8_fixedstep", "Fluid_16_eval",
                 "Fluid_8_256_tp", "KS22", "Fluid_9"):
        got, want = trun.fluid_config_for(name), jrun.fluid_config_for(name)
        if want is None:
            assert got is None
        else:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert trun._FLUID_TIERS == jrun._FLUID_TIERS


def test_make_sharded_ops_match():
    for n, lx in ((16, 1.0), (32, 1.0), (64, 2.0)):
        got, want = tsh.make_sharded_ops(n, n, lx, lx, device="cpu"), jsh.make_sharded_ops(n, n, lx, lx)
        for name in ("kx", "ky", "k2", "inv_k2", "mask23"):
            g = getattr(got, name)
            assert g.dtype == torch.float32 and g.shape == (n, n)
            np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, name)), err_msg=name)
        assert isinstance(got, tsh.ShardedOps) and got.n == n
    with pytest.raises(ValueError, match="square"):
        tsh.make_sharded_ops(16, 32, device="cpu")


# ------------------------------------------------------------ featurizer
@pytest.mark.parametrize("temporal_steps,memory_size", [(1, 0), (2, 1)])
def test_conv2d_featurizer_matches(temporal_steps, memory_size):
    rng = np.random.default_rng(3)
    spa, n, batch = 4, 16, 3
    sens = rng.standard_normal((spa * spa, n * n)).astype(np.float32)
    kw = dict(sensors_per_axis=spa, scale=1.0 / 70.0, window_size=3,
              temporal_steps=temporal_steps, memory_size=memory_size)
    jf = jfeat.Conv2DFeaturizer(sensor_matrix=jnp.asarray(sens),
                                actuators_to_sensors=np.arange(spa * spa), **kw)
    tf = tfeat.Conv2DFeaturizer(sensor_matrix=torch.from_numpy(sens),
                                actuators_to_sensors=torch.arange(spa * spa), **kw)
    assert tf.obs_dim == jf.obs_dim == 9 * temporal_steps + memory_size
    assert tf.n_actuators == jf.n_actuators == 16
    y = rng.standard_normal((batch, n, n)).astype(np.float32)
    dots = rng.standard_normal((batch, spa * spa)).astype(np.float32)
    prev = rng.standard_normal((batch, jf.obs_dim, spa * spa)).astype(np.float32)
    act = rng.standard_normal((batch, 1 + memory_size, spa * spa)).astype(np.float32)
    for po, a in ((None, None), (prev, act)):
        tpo = None if po is None else torch.from_numpy(po)
        ta = None if a is None else torch.from_numpy(a)
        got = tf.from_dots(torch.from_numpy(dots), tpo, ta).numpy()
        got_y = tf(torch.from_numpy(y), tpo, ta).numpy()
        assert got.shape == (batch, jf.obs_dim, spa * spa)
        for b in range(batch):
            jpo = None if po is None else jnp.asarray(po[b])
            ja = None if a is None else jnp.asarray(a[b])
            np.testing.assert_array_equal(got[b], np.asarray(jf.from_dots(jnp.asarray(dots[b]), jpo, ja)))
            np.testing.assert_allclose(got_y[b], np.asarray(jf(jnp.asarray(y[b]), jpo, ja)),
                                       rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- solver
def test_dfft_one_rank():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16)).astype(np.float32)
    w = tdfft.dfft2(torch.from_numpy(x))
    assert w.dtype == torch.complex64
    np.testing.assert_allclose(w.numpy(), np.fft.fft2(x), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tdfft.difft2(w).numpy(), x, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tdfft.difft2_real(w).numpy(), x, rtol=0, atol=1e-6)
    # a one-rank mesh transforms whole fields, bit for bit as no mesh; an sp
    # axis of several ranks transposes through the mesh's process groups
    # (tests/test_torch_mesh.py), which a mesh built without them lacks
    for fn, arg in ((tdfft.dfft2, torch.from_numpy(x)), (tdfft.difft2, w), (tdfft.difft2_real, w)):
        assert torch.equal(fn(arg, RankMesh(device="cpu")), fn(arg))
        with pytest.raises(RuntimeError, match="process groups"):
            fn(arg, RankMesh(sp=4, device="cpu"))


def _solver_inputs(n=32, batch=2):
    rng = np.random.default_rng(7)
    omg = np.stack([np.fft.ifft2(jns.initial_condition(c, n, n, 1.0, 1.0, rng)).real
                    for c in (2, 3)][:batch]).astype(np.float32)
    forcing = (0.5 * rng.standard_normal((batch, n, n))).astype(np.float32)
    return omg, forcing


@pytest.mark.parametrize("method,substeps", [("step_real", 4), ("step_real_if", 2)])
def test_step_real_matches_sharded_solver(method, substeps):
    """32^2, nu=5e-4, dt=0.01 with a non-zero forcing, against
    NSShardedSolverRI under shard_map on a one-device ("sp",) mesh."""
    n, nu, dt = 32, 5e-4, 0.01
    omg, forcing = _solver_inputs(n)
    jops = jsh.make_sharded_ops(n, n)
    jsolver = jsh.NSShardedSolverRI(nu=nu, sp_axis="sp")
    step = shard_map(
        lambda wb, fb, ob: getattr(jsolver, method)(wb, fb, ob, dt, substeps),
        mesh=_one_device_mesh(("sp",)),
        in_specs=(P(None, "sp", None), P(None, "sp", None), jax.tree.map(lambda _: P(None, "sp"), jops)),
        out_specs=P(None, "sp", None), check_vma=False)
    want = np.asarray(jax.jit(step)(jnp.asarray(omg), jnp.asarray(forcing), jops))
    tops = tsh.make_sharded_ops(n, n, device="cpu")
    tsolver = tsh.NSShardedSolverRI(nu=nu)
    got = getattr(tsolver, method)(torch.from_numpy(omg), torch.from_numpy(forcing), tops, dt,
                                   substeps).numpy()
    assert got.shape == omg.shape and got.dtype == np.float32
    assert np.abs(want - omg).max() > 1e-3  # the step moved the field
    np.testing.assert_allclose(got, want, rtol=0, atol=STEP_RTOL * np.abs(want).max())
    # a single field without the batch axis takes the same path
    one = getattr(tsolver, method)(torch.from_numpy(omg[0]), torch.from_numpy(forcing[0]), tops,
                                   dt, substeps).numpy()
    np.testing.assert_allclose(one, got[0], rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("dt,tol", [(0.02, 1.0), (0.05, 1e-3)])
def test_step_real_adaptive_matches_sharded_solver(dt, tol):
    """do_step2 at the presets' tolerance 1e0 (every trial accepted) and at
    a tight one with a longer step (trials rejected and retried): the port
    keeps time and step size in float32 on the host as the reference does
    on the device, so both take the same trials."""
    n, nu = 32, 5e-4
    omg, forcing = _solver_inputs(n)
    jops = jsh.make_sharded_ops(n, n)
    jsolver = jsh.NSShardedSolverRI(nu=nu, sp_axis="sp")
    step = shard_map(
        lambda wb, fb, ob: jsolver.step_real_adaptive(wb, fb, ob, dt, rtol=tol, atol=tol),
        mesh=_one_device_mesh(("sp",)),
        in_specs=(P(None, "sp", None), P(None, "sp", None), jax.tree.map(lambda _: P(None, "sp"), jops)),
        out_specs=P(None, "sp", None), check_vma=False)
    want = np.asarray(jax.jit(step)(jnp.asarray(omg), jnp.asarray(forcing), jops))
    tops = tsh.make_sharded_ops(n, n, device="cpu")
    calls = []
    tsolver = tsh.NSShardedSolverRI(nu=nu)
    orig = tsh.NSShardedSolver._rk4_substep_v
    try:
        tsh.NSShardedSolver._rk4_substep_v = lambda self, wv, fv, ops, h, lin: (
            calls.append(h), orig(self, wv, fv, ops, h, lin))[1]
        got = tsolver.step_real_adaptive(torch.from_numpy(omg), torch.from_numpy(forcing), tops, dt,
                                         rtol=tol, atol=tol).numpy()
    finally:
        tsh.NSShardedSolver._rk4_substep_v = orig
    trials = len(calls) // 3
    whole = calls[0::3]
    assert whole[0] == np.float32(dt / 16.0) and trials >= 2
    if tol < 1.0:  # some trial was rejected: the accepted lengths alone would overshoot dt
        assert sum(whole) > dt * 1.01
    assert np.abs(want - omg).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=STEP_RTOL * np.abs(want).max())


def test_rhs_and_rk4_substep_match_complex_solver():
    """The complex-spectrum surface against the reference's NSShardedSolver."""
    n, nu, h = 32, 5e-4, 0.0025
    omg, forcing = _solver_inputs(n)
    w, f = np.fft.fft2(omg).astype(np.complex64), np.fft.fft2(forcing).astype(np.complex64)
    jops = jsh.make_sharded_ops(n, n)
    jsolver = jsh.NSShardedSolver(nu=nu, sp_axis="sp")
    spec = P(None, None, "sp")
    ops_spec = jax.tree.map(lambda _: P(None, "sp"), jops)
    mesh = _one_device_mesh(("sp",))
    jrhs = shard_map(lambda a, b, o: jsolver.rhs(a, b, o), mesh=mesh,
                     in_specs=(spec, spec, ops_spec), out_specs=spec, check_vma=False)
    jsub = shard_map(lambda a, b, o: jsolver.rk4_substep(a, b, o, h), mesh=mesh,
                     in_specs=(spec, spec, ops_spec), out_specs=spec, check_vma=False)
    tops = tsh.make_sharded_ops(n, n, device="cpu")
    tsolver = tsh.NSShardedSolver(nu=nu)
    tw, tf = torch.from_numpy(w), torch.from_numpy(f)
    for got, want in ((tsolver.rhs(tw, tf, tops), jrhs(jnp.asarray(w), jnp.asarray(f), jops)),
                      (tsolver.rk4_substep(tw, tf, tops, h), jsub(jnp.asarray(w), jnp.asarray(f), jops))):
        want = np.asarray(want)
        assert got.dtype == torch.complex64
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=STEP_RTOL * np.abs(want).max())
    np.testing.assert_array_equal(tw.numpy(), w)  # inputs are not written to


def test_fused_rk4_substep_matches_unfused():
    """`_rk4_substep_v` and `_rhs_v` give kernel K2 the stage arithmetic as
    operands; on CPU tensors that route computes bit for bit what the
    advection term followed by the same arithmetic in PyTorch computes."""
    from distributedconvrl_pde_control_torch.ops.kernels.ns_advection import ns_advection

    n, nu, h = 32, 5e-4, 0.0025
    omg, forcing = _solver_inputs(n)
    tops = tsh.make_sharded_ops(n, n, device="cpu")
    tsolver = tsh.NSShardedSolver(nu=nu)
    wv = torch.view_as_real(torch.from_numpy(np.fft.fft2(omg).astype(np.complex64)))
    fv = torch.view_as_real(torch.from_numpy(np.fft.fft2(forcing).astype(np.complex64)))
    lin = tsolver._lin(tops)

    def rhs(zv, with_lin=True):
        adv = torch.view_as_real(ns_advection(torch.view_as_complex(zv), tops))
        if with_lin:
            adv = torch.addcmul(adv, lin[..., None], zv)
        return adv.add_(fv)

    k1 = rhs(wv)
    k2 = rhs(torch.add(wv, k1, alpha=0.5 * h))
    k3 = rhs(torch.add(wv, k2, alpha=0.5 * h))
    k4 = rhs(torch.add(wv, k3, alpha=h))
    want = torch.add(wv, k1.clone().add_(k2.clone().add_(k3).mul_(2.0)).add_(k4), alpha=h / 6.0)
    assert tsolver._rk4_substep_v(wv, fv, tops, h, lin).equal(want)
    assert tsolver._rhs_v(wv, fv, tops, lin).equal(k1)
    assert tsolver._rhs_v(wv, fv, tops, None).equal(rhs(wv, with_lin=False))
    assert (want - wv).abs().max() > 0


def test_solver_refuses_unported_tiers():
    """Every tier of the reference builds now; only an unknown mode is refused."""
    tsh.NSShardedSolverRI(nu=1e-3, fft_mode="matmul_hi", nl_fft_mode="matmul_fast")
    with pytest.raises(ValueError, match="unknown fft mode"):
        tsh.NSShardedSolverRI(nu=1e-3, fft_mode="bf16")
    with pytest.raises(ValueError, match="unknown fft mode"):
        tsh.NSShardedSolverRI(nu=1e-3, nl_fft_mode="bf16")


# ------------------------------------------------------- the whole slice
def _tiny(mod, **over):
    return dataclasses.replace(mod.FLUID_8, nx=16, sensors_per_axis=4,
                               **{"adaptive": False, **over})


def _distinct_fields(n, n_envs, amps):
    rng = np.random.default_rng(11)
    return np.stack([
        a * np.fft.ifft2(jns.initial_condition(4, n, n, 1.0, 1.0, rng)).real
        for a in amps[:n_envs]]).astype(np.float32)


def _both_evals(over, params, w0, n_steps=6, t_action_steps=2):
    jtr = jmc.ShardedFluidTrainer(_tiny(jfluid, **over), _one_device_mesh(("dp", "sp")),
                                  jmc.ShardedTrainConfig(n_envs=w0.shape[0]))
    jparams = [{"w": jnp.asarray(p["w"]), "b": jnp.asarray(p["b"])} for p in params]
    want = {k: np.asarray(v) for k, v in
            jtr.make_eval_fn(n_steps, t_action_steps=t_action_steps)(jparams, jnp.asarray(w0)).items()}
    ttr = tmc.ShardedFluidTrainer(_tiny(tfluid, **over), (1, 1),
                                  tmc.ShardedTrainConfig(n_envs=w0.shape[0]), device="cpu")
    got = ttr.make_eval_fn(n_steps, t_action_steps=t_action_steps)(actor_from_jax(params),
                                                                   torch.from_numpy(w0))
    return got, want, ttr, jtr


def _assert_records_match(got, want, n_steps, n_envs):
    for k in ("energy", "reward_mean", "active"):
        assert got[k].shape == want[k].shape == (n_steps, n_envs), k
    np.testing.assert_array_equal(got["active"], want["active"])
    np.testing.assert_allclose(got["energy"], want["energy"], rtol=SLICE_RTOL)
    np.testing.assert_allclose(got["reward_mean"], want["reward_mean"], rtol=SLICE_RTOL, atol=1e-7)


@pytest.mark.parametrize("over", [{"stepper": "rk4"}, {"stepper": "ifrk4"}, {"adaptive": True}],
                         ids=["rk4", "ifrk4", "adaptive"])
def test_eval_fn_matches_jax_with_shipped_actor(over):
    """3 envs from distinct ICs, the shipped Fluid_16_256 actor (9 -> 18 -> 1),
    6 steps with actuation from step 2, on each stepper the presets use."""
    w0 = _distinct_fields(16, 3, [1.0, 0.5, 2.0])
    got, want, ttr, jtr = _both_evals(over, load_best_actor(ARTIFACT), w0)
    assert want["active"].all()
    assert np.abs(want["reward_mean"][2:]).min() > 0
    assert not np.allclose(want["energy"][:, 0], want["energy"][:, 1])
    _assert_records_match(got, want, 6, 3)
    assert ttr.n_act == jtr.n_act == 16 and ttr.featurizer.obs_dim == jtr.featurizer.obs_dim == 9


def test_eval_fn_matches_jax_with_memory_rows():
    """temporal_steps=2, memory_size=1: a 19 -> 18 -> 2 actor with random
    weights; the memory row carries the previous action."""
    rng = np.random.default_rng(2)
    params = [{"w": (0.3 * rng.standard_normal((18, 19))).astype(np.float32),
               "b": (0.1 * rng.standard_normal(18)).astype(np.float32)},
              {"w": (0.3 * rng.standard_normal((2, 18))).astype(np.float32),
               "b": np.zeros(2, np.float32)}]
    w0 = _distinct_fields(16, 2, [1.0, 1.5])
    got, want, ttr, _ = _both_evals({"temporal_steps": 2, "memory_size": 1}, params, w0)
    assert ttr.featurizer.obs_dim == 19 and ttr.agent.cfg.na_rows == 2
    _assert_records_match(got, want, 6, 2)


@pytest.mark.parametrize("check", ["reward", "y"])
def test_eval_fn_freezes_blown_up_envs(check):
    """max_value set low: the largest env blows up at once, another after
    one kept step, and both freeze - energy stays at the last kept field,
    reward_mean is 0, active stays False - while the small one runs on."""
    over = {"check_max_value": check, "max_value": 0.05 if check == "reward" else 19.8}
    w0 = _distinct_fields(16, 4, [0.05, 1.0, 3.0, 0.3])
    got, want, _, _ = _both_evals(over, load_best_actor(ARTIFACT), w0)
    assert want["active"][:, 0].all() and not want["active"][:, 2].any()
    late = 1 if check == "reward" else 3  # kept at step 0, blown up at step 1
    assert want["active"][:, late].tolist() == [True] + [False] * 5
    _assert_records_match(got, want, 6, 4)
    for b in range(4):
        dead = np.flatnonzero(~got["active"][:, b])
        if len(dead):
            first = dead[0]
            assert not got["active"][first:, b].any()  # done latches
            assert (got["reward_mean"][first:, b] == 0).all()
            assert (got["energy"][first:, b] == got["energy"][first, b]).all()


def test_eval_w0_and_trainer_refusals():
    ttr = tmc.ShardedFluidTrainer(_tiny(tfluid), (1, 1), tmc.ShardedTrainConfig(n_envs=3), device="cpu")
    jtr = jmc.ShardedFluidTrainer(_tiny(jfluid), _one_device_mesh(("dp", "sp")),
                                  jmc.ShardedTrainConfig(n_envs=3))
    np.testing.assert_array_equal(ttr.eval_w0().numpy(), np.asarray(jtr.eval_w0()))
    assert ttr.eval_w0(5).shape == (5, 16, 16)
    # a mesh of several ranks is a RankMesh per rank; dp rank 1 of a 2x2 mesh
    # holds envs 2-3 and rows 8-15 of the fields, and its dp group's replay is
    # rounded to its own push width (2 envs x 16 actuators)
    with pytest.raises(ValueError, match="RankMesh"):
        tmc.ShardedFluidTrainer(_tiny(tfluid), (2, 1), device="cpu")
    rank = tmc.ShardedFluidTrainer(_tiny(tfluid), RankMesh(2, 2, 1, 1, "cpu"),
                                   tmc.ShardedTrainConfig(n_envs=4, capacity_per_dp=100),
                                   device="cpu")
    assert (rank.n_local, rank.envs, rank.rows, rank.capacity_per_dp) == (2, slice(2, 4),
                                                                           slice(8, 16), 128)
    assert tuple(rank.sensor_kernels.shape) == (16, 8, 16)
    np.testing.assert_array_equal(rank.eval_w0().numpy(), np.asarray(jtr.eval_w0(4))[2:, 8:])


def test_load_actor_for_eval_reads_the_fluid_actor(tmp_path):
    ttr = tmc.ShardedFluidTrainer(_tiny(tfluid), (1, 1), device="cpu")
    actor = tmc.load_actor_for_eval(ARTIFACT, ttr)
    with np.load(f"{ARTIFACT}/saves/hook.npz") as z:
        assert [tuple(w.shape) for w in actor.w] == [(18, 9), (1, 18)]
        assert [tuple(b.shape) for b in actor.b] == [(18,), (1,)]
        for i in range(2):
            np.testing.assert_array_equal(actor.w[i].detach().numpy(), z[f"best_actor_w{i}"])
            np.testing.assert_array_equal(actor.b[i].detach().numpy(), z[f"best_actor_b{i}"])
    with pytest.raises(ValueError, match="9 -> 1"):
        tmc.load_actor_for_eval("artifacts/KS22", ttr)  # a 1 -> 6 -> 1 actor
    # a run whose hook holds no best actor: the checkpoint's current actor
    from distributedconvrl_pde_control_torch.train import checkpoint
    from distributedconvrl_pde_control_torch.train.hooks import PDEHook
    from distributedconvrl_pde_control_torch.train.loop import TrainState

    checkpoint.save(str(tmp_path), None, PDEHook())
    with pytest.raises(FileNotFoundError, match="no checkpoint at .*agent_light.msgpack"):
        tmc.load_actor_for_eval(str(tmp_path), ttr)
    state = ttr.agent.init_state(torch.Generator().manual_seed(0), "cpu")
    checkpoint.save(str(tmp_path), TrainState(state, None, None), PDEHook(), include_replay=False)
    current = tmc.load_actor_for_eval(str(tmp_path), ttr)
    for got, want in zip(current.parameters(), state.actor.parameters()):
        assert torch.equal(got, want)


# ------------------------------------------------------------------- CLI
def test_cli_fluid_eval_prints_the_four_keys(capsys):
    argv = ["Fluid_16_256", "--eval", "--mesh", "1x1", "--nx", "32", "--cpu", "--p-te", "0.1",
            "--load-from", ARTIFACT]
    trun.main(argv)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out) == ["mesh", "grid", "trained", "no action"]
    assert out["mesh"] == "1x1" and out["grid"] == 32
    # the JAX CLI's numbers for the same protocol, from its own pieces
    cfg = dataclasses.replace(jfluid.FLUID_16_256, nx=32)
    jtr = jmc.ShardedFluidTrainer(cfg, _one_device_mesh(("dp", "sp")), jmc.ShardedTrainConfig(n_envs=1))
    actor = [{"w": jnp.asarray(p["w"]), "b": jnp.asarray(p["b"])} for p in load_best_actor(ARTIFACT)]
    for label, ta in (("trained", 0), ("no action", 5)):
        recs = jtr.make_eval_fn(5, t_action_steps=ta)(actor, jtr.eval_w0(1))
        e, m = np.asarray(recs["energy"]), np.asarray(recs["active"])
        np.testing.assert_allclose(out[label], float(e[m].mean()), rtol=SLICE_RTOL)
    assert out["trained"] != out["no action"]


def test_cli_eval_at_a_grid_other_than_a_power_of_two_matches_the_jax_cli(tmp_path, capsys):
    """`--mesh 1x1 --eval --nx 48` (48 = 16 * 3: K2's mixed-radix lines on
    the card, its plain version here) against the JAX CLI's own run."""
    argv = ["Fluid_16_256", "--mesh", "1x1", "--eval", "--load-from", ARTIFACT, "--nx", "48",
            "--p-te", "0.05", "--cpu"]
    trun.main(argv + ["--out", str(tmp_path / "port")])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jrun.main(argv + ["--out", str(tmp_path / "jax")])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["grid"] == want["grid"] == 48
    for k in ("trained", "no action"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    assert got["trained"] != got["no action"]


def test_cli_runs_an_adaptive_preset(capsys):
    """Fluid_8 (adaptive do_step2, 8x8 actuators) at a 32^2 grid."""
    trun.main(["Fluid_8", "--eval", "--mesh", "1x1", "--nx", "32", "--cpu", "--p-te", "0.06",
               "--n-envs", "2", "--load-from", "artifacts/Fluid_8"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out) == ["mesh", "grid", "trained", "no action"] and out["grid"] == 32
    assert np.isfinite(out["trained"]) and np.isfinite(out["no action"])
    assert out["trained"] != out["no action"]


@pytest.mark.parametrize("argv,message", [
    (["Fluid_16_256", "--eval", "--mesh", "2x1"], "needs 2 devices, have 1 (hint: --virtual-devices N)"),
    (["Fluid_16_256", "--eval", "--mesh", "two"], "DPxSP"),
    (["Fluid_16_256", "--train", "--mesh", "2x1"], "needs 2 devices, have 1 (hint: --virtual-devices N)"),
    (["Fluid_8_tp", "--eval", "--mesh", "2x1"], "needs 2 devices, have 1 (hint: --virtual-devices N)"),
    # a refusal of ROADMAP queue 1 item 15 until the dp batched path was ported; it keeps its id
    pytest.param(["Fluid_8_tp", "--train", "--batched", "--mesh", "1x2"],
                 "--batched shards over dp only", id="argv4-item 15"),
    (["KS22", "--eval", "--mesh", "1x1"], "fluid presets"),
])
def test_cli_refusals_name_what_is_missing(argv, message):
    with pytest.raises(SystemExit) as exc:
        trun.main(argv + ["--cpu", "--load-from", ARTIFACT])
    assert message in str(exc.value)


# --------------------------------------------- single-device fluid env (CLI)
TOY = {"nx": 32, "sensors_per_axis": 4}


def test_cli_fluid_eval_without_mesh_matches_jax(capsys):
    """`Fluid_8 --eval` on the single-device env prints the JAX CLI's three
    masked mean energies (trained, negate, no action) at a toy grid; the JAX
    numbers come from its own pieces on the same protocol."""
    import reproduce
    from distributedconvrl_pde_control_tpu.agents.policies import (
        NegatePolicy,
        ZeroPolicy,
        negate_center_row,
    )
    from distributedconvrl_pde_control_tpu.train.eval import actor_policy, energy_eval

    trun.main(["Fluid_8", "--eval", "--cpu", "--p-te", "0.1", "--load-from", "artifacts/Fluid_8",
               "--config-overrides", json.dumps(TOY)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out) == ["trained", "negate", "no action"]
    jsetup, actor = reproduce.load_actor(lambda: jfluid.build_fluid(dataclasses.replace(
        jfluid.FLUID_8, capacity=64, **TOY)), "artifacts/Fluid_8")
    env = jsetup.env
    pols = {"trained": actor_policy(jsetup.agent, actor),
            "negate": NegatePolicy(env.action_shape, center_row=negate_center_row(env.featurize)),
            "no action": ZeroPolicy(env.action_shape)}
    for label, pol in pols.items():
        want = energy_eval(env, pol, te=0.1)["mean_energy"]
        np.testing.assert_allclose(out[label], want, rtol=SLICE_RTOL)
    assert out["trained"] != out["no action"]


def test_cli_fluid_train_without_mesh_at_a_toy_size(tmp_path, capsys):
    """`--train` (the single-env loop, full checkpoint), `--resume`,
    `--eval` of the run and `--train --batched` on the single-device env."""
    from distributedconvrl_pde_control_torch.train import checkpoint

    out = str(tmp_path / "run")
    over = json.dumps({**TOY, "te": 0.06, "capacity": 2048})
    trun.main(["Fluid_8", "--train", "--cpu", "--loops", "1", "--no-steps", "6",
               "--config-overrides", over, "--out", out])
    setup = tfluid.build_fluid(dataclasses.replace(tfluid.FLUID_8, **json.loads(over)),
                               device="cpu")
    ts, hook = checkpoint.load(out, setup.agent, device="cpu")
    assert hook.ep - 1 == 2 and ts.replay.size == 6 * 16
    assert np.isfinite(hook.rewards).all()
    trun.main(["Fluid_8", "--train", "--resume", "--cpu", "--loops", "1", "--no-steps", "3",
               "--config-overrides", over, "--out", out])
    ts2, hook2 = checkpoint.load(out, setup.agent, device="cpu")
    assert hook2.ep - 1 == 3 and ts2.replay.size == 9 * 16
    capsys.readouterr()
    trun.main(["Fluid_8", "--eval", "--cpu", "--p-te", "0.04", "--load-from", out])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(res) == ["trained", "negate", "no action"] and np.isfinite(list(res.values())).all()
    bout = str(tmp_path / "batched")
    trun.main(["Fluid_8", "--train", "--batched", "--cpu", "--n-envs", "2", "--total-steps", "6",
               "--chunk-len", "3", "--learner-batch", "8", "--capacity", "2048",
               "--config-overrides", json.dumps({**TOY, "te": 0.06}), "--out", bout])
    assert "12 env steps" in capsys.readouterr().out
    assert np.isfinite(checkpoint.load_hook(bout).rewards).all()
