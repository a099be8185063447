"""The port's Keller-Segel family, baseline policies and shipped actors
against the JAX package on the CPU.

The same numpy inputs go to both sides: the solvers' right-hand side and
steps, the legacy spectral step, the rectangle kernels, the two-field
featurizer, 20 env steps of `build_keller_segel`, the policies, and the
shipped Fluid_8 and KellerSegel10_16_fast actors read by each package's
`checkpoint.load`. On the CPU the Keller-Segel step runs eagerly; its CUDA
graph is held to the eager step in tests/test_torch_families_gpu.py.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reproduce
import reproduce_torch
from distributedconvrl_pde_control_tpu import configs as C
from distributedconvrl_pde_control_tpu.agents import policies as jpol
from distributedconvrl_pde_control_tpu.envs import features as jfeat
from distributedconvrl_pde_control_tpu.ops import keller_segel as jkss
from distributedconvrl_pde_control_tpu.train.eval import actor_policy as jax_policy
from distributedconvrl_pde_control_torch.agents import policies as tpol
from distributedconvrl_pde_control_torch.configs import fluid as tfluid
from distributedconvrl_pde_control_torch.configs import keller_segel as tkss_cfg
from distributedconvrl_pde_control_torch.envs import features as tfeat
from distributedconvrl_pde_control_torch.experiments import run as trun
from distributedconvrl_pde_control_torch.ops import keller_segel as tkss
from distributedconvrl_pde_control_torch.train import checkpoint
from distributedconvrl_pde_control_torch.train.eval import actor_policy

# float32 elementwise arithmetic in the same order on both sides; matrix
# products and 10-50 RK4 substeps round differently by a few ulps
RTOL = 1e-5


def _close(got, want, rtol=RTOL, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, f"{what}: max abs err {err:.3e} > {rtol:.0e} of {scale:.3e}"


def _states(n, seed=0, nx=100):
    rng = np.random.default_rng(seed)
    y = 1.0 + 0.3 * rng.standard_normal((n, 2, nx))
    f = 0.5 * rng.standard_normal((n, nx))
    return y.astype(np.float32), f.astype(np.float32)


# -------------------------------------------------------------------- solver
def test_rhs_matches():
    y, f = _states(3)
    js, ts = jkss.KellerSegelSolver(100, 10.0), tkss.KellerSegelSolver(100, 10.0)
    got = ts.rhs(torch.from_numpy(y), torch.from_numpy(f))
    for b in range(3):
        _close(got[b], js.rhs(jnp.asarray(y[b]), jnp.asarray(f[b])), what=f"rhs {b}")


@pytest.mark.parametrize("oversampling", [10, 50])
def test_step_matches(oversampling):
    y, f = _states(2, seed=1)
    js, ts = jkss.KellerSegelSolver(100, 10.0), tkss.KellerSegelSolver(100, 10.0)
    got = ts.step(torch.from_numpy(y), torch.from_numpy(f), 0.006, oversampling)
    for b in range(2):
        _close(got[b], js.step(jnp.asarray(y[b]), jnp.asarray(f[b]), 0.006, oversampling),
               what=f"step {b}")
    assert not ts.graphs  # the CPU steps eagerly


def test_legacy_spectral_step_matches():
    y, f = _states(2, seed=2)
    y = 1.0 + 0.1 * (y - 1.0)  # the "wrong" operators grow fast; keep it in range
    js, ts = jkss.KellerSegelSpectralLegacy(100, 10.0), tkss.KellerSegelSpectralLegacy(100, 10.0)
    got = ts.step(torch.from_numpy(y), torch.from_numpy(f), 0.006, 5)
    for b in range(2):
        _close(got[b], js.step(jnp.asarray(y[b]), jnp.asarray(f[b]), 0.006, 5),
               what=f"legacy {b}")


# ---------------------------------------------------------------- features
def test_rectangle_kernels_identical():
    for args in ((np.arange(3, 101, 5), 100, 2), (np.arange(4, 60, 7), 64, 1)):
        np.testing.assert_array_equal(tfeat.rectangle_kernels_1d(*args),
                                      jfeat.rectangle_kernels_1d(*args))


@pytest.mark.parametrize("over", [{}, dict(sees_action=True), dict(memory_size=1,
                                                                   sees_action=True)])
def test_two_field_featurizer_matches(over):
    cfg = dataclasses.replace(C.KELLER_SEGEL_10_16, **over)
    sens = jfeat.rectangle_kernels_1d(cfg.sensor_positions, cfg.nx, cfg.half_window)
    kw = dict(scale=cfg.sensor_scale, window_size=3, temporal_steps=2,
              memory_size=cfg.memory_size, sees_action=cfg.sees_action,
              action_rows=1 + cfg.memory_size)
    jf = jfeat.TwoFieldFeaturizer(jnp.asarray(sens, jnp.float32), cfg.actuators_to_sensors, **kw)
    tf = tfeat.TwoFieldFeaturizer(torch.tensor(sens, dtype=torch.float32),
                                  torch.as_tensor(cfg.actuators_to_sensors), **kw)
    assert tf.obs_dim == jf.obs_dim
    y, _ = _states(2, seed=3)
    rng = np.random.default_rng(4)
    a = rng.uniform(-1, 1, (2, 1 + cfg.memory_size, 16)).astype(np.float32)
    o0 = tf(torch.from_numpy(y))
    o1 = tf(torch.from_numpy(y) * 1.1, o0, torch.from_numpy(a))
    for b in range(2):
        j0 = jf(jnp.asarray(y[b]))
        _close(o0[b], j0, what="reset obs")
        _close(o1[b], jf(jnp.asarray(y[b]) * 1.1, j0, jnp.asarray(a[b])), what="step obs")


# ---------------------------------------------------------------------- env
@pytest.fixture(scope="module")
def setups():
    return (C.build_keller_segel(C.KELLER_SEGEL_10_16_FAST),
            tkss_cfg.build_keller_segel(tkss_cfg.KELLER_SEGEL_10_16_FAST, device="cpu"))


def test_setup_matches(setups):
    jsetup, tsetup = setups
    assert tsetup.agent.cfg.__dict__ == {k: v for k, v in jsetup.agent.cfg.__dict__.items()
                                        if k in tsetup.agent.cfg.__dict__}
    for k in ("name", "seed", "loops", "no_steps", "noise_decay", "min_best_episode", "record"):
        assert getattr(tsetup, k) == getattr(jsetup, k), k
    np.testing.assert_array_equal(tsetup.env.y0.numpy(), np.asarray(jsetup.env.y0))
    for k in ("te", "dt", "max_value", "check_max_value", "action_shape", "n_rewards"):
        assert getattr(tsetup.env, k) == getattr(jsetup.env, k), k
    assert dataclasses.asdict(tkss_cfg.KELLER_SEGEL_10_16) == dataclasses.asdict(
        C.KELLER_SEGEL_10_16)


def test_twenty_env_steps_match(setups):
    """4 envs from random_init-shaped fields, 20 steps of shared actions:
    fields, observations, rewards, forcings and done flags."""
    jsetup, tsetup = setups
    je, te = jsetup.env, tsetup.env
    y0 = np.stack([np.asarray(jsetup.random_init(k)) for k in jax.random.split(
        jax.random.PRNGKey(3, impl="threefry2x32"), 4)]).astype(np.float32)
    rng = np.random.default_rng(5)
    actions = rng.uniform(-1, 1, (20, 4, 1, 16)).astype(np.float32)
    js = jax.vmap(je.reset)(jnp.asarray(y0))
    ts = te.reset(torch.from_numpy(y0))
    jstep = jax.jit(jax.vmap(je.step))
    for i in range(20):
        js = jstep(js, jnp.asarray(actions[i]))
        ts = te.step(ts, torch.from_numpy(actions[i]))
        for name in ("y", "obs", "reward", "forcing"):
            _close(getattr(ts, name), getattr(js, name), what=f"{name} step {i}")
        np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
    assert np.abs(np.asarray(js.y) - y0).max() > 0.01  # the fields moved


def test_shipped_key8_field_is_jax_random_init():
    """data_keller_segel_y0_key8.npy is `random_init(PRNGKey(8))` of the JAX
    package, the key's threefry implementation named explicitly (another test
    in the same process may switch JAX's default)."""
    jsetup = C.build_keller_segel(C.KELLER_SEGEL_10_16_FAST)
    want = np.asarray(jsetup.random_init(jax.random.PRNGKey(8, impl="threefry2x32")))
    np.testing.assert_array_equal(tkss_cfg.keller_segel_y0_key8(), want)


def test_random_init_draws_unit_sine_coefficients():
    """u - 1 and v - 1 are sums of the ceil(Lx/3) = 4 harmonics whose 8
    coefficients have unit norm, as generate_random_init draws them."""
    cfg = tkss_cfg.KELLER_SEGEL_10_16
    init = tkss_cfg.keller_segel_random_init(cfg, device="cpu")
    y = init(torch.Generator().manual_seed(0), 5).numpy().astype(np.float64)
    assert y.shape == (5, 2, 100)
    x = np.arange(1, 101) * 0.1
    h = np.stack([np.sin(i * x / (2 * np.pi * 10 / 22)) for i in range(1, 5)])
    coef = np.linalg.lstsq(h.T, (y - 1.0).reshape(10, 100).T, rcond=None)[0].T.reshape(5, 8)
    np.testing.assert_allclose(np.linalg.norm(coef, axis=1), 1.0, rtol=1e-5)


# ----------------------------------------------------------------- policies
def test_policies_match():
    rng = np.random.default_rng(6)
    obs = rng.standard_normal((3, 18, 16)).astype(np.float32) * 2.0
    shape = (1, 16)
    got = tpol.ZeroPolicy(shape)(torch.from_numpy(obs))
    assert got.shape == (3, 1, 16) and not got.any()
    for faithful in (False, True):
        for rows in (1, 2):
            jp = jpol.NegatePolicy((rows, 16), center_row=4, faithful=faithful)
            tp = tpol.NegatePolicy((rows, 16), center_row=4, faithful=faithful)
            got = tp(torch.from_numpy(obs))
            for b in range(3):
                np.testing.assert_array_equal(got[b].numpy(), np.asarray(jp(jnp.asarray(obs[b]))))
    warm = tpol.NegatePolicy(shape, center_row=4, start_steps=3)
    assert not warm(torch.from_numpy(obs), step_idx=2).any()
    assert warm(torch.from_numpy(obs), step_idx=3).any()
    r = tpol.RandomPolicy(shape)(torch.from_numpy(obs), torch.Generator().manual_seed(0))
    assert r.shape == (3, 1, 16) and r.min() >= -1.0 and r.max() < 1.0
    for feat in (tfeat.Conv2DFeaturizer(torch.zeros(64, 4), torch.arange(64), 8, 1.0),
                 tfeat.TwoFieldFeaturizer(torch.zeros(20, 100), torch.arange(16)),
                 jfeat.TwoFieldFeaturizer(jnp.zeros((20, 100)), np.arange(16))):
        assert tpol.negate_center_row(feat) == jpol.negate_center_row(feat)
    assert tpol.negate_center_row(tfeat.Conv2DFeaturizer(torch.zeros(64, 4), torch.arange(64),
                                                         8, 1.0)) == 4


# ----------------------------------------------------------- shipped actors
@pytest.mark.parametrize("name", ["Fluid_8", "KellerSegel10_16_fast"])
def test_shipped_actor_gives_jax_actions(name):
    if name == "Fluid_8":
        over = dict(nx=32, sensors_per_axis=4, capacity=64)
        jbuild = lambda: C.build_fluid(dataclasses.replace(C.FLUID_8, **over))  # noqa: E731
        tbuild = lambda: tfluid.build_fluid(dataclasses.replace(  # noqa: E731
            tfluid.FLUID_8, **over), device="cpu")
    else:
        jbuild = lambda: C.build_keller_segel(C.KELLER_SEGEL_10_16_FAST)  # noqa: E731
        tbuild = lambda: tkss_cfg.build_keller_segel(  # noqa: E731
            tkss_cfg.KELLER_SEGEL_10_16_FAST, device="cpu")
    jsetup, jactor = reproduce.load_actor(jbuild, f"artifacts/{name}")
    tsetup, tactor = reproduce_torch.load_actor(tbuild, reproduce_torch.ARTIFACTS / name, "cpu")
    ns, n_act = tsetup.agent.cfg.ns, tsetup.agent.cfg.n_actuators
    obs = np.random.default_rng(8).standard_normal((2, ns, n_act)).astype(np.float32)
    got = actor_policy(tsetup.agent, tactor)(torch.from_numpy(obs))
    jp = jax_policy(jsetup.agent, jactor)
    for b in range(2):
        _close(got[b], jp(jnp.asarray(obs[b]), None), what=f"{name} actions")


# ---------------------------------------------------------------------- CLI
def test_cli_keller_segel_eval_matches_jax(capsys):
    """`--eval` rolls the shipped actor from the preset's standard field and
    prints the deviation |u - 1| as the JAX CLI does (JAX run.py:1130-1140)."""
    from distributedconvrl_pde_control_tpu.train.eval import rollout as jax_rollout

    trun.main(["KellerSegel10_16_fast", "--eval", "--cpu", "--p-te", "0.6", "--load-from",
               "artifacts/KellerSegel10_16_fast"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"pre_control_mean_abs_dev", "post_control_mean_abs_dev", "suppression"}
    jsetup, jactor = reproduce.load_actor(lambda: C.build_keller_segel(C.KELLER_SEGEL_10_16_FAST),
                                          "artifacts/KellerSegel10_16_fast")
    y = np.asarray(jax_rollout(jsetup.env, jax_policy(jsetup.agent, jactor), te=0.6,
                               t_action=0.3)["y"])[:, 0] - 1.0
    np.testing.assert_allclose(out["post_control_mean_abs_dev"], np.abs(y[-10:]).mean(),
                               rtol=1e-4)
    assert out["post_control_mean_abs_dev"] > 0


def test_cli_keller_segel_train_resume_batched_hyperopt(tmp_path, capsys):
    """`--train`, `--resume`, `--eval` of the run, `--train --batched` and
    `--hyperopt` at a toy horizon; the search draws the JAX CLI's trials."""
    from distributedconvrl_pde_control_tpu.train.hyperopt import sample_trial

    out = str(tmp_path / "run")
    over = json.dumps({"te": 0.06})  # 10 env steps per episode
    base = ["KellerSegel10_16_fast", "--cpu", "--config-overrides", over]
    trun.main(base + ["--train", "--loops", "1", "--no-steps", "20", "--out", out])
    setup = tkss_cfg.build_keller_segel(tkss_cfg.KELLER_SEGEL_10_16_FAST, device="cpu")
    ts, hook = checkpoint.load(out, setup.agent, device="cpu")
    assert hook.ep - 1 == 2 and ts.replay.size == 20 * 16 and np.isfinite(hook.rewards).all()
    trun.main(base + ["--train", "--resume", "--loops", "1", "--no-steps", "10", "--out", out])
    ts2, hook2 = checkpoint.load(out, setup.agent, device="cpu")
    assert hook2.ep - 1 == 3 and ts2.replay.size == 30 * 16
    capsys.readouterr()
    trun.main(["KellerSegel10_16_fast", "--eval", "--cpu", "--p-te", "0.06", "--load-from", out])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(res["post_control_mean_abs_dev"])
    trun.main(base + ["--train", "--batched", "--n-envs", "4", "--total-steps", "6",
                      "--chunk-len", "3", "--learner-batch", "8", "--capacity", "2048",
                      "--out", str(tmp_path / "batched")])
    assert "24 env steps" in capsys.readouterr().out
    trun.main(["KellerSegel10_16", "--hyperopt", "2", "--hyperopt-episodes", "2", "--cpu",
               "--config-overrides", json.dumps({"te": 0.03})])
    rows = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    rng = np.random.default_rng(0)
    for row in rows[:2]:
        want = sample_trial(rng)
        assert row["cost"] is not None and np.isfinite(row["cost"])
        assert {k: row[k] for k in want} == want
    assert rows[2]["best_trial"] in (0, 1)
