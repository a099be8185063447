"""The port's KS features, reward, forcing and batched env against JAX.

Inputs are made with numpy from a seed and handed to both sides; the JAX
env is one env under `jax.vmap`, the port's is the batch itself.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedconvrl_pde_control_tpu.configs import ks as jks
from distributedconvrl_pde_control_tpu.envs import features as jfeat
from distributedconvrl_pde_control_torch.configs import ks as tks
from distributedconvrl_pde_control_torch.envs import features as tfeat

# f32 matrix-vector products summed in another order than XLA's: a few ulps
RTOL = 1e-6
ATOL = 1e-7


@pytest.fixture(scope="module")
def setups():
    return jks.build_ks(jks.KS22), tks.build_ks(tks.KS22, device="cpu")


def _fields(n, nx=192, seed=0, amp=1.5):
    rng = np.random.default_rng(seed)
    return (amp * rng.standard_normal((n, nx))).astype(np.float32)


def _actions(n, seed=1, rows=1, n_act=8):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, (n, rows, n_act)).astype(np.float32)


@pytest.mark.parametrize("norm_mode,amp", [(1, True), (2, True), (1, False)])
def test_gaussian_kernels_1d_identical(norm_mode, amp):
    args = (np.arange(1, 241, 3), 240, 200.0, 1.0, norm_mode, amp)
    np.testing.assert_array_equal(tfeat.gaussian_kernels_1d(*args),
                                  jfeat.gaussian_kernels_1d(*args))


def test_featurizer_reward_prepare_action(setups):
    jsetup, tsetup = setups
    y, a, da = _fields(4), _actions(4), _actions(4, seed=2)
    je, te = jsetup.env, tsetup.env
    ty, ta, tda = torch.from_numpy(y), torch.from_numpy(a), torch.from_numpy(da)
    obs = te.featurize(ty, None, None)
    assert obs.shape == (4, 1, 8)
    np.testing.assert_allclose(obs.numpy(), jax.vmap(lambda v: je.featurize(v, None, None))(y),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(te.reward_fn(ty, ta, tda).numpy(),
                               jax.vmap(je.reward_fn)(y, a, da), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(te.prepare_action(ta).numpy(), jax.vmap(je.prepare_action)(a),
                               rtol=RTOL, atol=ATOL)


def test_featurizer_window_temporal_memory():
    """Window 3, two temporal blocks and one memory row: reset and step."""
    sensors = jfeat.gaussian_kernels_1d(np.arange(1, 193, 24), 192, 22.0, 0.7)
    a2s = np.arange(8)
    kw = dict(actuators_to_sensors=a2s, scale=1 / 30.0, window_size=3, temporal_steps=2,
              memory_size=1)
    jf = jfeat.Conv1DFeaturizer(sensor_matrix=jnp.asarray(sensors, jnp.float32), **kw)
    tf = tfeat.Conv1DFeaturizer(sensor_matrix=torch.as_tensor(sensors, dtype=torch.float32),
                                **{**kw, "actuators_to_sensors": torch.as_tensor(a2s)})
    y0, y1, act = _fields(3, seed=3), _fields(3, seed=4), _actions(3, rows=2)
    j0 = jax.vmap(lambda v: jf(v, None, None))(y0)
    t0 = tf(torch.from_numpy(y0))
    np.testing.assert_allclose(t0.numpy(), j0, rtol=RTOL, atol=ATOL)
    j1 = jax.vmap(jf)(y1, j0, act)
    t1 = tf(torch.from_numpy(y1), t0, torch.from_numpy(act))
    assert t1.shape == (3, tf.obs_dim, 8)
    np.testing.assert_allclose(t1.numpy(), j1, rtol=RTOL, atol=ATOL)


def _env_pair(te_s=5.0):
    cfg_j = dataclasses.replace(jks.KS22, te=te_s)
    cfg_t = dataclasses.replace(tks.KS22, te=te_s)
    return jks.build_ks(cfg_j).env, tks.build_ks(cfg_t, device="cpu").env


def test_env_reset_matches():
    je, te = _env_pair()
    y0 = _fields(4, seed=5)
    js = jax.vmap(je.reset)(jnp.asarray(y0))
    ts = te.reset(torch.from_numpy(y0))
    for name in ("y", "obs", "action", "delta_action", "forcing", "steps", "time", "reward", "done"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    default = te.reset()
    assert default.y.shape == (1, 192)
    np.testing.assert_array_equal(default.y[0].numpy(), tks.ks_standard_y0(192))


def test_env_step_matches_vmap_with_blowup():
    """4 envs for 2 steps to te=0.2; env 3 starts above max_value, so the
    blow-up `done` fires there on both sides after the first step."""
    je, te = _env_pair(te_s=0.2)
    x = np.arange(1, 193) * (22.0 / 192)
    y0 = _fields(4, seed=6, amp=0.8)
    y0[3] = 35.0 * np.sin(2 * np.pi * x / 22.0)
    js = jax.vmap(je.reset)(jnp.asarray(y0))
    ts = te.reset(torch.from_numpy(y0))
    jstep = jax.jit(jax.vmap(je.step))
    for i in range(2):
        a = _actions(4, seed=10 + i)
        js = jstep(js, jnp.asarray(a))
        ts = te.step(ts, torch.from_numpy(a))
        np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
        np.testing.assert_array_equal(ts.steps.numpy(), np.asarray(js.steps))
        np.testing.assert_array_equal(ts.time.numpy(), np.asarray(js.time))
        np.testing.assert_allclose(ts.y.numpy(), np.asarray(js.y), rtol=0, atol=2e-4)
        np.testing.assert_allclose(ts.reward.numpy(), np.asarray(js.reward), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(ts.forcing.numpy(), np.asarray(js.forcing), rtol=RTOL, atol=1e-6)
        if i == 0:
            assert ts.done.tolist() == [False, False, False, True]  # blow-up only
    assert ts.done.tolist() == [True, True, True, True]  # t = te after 2 steps
    blown = ts.y.abs().amax(dim=-1) > 30.0
    assert blown.tolist() == [False, False, False, True]


def test_env_nonfinite_field_terminates():
    _, te = _env_pair()
    y0 = _fields(2, seed=7, amp=0.5)
    y0[1, 5] = np.nan
    ts = te.step(te.reset(torch.from_numpy(y0)), torch.zeros(2, 1, 8))
    assert ts.done.tolist() == [False, True]
