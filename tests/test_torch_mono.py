"""The port's KS mono ablation and hyperparameter search against the JAX
package on the CPU.

`GlobalFeaturizer`, `build_ks_global` (observation, reward, one env step),
one mono episode with learning on JAX's draws (one column, eight action
rows, interleave 1), `sample_trial` and `search` on the same numpy seed, and
the two search objectives on the same episode rewards, trained actor and
initial fields. On the CPU the port runs K1's plain version.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distributedconvrl_pde_control_tpu.configs import ks as jks
from distributedconvrl_pde_control_tpu.envs import features as jfeat
from distributedconvrl_pde_control_tpu.train import checkpoint as jcheckpoint
from distributedconvrl_pde_control_tpu.train import drivers as jdrivers
from distributedconvrl_pde_control_tpu.train import hyperopt as jhyperopt
from distributedconvrl_pde_control_tpu.train import loop as jloop
from distributedconvrl_pde_control_torch.configs import ks as tks
from distributedconvrl_pde_control_torch.envs import features as tfeat
from distributedconvrl_pde_control_torch.train import checkpoint
from distributedconvrl_pde_control_torch.train import drivers as tdrivers
from distributedconvrl_pde_control_torch.train import hyperopt as thyperopt
from distributedconvrl_pde_control_torch.train import loop as tloop
from test_torch_fidelity import assert_agent_close, assert_rel, assert_replay_equal, carry_over
from test_torch_fidelity import episode_draws

MONO_ART = "artifacts/KS22_global"


def mono_setups(**over):
    return (jks.build_ks_global(dataclasses.replace(jks.KS22_GLOBAL, fft_mode="native", **over)),
            tks.build_ks_global(dataclasses.replace(tks.KS22_GLOBAL, **over), device="cpu"))


@pytest.mark.parametrize("temporal_steps,memory_size", [(1, 0), (2, 1)])
def test_global_featurizer_matches(temporal_steps, memory_size):
    rng = np.random.default_rng(temporal_steps)
    sensors = rng.random((8, 192)).astype(np.float32)
    kw = dict(scale=1.0 / 30, temporal_steps=temporal_steps, memory_size=memory_size)
    jf = jfeat.GlobalFeaturizer(sensor_matrix=sensors, **kw)
    tf = tfeat.GlobalFeaturizer(sensor_matrix=torch.tensor(sensors), **kw)
    assert tf.obs_dim == jf.obs_dim == 8 * temporal_steps + memory_size
    y0, y1 = (rng.standard_normal(192).astype(np.float32) for _ in range(2))
    action = rng.standard_normal((8, 1)).astype(np.float32)
    jobs0 = np.asarray(jf(y0))
    tobs0 = tf(torch.tensor(y0)[None])
    np.testing.assert_allclose(tobs0[0].numpy(), jobs0, rtol=1e-6, atol=1e-7)
    jobs1 = np.asarray(jf(y1, jobs0, action))
    tobs1 = tf(torch.tensor(y1)[None], tobs0, torch.tensor(action)[None])
    np.testing.assert_allclose(tobs1[0].numpy(), jobs1, rtol=1e-6, atol=1e-7)


def test_build_ks_global_matches_jax():
    """The fixed y0 (the same bytes), the networks' sizes, the reset
    observation, and one env step's field, forcing, reward and observation."""
    jsetup, tsetup = mono_setups()
    np.testing.assert_array_equal(tks.ks_global_fixed_y0(), jks.ks_global_fixed_y0())
    np.testing.assert_array_equal(tsetup.env.y0.numpy(), np.asarray(jsetup.env.y0))
    jcfg, tcfg = jsetup.agent.cfg, tsetup.agent.cfg
    assert (tcfg.ns, tcfg.na_rows, tcfg.n_actuators, tcfg.interleave, tcfg.n_rewards) == (
        jcfg.ns, jcfg.na_rows, jcfg.n_actuators, 1, 1) == (8, 8, 1, 1, 1)
    assert tsetup.agent.critic_layer_sizes == [16, 1120, 1] and tcfg.mono and tcfg.capacity == 700_000
    jst, tst = jsetup.env.reset(), tsetup.env.reset()
    np.testing.assert_allclose(tst.obs[0].numpy(), np.asarray(jst.obs), rtol=1e-6, atol=1e-7)
    action = np.random.default_rng(1).uniform(-1, 1, (8, 1)).astype(np.float32)
    jst = jsetup.env.step(jst, action)
    tst = tsetup.env.step(tst, torch.tensor(action)[None])
    assert tst.reward.shape == (1, 1)
    for got, want in ((tst.y[0], jst.y), (tst.forcing[0], jst.forcing), (tst.obs[0], jst.obs),
                      (tst.reward[0], jst.reward)):
        assert_rel(got.numpy(), np.asarray(want), 1e-5, "mono env step")


def test_mono_episode_matches_jax():
    """One mono episode with learning (14 steps, learning from step 12):
    networks and Adam moments rel 1e-4, reward_sum, steps, replay rows. The
    critic is 1120 wide, and float32 rounding of its sums grows in its first
    Adam moment with the updates: the episode is held to 60 updates."""
    jsetup, tsetup = mono_setups(te=1.4)
    ts0 = jloop.init_train_state(jsetup.env, jsetup.agent, jax.random.PRNGKey(2))
    y0 = np.asarray(jsetup.random_init(jax.random.PRNGKey(3)))
    draws, _ = episode_draws(jsetup.agent, ts0.key, 14, 0)
    jts1, jres = jloop.make_episode_fn(jsetup.env, jsetup.agent, learning=True)(ts0, y0)
    ts = carry_over(tsetup.agent, jax.tree.map(np.array, ts0))
    ts, res = tloop.make_episode_fn(tsetup.env, tsetup.agent, learning=True)(
        ts, torch.tensor(y0), draws)
    assert res.steps == int(jres.steps) == 14 and ts.replay.size == 14
    assert int(jts1.agent.opt_critic[0].count) == 20 * 3
    assert_rel(float(res.reward_sum), float(jres.reward_sum), 1e-4, "reward_sum")
    assert_agent_close(ts.agent, jax.tree.map(np.asarray, jts1.agent))
    assert_replay_equal(ts.replay, jax.tree.map(np.asarray, jts1.replay))


@pytest.mark.parametrize("seed", [0, 11])
def test_sample_trial_matches_jax(seed):
    want = jhyperopt.sample_trial(np.random.default_rng(seed))
    got = thyperopt.sample_trial(np.random.default_rng(seed))
    assert got == want and list(got) == list(thyperopt.SEARCH_SPACE) == list(jhyperopt.SEARCH_SPACE)


def test_search_matches_jax_on_a_stub_objective():
    """The same trials, costs and winner for one seed, each trial's setup
    built from the preset with the sampled fields."""
    def objective(setup, n_episodes):
        cfg = setup.agent.cfg
        return cfg.learning_rate * 1e3 + cfg.gamma + n_episodes + (0.5 if cfg.drop_middle_layer else 0)

    def build(pkg):
        return lambda cfg: (jks.build_ks_global(cfg) if pkg == "jax" else
                            tks.build_ks_global(cfg, device="cpu"))

    jbest, jtrials = jhyperopt.search(jks.KS22_GLOBAL, build("jax"), n_trials=3, seed=5,
                                      n_episodes=2, verbose=False, objective=objective)
    tbest, ttrials = thyperopt.search(tks.KS22_GLOBAL, build("torch"), n_trials=3, seed=5,
                                      n_episodes=2, verbose=False, objective=objective)
    strip = [{k: v for k, v in t.items() if k != "seconds"} for t in ttrials]
    assert strip == [{k: v for k, v in t.items() if k != "seconds"} for t in jtrials]
    assert tbest == jbest


def shipped_run(pkg, setup):
    """(ts, hook) of the shipped KS22_global run, as the package's loader
    reads it: what the objectives score in place of a trained candidate."""
    if pkg == "jax":
        template = jloop.init_train_state(setup.env, setup.agent, jax.random.PRNGKey(0))
        return jcheckpoint.load(MONO_ART, template)
    return checkpoint.load(MONO_ART, setup.agent, device="cpu")


def test_hyperopt_objectives_match_jax(monkeypatch):
    """Both objectives score the same training run the same: the reference's
    cost on the hook's rewards, and the robust cost of the best actor
    rolled from the same held-out fields (JAX's keys)."""
    jsetup, tsetup = mono_setups(te=2.0)
    runs = {"jax": shipped_run("jax", jsetup), "torch": shipped_run("torch", tsetup)}
    rewards = [-3.0, -0.4, -0.05, -0.02, -0.3, -0.01]
    for pkg, mod in (("jax", jdrivers), ("torch", tdrivers)):
        ts, hook = runs[pkg]
        hook.rewards = list(rewards)
        monkeypatch.setattr(mod, "run_episodes",
                            lambda setup, n, _r=(ts, hook), _p=pkg: (*_r, None) if _p == "jax" else _r)
    assert tdrivers.hyperopt_objective(tsetup, n_episodes=6) == pytest.approx(
        jdrivers.hyperopt_objective(jsetup, n_episodes=6), rel=1e-12)
    assert tdrivers.hyperopt_cost(rewards, 6) == pytest.approx(0.11 - (0.08 + 0.09), rel=1e-12)
    y0s = [np.asarray(jsetup.random_init(jax.random.PRNGKey(10_000 + i))) for i in range(2)]
    want = jdrivers.hyperopt_objective_robust(jsetup, n_episodes=6, n_eval_inits=2)
    got = tdrivers.hyperopt_objective_robust(tsetup, n_episodes=6, n_eval_inits=2,
                                             eval_y0s=[torch.tensor(y) for y in y0s])
    assert np.isfinite(got) and got == pytest.approx(want, rel=1e-4)


def test_objectives_on_a_toy_budget():
    """Both objectives train a candidate from scratch and score it."""
    _, tsetup = mono_setups(te=0.5, update_loops=2, capacity=1000)
    cost = tdrivers.hyperopt_objective(tsetup, n_episodes=4)
    robust = tdrivers.hyperopt_objective_robust(tsetup, n_episodes=3, n_eval_inits=2)
    assert np.isfinite(cost) and np.isfinite(robust) and robust > 0
