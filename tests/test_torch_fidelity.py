"""The port's fidelity loop against the JAX package on the CPU.

The episode tests carry a JAX `TrainState` across (networks, Adam moments,
replay) and run one KS22 episode on both sides with every draw passed in:
the test walks the JAX key chain of `make_episode_fn` (`split(key, 3)` per
step; `act`'s `split` then `normal`; `learn_many`'s `split(k_learn,
update_loops)` then `replay_sample`'s `randint` below `size - interleave`)
and hands the draws to the port as `StepDraws`. The `drivers.train` test also passes
JAX's initial fields (`run_min_steps`' `split` then `random_init`). On the
CPU the port runs K1's plain version. te is cut so that learning starts
inside the run (the gate opens once the replay holds more than 80 rows).
"""

import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from distributedconvrl_pde_control_tpu.configs import ks as jks
from distributedconvrl_pde_control_tpu.train import checkpoint as jcheckpoint
from distributedconvrl_pde_control_tpu.train import drivers as jdrivers
from distributedconvrl_pde_control_tpu.train import eval as jeval
from distributedconvrl_pde_control_tpu.train import loop as jloop
from distributedconvrl_pde_control_torch.configs import ks as tks
from distributedconvrl_pde_control_torch.train import checkpoint
from distributedconvrl_pde_control_torch.train import drivers as tdrivers
from distributedconvrl_pde_control_torch.train import eval as teval
from distributedconvrl_pde_control_torch.train import loop as tloop
from distributedconvrl_pde_control_torch.train.batched import StepDraws


def setups(**over):
    """The JAX and the port's KS22 setups with the same overrides."""
    return (jks.build_ks(dataclasses.replace(jks.KS22, fft_mode="native", **over)),
            tks.build_ks(dataclasses.replace(tks.KS22, **over), device="cpu"))


def episode_draws(agent, key, n_steps, size0):
    """The draws of one JAX episode of `n_steps` from the episode key `key`,
    the replay holding `size0` rows at its start (no early termination).
    Returns (draws, the key after the episode)."""
    cfg, draws = agent.cfg, []
    n_cols = cfg.n_rewards if cfg.mono else cfg.n_actuators
    for step in range(n_steps):
        key, k_act, k_learn = jax.random.split(key, 3)
        _, k_noise = jax.random.split(k_act)
        size = min(size0 + step * cfg.interleave, cfg.capacity)
        n_valid = max(size - cfg.interleave, 1)
        offs = np.stack([np.asarray(jax.random.randint(k, (cfg.batch_size,), 0, n_valid))
                         for k in jax.random.split(k_learn, cfg.update_loops)])
        noise = np.asarray(jax.random.normal(k_noise, (cfg.na_rows, n_cols)))
        draws.append(StepDraws(noise=torch.tensor(noise), offs=torch.tensor(offs)))
    return draws, key


def carry_over(tagent, jts):
    """The port's TrainState from a JAX TrainState of numpy leaves."""
    return tloop.TrainState(agent=checkpoint.ddpg_state_from_jax(tagent, jts.agent, "cpu"),
                            replay=checkpoint.replay_from_jax(jts.replay, "cpu"),
                            generator=torch.Generator().manual_seed(0))


def assert_rel(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: max abs difference {err:.3e} > {rel} x {scale:.3e}"


def assert_agent_close(tstate, jstate, rel=1e-4):
    """Networks and Adam moments of the port's state within `rel` of each
    JAX tensor's largest entry; counters and noise equal."""
    got = checkpoint.agent_state_dict(tstate)
    want = serialization.to_state_dict(jax.tree.map(np.asarray, jstate))
    for name in ("actor", "critic", "target_actor", "target_critic"):
        for layer in want[name]:
            for k in ("w", "b"):
                assert_rel(got[name][layer][k], want[name][layer][k], rel, f"{name}.{layer}.{k}")
    for opt in ("opt_actor", "opt_critic"):
        assert int(got[opt]["0"]["count"]) == int(want[opt]["0"]["count"])
        for moment in ("mu", "nu"):
            for layer in want[opt]["0"][moment]:
                for k in ("w", "b"):
                    assert_rel(got[opt]["0"][moment][layer][k], want[opt]["0"][moment][layer][k],
                               rel, f"{opt}.{moment}.{layer}.{k}")
    assert tstate.update_step == int(jstate.update_step)


def assert_replay_equal(rb, jrb):
    assert rb.ptr == int(jrb.ptr) and rb.size == int(jrb.size)
    n = rb.size
    for got, want in ((rb.s, jrb.s), (rb.a, jrb.a), (rb.sn, jrb.sn)):
        np.testing.assert_allclose(got.numpy()[:, :n], np.asarray(want)[:, :n], atol=1e-5, rtol=0)
    for got, want in ((rb.r, jrb.r), (rb.t, jrb.t)):
        np.testing.assert_allclose(got.numpy()[:n], np.asarray(want)[:n], atol=1e-5, rtol=0)


# id -> (setup overrides, the JAX state's seed, the initial field's key)
EPISODE_CASES = {
    # 20 steps: warm-up to step 6, learning from step 12 (size 88 > 80)
    "learning": (dict(te=2.0), 3, 5),
    # the field check trips inside the episode: no push, learning or count after it
    "early-stop": (dict(te=3.0, max_value=4.0), 4, 6),
}


@functools.lru_cache(maxsize=None)
def jax_episode(case):
    over, seed, y0_key = EPISODE_CASES[case]
    jsetup, _ = setups(**over)
    ts0 = jloop.init_train_state(jsetup.env, jsetup.agent, jax.random.PRNGKey(seed))
    y0 = np.asarray(jsetup.random_init(jax.random.PRNGKey(y0_key)))
    n_steps = jsetup.env.max_steps
    draws, _ = episode_draws(jsetup.agent, ts0.key, n_steps, 0)
    ts1, res = jloop.make_episode_fn(jsetup.env, jsetup.agent, learning=True, record=True)(ts0, y0)
    return (jax.tree.map(np.array, ts0), y0, draws, jax.tree.map(np.asarray, ts1),
            jax.tree.map(np.asarray, res))


@pytest.mark.parametrize("case", list(EPISODE_CASES))
def test_episode_matches_jax(case):
    """One episode with learning: networks and Adam moments rel 1e-4,
    reward_sum rel 1e-4, equal steps, completion, counters and replay rows,
    and the recorded traces (frozen after an early stop)."""
    jts0, y0, draws, jts1, jres = jax_episode(case)
    _, tsetup = setups(**EPISODE_CASES[case][0])
    ts = carry_over(tsetup.agent, jts0)
    episode = tloop.make_episode_fn(tsetup.env, tsetup.agent, learning=True, record=True)
    ts, res = episode(ts, torch.tensor(y0), draws)
    assert res.steps == int(jres.steps) and res.completed == bool(jres.completed)
    if case == "early-stop":
        assert 0 < res.steps < tsetup.env.max_steps and not res.completed
    else:
        assert res.steps == tsetup.env.max_steps and res.completed
        assert int(jts1.agent.opt_actor[0].count) == 20 * (res.steps - 11)  # learning ran
    assert_rel(float(res.reward_sum), float(jres.reward_sum), 1e-4, "reward_sum")
    assert_rel(res.step_rewards.numpy(), jres.step_rewards, 1e-4, "step_rewards")
    assert_agent_close(ts.agent, jts1.agent)
    assert_replay_equal(ts.replay, jts1.replay)
    for k in ("y", "action", "forcing", "reward"):
        got, want = getattr(res, f"{k}_trace").numpy(), getattr(jres, f"{k}_trace")
        assert got.shape == want.shape
        assert_rel(got, want, 1e-4, f"{k}_trace")
    assert_rel(res.final_y.numpy(), jres.final_y, 1e-4, "final_y")


def test_evaluation_episode_matches_jax():
    """learning=False with delayed actuation: no noise, no learning, no
    push; the traces of JAX's evaluation episode."""
    jsetup, tsetup = setups(te=1.5)
    jts = jloop.init_train_state(jsetup.env, jsetup.agent, jax.random.PRNGKey(8))
    ts = carry_over(tsetup.agent, jax.tree.map(np.array, jts))
    kw = dict(learning=False, record=True, t_action_steps=4)
    _, jres = jloop.make_episode_fn(jsetup.env, jsetup.agent, **kw)(jts, jsetup.env.y0)
    ts, res = tloop.make_episode_fn(tsetup.env, tsetup.agent, **kw)(ts)
    assert ts.replay.size == 0 and ts.agent.update_step == 0 and res.steps == 15
    assert np.abs(res.action_trace.numpy()[:4]).max() == 0 < np.abs(res.action_trace.numpy()[4:]).max()
    for k in ("y", "action", "reward"):
        assert_rel(getattr(res, f"{k}_trace").numpy(), getattr(jres, f"{k}_trace"), 1e-5, k)


@functools.lru_cache(maxsize=None)
def jax_train():
    """One JAX `drivers.train` loop of 30 steps (three 10-step episodes,
    learning from the second), rewards clamped at -1.5; the port's draws."""
    jsetup, _ = setups(te=1.0)
    jsetup = dataclasses.replace(jsetup, reward_clamp=-1.5)
    seed = 21
    key = jax.random.PRNGKey(seed)
    key, k_init = jax.random.split(key)
    ts0 = jloop.init_train_state(jsetup.env, jsetup.agent, k_init)
    episodes, ekey = [], ts0.key
    for e in range(3):
        key, k0 = jax.random.split(key)
        steps, ekey = episode_draws(jsetup.agent, ekey, 10, 80 * e)
        episodes.append(tdrivers.EpisodeDraws(y0=torch.tensor(np.asarray(jsetup.random_init(k0))),
                                              steps=steps))
    ts1, hook = jdrivers.train(jsetup, loops=1, no_steps=30, seed=seed, verbose=False)
    return jax.tree.map(np.array, ts0), episodes, jax.tree.map(np.asarray, ts1), hook


def test_train_loop_matches_jax():
    """`drivers.train`: the hook's rewards (clamped), best episode and best
    actor, and the final state, on JAX's initial fields and draws."""
    jts0, episodes, jts1, jhook = jax_train()
    _, tsetup = setups(te=1.0)
    tsetup = dataclasses.replace(tsetup, reward_clamp=-1.5)
    ts, hook = tdrivers.train(tsetup, loops=1, no_steps=30, verbose=False,
                              ts=carry_over(tsetup.agent, jts0), draws=iter(episodes))
    assert hook.ep == jhook.ep == 4 and hook.bestepisode == jhook.bestepisode
    assert min(jhook.rewards) == -1.5  # the clamp bit
    np.testing.assert_allclose(hook.rewards, jhook.rewards, rtol=1e-4, atol=0)
    np.testing.assert_allclose(hook.rewards_compare, jhook.rewards_compare, rtol=1e-4, atol=0)
    assert_rel(hook.bestreward, jhook.bestreward, 1e-4, "bestreward")
    for got, want in zip(hook.best_actor, jhook.best_actor):
        assert_rel(got["w"], want["w"], 1e-4, "best actor w")
        assert_rel(got["b"], want["b"], 1e-4, "best actor b")
    assert_rel(hook.best_trace["y"], jhook.best_trace["y"], 1e-4, "best trace")
    assert hook.best_trace["steps"] == jhook.best_trace["steps"] == 10
    assert_agent_close(ts.agent, jts1.agent)
    assert_replay_equal(ts.replay, jts1.replay)
    assert np.float32(ts.agent.act_noise) == np.float32(jts1.agent.act_noise) == np.float32(1.2)


def test_train_multi_numbered_saves(tmp_path):
    """`train_multi` saves each experiment as agent{n}.msgpack / hook{n}.npz,
    which the JAX `checkpoint.load` reads; experiment n is seeded seed + 7919 n."""
    jsetup, tsetup = setups(te=0.3, update_loops=2)
    out = str(tmp_path)
    best = tdrivers.train_multi(
        tsetup, no_episodes=4, n_experiments=2, inner_episodes=2, inner_loops=2,
        save_fn=lambda n, ts, hook: checkpoint.save(out, ts, hook, n), verbose=False)
    assert len(best) == 2 and all(np.isfinite(best))
    assert sorted(os.listdir(os.path.join(out, "saves"))) == [
        "agent1.msgpack", "agent2.msgpack", "hook1.npz", "hook2.npz"]
    template = jloop.init_train_state(jsetup.env, jsetup.agent, jax.random.PRNGKey(0))
    for n in (1, 2):
        jts, jhook = jcheckpoint.load(out, template, number=n)
        ts, hook = checkpoint.load(out, tsetup.agent, number=n, device="cpu")
        assert jhook.ep == hook.ep == 5 and jhook.bestreward == best[n - 1]
        assert np.asarray(jts.key).tolist() == [0, tsetup.seed + 7919 * n]
        assert int(jts.replay.size) == ts.replay.size == 4 * 3 * 8
        np.testing.assert_array_equal(np.asarray(jts.replay.s), ts.replay.s.numpy())


def test_energy_eval_helpers_match_jax():
    """`energy_trace` on real and spectral traces and the active-masked
    `mean_energy`."""
    rng = np.random.default_rng(0)
    y = rng.standard_normal((6, 8, 8)).astype(np.float32)
    for trace in (y, np.fft.fft2(y)):
        np.testing.assert_allclose(teval.energy_trace(trace), jeval.energy_trace(trace),
                                   rtol=1e-12)
    traces = {"y": y, "active": np.array([1, 1, 1, 0, 0, 0], bool)}
    assert teval.mean_energy(traces) == jeval.mean_energy(traces)
    assert np.isnan(teval.mean_energy({"y": y, "active": np.zeros(6, bool)}))
