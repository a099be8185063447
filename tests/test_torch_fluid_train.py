"""The port's fluid training half (2/3-rule solver, 1x1 mesh) against the JAX
package on the CPU.

The chunk tests carry a JAX `MCState` across (`mc_state_from_jax`: fields,
networks, Adam moments, replay, accounting) and run one 20-step chunk on
both sides with every draw passed in: the test walks the JAX key chain of
`_local_step` (`split(key, 4)`, each part folded with dp index 0; `act`'s
`split` then `normal`; `split(k_learn, update_loops)` then `replay_sample`'s
`randint`; the reset's `randint` over the pool) and hands the draws to the
port as `StepDraws`. JAX runs under a one-device ('dp', 'sp') mesh, the port
runs K2's plain version. The tiny config is that of tests/test_parallel.py
(16x16 grid, 4x4 actuators) with te=0.3 (episodes end at step 15), learning
from step 2 and the start policy until step 3.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from distributedconvrl_pde_control_tpu.configs import fluid as jfluid
from distributedconvrl_pde_control_tpu.parallel import multichip as jmc
from distributedconvrl_pde_control_torch.configs import fluid as tfluid
from distributedconvrl_pde_control_torch.models.mlp import chain_to_numpy
from distributedconvrl_pde_control_torch.parallel import multichip as tmc
from distributedconvrl_pde_control_torch.train import checkpoint
from distributedconvrl_pde_control_torch.train.batched import StepDraws
from distributedconvrl_pde_control_torch.train.hooks import PDEHook, unpack_records
from distributedconvrl_pde_control_torch.train.records import consume_record_read, start_record_read
from distributedconvrl_pde_control_torch.utils import flax_msgpack

N_ENVS, BATCH, N_STEPS, POOL, SEED = 2, 8, 20, 3, 5
BASE = dict(nx=16, sensors_per_axis=4, adaptive=False, te=0.3, start_steps=3, update_after=2)
# id -> config overrides. "y": the field check at 58, between the pool's field
# maxima (53.6, 63.0, 55.2): env 1 starts on the large field and blows up,
# with neighbour jumps > 10, so its episodes are flagged as errored
CHUNK_CASES = {
    "rk4": {},
    "ifrk4": {"stepper": "ifrk4"},
    "y": {"check_max_value": "y", "max_value": 58.0},
    "memory": {"temporal_steps": 2, "memory_size": 1},
}
TCFG = dict(n_envs=N_ENVS, batch_size=BATCH, capacity_per_dp=1000, y0_pool_size=POOL)


def one_device_mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("dp", "sp"))


def jax_trainer(over=None, **tkw):
    cfg = dataclasses.replace(jfluid.FLUID_8, **{**BASE, **(over or {})})
    return jmc.ShardedFluidTrainer(cfg, one_device_mesh(), jmc.ShardedTrainConfig(**{**TCFG, **tkw}))


def torch_trainer(over=None, **tkw):
    cfg = dataclasses.replace(tfluid.FLUID_8, **{**BASE, **(over or {})})
    return tmc.ShardedFluidTrainer(cfg, (1, 1), tmc.ShardedTrainConfig(**{**TCFG, **tkw}),
                                   device="cpu")


def strip_dp(jstate):
    """A JAX MCState of numpy leaves with the replay's dp axis (size 1) gone."""
    return jstate.replace(replay=jax.tree.map(lambda x: x[0], jstate.replay))


def jax_draws(jtr, key, n_steps, global_step=0):
    """The draws of `n_steps` JAX train steps from `key`, by `_local_step`'s
    key chain."""
    acfg, push, draws = jtr.agent.cfg, N_ENVS * jtr.n_act, []
    for step in range(n_steps):
        key, k_act, k_learn, k_reset = jax.random.split(key, 4)
        k_act, k_learn, k_reset = (jax.random.fold_in(k, 0) for k in (k_act, k_learn, k_reset))
        _, k_noise = jax.random.split(k_act)
        size = min((global_step + step + 1) * push, jtr.capacity_per_dp)
        offs = [np.asarray(jax.random.randint(k, (BATCH,), 0, size))
                for k in jax.random.split(k_learn, jtr.tcfg.update_loops)]
        draws.append(StepDraws(
            noise=torch.tensor(np.asarray(jax.random.normal(k_noise, (acfg.na_rows, push)))),
            offs=torch.tensor(np.stack(offs)),
            idx=torch.tensor(np.asarray(jax.random.randint(k_reset, (N_ENVS,), 0, POOL)))))
    return draws


@functools.lru_cache(maxsize=None)
def jax_chunk(case):
    """One JAX chunk from a fresh state: (initial state as numpy, the draws,
    final state as numpy, packed records)."""
    jtr = jax_trainer(CHUNK_CASES[case])
    js0 = jtr.init(jax.random.PRNGKey(3), seed=SEED)
    js0_np = strip_dp(jax.tree.map(np.array, js0))
    draws = jax_draws(jtr, js0.key, N_STEPS)
    js1, packed = jtr.make_chunk_fn(N_STEPS)(js0)
    return js0_np, draws, strip_dp(jax.tree.map(np.asarray, js1)), np.asarray(packed)


@pytest.fixture(scope="module", params=list(CHUNK_CASES))
def chunk_pair(request):
    js0, draws, js1, jpacked = jax_chunk(request.param)
    ttr = torch_trainer(CHUNK_CASES[request.param])
    ts = tmc.mc_state_from_jax(ttr, js0, seed=SEED)
    ts, tpacked = ttr.make_chunk_fn(N_STEPS)(ts, draws)
    return request.param, ts, tpacked.numpy(), js1, jpacked


def assert_chain_close(chain, want, atol):
    for g, w in zip(chain_to_numpy(chain), want):
        np.testing.assert_allclose(g["w"], w["w"], atol=atol, rtol=0)
        np.testing.assert_allclose(g["b"], w["b"], atol=atol, rtol=0)


def test_chunk_records_match_jax(chunk_pair):
    """Packed records: finished / completed / errored exact, ep_reward atol
    1e-4, mean_reward atol 1e-5."""
    case, _, got, _, want = chunk_pair
    assert got.shape == want.shape == (5, N_STEPS, N_ENVS) and got.dtype == np.float32
    for row in (0, 1, 3):
        np.testing.assert_array_equal(got[row], want[row])
    np.testing.assert_allclose(got[2], want[2], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[4], want[4], atol=1e-5, rtol=0)
    assert want[1, 14, 0] == 1.0 and np.abs(want[2, 14, 0]) > 0.2  # a whole episode's sum
    if case == "y":
        assert want[3].sum() == 5 and want[0, :4, 1].all()  # blow-ups, flagged as errored
    else:
        assert want[0].sum() == N_ENVS == want[1].sum() and not want[3].any()


def test_chunk_final_state_matches_jax(chunk_pair):
    """Networks, targets and Adam moments (atol 1e-4), replay rows, fields,
    observations, counters and the on-device best tracking after the chunk."""
    case, ts, _, js1, _ = chunk_pair
    for name in ("actor", "critic", "target_actor", "target_critic"):
        assert_chain_close(getattr(ts.agent, name), getattr(js1.agent, name), atol=1e-4)
    assert_chain_close(ts.best_actor, js1.best_actor, atol=1e-4)
    for opt, chain, jopt in ((ts.agent.opt_actor, ts.agent.actor, js1.agent.opt_actor[0]),
                             (ts.agent.opt_critic, ts.agent.critic, js1.agent.opt_critic[0])):
        assert float(opt.state[chain.w[0]]["step"]) == int(jopt.count) == N_STEPS - 1
        for i, (w, b) in enumerate(zip(chain.w, chain.b)):
            for p, k in ((w, "w"), (b, "b")):
                np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(), jopt.mu[i][k], atol=1e-4)
                np.testing.assert_allclose(opt.state[p]["exp_avg_sq"].numpy(), jopt.nu[i][k],
                                           atol=1e-4)
    assert ts.agent.update_step == int(js1.agent.update_step) == N_STEPS
    assert ts.global_step == int(js1.global_step) == N_STEPS
    rb = ts.replay
    assert rb.capacity == ts.replay.buf.shape[0] == 1024  # 1000 rounded up to the push of 32
    assert (rb.ptr, rb.size) == (int(js1.replay.ptr), int(js1.replay.size)) == (640, 640)
    for name in ("s", "a", "r", "t", "sn"):
        np.testing.assert_allclose(getattr(rb, name).numpy()[..., :rb.size],
                                   getattr(js1.replay, name)[..., :rb.size], atol=1e-4, rtol=0)
    np.testing.assert_allclose(ts.w.numpy(), js1.w, atol=1e-3, rtol=0)
    np.testing.assert_allclose(ts.obs.numpy(), js1.obs, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ts.action.numpy(), js1.action, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(ts.steps.numpy(), js1.steps)
    np.testing.assert_allclose(ts.ep_reward.numpy(), js1.ep_reward, atol=1e-4)
    assert int(ts.ep_count) == int(js1.ep_count) == (7 if case == "y" else N_ENVS)
    assert int(ts.best_episode) == int(js1.best_episode) > 0
    np.testing.assert_allclose(float(ts.best_reward), float(js1.best_reward), atol=1e-4)
    np.testing.assert_allclose(float(ts.mean_reward), float(js1.mean_reward), atol=1e-5)


def test_mc_state_from_jax_and_init_match_jax():
    """The carried state is the JAX state field for field; the port's own
    `init` makes the same pool (bit for bit) and the same initial
    observations from it, and a replay of the rounded capacity."""
    jtr = jax_trainer()
    js0 = jtr.init(jax.random.PRNGKey(3), seed=SEED)
    jnp_state = strip_dp(jax.tree.map(np.array, js0))
    ttr = torch_trainer()
    ts = tmc.mc_state_from_jax(ttr, jnp_state, seed=SEED)
    np.testing.assert_array_equal(ttr.pool.numpy(), np.asarray(jtr.pool))
    for name in ("w", "obs", "action", "steps", "ep_reward"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), getattr(jnp_state, name))
    assert_chain_close(ts.agent.actor, jnp_state.agent.actor, atol=0)
    assert_chain_close(ts.agent.critic, jnp_state.agent.critic, atol=0)
    assert_chain_close(ts.best_actor, jnp_state.best_actor, atol=0)
    assert ts.replay.capacity == 1024 and (ts.replay.ptr, ts.replay.size) == (0, 0)
    assert float(ts.best_reward) == -np.inf and ts.global_step == 0 and int(ts.ep_count) == 0
    own = ttr.init(torch.Generator().manual_seed(0), seed=SEED)
    np.testing.assert_array_equal(own.w.numpy(), jnp_state.w)
    np.testing.assert_allclose(own.obs.numpy(), jnp_state.obs, atol=1e-6, rtol=0)
    own.agent.actor.w[0].data.add_(1.0)  # the snapshot is a copy
    assert not torch.equal(own.best_actor.w[0], own.agent.actor.w[0])


def test_reset_observation_gather_matches_per_step_featurization():
    """The port featurizes the pool once and gathers; JAX featurizes
    `pool[idx]` at every step. Same observations for every row and for a
    gather with repeats."""
    jtr = jax_trainer({"temporal_steps": 2, "memory_size": 1})
    jtr.init(jax.random.PRNGKey(0), seed=SEED)
    ttr = torch_trainer({"temporal_steps": 2, "memory_size": 1})
    ttr.init(torch.Generator().manual_seed(0), seed=SEED)
    idx = np.array([2, 0, 2, 1, 1])
    spec = P(None, "sp", None)
    featurize = shard_map(lambda w, s: jtr._featurize_reset(jtr._sensor_dots(w, s)),
                          mesh=jtr.mesh, in_specs=(spec, spec), out_specs=P(), check_vma=False)
    want = np.asarray(jax.jit(featurize)(jtr.pool[jnp.asarray(idx)], jtr.sensor_kernels))
    got = ttr.pool_obs[torch.tensor(idx)].numpy()
    assert got.shape == want.shape == (5, 19, 16)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert np.abs(want[:, 9:18]).max() > 0.1 and not want[:, 18].any()  # tiled rows, zero memory


def corrupted_fields(n=16):
    w = np.zeros((5, n, n), np.float32)
    w[0, :, n // 2:] = 50.0  # a jump along x
    w[1, n // 2:, :] = 50.0  # a jump along y (across the wrap too)
    w[2] = 50.0  # large but smooth: diverged, not corrupted
    w[3, 3, 4] = np.nan  # NaN does not flag
    w[4] = np.random.default_rng(0).standard_normal((n, n))  # small jumps
    return w


def test_error_flags_match_jax():
    jtr, ttr = jax_trainer(), torch_trainer()
    w = corrupted_fields()
    flags = shard_map(jtr._error_flags, mesh=jtr.mesh, in_specs=(jtr._w_spec,),
                      out_specs=P("dp"), check_vma=False)
    want = np.asarray(jax.jit(flags)(jnp.asarray(w)))
    got = ttr._error_flags(torch.from_numpy(w)).numpy()
    assert got.tolist() == want.tolist() == [True, True, False, False, False]


def test_corrupted_blowup_is_recorded_as_errored():
    """End to end: a blown-up corrupted env finishes errored and the hook
    records its episode; a blown-up smooth env finishes unflagged."""
    ttr = torch_trainer({"check_max_value": "y", "max_value": 3.0}, n_envs=3)
    st = ttr.init(torch.Generator().manual_seed(0), seed=SEED)
    w = corrupted_fields()
    st.w = torch.from_numpy(np.stack([w[0], w[2], 0.01 * w[4]]))
    st, packed = ttr.make_chunk_fn(1)(st)
    rec = unpack_records(packed)
    assert rec["finished"][0].tolist() == [True, True, False]
    assert rec["errored"][0].tolist() == [True, False, False]
    hook = PDEHook(collect_best_trace=False)
    hook.feed_episode_records(packed)
    assert hook.errored_episodes == [1] and hook.ep - 1 == 2


def small_run(**kw):
    ttr = torch_trainer({"te": 0.2}, n_envs=4, chunk_len=10, capacity_per_dp=2048)
    st, hook = tmc.train_sharded(ttr, loops=1, no_steps=20, seed=0, verbose=False, **kw)
    return ttr, st, hook


def test_train_sharded_accounting_and_best_tracking(tmp_path):
    """The twin of the JAX test of that name: 20 steps x 4 envs of 10-step
    episodes finish 8 episodes; the hook, the device counters and the best
    snapshot agree; the light checkpoint gives back the best actor."""
    ttr, st, hook = small_run()
    assert hook.ep - 1 == 8 == int(st.ep_count) and len(hook.rewards) == 8
    assert np.isfinite(hook.bestreward) and hook.bestreward == pytest.approx(float(st.best_reward))
    assert hook.bestreward == pytest.approx(max(hook.rewards_compare))
    assert hook.best_actor is not None and st.replay.size == 20 * 4 * 16
    for a, b in zip(hook.best_actor, chain_to_numpy(st.best_actor)):
        np.testing.assert_array_equal(a["w"], b["w"])
    tmc.save_sharded(str(tmp_path), ttr, st, hook)
    actor = tmc.load_actor_for_eval(str(tmp_path), ttr)
    for a, b in zip(chain_to_numpy(actor), hook.best_actor):
        np.testing.assert_array_equal(a["w"], b["w"])
    agent_state, hook2 = tmc.load_sharded(str(tmp_path), ttr)
    assert hook2.rewards == hook.rewards and agent_state.update_step == 20
    assert_chain_close(agent_state.critic, chain_to_numpy(st.agent.critic), atol=0)


def test_train_sharded_sparse_records_and_depth_match_dense():
    """train_sharded reads its records dense at every pipeline depth with
    the same accounting; the sparse reader of train/records.py (the JAX
    package's choice for large planes) reads a sharded chunk's records to the
    same accounting as the dense one."""
    _, _, dense = small_run()
    ttr = torch_trainer({"te": 0.2}, n_envs=4, chunk_len=10, capacity_per_dp=2048,
                        pipeline_depth=1)
    _, shallow = tmc.train_sharded(ttr, loops=1, no_steps=20, seed=0, verbose=False)
    assert shallow.ep == dense.ep and shallow.rewards == dense.rewards
    assert shallow.errored_episodes == dense.errored_episodes
    assert shallow.bestreward == dense.bestreward
    chunk_fn = ttr.make_chunk_fn(10)
    state = ttr.init(torch.Generator().manual_seed(0), seed=0)
    by_dense, by_sparse = PDEHook(), PDEHook()
    for _ in range(2):
        state, packed = chunk_fn(state)
        by_dense.feed_episode_records(consume_record_read(start_record_read(packed)))
        by_sparse.feed_episode_records(consume_record_read(start_record_read(packed, sparse=True)))
    assert by_dense.ep - 1 == 8 and by_sparse.rewards == by_dense.rewards == dense.rewards
    assert by_sparse.ep == by_dense.ep
    assert by_sparse.errored_episodes == by_dense.errored_episodes


def test_train_sharded_eval_driven_selection():
    """eval_every: deterministic evals every 10 steps (15-step rollouts past
    the 10-step episode cap) drive the hook's best actor, a numpy copy."""
    _, st, hook = small_run(eval_every=10, eval_steps=15)
    steps, rewards = zip(*hook.evals)
    assert steps == (10, 20) and all(np.isfinite(r) for r in rewards)
    assert hook.bestreward == max(rewards) and isinstance(hook.best_actor[0]["w"], np.ndarray)
    before = hook.best_actor[0]["w"].copy()
    st.agent.actor.w[0].data.add_(1.0)
    np.testing.assert_array_equal(hook.best_actor[0]["w"], before)


def test_train_sharded_noise_schedule_and_loop_print(capsys):
    ttr = torch_trainer({"te": 0.2, "noise_decay": 0.5}, chunk_len=10)
    st, hook = tmc.train_sharded(ttr, loops=2, no_steps=10, seed=1)
    out = capsys.readouterr().out
    assert "loop 1/2 noise=1.2000" in out and "loop 2/2 noise=0.6000" in out
    assert st.agent.act_noise == pytest.approx(0.6) and hook.ep - 1 == 2 * N_ENVS
    assert all(-3000.0 <= r <= 0.0 for r in hook.rewards)


def test_train_multi_sharded_numbered_saves(tmp_path):
    """Two experiments of >= 3 episodes each (2 envs of 10-step episodes: two
    rounds each), numbered saves, seeds seed + 7919 n, the restart noise
    decayed once per round."""
    ttr = torch_trainer({"te": 0.2}, chunk_len=10)
    best = tmc.train_multi_sharded(
        ttr, no_episodes=3, n_experiments=2, seed=4, verbose=False,
        save_fn=lambda n, st, hook: tmc.save_sharded(str(tmp_path), ttr, st, hook, number=n))
    assert len(best) == 2 and all(np.isfinite(b) for b in best)
    assert sorted(os.listdir(tmp_path / "saves")) == [
        "agent_light1.msgpack", "agent_light2.msgpack", "hook1.npz", "hook2.npz"]
    for n in (1, 2):
        ts, hook = checkpoint.load(str(tmp_path), ttr.agent, n, "cpu")
        agent_state = ts.agent
        with open(tmp_path / "saves" / f"agent_light{n}.msgpack", "rb") as f:
            assert checkpoint.seed_of_key(flax_msgpack.unpack(f.read())["key"]) == 4 + 7919 * n
        assert hook.ep - 1 == 4 and hook.bestreward == best[n - 1]
        assert agent_state.act_noise == pytest.approx(0.17 * 0.7) and agent_state.update_step == 20
