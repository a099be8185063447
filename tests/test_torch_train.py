"""The port's batched trainer against the JAX package on the CPU.

The chunk tests carry a JAX `BatchedTrainState` across (networks, Adam
moments, replay, initial fields) and run one 60-step chunk on both sides
with every draw passed in: the test walks the JAX key chain of
`_train_step` (`split(ts.key, 4)`; `act`'s `split` then `normal`;
`split(k_learn, update_loops)` then `replay_sample`'s `randint`;
`_fresh_states`' `randint` over the y0 pool) and hands the draws to the port
as `StepDraws`. On the CPU the port runs K1's plain version. KS22 with te=5
ends every episode at step 50, inside the chunk.
"""

import dataclasses
import functools
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedconvrl_pde_control_tpu.configs import ks as jks
from distributedconvrl_pde_control_tpu.train import batched as jbatched
from distributedconvrl_pde_control_torch.configs import ks as tks
from distributedconvrl_pde_control_torch.experiments import run as trun
from distributedconvrl_pde_control_torch.models.mlp import chain_to_numpy
from distributedconvrl_pde_control_torch.train import checkpoint
from distributedconvrl_pde_control_torch.train.batched import (
    BatchedTrainer,
    BatchedTrainerConfig,
    StepDraws,
    train_batched,
)
from distributedconvrl_pde_control_torch.train.hooks import PDEHook, unpack_records
from distributedconvrl_pde_control_torch.train.records import (
    consume_record_read,
    record_bytes,
    start_record_read,
)

N_ENVS, BATCH, N_STEPS, POOL = 4, 16, 60, 6
SF = dict(stepper="etdrk4", spectral_carry=True, spectral_featurize=True)
# the KS22_tp preset's tiers (tests/test_torch_tiers.py holds its chunk to JAX's)
TP = dict(stepper="etdrk4", fft_mode="matmul_hi", nl_fft_mode="matmul_fast", spectral_carry=True)
# id -> (config overrides, the JAX trainer's TPU layout knobs)
CHUNK_CASES = {"cnab2-unflat": ({}, False), "cnab2-flat": ({}, True), "sf": (SF, True),
               "tp": (TP, True), "tp-matmul": ({**TP, "fft_mode": "matmul", "nl_fft_mode": None}, True)}


def torch_trainer(kw=None, n_envs=N_ENVS, batch=BATCH, pool=None, **cfg_kw):
    setup = tks.build_ks(dataclasses.replace(tks.KS22, **(kw or {})), device="cpu")
    return BatchedTrainer(setup.env, setup.agent,
                          BatchedTrainerConfig(n_envs=n_envs, batch_size=batch, **cfg_kw),
                          random_init=None if pool is not None else setup.random_init,
                          y0_pool=pool)


@functools.lru_cache(maxsize=None)
def jax_chunk(case):
    """One JAX chunk from a fresh state: (initial state as numpy, the pool,
    the draws of every step, final state, packed records)."""
    kw, flat = CHUNK_CASES[case]
    setup = jks.build_ks(dataclasses.replace(jks.KS22, **{"fft_mode": "native", **kw}))
    init = jks.ks_random_init(jks.KS22)
    pool = np.stack([np.asarray(init(k)) for k in jax.random.split(jax.random.PRNGKey(7), POOL)])
    trainer = jbatched.BatchedTrainer(
        setup.env, setup.agent,
        jbatched.BatchedTrainerConfig(n_envs=N_ENVS, batch_size=BATCH, update_loops=1,
                                      min_best_episode=1, flat_obs_state=flat,
                                      flat_action_state=flat),
        y0_pool=pool)
    ts0 = trainer.init(jax.random.PRNGKey(11))
    ts0_np = jax.tree.map(np.array, ts0)
    # the draws, by the key chain of `_train_step`
    n_cols, push, draws, key = N_ENVS * 8, N_ENVS * 8, [], ts0.key
    for step in range(N_STEPS):
        key, k_act, k_learn, k_reset = jax.random.split(key, 4)
        _, k_noise = jax.random.split(k_act)
        size = min((step + 1) * push, ts0.replay.s.shape[1])
        offs = [np.asarray(jax.random.randint(k, (BATCH,), 0, max(size, 1)))
                for k in jax.random.split(k_learn, 1)]
        draws.append(dict(noise=np.asarray(jax.random.normal(k_noise, (1, n_cols))),
                          offs=np.stack(offs),
                          idx=np.asarray(jax.random.randint(k_reset, (N_ENVS,), 0, POOL))))
    ts1, packed = trainer.make_chunk_fn(N_STEPS)(ts0)
    return ts0_np, pool, draws, jax.tree.map(np.asarray, ts1), np.asarray(packed)


def carry_over(trainer, jts):
    """The port's train state from a JAX BatchedTrainState of numpy leaves."""
    tts = trainer.init(torch.Generator().manual_seed(0), y0s=torch.from_numpy(jts.env_states.y))
    tts.agent = checkpoint.ddpg_state_from_jax(trainer.agent, jts.agent, "cpu")
    tts.best_actor = checkpoint.actor_from_jax(jts.best_actor)
    tts.replay = checkpoint.replay_from_jax(jts.replay, "cpu")
    return tts


def as_step_draws(draws):
    return [StepDraws(noise=torch.tensor(d["noise"]), offs=torch.tensor(d["offs"]),
                      idx=torch.tensor(d["idx"])) for d in draws]


def assert_chain_close(chain, want, atol):
    for g, w in zip(chain_to_numpy(chain), want):
        np.testing.assert_allclose(g["w"], w["w"], atol=atol, rtol=0)
        np.testing.assert_allclose(g["b"], w["b"], atol=atol, rtol=0)


def torch_chunk(case, **cfg_kw):
    """The port's chunk on the state and draws of `jax_chunk(case)`."""
    jts0, pool, draws, _, _ = jax_chunk(case)
    trainer = torch_trainer(CHUNK_CASES[case][0], pool=torch.tensor(pool), min_best_episode=1,
                            **cfg_kw)
    tts = carry_over(trainer, jts0)
    assert tts.replay.capacity == jts0.replay.s.shape[1] == 150016  # rounded up to the push width
    np.testing.assert_allclose(tts.obs_flat.numpy(), jts0.obs_flat.reshape(1, -1), atol=1e-6)
    tts, tpacked = trainer.make_chunk_fn(N_STEPS)(tts, as_step_draws(draws))
    return trainer, tts, tpacked


@pytest.fixture(scope="module", params=["cnab2-unflat", "cnab2-flat", "sf"])
def chunk_pair(request):
    """The JAX chunk and the port's chunk on the same state and draws."""
    _, _, _, jts1, jpacked = jax_chunk(request.param)
    return (*torch_chunk(request.param), jts1, jpacked)


def test_chunk_records_match_jax(chunk_pair):
    """Packed records: finished / completed exact (every env finishes at
    step 50 and nowhere else), ep_reward atol 1e-4 on sums of order 15,
    mean_reward atol 1e-5."""
    _, _, tpacked, _, jpacked = chunk_pair
    got = tpacked.numpy()
    assert got.shape == jpacked.shape == (5, N_STEPS, N_ENVS) and got.dtype == np.float32
    np.testing.assert_array_equal(got[0], jpacked[0])
    np.testing.assert_array_equal(got[1], jpacked[1])
    assert got[0].sum() == N_ENVS and got[0, 49].all() and got[1, 49].all()
    assert not got[3].any()
    np.testing.assert_allclose(got[2], jpacked[2], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[4], jpacked[4], atol=1e-5, rtol=0)
    assert np.abs(jpacked[2, 49]).min() > 5.0  # whole episodes' sums, not zeros


def test_chunk_final_state_matches_jax(chunk_pair):
    """Networks (atol 1e-4), replay contents, counters and the on-device
    best-episode tracking after the chunk."""
    trainer, tts, _, jts1, _ = chunk_pair
    for name in ("actor", "critic", "target_actor", "target_critic"):
        assert_chain_close(getattr(tts.agent, name), getattr(jts1.agent, name), atol=1e-4)
    assert_chain_close(tts.best_actor, jts1.best_actor, atol=1e-4)
    assert tts.agent.update_step == int(jts1.agent.update_step) == N_STEPS
    assert float(tts.agent.opt_actor.state[tts.agent.actor.w[0]]["step"]) == float(
        jts1.agent.opt_actor[0].count) == N_STEPS - 2  # learning starts at step 3
    rb = tts.replay
    assert (rb.ptr, rb.size) == (int(jts1.replay.ptr), int(jts1.replay.size)) == (1920, 1920)
    for name in ("s", "a", "r", "t", "sn"):
        np.testing.assert_allclose(getattr(rb, name).numpy()[..., :rb.size],
                                   getattr(jts1.replay, name)[..., :rb.size], atol=1e-4, rtol=0)
        assert not getattr(rb, name)[..., rb.size:].any()
    assert rb.t.sum() == N_ENVS * 8  # one terminal row per actuator and env
    assert int(tts.ep_count) == int(jts1.ep_count) == N_ENVS
    assert int(tts.best_episode) == int(jts1.best_episode) == N_ENVS
    np.testing.assert_allclose(float(tts.best_reward), float(jts1.best_reward), atol=1e-4)
    assert tts.total_env_steps == int(jts1.total_env_steps) == N_STEPS * N_ENVS
    np.testing.assert_allclose(tts.ep_reward.numpy(), jts1.ep_reward, atol=1e-4)
    np.testing.assert_allclose(tts.obs_flat.numpy(), jts1.obs_flat.reshape(1, -1), atol=1e-4)
    np.testing.assert_array_equal(tts.env_states.steps.numpy(), jts1.env_states.steps)
    assert tts.env_states.steps.tolist() == [10] * N_ENVS  # reset at step 50
    if trainer.env.featurize_carry is None:
        np.testing.assert_allclose(tts.env_states.y.numpy(), jts1.env_states.y, atol=1e-3)
    else:  # the sf tier keeps the reset field: a row of the pool
        np.testing.assert_array_equal(tts.env_states.y.numpy(), jts1.env_states.y)


def test_reset_select_is_the_identity_while_no_env_is_done():
    """Fresh states are made and selected every step without reading `done`:
    over 10 steps with no episode end, other reset draws change nothing (bit
    for bit); at the step where every env finishes they decide the fields."""
    jts0, pool, draws, _, _ = jax_chunk("sf")
    trainer = torch_trainer(SF, pool=torch.tensor(pool), min_best_episode=1)
    outs = []
    for shift in (0, 1):
        sd = as_step_draws(draws)
        for d in sd:
            d.idx = (d.idx + shift) % POOL
        tts = carry_over(trainer, jts0)
        tts, packed10 = trainer.make_chunk_fn(10)(tts, sd[:10])
        snap = (packed10, tts.env_states.carry.clone(), tts.agent.actor.w[0].detach().clone())
        tts, packed40 = trainer.make_chunk_fn(40)(tts, sd[10:50])
        outs.append((*snap, packed40, tts.env_states.y.clone()))
    for got, want in zip(outs[0][:3], outs[1][:3]):
        assert torch.equal(got, want)
    assert not outs[0][0][0].any() and outs[0][3][0, 39].all()  # finishes at step 50 only
    for shift, out in enumerate(outs):
        idx = (torch.tensor(draws[49]["idx"]) + shift) % POOL
        assert torch.equal(out[4], torch.tensor(pool)[idx])


def test_records_readers_agree(chunk_pair):
    """unpack_records, and the dense and sparse readers: same dict, same
    values over the finished steps, same step-major order into the hook."""
    _, _, packed, _, _ = chunk_pair
    rec = unpack_records(packed)
    assert rec["finished"].dtype == bool and rec["finished"].shape == (N_STEPS, N_ENVS)
    assert rec["mean_reward"].shape == (N_STEPS,) and not rec["errored"].any()
    np.testing.assert_array_equal(rec["ep_reward"], packed[2].numpy())
    dense = consume_record_read(start_record_read(packed, sparse=False))
    sparse = consume_record_read(start_record_read(packed, sparse=True))
    assert list(dense) == list(sparse) == list(rec)
    assert sparse["finished"].shape == (1, N_ENVS)  # only step 50 carries finishes
    np.testing.assert_array_equal(dense["mean_reward"], sparse["mean_reward"])
    hooks = [PDEHook(), PDEHook(), PDEHook()]
    for hook, r in zip(hooks, (rec, dense, sparse)):
        hook.feed_episode_records(r)
    hooks.append(PDEHook())
    hooks[-1].feed_episode_records(packed)  # the packed form is unpacked on the way in
    assert hooks[0].rewards == packed[2, 49].double().tolist()
    assert all(h.rewards == hooks[0].rewards and h.rewards_compare == hooks[0].rewards
               and h.ep == N_ENVS + 1 for h in hooks)
    empty = consume_record_read(start_record_read(packed[:, :10], sparse=True))
    assert empty["finished"].shape == (0, N_ENVS) and empty["mean_reward"].shape == (10,)
    assert record_bytes(50, 16384) == 16_384_000


def test_feed_episode_records_order_and_errored():
    """Step-major then env order; completed gates rewards_compare; an errored
    flag records the episode index."""
    hook = PDEHook()
    hook.ep = 5
    fin = np.zeros((3, 2), bool)
    fin[0, 1] = fin[2, 0] = fin[2, 1] = True
    rec = {"finished": fin, "completed": fin & np.array([[1, 0], [1, 1], [1, 1]], bool),
           "ep_reward": np.arange(6, dtype=np.float32).reshape(3, 2),
           "errored": fin & np.array([[0, 1], [0, 0], [0, 0]], bool),
           "mean_reward": np.zeros(3, np.float32)}
    hook.feed_episode_records(rec)
    assert hook.rewards == [1.0, 4.0, 5.0] and hook.rewards_compare == [4.0, 5.0]
    assert hook.errored_episodes == [5] and hook.ep == 8
    hook.clamp_rewards(2.0, 4.5)
    assert hook.rewards == [2.0, 4.0, 4.5]
    assert "episodes 1..3" in hook.ascii_curve() and PDEHook().ascii_curve() == "(no episodes)"


def run_sf(total_steps=60, chunk_len=20, seed=3, **kw):
    trainer = torch_trainer(SF, n_envs=4, batch=16, min_best_episode=1)
    return trainer, *train_batched(trainer, total_steps, chunk_len=chunk_len,
                                   generator=torch.Generator().manual_seed(seed), **kw)


def test_pipelined_accounting_matches_depth_one():
    _, ts4, hook4, means4 = run_sf(pipeline_depth=4)
    _, ts1, hook1, means1 = run_sf(pipeline_depth=1, sparse_records=True)
    np.testing.assert_array_equal(means4, means1)
    assert hook4.rewards == hook1.rewards and len(hook4.rewards) == 4
    assert hook4.ep == hook1.ep == int(ts4.ep_count) + 1
    assert hook4.bestreward == hook1.bestreward == pytest.approx(float(ts4.best_reward))
    assert hook4.bestepisode == int(ts4.best_episode) == 4
    assert ts4.replay.size == 60 * 4 * 8


def test_train_batched_with_evals_returns_copies():
    """60 steps with eval_every: finite, `hook.evals` filled, the eval picks
    the best actor, and the actors the hook holds are copies: training
    further changes neither them nor the state's own best snapshot."""
    trainer, ts, hook, means = run_sf(eval_every=20, eval_steps=60, noise_decay_every=20,
                                      noise_decay=0.5)
    assert np.isfinite(means).all() and means.shape == (3,)
    assert [s for s, _ in hook.evals] == [20, 40, 60] and all(np.isfinite(r) for _, r in hook.evals)
    assert hook.bestreward == max(r for _, r in hook.evals)
    assert hook.best_eval_step in (20, 40, 60)
    assert ts.agent.act_noise == pytest.approx(1.2 * 0.5 ** 3)
    best = [dict(w=l["w"].copy(), b=l["b"].copy()) for l in hook.best_actor]
    current = [dict(w=l["w"].copy(), b=l["b"].copy()) for l in hook.current_actor]
    snapshot = chain_to_numpy(ts.best_actor)
    assert all(np.array_equal(c["w"], l["w"]) for c, l in zip(current, chain_to_numpy(ts.agent.actor)))
    before = ts.agent.actor.w[0].detach().clone()
    ts.best_reward.fill_(float("inf"))  # nothing beats it: the snapshot must stay put
    trainer.make_chunk_fn(10)(ts)
    assert not torch.equal(ts.agent.actor.w[0], before)
    for kept, was in ((hook.best_actor, best), (hook.current_actor, current),
                      (chain_to_numpy(ts.best_actor), snapshot)):
        for k, w in zip(kept, was):
            np.testing.assert_array_equal(k["w"], w["w"])
            np.testing.assert_array_equal(k["b"], w["b"])
    # the eval of the trainer scores the hook's actor through actor_from_jax
    r = trainer.eval_mean_reward(checkpoint.actor_from_jax(hook.best_actor), 10)
    assert np.isfinite(r)


def test_warm_start_splices_and_scores_the_given_actor():
    warm = [{"w": np.full((6, 1), 0.1, np.float32), "b": np.zeros(6, np.float32)},
            {"w": np.full((1, 6), -0.2, np.float32), "b": np.zeros(1, np.float32)}]
    trainer, ts, hook, _ = run_sf(total_steps=20, eval_every=20, eval_steps=10,
                                  warm_start={"actor": warm})
    assert hook.evals[0][0] == 0 and len(hook.evals) == 2
    want = trainer.eval_mean_reward(checkpoint.actor_from_jax(warm), 10)
    assert hook.evals[0][1] == pytest.approx(want)
    warm[0]["w"][:] = 7.0  # the state owns its copy
    assert float(ts.agent.actor.w[0].detach().abs().max()) < 1.0


def test_actor_from_jax_owns_its_weights():
    """An optimizer updates a chain in place; the arrays it was made from
    (numpy views of JAX buffers in the parity tests) must not change."""
    src = [{"w": jnp.ones((2, 3)), "b": jnp.zeros(2)}]
    views = [{"w": np.asarray(src[0]["w"]), "b": np.asarray(src[0]["b"])}]
    chain = checkpoint.actor_from_jax(views)
    with torch.no_grad():
        chain.w[0].add_(1.0)
    np.testing.assert_array_equal(np.asarray(src[0]["w"]), 1.0)
    assert float(chain.w[0].detach()[0, 0]) == 2.0


def test_batched_training_beats_no_learning_baseline():
    """The port's twin of the JAX test of that name at a smaller size (600
    steps, ETDRK4 carry tier): same seed, same env stream; the learner ends
    far above the noise-only baseline."""
    setup = tks.build_ks(dataclasses.replace(tks.KS22, stepper="etdrk4", spectral_carry=True),
                         device="cpu")

    def run(learn):
        trainer = BatchedTrainer(setup.env, setup.agent,
                                 BatchedTrainerConfig(n_envs=16, batch_size=128,
                                                      update_loops=4 if learn else 0),
                                 random_init=setup.random_init)
        return train_batched(trainer, total_steps=600, chunk_len=100, noise_decay_every=200,
                             noise_decay=0.1, generator=torch.Generator().manual_seed(0))

    _, _, base = run(False)
    ts, hook, learned = run(True)
    assert np.isfinite(learned).all()
    assert learned[-2:].mean() > base[-2:].mean() + 0.08, (learned, base)
    assert learned[-2:].mean() > 0.25 * base[-2:].mean(), (learned, base)
    assert ts.total_env_steps == 600 * 16
    assert hook.ep - 1 == int(ts.ep_count) and hook.ep > 1
    assert hook.best_actor is not None and np.isfinite(hook.bestreward)


def test_cli_train_then_eval(tmp_path, capsys):
    """`--train --batched --cpu` writes saves/hook.npz and
    config_overrides.json; `--eval --load-from` reads them back (dropping the
    trainer-only sf tier) and evaluates the very actor the hook holds."""
    out = tmp_path / "run"
    trun.main(["KS22", "--train", "--batched", "--cpu", "--n-envs", "4", "--total-steps", "60",
               "--chunk-len", "20", "--learner-batch", "16", "--eval-every", "20",
               "--eval-steps", "10", "--seed", "5", "--capacity", "5000", "--out", str(out),
               "--config-overrides", json.dumps(SF)])
    text = capsys.readouterr().out
    assert "applied config overrides" in text and "evals: [(20," in text
    assert f"saved to {out}; best reward" in text and "240 env steps" in text
    assert checkpoint.load_config_overrides(str(out)) == SF
    hook = checkpoint.load_hook(str(out))
    assert len(hook.rewards) == 4 and hook.ep == 5 and np.isfinite(hook.bestreward)
    with np.load(out / "saves" / "hook.npz") as z:
        assert {"rewards", "rewards_compare", "errored_episodes", "meta", "best_actor_w0",
                "best_actor_b0", "best_actor_w1", "best_actor_b1"} <= set(z.files)
    actor = checkpoint.load_best_actor(str(out))
    np.testing.assert_array_equal(actor[0]["w"], hook.best_actor[0]["w"])
    trun.main(["KS22", "--eval", "--load-from", str(out), "--p-te", "4", "--cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == {"pre_control_mean_abs_dev", "post_control_mean_abs_dev", "suppression"}
    assert np.isfinite(res["post_control_mean_abs_dev"])


def test_held_out_eval_pool_extends_and_is_disjoint():
    setup = tks.build_ks(tks.KS22, device="cpu")
    narrow, wide = trun.held_out_eval_pool(setup, 4), trun.held_out_eval_pool(setup, 9)
    assert torch.equal(wide[:4], narrow) and wide.shape == (9, 192)
    train_pool = setup.random_init(torch.Generator().manual_seed(setup.seed), 32)
    assert not any(torch.equal(w, t) for w in wide for t in train_pool)


NEEDS_2 = r"mesh 2x1 needs 2 devices, have 1 \(hint: --virtual-devices N\)"


# the first six cases were refusals of ROADMAP queue 1 item 15 until the data-parallel
# batched paths were ported; they keep their ids and now hold the JAX CLI's behaviour
@pytest.mark.parametrize("argv,item", [
    pytest.param(["KS22", "--train", "--batched", "--population", "4", "--mesh", "2"], NEEDS_2,
                 id="argv0-item 15"),
    pytest.param(["KS22", "--train", "--batched", "--pop-search", "4", "--mesh", "2"], NEEDS_2,
                 id="argv1-item 15"),
    pytest.param(["KS22", "--train", "--batched", "--virtual-devices", "2", "--mesh", "2",
                  "--n-envs", "4", "--total-steps", "20", "--chunk-len", "10", "--learner-batch",
                  "8", "--capacity", "2048", "--config-overrides", '{"te": 0.5}'], None,
                 id="argv2-item 15"),
    pytest.param(["KS22", "--train", "--batched", "--mesh", "2"], NEEDS_2, id="argv3-item 15"),
    pytest.param(["KS22_tp", "--train", "--batched", "--population", "2", "--mesh", "2"], NEEDS_2,
                 id="argv4-item 15"),
    pytest.param(["Fluid_8", "--train", "--batched", "--mesh", "1x2"],
                 "--batched shards over dp only; use --mesh 1 or 1x1", id="argv5-item 15"),
    (["KellerSegel10_16", "--train", "--batched", "--population", "2", "--pop-overrides",
      '{"gamma": [0.9, 0.99]}'], r"--pop-overrides supports \['act_noise'"),
    (["KellerSegel10_16_fast", "--train", "--batched", "--population", "4", "--pop-overrides",
      '{"act_noise": [1.0, 0.5]}'], r"--pop-overrides\[act_noise\] needs 4 values, got 2"),
    (["KS22", "--train", "--ckpt-backend", "orbax"], "orbax is not installed"),
])
def test_cli_refusals_name_their_queue_item(argv, item, tmp_path, capsys):
    if item is None:  # a small run on 2 gloo ranks, as the JAX CLI runs it on 2 virtual devices
        trun.main(argv + ["--cpu", "--out", str(tmp_path / "run")])
        assert "80 env steps over dp=2" in capsys.readouterr().out
        return
    with pytest.raises(SystemExit, match=item):
        trun.main(argv + ["--cpu"])


def test_cli_virtual_devices_without_mesh_runs_on_the_cpu(tmp_path, capsys):
    """`--virtual-devices N` without `--mesh` runs on the CPU, as the JAX CLI's
    does (no --cpu given: the default device would be the card)."""
    out = str(tmp_path / "run")
    trun.main(["KS22", "--train", "--batched", "--virtual-devices", "2", "--n-envs", "2",
               "--total-steps", "10", "--chunk-len", "5", "--learner-batch", "8", "--capacity",
               "2048", "--config-overrides", '{"te": 0.5}', "--out", out])
    assert "saved to" in capsys.readouterr().out
    _, hook = checkpoint.load(out, tks.build_ks(tks.KS22, device="cpu").agent, device="cpu")
    assert hook.ep - 1 == 4 and np.isfinite(hook.rewards).all()


def test_cli_batched_train_ignores_resume(tmp_path, capsys):
    """`--train --batched --resume` trains afresh, as the JAX CLI's batched
    branch does (it never reads --resume), and says so."""
    out = str(tmp_path / "run")
    argv = ["KS22", "--train", "--batched", "--cpu", "--n-envs", "2", "--total-steps", "10",
            "--chunk-len", "5", "--learner-batch", "8", "--capacity", "2048", "--seed", "5",
            "--out", out]
    trun.main(argv + ["--resume"])
    text = capsys.readouterr().out
    assert "starts afresh" in text and "20 env steps" in text
    first = checkpoint.load_hook(out).rewards
    trun.main(argv)
    assert checkpoint.load_hook(out).rewards == first


def test_cli_ks22_global_hyperopt(capsys):
    """`KS22_global --hyperopt 2` at a toy size: one JSON line per trial and
    the winner, the trials those of numpy's seed."""
    from distributedconvrl_pde_control_tpu.train.hyperopt import sample_trial as jax_sample_trial

    trun.main(["KS22_global", "--hyperopt", "2", "--hyperopt-episodes", "2", "--cpu",
               "--seed", "3"])
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    rng = np.random.default_rng(3)
    for row in lines[:2]:
        want = jax_sample_trial(rng)
        assert {k: row[k] for k in want} == want
        assert row["cost"] is not None and np.isfinite(row["cost"])
    assert lines[2]["best_trial"] in (0, 1) and set(lines[2]) == {"best_trial", "best_cost",
                                                                   "best_params"}


def test_cli_ks22_global_train(tmp_path, capsys):
    """`KS22_global --train` runs the mono agent through the fidelity loop."""
    out = str(tmp_path / "mono")
    trun.main(["KS22_global", "--train", "--cpu", "--loops", "1", "--no-steps", "6",
               "--config-overrides", '{"te": 0.3, "capacity": 1000}', "--out", out])
    assert "loop 1/1" in capsys.readouterr().out
    ts, hook = checkpoint.load(out, tks.build_ks_global(
        dataclasses.replace(tks.KS22_GLOBAL, capacity=1000), device="cpu").agent, device="cpu")
    assert hook.ep - 1 == 2 and ts.replay.size == 6 and ts.replay.s.shape == (8, 1000)


def test_port_imports_without_jax():
    """Every module of the port, chip_smoke.py, bench_torch.py,
    reproduce_torch.py and the two population evaluation scripts import in a
    process where `jax`, `flax`, `optax`, `msgpack`, `h5py`, `matplotlib`
    and the JAX package cannot be."""
    code = """
import importlib, pkgutil, sys
for name in ("jax", "flax", "optax", "msgpack", "h5py", "matplotlib",
             "distributedconvrl_pde_control_tpu"):
    sys.modules[name] = None
import distributedconvrl_pde_control_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names + ["chip_smoke", "bench_torch", "reproduce_torch", "eval_kss_pop_torch",
                     "eval_fluid_pop_torch"]:
    importlib.import_module(name)
assert len(names) > 25, names
new = {"agents.policies", "configs.keller_segel", "ops.fourier", "ops.integrators",
       "ops.keller_segel", "experiments.serve", "experiments.export_controller",
       "train.reference_import", "utils.jld2", "utils.profiling", "utils.resilience",
       "viz.plotting"}
assert {pkg.__name__ + "." + n for n in new} <= set(names), names
print("imported", len(names))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=str(trun.__file__).rsplit("/distributedconvrl_pde_control_torch", 1)[0])
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout
