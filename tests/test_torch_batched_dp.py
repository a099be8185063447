"""The port's data-parallel batched trainer (parallel/batched_dp.py) against
the JAX package's on the CPU; the twin of tests/test_batched_dp.py.

dp 1 runs in this process on a gloo group of one. The larger meshes run in
one world of 4 spawned gloo ranks (`tests/torch_dp_ranks.py`) beside the
JAX references on the conftest's virtual CPU devices: a 30-step chunk at dp 4
on CNAB2 (te=2: episodes end at steps 20, learning from step 7) and a
60-step chunk at dp 2 on ETDRK4 with the spectral carry (episodes end at
step 50), each from JAX's state with JAX's draws for every rank; the
unchanged `train_batched` at dp 4 (200 steps, noise decay) and with
learning off (170 steps), against JAX's driver's accounting; the held-out
eval pool at dp 2. Tolerances: parameters 1e-4 of each tensor's maximum,
mean_reward 1e-4, ep_reward 1e-3, the eval rel 1e-5; finished steps,
episode counts and replay sizes exact; dp 1 against the single-device
trainer: records and obs_flat equal, parameters within 1e-7.
"""

import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor

import flax
import jax
import numpy as np
import pytest
import torch

import torch_dp_ranks as dpr
import torch_mesh_ranks as ranks
from distributedconvrl_pde_control_tpu.configs import ks as jks
from distributedconvrl_pde_control_tpu.experiments import run as jrun
from distributedconvrl_pde_control_tpu.parallel import batched_dp as jdp
from distributedconvrl_pde_control_tpu.train import batched as jbatched
from distributedconvrl_pde_control_torch.configs import ks as tks
from distributedconvrl_pde_control_torch.experiments import run as trun
from distributedconvrl_pde_control_torch.models.mlp import chain_to_numpy
from distributedconvrl_pde_control_torch.parallel.batched_dp import (
    DPBatchedTrainer,
    dp_mesh,
    merge_rank_draws,
)
from distributedconvrl_pde_control_torch.parallel.mesh import RankMesh, launch
from distributedconvrl_pde_control_torch.train import checkpoint
from distributedconvrl_pde_control_torch.train.batched import (
    BatchedTrainer,
    BatchedTrainerConfig,
    StepDraws,
)

POOL = 6
CHUNKS = {  # name -> (dp, KS22 overrides, n_envs, learner batch, steps)
    "dp4-cnab2": (4, {"te": 2.0}, 8, 16, 30),
    "dp2-carry": (2, {"stepper": "etdrk4", "spectral_carry": True}, 4, 16, 60),
}
DRIVERS = {  # name -> (n_envs, learner batch, update loops, seed, train_batched kwargs)
    "driver": (8, 32, 1, 1, dict(total_steps=200, chunk_len=25, noise_decay_every=100,
                                 noise_decay=0.5)),
    "best": (8, 16, 0, 2, dict(total_steps=170, chunk_len=17)),
}


def jkey(seed):
    return jax.random.PRNGKey(seed)


def jsetup(over):
    return jks.build_ks(dataclasses.replace(jks.KS22, **{"fft_mode": "native", **over}))


def jax_dp_draws(jtr, key_rows, n_steps, pool_n):
    """Each rank's draws of `n_steps` JAX train steps: the per-device key
    chain of `_train_step` from the rank's key row."""
    acfg, nl = jtr.agent.cfg, jtr.local.cfg.n_envs
    push, b = nl * acfg.n_actuators, jtr.cfg.batch_size
    out = []
    for key in key_rows:
        steps = []
        for step in range(n_steps):
            key, k_act, k_learn, k_reset = jax.random.split(key, 4)
            _, k_noise = jax.random.split(k_act)
            size = min((step + 1) * push, jtr.capacity_local)
            offs = [np.asarray(jax.random.randint(k, (b,), 0, size))
                    for k in jax.random.split(k_learn, jtr.cfg.update_loops)]
            steps.append({"noise": np.asarray(jax.random.normal(k_noise, (acfg.na_rows, push))),
                          "offs": np.stack(offs),
                          "idx": np.asarray(jax.random.randint(k_reset, (nl,), 0, pool_n))})
        out.append(steps)
    return out


def pool_of(seed, n=POOL):
    init = jks.ks_random_init(jks.KS22)
    return np.stack([np.asarray(init(k)) for k in jax.random.split(jkey(seed), n)])


def jax_chunk(name):
    """(payload for the ranks, run() -> JAX's final state and records)."""
    dp, over, n_envs, batch, n_steps = CHUNKS[name]
    setup = jsetup(over)
    pool = pool_of(7)
    jtr = jdp.DPBatchedTrainer(setup.env, setup.agent,
                               jbatched.BatchedTrainerConfig(n_envs=n_envs, batch_size=batch),
                               jdp.dp_mesh(dp), y0_pool=pool)
    ts0 = jtr.init(jkey(11))
    payload = {"dp": dp, "ks": over, "n_envs": n_envs, "batch": batch, "pool": pool,
               "y0s": np.asarray(ts0.env_states.y),
               "agent": flax.serialization.to_state_dict(jax.tree.map(np.array, ts0.agent)),
               "draws": jax_dp_draws(jtr, np.asarray(ts0.key), n_steps, POOL)}

    def run():
        ts1, packed = jtr.make_chunk_fn(n_steps)(ts0)
        return jtr, jax.tree.map(np.asarray, ts1), np.asarray(packed)

    return payload, run


def jax_driver(name):
    n_envs, batch, loops, seed, kw = DRIVERS[name]
    payload = {"dp": 4, "ks": {}, "n_envs": n_envs, "batch": batch, "update_loops": loops,
               "seed": seed, "kwargs": kw}

    def run():
        setup = jsetup({})
        jtr = jdp.DPBatchedTrainer(setup.env, setup.agent,
                                   jbatched.BatchedTrainerConfig(n_envs=n_envs, batch_size=batch,
                                                                 update_loops=loops),
                                   jdp.dp_mesh(4), random_init=jks.ks_random_init(jks.KS22))
        ts, hook, means = jbatched.train_batched(jtr, key=jkey(seed), **kw)
        return {"means": means, "total_env_steps": int(ts.total_env_steps), "ep": hook.ep,
                "act_noise": float(ts.agent.act_noise)}

    return payload, run


def jax_eval_pools():
    setup = jsetup({})
    train_pool, eval_pool = pool_of(3, 4), pool_of(100, 4)
    actor = setup.agent.init_state(jkey(5)).actor
    jtr = jdp.DPBatchedTrainer(setup.env, setup.agent,
                               jbatched.BatchedTrainerConfig(n_envs=4, batch_size=8,
                                                             update_loops=0),
                               jdp.dp_mesh(2), y0_pool=train_pool, eval_y0_pool=eval_pool)
    k = jkey(2)
    payload = {"dp": 2, "train_pool": train_pool, "eval_pool": eval_pool,
               "actor": jax.tree.map(np.asarray, actor),
               "y0s": np.asarray(jtr.local._fresh_eval_y0s(k, 2))}
    return payload, lambda: jtr.eval_mean_reward(actor, 10, key=k)


# a dp 2 chunk against the single-device chunk at twice the learner batch on the merged
# draws (`merge_rank_draws`): the sf tier, episodes ending at step 15, learning from step 1
MERGED = {"dp": 2, "ks": {"stepper": "etdrk4", "spectral_carry": True, "spectral_featurize": True,
                          "te": 1.5, "update_after": 0},
          "n_envs": 4, "batch": 8, "seed": 3, "steps": 20}


def merged_payload():
    """The rank draws (from a CPU generator) and the fresh state's pool rows."""
    p = dict(MERGED)
    g = torch.Generator().manual_seed(29)
    nl = p["n_envs"] // p["dp"]
    push = nl * tks.KS22.n_actuators
    p["pool"] = tks.ks_random_init(tks.KS22, "cpu")(g, POOL).numpy()
    p["idx0"] = torch.randint(0, POOL, (p["n_envs"],), generator=g).numpy()
    p["draws"] = [[{"noise": torch.randn((1, push), generator=g).numpy(),
                    "offs": torch.randint(0, (i + 1) * push, (1, p["batch"]), generator=g).numpy(),
                    "idx": torch.randint(0, POOL, (nl,), generator=g).numpy()}
                   for i in range(p["steps"])] for _ in range(p["dp"])]
    return p


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX references and the ranks' results of every check, the ranks
    running beside the JAX runs."""
    jobs = {"chunks": {k: jax_chunk(k) for k in CHUNKS},
            "drivers": {k: jax_driver(k) for k in DRIVERS}}
    ev_payload, ev_run = jax_eval_pools()
    payload = {"chunks": {k: p for k, (p, _) in jobs["chunks"].items()},
               "drivers": {k: p for k, (p, _) in jobs["drivers"].items()},
               "eval_pools": ev_payload, "merged": merged_payload()}
    with ThreadPoolExecutor(1) as pool:
        on_ranks = pool.submit(ranks.run_world, dpr.batched_dp_checks, 4,
                               str(tmp_path_factory.mktemp("dp")), payload)
        want = {group: {k: run() for k, (_, run) in jobs[group].items()} for group in jobs}
        want["eval_pools"] = ev_run()
        got = on_ranks.result()
    return want, got


def assert_nets_close(got, want_agent):
    for name in dpr.NETS:
        for g, w in zip(got[name], getattr(want_agent, name)):
            for k in ("w", "b"):
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-4 * np.abs(w[k]).max())


def test_dp1_matches_single_device(tmp_path):
    """At dp 1 (a gloo group of one) the data-parallel trainer is the
    single-device trainer: the same init from the same generator, then a
    12-step chunk (learning from step 7): records, counters and obs_flat
    equal, the replay equal, parameters within 1e-7 (JAX's bound)."""
    setup = tks.build_ks(tks.KS22, device="cpu")
    cfg = BatchedTrainerConfig(n_envs=4, batch_size=16, update_loops=1)

    def run(mesh):
        single = BatchedTrainer(setup.env, setup.agent, cfg, random_init=setup.random_init)
        dp = DPBatchedTrainer(setup.env, setup.agent, cfg, mesh, random_init=setup.random_init)
        t1, t2 = (tr.init(torch.Generator().manual_seed(7)) for tr in (single, dp))
        assert dp.capacity_local == t1.replay.capacity == t2.replay.capacity
        t1, r1 = single.make_chunk_fn(12)(t1)
        t2, r2 = dp.make_chunk_fn(12)(t2)
        return t1, r1, t2, r2, mesh.backend

    t1, r1, t2, r2, backend = launch(run, 1, 1, backend="gloo", store_dir=str(tmp_path))
    assert backend == "gloo"
    assert torch.equal(r1, r2)
    for name in ("total_env_steps", "ep_count", "best_reward", "obs_flat"):
        a, b = getattr(t1, name), getattr(t2, name)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b), name
    for x, y in zip(t1.agent.actor.parameters(), t2.agent.actor.parameters()):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), rtol=0, atol=1e-7)
    assert torch.equal(t1.replay.buf, t2.replay.buf)


@pytest.mark.parametrize("name", list(CHUNKS))
def test_chunk_matches_jax_on_its_draws(world, name):
    """Global accounting and learning: the records in the global (5, steps,
    n_envs) layout, every rank's networks bit-identical, the learner moved
    the parameters as JAX's, the env steps and episodes counted globally."""
    (jtr, js1, jpacked), got = world[0]["chunks"][name], world[1]["chunks"][name]
    dp, _, n_envs, _, n_steps = CHUNKS[name]
    assert got["packed"].shape == jpacked.shape == (5, n_steps, n_envs)
    np.testing.assert_array_equal(got["packed"][[0, 1, 3]], jpacked[[0, 1, 3]])
    np.testing.assert_allclose(got["packed"][2], jpacked[2], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["packed"][4], jpacked[4], atol=1e-4, rtol=0)
    assert got["packed"][0].sum() >= n_envs  # every env finished an episode
    assert_nets_close(got, js1.agent)
    for g, w in zip(got["best_actor"], js1.best_actor):
        np.testing.assert_allclose(g["w"], w["w"], rtol=0, atol=1e-4 * np.abs(w["w"]).max())
    assert got["total_env_steps"] == int(js1.total_env_steps) == n_steps * n_envs
    assert got["ep_count"] == int(js1.ep_count) and got["best_episode"] == int(js1.best_episode)
    np.testing.assert_allclose(got["best_reward"], float(js1.best_reward), atol=1e-3)
    assert got["replay_size"] == int(js1.replay.size)
    assert got["replay_capacity"] == jtr.capacity_local
    assert len(got["every_rank"]) == dp
    for other in got["every_rank"][1:]:
        np.testing.assert_array_equal(other, got["every_rank"][0])


def test_spectral_carry_shards_and_survives_the_reset(world):
    """The carried half-spectrum is each rank's envs' and stays finite across
    the auto-reset (every env reset at step 50)."""
    got = world[1]["chunks"]["dp2-carry"]
    assert got["carry_shape"] == (2, tks.KS22.nx // 2 + 1)
    assert got["carry_finite"] and got["packed"][0, 49].all()


def test_train_batched_runs_unchanged(world):
    """The pipelined driver at dp 4: the hook fed from the global records,
    the noise decayed twice, the device best adopted, the eval finite; the
    same chunk count, env steps, episodes and noise as JAX's driver."""
    want, got = world[0]["drivers"]["driver"], world[1]["drivers"]["driver"]
    assert len(got["means"]) == len(want["means"]) == 8 and np.isfinite(got["means"]).all()
    assert got["total_env_steps"] == want["total_env_steps"] == 200 * 8
    assert got["ep"] == want["ep"] > 1
    assert got["best_actor"] is not None and np.isfinite(got["bestreward"])
    np.testing.assert_allclose(got["act_noise"], want["act_noise"], rtol=1e-6)
    assert got["act_noise"] < tks.KS22.act_noise * 0.5 + 1e-6
    assert np.isfinite(got["eval"])


def test_best_tracking_is_global(world):
    """The best candidate is maximized over dp: the adopted best reward is the
    best of all envs' completed episodes (the hook's own records)."""
    want, got = world[0]["drivers"]["best"], world[1]["drivers"]["best"]
    assert got["rewards"] and got["ep"] == want["ep"]
    np.testing.assert_allclose(got["bestreward"], max(got["rewards"]), atol=1e-5)


def test_eval_y0_pool_is_held_out(world):
    """The eval honours `eval_y0_pool` as the single-device trainer does, and
    on JAX's drawn ICs it gives JAX's eval."""
    want, got = world[0]["eval_pools"], world[1]["eval_pools"]
    assert got["held"] == got["swap"] and got["held"] != got["train"]
    np.testing.assert_allclose(got["given"], want, rtol=1e-5)


def test_dp_refusals():
    setup = tks.build_ks(tks.KS22, device="cpu")
    cfg = BatchedTrainerConfig(n_envs=4, batch_size=8)
    with pytest.raises(ValueError, match="shards only over 'dp'; axis 'sp' has size 2"):
        DPBatchedTrainer(setup.env, setup.agent, cfg, RankMesh(dp=1, sp=2, device="cpu"))
    with pytest.raises(ValueError, match="n_envs=4 must divide by dp=8"):
        DPBatchedTrainer(setup.env, setup.agent, cfg, RankMesh(dp=8, device="cpu"))
    assert dp_mesh(device="cpu").shape == (1, 1)


def test_cli_checkpoint_is_read_by_both_single_device_evals(tmp_path, capsys):
    """`--batched --mesh 2 --virtual-devices 2`: rank 0 prints and saves the
    single-device checkpoint, which the port's and the JAX package's `--eval`
    (without --mesh) both read and evaluate to the same numbers."""
    out = str(tmp_path / "run")
    trun.main(["KS22", "--train", "--batched", "--virtual-devices", "2", "--mesh", "2",
               "--n-envs", "4", "--total-steps", "20", "--chunk-len", "10", "--learner-batch",
               "8", "--capacity", "2048", "--config-overrides", '{"te": 0.5}', "--out", out])
    text = capsys.readouterr().out
    assert text.count("saved to") == 1 and "80 env steps over dp=2" in text
    hook = checkpoint.load_hook(out)
    assert hook.ep - 1 == 16 and np.isfinite(hook.rewards).all()
    argv = ["KS22", "--eval", "--load-from", out, "--p-te", "3", "--p-t-action", "1", "--cpu"]
    trun.main(argv)
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jrun.main(argv + ["--out", str(tmp_path / "jax_eval")])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want) and np.isfinite(got["post_control_mean_abs_dev"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)


def test_dp2_chunk_is_the_single_device_chunk_on_merged_draws(world):
    """The gradient mean over dp of each rank's batch is the gradient of the
    two batches side by side: a single-device chunk at batch 2 x 8 on the
    ranks' draws merged (`merge_rank_draws`) gives the dp 2 chunk's records
    (finished exact, ep_reward 1e-3, mean_reward 1e-4) and networks (1e-4 of
    each tensor's maximum). The smoke's last phase holds the card to this."""
    got, p = world[1]["merged"], merged_payload()  # the payload is drawn from a fixed seed
    setup = tks.build_ks(dataclasses.replace(tks.KS22, **p["ks"]), device="cpu")
    single = BatchedTrainer(setup.env, setup.agent,
                            BatchedTrainerConfig(n_envs=p["n_envs"], batch_size=2 * p["batch"]),
                            y0_pool=torch.from_numpy(p["pool"]))
    ts = single.init(torch.Generator().manual_seed(p["seed"]), idx=torch.from_numpy(p["idx0"]))
    draws = [[StepDraws(**{k: torch.from_numpy(v) for k, v in d.items()}) for d in rank]
             for rank in p["draws"]]
    push = p["n_envs"] // p["dp"] * tks.KS22.n_actuators
    ts, packed = single.make_chunk_fn(p["steps"])(ts, merge_rank_draws(draws, push))
    want = packed.numpy()
    np.testing.assert_array_equal(got["packed"][[0, 1, 3]], want[[0, 1, 3]])
    assert want[0].sum() == p["n_envs"]
    np.testing.assert_allclose(got["packed"][2], want[2], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["packed"][4], want[4], atol=1e-4, rtol=0)
    for name in dpr.NETS:
        for g, w in zip(got[name], chain_to_numpy(getattr(ts.agent, name))):
            for k in ("w", "b"):
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-4 * np.abs(w[k]).max())
