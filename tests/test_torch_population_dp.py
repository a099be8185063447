"""The population over a dp mesh (train/population.py with `mesh`) against
the JAX package's on the CPU; the twin of tests/test_population_dp.py.

Every rank runs a local mini-population, P members x (n_envs / n_dp) envs
member-major, so the global env axis is rank-major. dp 1 runs in this
process on a gloo group of one; the rest in one world of 4 spawned gloo
ranks (`tests/torch_dp_ranks.py`) beside the JAX references on the
conftest's virtual CPU devices: a P=2 chunk at dp 2 and at dp 4 (20 steps,
per-member learning rates and noise, learning from step 7, the episodes of
te=1.5 ending at step 15) from JAX's state with JAX's draws for every rank;
member isolation under the dp gradient mean; the record layout routing
members; the driver's per-member schedules, evals and member checkpoints
(read by the JAX loader). Tolerances: parameters 1e-4 of each tensor's
maximum, mean_reward 1e-4, ep_reward 1e-3; finished steps and episode
counts exact; dp 1 against the unsharded population: records equal,
parameters within 1e-7.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_ranks as dpr
import torch_mesh_ranks as ranks
from distributedconvrl_pde_control_tpu.configs import ks as jks
from distributedconvrl_pde_control_tpu.parallel import batched_dp as jdp
from distributedconvrl_pde_control_tpu.train import checkpoint as jckpt
from distributedconvrl_pde_control_tpu.train import population as jpop
from distributedconvrl_pde_control_tpu.train.batched import BatchedTrainerConfig as JaxBTConfig
from distributedconvrl_pde_control_tpu.train.loop import init_train_state
from distributedconvrl_pde_control_torch.configs import ks as tks
from distributedconvrl_pde_control_torch.parallel.mesh import RankMesh, launch
from distributedconvrl_pde_control_torch.train import checkpoint
from distributedconvrl_pde_control_torch.train.batched import BatchedTrainerConfig
from distributedconvrl_pde_control_torch.train.population import PopulationTrainer

P, POOL, BATCH, STEPS = 2, 6, 16, 20
CHUNK_OVER = {"stepper": "etdrk4", "te": 1.5}
LRS = ([5e-4, 2e-3], [1e-3, 4e-3])
NOISE = [0.4, 1.5]
CHUNKS = {"dp2": (2, 4), "dp4": (4, 4)}  # name -> (dp, n_envs per member)


def jkey(seed):
    return jax.random.PRNGKey(seed)


def jax_pool(seed, n):
    init = jks.ks_random_init(jks.KS22)
    return np.stack([np.asarray(init(k)) for k in jax.random.split(jkey(seed), n)])


def jax_pop_chunk(name):
    """(payload for the ranks, run() -> JAX's final state and records)."""
    dp, n_envs = CHUNKS[name]
    setup = jks.build_ks(dataclasses.replace(jks.KS22, fft_mode="native", **CHUNK_OVER))
    pool = jax_pool(7, POOL)
    jtr = jpop.PopulationTrainer(setup.env, setup.agent, JaxBTConfig(n_envs=n_envs,
                                                                     batch_size=BATCH),
                                 P, y0_pool=pool, lr_actor=LRS[0], lr_critic=LRS[1],
                                 mesh=jdp.dp_mesh(dp))
    ts0 = jtr.init(jkey(11))
    ts0 = ts0.replace(agent=ts0.agent.replace(act_noise=jnp.asarray(NOISE, jnp.float32)))
    agent, nl = jtr.agent, n_envs // dp
    push = P * nl * agent.cfg.n_actuators
    shape = (agent.cfg.na_rows, push)
    draws = []
    for k in np.asarray(ts0.key):  # each rank's key chain
        steps = []
        for step in range(STEPS):
            k, k_act, k_learn, k_reset = jax.random.split(k, 4)
            k_start, k_noise = jax.random.split(k_act)
            size = min((step + 1) * push, jtr.base.capacity_local)
            steps.append({
                "noise": np.array(jax.random.normal(k_noise, shape)),
                "start": np.array(agent.start_action(k_start, shape, None)),
                "offs": np.stack([np.asarray(jpop.member_slot_indices(
                    kl, size // push, P, agent.block, BATCH))
                    for kl in jax.random.split(k_learn, 1)]),
                "idx": np.array(jax.random.randint(k_reset, (P * nl,), 0, POOL))})
        draws.append(steps)
    payload = {"dp": dp, "ks": CHUNK_OVER, "n_envs": n_envs, "batch": BATCH, "pool": pool,
               "y0s": np.asarray(ts0.env_states.y), "members": P, "lrs": LRS, "noise": NOISE,
               "agent": {"actor": jax.tree.map(np.array, ts0.agent.actor),
                         "critic": jax.tree.map(np.array, ts0.agent.critic)},
               "draws": draws}

    def run():
        ts1, packed = jtr.make_chunk_fn(STEPS)(ts0)
        return jtr, jax.tree.map(np.asarray, ts1), np.asarray(packed)

    return payload, run


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jobs = {k: jax_pop_chunk(k) for k in CHUNKS}
    out = str(tmp_path_factory.mktemp("popdp_save"))
    small = {"n_envs": 4, "pool": jax_pool(99, 8), "out": out}
    payload = {"chunks": {k: p for k, (p, _) in jobs.items()}, "small": small}
    with ThreadPoolExecutor(1) as pool:
        on_ranks = pool.submit(ranks.run_world, dpr.population_dp_checks, 4,
                               str(tmp_path_factory.mktemp("popdp")), payload)
        want = {k: run() for k, (_, run) in jobs.items()}
        got = on_ranks.result()
    return want, got, out


def test_population_dp1_matches_unsharded(tmp_path):
    """At dp 1 (a gloo group of one) the population over dp is the unsharded
    population: the same init, a 12-step chunk, records and the member
    routing equal, parameters within 1e-7."""
    setup = tks.build_ks(dataclasses.replace(tks.KS22, stepper="etdrk4"), device="cpu")
    pool = setup.random_init(torch.Generator().manual_seed(99), 8)
    cfg = BatchedTrainerConfig(n_envs=4, batch_size=16)

    def run(mesh):
        flat = PopulationTrainer(setup.env, setup.agent, cfg, P, y0_pool=pool)
        dp = PopulationTrainer(setup.env, setup.agent, cfg, P, y0_pool=pool, mesh=mesh)
        t1, t2 = (pop.init(torch.Generator().manual_seed(7)) for pop in (flat, dp))
        (t1, r1), (t2, r2) = flat.make_chunk_fn(12)(t1), dp.make_chunk_fn(12)(t2)
        recs = {"finished": r1[0].numpy(), "ep_reward": r1[2].numpy()}
        return t1, r1, t2, r2, flat.member_records(recs, 1), dp.member_records(recs, 1)

    t1, r1, t2, r2, m1, m2 = launch(run, 1, 1, backend="gloo", store_dir=str(tmp_path))
    assert torch.equal(r1, r2)
    for name in ("total_env_steps", "ep_count", "best_reward", "obs_flat"):
        a, b = getattr(t1, name), getattr(t2, name)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b), name
    assert torch.equal(t1.replay.buf, t2.replay.buf)
    for x, y in zip(t1.agent.actor.parameters(), t2.agent.actor.parameters()):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), rtol=0, atol=1e-7)
    for k in m1:
        np.testing.assert_array_equal(m1[k], m2[k])


@pytest.mark.parametrize("name", list(CHUNKS))
def test_chunk_matches_jax_on_its_draws(world, name):
    (jtr, js1, jpacked), got = world[0][name], world[1]["chunks"][name]
    dp, n_envs = CHUNKS[name]
    assert got["packed"].shape == jpacked.shape == (5, STEPS, P * n_envs)
    np.testing.assert_array_equal(got["packed"][[0, 1, 3]], jpacked[[0, 1, 3]])
    assert got["packed"][0].sum() == P * n_envs and got["packed"][0, 14].all()
    np.testing.assert_allclose(got["packed"][2], jpacked[2], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["packed"][4], jpacked[4], atol=1e-4, rtol=0)
    for net in dpr.NETS:
        for g, w in zip(got[net], getattr(js1.agent, net)):
            for leaf in ("w", "b"):
                w_ = np.asarray(w[leaf])
                np.testing.assert_allclose(g[leaf], w_, rtol=0,
                                           atol=1e-4 * max(np.abs(w_).max(), 1e-30))
    assert got["ep_count"] == int(js1.ep_count) == P * n_envs
    assert got["replay_size"] == int(js1.replay.size)
    assert got["total_env_steps"] == int(js1.total_env_steps) == STEPS * P * n_envs
    for other in got["every_rank"][1:]:
        np.testing.assert_array_equal(other, got["every_rank"][0])


def test_member_isolation_under_the_dp_mean(world):
    """A learning-rate-0 member's stacked parameters stay bit-frozen across a
    learning chunk at dp 2 while its sibling trains."""
    moved, frozen = world[1]["isolation"]
    assert moved > 0.0 and frozen == 0.0


def test_record_layout_routes_members(world):
    """Member 0 (frozen, noise-free) can only repeat the rewards of the pool's
    8 fields (plus each env's first, warm-up episode: at most 12 distinct),
    noisy member 1's rewards are all distinct: a mix-up of the rank-major
    layout would blend noisy columns into member 0's hook."""
    quiet, noisy = world[1]["layout"]
    eps = (340 // 50) * 4
    assert quiet["ep"] - 1 == noisy["ep"] - 1 == eps
    assert len(set(np.round(quiet["rewards"], 4))) <= 12
    assert len(set(np.round(noisy["rewards"], 4))) == len(noisy["rewards"]) == eps


def test_driver_eval_selection_and_save(world):
    """`train_population` unchanged on the dp composition: per-member noise
    decay, eval-driven best actors, standard member checkpoints that the port
    and the JAX package load."""
    got, out = world[1]["driver"], world[2]
    np.testing.assert_allclose(got["act_noise"], [1.2 * 0.5 ** 3, 0.6], rtol=1e-6)
    assert [len(e) for e in got["evals"]] == [2, 2]
    assert np.isfinite(got["bestrewards"]).all() and len(got["summary"]["ranking"]) == 2
    setup = jks.build_ks(dataclasses.replace(jks.KS22, stepper="etdrk4", fft_mode="native"))
    _, hook0 = jckpt.load(f"{out}/member_00", init_train_state(setup.env, setup.agent, jkey(0)))
    assert hook0.best_actor is not None
    tagent = tks.build_ks(tks.KS22, device="cpu").agent
    _, thook = checkpoint.load(f"{out}/member_01", tagent, device="cpu")
    assert thook.best_actor is not None and np.isfinite(thook.bestreward)


def test_requires_divisible_envs():
    setup = tks.build_ks(tks.KS22, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        PopulationTrainer(setup.env, setup.agent, BatchedTrainerConfig(n_envs=4, batch_size=16),
                          P, mesh=RankMesh(dp=8, device="cpu"))
