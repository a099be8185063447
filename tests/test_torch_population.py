"""The port's population trainer against the JAX package.

Same numpy inputs and draws through both: the member slot arithmetic; the
population agent's `act`, `sample` and `learn_batch` with per-member learning
rates and noise scales; a P=2 chunk of the fused train step on KS22 (CNAB2 with
the port's plain K1, and the spectral-featurize tier) and on Keller-Segel;
the per-member evaluation scored "mean" and "min"; the member checkpoints read
by the JAX loader; and the schedule search's trials. Also: a member at
learning rate 0 stays frozen, another member's replay region does not reach
a member, and a P=1 chunk is the solo trainer's chunk.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedconvrl_pde_control_tpu.agents import replay as jreplay
from distributedconvrl_pde_control_tpu.configs import keller_segel as jkss
from distributedconvrl_pde_control_tpu.configs import ks as jks
from distributedconvrl_pde_control_tpu.train import checkpoint as jckpt
from distributedconvrl_pde_control_tpu.train import hyperopt as jhyperopt
from distributedconvrl_pde_control_tpu.train import population as jpop
from distributedconvrl_pde_control_tpu.train.batched import BatchedTrainerConfig as JaxBTConfig
from distributedconvrl_pde_control_tpu.train.loop import init_train_state
from distributedconvrl_pde_control_torch.configs import keller_segel as tkss
from distributedconvrl_pde_control_torch.configs import ks as tks
from distributedconvrl_pde_control_torch.experiments import run as trun
from distributedconvrl_pde_control_torch.models.mlp import chain_to_numpy, copy_chain
from distributedconvrl_pde_control_torch.train import checkpoint
from distributedconvrl_pde_control_torch.train import population as tpop
from distributedconvrl_pde_control_torch.train.batched import (
    BatchedTrainer,
    BatchedTrainerConfig,
    StepDraws,
)

SF = dict(stepper="etdrk4", spectral_carry=True, spectral_featurize=True)
P, N_ENVS, BATCH, POOL, STEPS = 2, 4, 16, 6, 20


def key(seed):
    return jax.random.PRNGKey(seed, impl="threefry2x32")


def to_np(tree):
    return jax.tree.map(np.array, tree)


def stacked(chain_np) -> "tpop.Chain":
    """The port's stacked chain from a JAX stacked chain of numpy leaves."""
    return checkpoint.actor_from_jax(chain_np)


def assert_stacked_close(chain, want, atol, of_max=False):
    for g, w in zip(chain_to_numpy(chain), to_np(want)):
        for leaf in ("w", "b"):
            tol = atol * max(np.abs(w[leaf]).max(), 1e-30) if of_max else atol
            np.testing.assert_allclose(g[leaf], w[leaf], atol=tol, rtol=0)


# ------------------------------------------------------------- slots, agent
def test_member_slot_indices_on_jax_draws():
    """JAX's two draws give JAX's slots through the port's arithmetic, and
    every slot lies in its member's region."""
    k, n_chunks, block, batch = key(3), 5, 12, 40
    want = np.asarray(jpop.member_slot_indices(k, n_chunks, 3, block, batch))
    kk, kj = jax.random.split(k)
    k_idx = torch.from_numpy(np.array(jax.random.randint(kk, (3, batch), 0, n_chunks)))
    j_idx = torch.from_numpy(np.array(jax.random.randint(kj, (3, batch), 0, block)))
    got = tpop.member_slots(k_idx, j_idx, block).numpy()
    np.testing.assert_array_equal(got, want)
    drawn = tpop.member_slot_indices(torch.Generator().manual_seed(0), n_chunks, 3, block, 4000)
    assert drawn.shape == (3, 4000)
    member = (drawn % (3 * block)) // block
    assert (member == torch.arange(3)[:, None]).all() and drawn.max() < n_chunks * 3 * block
    assert len(set((drawn // (3 * block)).flatten().tolist())) == n_chunks


LRS = ([1e-3, 4e-3, 2e-4], [3e-3, 1e-3, 6e-4])
NOISE = [0.5, 1.0, 2.0]


@functools.lru_cache(maxsize=None)
def jax_agent_steps():
    """A 3-member JAX PopulationDDPG on KS22 (2 envs per member): its state,
    one `act` and three `sample` + `learn_batch` rounds on a filled replay."""
    jsetup = jks.build_ks(jks.KS22)
    agent = jpop.PopulationDDPG(jsetup.agent.cfg, 3, 2, lr_actor=LRS[0], lr_critic=LRS[1])
    st = agent.init_state(key(4))
    st = st.replace(act_noise=jnp.asarray(NOISE, jnp.float32),
                    update_step=jnp.asarray(50, jnp.int32))
    st0 = to_np(st)
    rng = np.random.default_rng(2)
    cols = 3 * agent.block
    obs = rng.uniform(-1, 1, (1, cols)).astype(np.float32)
    k_act = key(5)
    actions = np.asarray(agent.act(st, jnp.asarray(obs), k_act))
    noise = np.array(jax.random.normal(jax.random.split(k_act)[1], (1, cols)))
    rb = jreplay.replay_init(cols * 6, 1, 1)
    for _ in range(4):  # 4 pushes of every member's columns
        rb = jreplay.replay_push_flat(rb, *(jnp.asarray(x) for x in (
            rng.uniform(-1, 1, (1, cols)), rng.uniform(-1, 1, (1, cols)),
            rng.standard_normal(cols), (rng.uniform(size=cols) < 0.1).astype(np.float32),
            rng.uniform(-1, 1, (1, cols)))))
    rounds = []
    for k in jax.random.split(key(6), 3):
        batch = agent.sample(rb, k, BATCH)
        slots = np.array(jpop.member_slot_indices(k, int(rb.size) // cols, 3, agent.block,
                                                  BATCH))
        st = agent.learn_batch(st, batch)
        rounds.append((slots, to_np(batch), to_np(st)))
    return agent, st0, obs, noise, actions, to_np(rb), rounds


def port_agent(st0, lrs=LRS):
    setup = tks.build_ks(tks.KS22, device="cpu")
    agent = tpop.PopulationDDPG(setup.agent.cfg, 3, 2, lr_actor=lrs[0], lr_critic=lrs[1])
    state = agent.make_state(stacked(st0.actor), stacked(st0.critic),
                             stacked(st0.target_actor), stacked(st0.target_critic))
    state.act_noise = torch.tensor(NOISE)
    state.update_step = 50
    return agent, state


def test_population_agent_matches_jax():
    """`act` (per-member noise scales), `sample` (member regions) and three
    `learn_batch` steps (per-member learning rates) against JAX's."""
    jagent, st0, obs, noise, want_actions, jrb, rounds = jax_agent_steps()
    agent, state = port_agent(st0)
    assert agent.cfg.capacity == 3 * jagent.base_cfg.capacity and agent.block == 16
    got = agent.act(state, torch.from_numpy(obs), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), want_actions, atol=1e-6, rtol=0)
    rb = checkpoint.replay_from_jax(jrb, "cpu")
    for slots, jbatch, jst in rounds:
        batch = agent.sample(rb, BATCH, offs=torch.from_numpy(slots))
        for g, w in zip(batch, jbatch):
            np.testing.assert_array_equal(g.numpy(), w)
        agent.learn_batch(state, batch)
        for name in ("actor", "critic", "target_actor", "target_critic"):
            assert_stacked_close(getattr(state, name), getattr(jst, name), atol=1e-5)
        np.testing.assert_allclose(state.critic_loss.numpy(), jst.critic_loss, rtol=1e-5)
        np.testing.assert_allclose(state.actor_loss.numpy(), jst.actor_loss, rtol=1e-5, atol=1e-7)
    assert state.opt_actor.count == 3
    np.testing.assert_allclose(state.opt_actor.exp_avg_sq[0].numpy(),
                               jst.opt_actor.inner_state[0].nu[0]["w"], rtol=1e-4, atol=1e-12)


def test_members_are_isolated():
    """A member at learning rate 0 keeps its networks; perturbing member 2's
    replay region leaves members 0 and 1 unchanged."""
    jagent, st0, _, _, _, jrb, rounds = jax_agent_steps()
    outs = []
    for perturb in (False, True):
        agent, state = port_agent(st0, ([0.0, 1e-3, 1e-3], [0.0, 1e-3, 1e-3]))
        rb = checkpoint.replay_from_jax(jrb, "cpu")
        if perturb:  # member 2's rows of every push
            rows = torch.arange(rb.size).reshape(-1, 3, agent.block)[:, 2].flatten()
            rb.buf[rows] += 0.5
        for slots, _, _ in rounds:
            agent.learn_batch(state, agent.sample(rb, BATCH, offs=torch.from_numpy(slots)))
        outs.append(state)
    for name in ("actor", "critic"):
        for g, w in zip(chain_to_numpy(getattr(outs[0], name)), to_np(getattr(st0, name))):
            np.testing.assert_array_equal(g["w"][0], w["w"][0])  # lr 0: frozen
            assert np.abs(g["w"][1] - w["w"][1]).max() > 0
        for a, b in zip(chain_to_numpy(getattr(outs[0], name)),
                        chain_to_numpy(getattr(outs[1], name))):
            np.testing.assert_array_equal(a["w"][:2], b["w"][:2])
            assert np.abs(a["w"][2] - b["w"][2]).max() > 0


def test_p1_chunk_is_the_solo_chunk():
    """A P=1 population runs the solo trainer's chunk: the same draws (the
    sampled rows given to both) give the same records, replay and networks."""
    setup = tks.build_ks(dataclasses.replace(tks.KS22, te=1.5), device="cpu")
    pool = setup.random_init(torch.Generator().manual_seed(1), POOL)
    cfg = BatchedTrainerConfig(n_envs=N_ENVS, batch_size=BATCH, min_best_episode=1)
    solo = BatchedTrainer(setup.env, setup.agent, cfg, y0_pool=pool)
    pop = tpop.PopulationTrainer(setup.env, setup.agent, cfg, 1, y0_pool=pool)
    ts_s, ts_p = solo.init(torch.Generator().manual_seed(2)), pop.init(torch.Generator().manual_seed(2))
    for a, b in zip(chain_to_numpy(ts_s.agent.actor), chain_to_numpy(ts_p.agent.actor)):
        np.testing.assert_array_equal(a["w"], b["w"][0])
    gen = torch.Generator().manual_seed(3)
    block = N_ENVS * 8
    draws_s, draws_p = [], []
    for step in range(STEPS):
        k = torch.randint(0, step + 1, (1, BATCH), generator=gen)
        j = torch.randint(0, block, (1, BATCH), generator=gen)
        common = dict(noise=torch.randn((1, block), generator=gen),
                      idx=torch.randint(0, POOL, (N_ENVS,), generator=gen))
        draws_s.append(StepDraws(offs=k * block + j, **common))
        draws_p.append(StepDraws(offs=tpop.member_slots(k, j, block)[None], **common))
    ts_s, rec_s = solo.make_chunk_fn(STEPS)(ts_s, draws_s)
    ts_p, rec_p = pop.make_chunk_fn(STEPS)(ts_p, draws_p)
    np.testing.assert_array_equal(rec_s[:2].numpy(), rec_p[:2].numpy())
    np.testing.assert_allclose(rec_s.numpy(), rec_p.numpy(), atol=1e-5, rtol=0)
    assert rec_s[0].sum() == N_ENVS and ts_p.agent.update_step == STEPS
    np.testing.assert_allclose(ts_s.replay.buf.numpy(), ts_p.replay.buf.numpy(), atol=1e-5)
    for name in ("actor", "critic", "target_actor", "target_critic"):
        for a, b in zip(chain_to_numpy(getattr(ts_s.agent, name)),
                        chain_to_numpy(getattr(ts_p.agent, name))):
            np.testing.assert_allclose(a["w"], b["w"][0], atol=1e-5, rtol=0)
    assert float(ts_s.agent.opt_actor.state[ts_s.agent.actor.w[0]]["step"]) == \
        ts_p.agent.opt_actor.count == STEPS - 2


# ------------------------------------------------------------- P=2 chunks
FAMILIES = {  # id -> (JAX setup, port setup, env config overrides)
    "ks22-cnab2": (lambda o: jks.build_ks(dataclasses.replace(jks.KS22, fft_mode="native", **o)),
                   lambda o: tks.build_ks(dataclasses.replace(tks.KS22, **o), device="cpu"),
                   dict(te=1.5)),
    "ks22-sf": (lambda o: jks.build_ks(dataclasses.replace(jks.KS22, fft_mode="native", **o)),
                lambda o: tks.build_ks(dataclasses.replace(tks.KS22, **o), device="cpu"),
                dict(te=1.5, **SF)),
    "keller-segel": (
        lambda o: jkss.build_keller_segel(dataclasses.replace(jkss.KELLER_SEGEL_10_16_FAST, **o)),
        lambda o: tkss.build_keller_segel(dataclasses.replace(tkss.KELLER_SEGEL_10_16_FAST, **o),
                                          device="cpu"),
        dict(te=15 * 0.006)),
}
CHUNK_LRS = ([5e-4, 2e-3], [1e-3, 4e-3])
CHUNK_NOISE = [0.4, 1.5]


@functools.lru_cache(maxsize=None)
def jax_pop_chunk(family):
    """A JAX P=2 chunk from a fresh state with per-member learning rates and
    noise: (initial state, pool, the draws of every step, final state,
    packed records)."""
    build, _, over = FAMILIES[family]
    jsetup = build(over)
    pool = np.stack([np.asarray(jsetup.random_init(k)) for k in jax.random.split(key(7), POOL)])
    trainer = jpop.PopulationTrainer(jsetup.env, jsetup.agent,
                                     JaxBTConfig(n_envs=N_ENVS, batch_size=BATCH,
                                                 min_best_episode=1),
                                     P, y0_pool=pool, lr_actor=CHUNK_LRS[0],
                                     lr_critic=CHUNK_LRS[1])
    ts0 = trainer.init(key(11))
    ts0 = ts0.replace(agent=ts0.agent.replace(act_noise=jnp.asarray(CHUNK_NOISE, jnp.float32)))
    agent = trainer.agent
    n_act = agent.cfg.n_actuators
    push = P * N_ENVS * n_act
    draws, k = [], ts0.key
    for step in range(STEPS):
        k, k_act, k_learn, k_reset = jax.random.split(k, 4)
        k_start, k_noise = jax.random.split(k_act)
        shape = (agent.cfg.na_rows, push)
        size = min((step + 1) * push, ts0.replay.s.shape[1])
        draws.append(dict(
            noise=np.array(jax.random.normal(k_noise, shape)),
            start=np.array(agent.start_action(k_start, shape, None)),
            offs=np.stack([np.asarray(jpop.member_slot_indices(kl, size // push, P, agent.block,
                                                               BATCH))
                           for kl in jax.random.split(k_learn, 1)]),
            idx=np.array(jax.random.randint(k_reset, (P * N_ENVS,), 0, POOL))))
    ts0_np = to_np(ts0)  # the chunk donates its input state
    ts1, packed = trainer.make_chunk_fn(STEPS)(ts0)
    return ts0_np, pool, draws, to_np(ts1), np.asarray(packed)


def port_pop(family, pool):
    _, tbuild, over = FAMILIES[family]
    setup = tbuild(over)
    return setup, tpop.PopulationTrainer(
        setup.env, setup.agent, BatchedTrainerConfig(n_envs=N_ENVS, batch_size=BATCH,
                                                     min_best_episode=1),
        P, y0_pool=torch.from_numpy(pool), lr_actor=CHUNK_LRS[0], lr_critic=CHUNK_LRS[1])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_p2_chunk_matches_jax(family):
    """Records (finished/completed exact, ep_reward 1e-3, mean_reward 1e-4),
    networks (KS: 1e-4; Keller-Segel: 1e-4 of each tensor's largest value),
    replay and counters after 20 steps with learning and an episode end."""
    jts0, pool, draws, jts1, jpacked = jax_pop_chunk(family)
    _, pop = port_pop(family, pool)
    ts = pop.init(torch.Generator().manual_seed(0), y0s=torch.from_numpy(jts0.env_states.y))
    ag = jts0.agent
    ts.agent = pop.agent.make_state(stacked(ag.actor), stacked(ag.critic))
    ts.agent.act_noise = torch.tensor(CHUNK_NOISE)
    ts.best_actor = copy_chain(ts.agent.actor)
    np.testing.assert_allclose(ts.obs_flat.numpy(), jts0.obs_flat.reshape(ts.obs_flat.shape),
                               atol=1e-6)
    ts, packed = pop.make_chunk_fn(STEPS)(
        ts, [StepDraws(**{k: torch.from_numpy(v) for k, v in d.items()}) for d in draws])
    got = packed.numpy()
    np.testing.assert_array_equal(got[:2], jpacked[:2])
    assert got[0].sum() == P * N_ENVS and got[0, 14].all()
    np.testing.assert_allclose(got[2], jpacked[2], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[4], jpacked[4], atol=1e-4, rtol=0)
    chem = family == "keller-segel"
    for name in ("actor", "critic", "target_actor", "target_critic"):
        assert_stacked_close(getattr(ts.agent, name), getattr(jts1.agent, name), atol=1e-4,
                             of_max=chem)
    assert ts.agent.opt_actor.count == int(np.asarray(jts1.agent.opt_actor.count)[0])
    assert ts.agent.opt_actor.count >= STEPS - 6
    rb = ts.replay
    assert (rb.ptr, rb.size) == (int(jts1.replay.ptr), int(jts1.replay.size))
    np.testing.assert_allclose(rb.r.numpy()[:rb.size], jts1.replay.r[:rb.size], atol=1e-4,
                               rtol=1e-4)
    assert int(ts.ep_count) == int(jts1.ep_count) == P * N_ENVS


@pytest.mark.parametrize("score", ["mean", "min"])
def test_eval_mean_rewards_matches_jax(score):
    """Per-member deterministic evals on the same IC batch, 12 steps past
    the te=1.5 cap after a 3-step warmup."""
    jts0, pool, _, _, _ = jax_pop_chunk("ks22-cnab2")
    build, _, over = FAMILIES["ks22-cnab2"]
    jsetup = build(over)
    jtr = jpop.PopulationTrainer(jsetup.env, jsetup.agent, JaxBTConfig(n_envs=N_ENVS), P,
                                 y0_pool=pool)
    actors = jax.tree.map(jnp.asarray, jts0.agent.actor)
    # perturb member 1 so that the two members score differently
    actors = jax.tree.map(lambda x: x.at[1].multiply(-0.5), actors)
    k = key(12)
    want = jtr.eval_mean_rewards(actors, 12, key=k, warmup_steps=3, score=score)
    drawn = np.array(jtr._local._fresh_eval_y0s(k, N_ENVS))
    _, pop = port_pop("ks22-cnab2", pool)
    got = pop.eval_mean_rewards(stacked(to_np(actors)), 12, warmup_steps=3, score=score,
                                y0s=torch.from_numpy(drawn))
    assert got.shape == (P,) and np.isfinite(want).all() and abs(want[0] - want[1]) > 1e-4
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


# -------------------------------------------- driver, checkpoints, search
def small_population(lrs=None):
    setup = tks.build_ks(dataclasses.replace(tks.KS22, te=1.0), device="cpu")
    pool = setup.random_init(torch.Generator().manual_seed(1), POOL)
    return setup, tpop.PopulationTrainer(
        setup.env, setup.agent, BatchedTrainerConfig(n_envs=N_ENVS, batch_size=BATCH), P,
        y0_pool=pool, lr_actor=lrs, lr_critic=lrs)


def test_train_population_and_save_read_by_jax(tmp_path):
    """Per-member noise decay, eval-selected best actors, and the member
    checkpoints: JAX's `checkpoint.load` reads every member_XX, its actor
    and hook as the port wrote them; population.json ranks the members."""
    setup, pop = small_population(lrs=[1e-3, 3e-3])
    ts, hooks, means = tpop.train_population(
        pop, 40, torch.Generator().manual_seed(4), act_noise=[1.0, 0.5], noise_decay_every=20,
        noise_decay=[0.5, 0.2], chunk_len=10, eval_every=20, eval_steps=5)
    np.testing.assert_allclose(ts.agent.act_noise.numpy(), [0.25, 0.02], rtol=1e-6)
    assert len(means) == 4 and all(len(h.evals) == 2 for h in hooks)
    for i, h in enumerate(hooks):
        assert h.bestreward == max(r for _, r in h.evals) and h.ep == 1 + 4 * N_ENVS
    summary = tpop.save_population(str(tmp_path), pop, ts, hooks, overrides={"te": 1.0})
    assert [r["member"] for r in summary["ranking"]] == list(
        np.argsort([-h.bestreward for h in hooks], kind="stable"))
    assert json.load(open(tmp_path / "population.json")) == json.loads(json.dumps(summary))
    jsetup = jks.build_ks(dataclasses.replace(jks.KS22, te=1.0))
    template = init_train_state(jsetup.env, jsetup.agent, key(0))
    for i in range(P):
        jts, jhook = jckpt.load(str(tmp_path / f"member_{i:02d}"), template)
        for g, w in zip(hooks[i].current_actor, to_np(jts.agent.actor)):
            np.testing.assert_array_equal(g["w"], w["w"])
        for g, w in zip(hooks[i].best_actor, jhook.best_actor):
            np.testing.assert_array_equal(g["w"], w["w"])
        assert int(jts.agent.opt_actor[0].count) == 0  # fresh moments under per-member lrs
        assert float(jts.agent.act_noise) == pytest.approx([0.25, 0.02][i])
        assert jckpt.load_config_overrides(str(tmp_path / f"member_{i:02d}")) == {"te": 1.0}


def test_member_state_keeps_adam_without_per_member_lrs():
    setup, pop = small_population()
    ts, _, _ = tpop.train_population(pop, 20, torch.Generator().manual_seed(5), chunk_len=10)
    st = pop.agent.member_state(ts.agent, 1)
    opt = ts.agent.opt_critic
    assert float(st.opt_critic.state[st.critic.w[0]]["step"]) == opt.count > 0
    np.testing.assert_array_equal(st.opt_critic.state[st.critic.w[1]]["exp_avg"].numpy(),
                                  opt.exp_avg[2][1].numpy())


def test_population_search_draws_jax_trials(capsys):
    """The trials of a seed are JAX's; rounds of `members_per_round`; the
    winner is the best eval-selected trial, as a standalone state."""
    n, seed = 3, 17
    rng = np.random.default_rng(seed)
    want = [jhyperopt.sample_trial(rng, jpop.SCHEDULE_SPACE) for _ in range(n)]
    assert tpop.SCHEDULE_SPACE == jpop.SCHEDULE_SPACE
    setup, _ = small_population()
    pool = setup.random_init(torch.Generator().manual_seed(1), POOL)
    best, trials, best_hook, best_state = tpop.population_search(
        setup.env, setup.agent, BatchedTrainerConfig(n_envs=N_ENVS, batch_size=BATCH), n, 20,
        members_per_round=2, seed=seed, eval_every=10, eval_steps=4, chunk_len=10, y0_pool=pool)
    assert [{k: t[k] for k in want[0]} for t in trials] == want
    assert [t["round"] for t in trials] == [0, 0, 1] and [t["trial"] for t in trials] == [0, 1, 2]
    assert best["reward"] == max(t["eval_reward"] for t in trials)
    assert best["params"] == want[best["trial"]] and best_hook.bestreward == best["reward"]
    assert best_state.actor.w[0].dim() == 2
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 4 and json.loads(lines[-1])["best_trial"] == best["trial"]


# --------------------------------------------------------------------- CLI
BASE = ["--train", "--batched", "--cpu", "--n-envs", "2", "--total-steps", "20", "--chunk-len",
        "10", "--learner-batch", "8", "--capacity", "4096", "--eval-every", "10",
        "--eval-steps", "4"]


def test_cli_population_then_member_eval(tmp_path, capsys):
    out = str(tmp_path / "pop")
    trun.main(["KS22", *BASE, "--population", "2", "--pop-overrides",
               json.dumps({"act_noise": [0.8, 1.6], "learning_rate": [1e-3, 2e-3]}),
               "--out", out, "--config-overrides", json.dumps({"te": 1.0})])
    text = capsys.readouterr().out
    assert f"saved 2 members + population.json to {out}" in text
    ranking = json.load(open(f"{out}/population.json"))["ranking"]
    assert sorted(r["dir"] for r in ranking) == ["member_00", "member_01"]
    trun.main(["KS22", "--eval", "--cpu", "--load-from", f"{out}/member_01", "--p-te", "3",
               "--p-t-action", "1"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(res["suppression"])


def test_cli_pop_search_writes_search_json_and_winner(tmp_path, capsys):
    out = str(tmp_path / "search")
    trun.main(["KellerSegel10_16_fast", *BASE, "--pop-search", "2", "--population", "2",
               "--out", out, "--config-overrides", json.dumps({"te": 0.06})])
    assert f"saved search.json + winner checkpoint to {out}" in capsys.readouterr().out
    search = json.load(open(f"{out}/search.json"))
    assert {"best", "trials", "seed_discipline_note", "search_space_note"} == set(search)
    assert len(search["trials"]) == 2
    hook = checkpoint.load_hook(out)
    assert hook.bestreward == pytest.approx(search["best"]["reward"])
    setup = tkss.build_keller_segel(dataclasses.replace(tkss.KELLER_SEGEL_10_16_FAST, te=0.06),
                                    device="cpu")
    ts, _ = checkpoint.load(out, setup.agent, device="cpu")
    assert all(np.isfinite(p.detach().numpy()).all() for p in ts.agent.actor.parameters())
