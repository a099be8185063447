"""The port's DDPG agent and replay buffer against the JAX package on the CPU.

A JAX `DDPGState` / `Replay` is made from a seed, carried across as numpy
with `ddpg_state_from_jax` / `replay_from_jax`, and both sides run the same
function on the same inputs. `jax.random` and torch never share a stream:
the JAX draws (`act`'s `split(key)` then `normal` / `uniform`,
`replay_sample`'s `randint`) are reproduced here by walking the key chain
and handed to the port through its doors (`noise=`, `start=`, `offs=`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedconvrl_pde_control_tpu.agents import ddpg as jddpg
from distributedconvrl_pde_control_tpu.agents import replay as jreplay
from distributedconvrl_pde_control_torch.agents import ddpg as tddpg
from distributedconvrl_pde_control_torch.agents import replay as treplay
from distributedconvrl_pde_control_torch.models.mlp import Chain, chain_to_numpy, copy_chain, init_chain
from distributedconvrl_pde_control_torch.train.checkpoint import (
    actor_from_jax,
    ddpg_state_from_jax,
    replay_from_jax,
)

# a config with every feature on: 3 obs rows of which 1 memory row, 2 action
# rows, a middle layer in the actor, a wider critic
CFG = dict(ns=3, na_rows=2, n_actuators=4, memory_size=1, nna_scale=0.6, nna_scale_critic=1.0,
           drop_middle_layer=False, drop_middle_layer_critic=True, start_steps=2, act_noise=0.7)
N_COLS = 12  # 3 envs x 4 actuators


def agents(**over):
    kw = {**CFG, **over}
    return jddpg.DDPGAgent(jddpg.DDPGConfig(**kw)), tddpg.DDPGAgent(tddpg.DDPGConfig(**kw))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def adam_moments(opt, chain):
    """(mu, nu) of a torch Adam as lists of {"w", "b"} numpy dicts."""
    def pick(key):
        return [{"w": opt.state[w][key].numpy(), "b": opt.state[b][key].numpy()}
                for w, b in zip(chain.w, chain.b)]
    return pick("exp_avg"), pick("exp_avg_sq")


def assert_chain_close(got, want, **tol):
    got = chain_to_numpy(got) if isinstance(got, Chain) else got
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["w"], np.asarray(w["w"]), **tol)
        np.testing.assert_allclose(g["b"], np.asarray(w["b"]), **tol)


def test_init_state_syncs_targets_and_sizes():
    _, tagent = agents()
    st = tagent.init_state(torch.Generator().manual_seed(0), "cpu")
    assert [tuple(w.shape) for w in st.actor.w] == [(6, 3), (6, 6), (2, 6)]
    assert [tuple(w.shape) for w in st.critic.w] == [(20, 5), (1, 20)]
    for w in st.actor.w:  # glorot-uniform: inside the limit, not degenerate
        limit = np.sqrt(6.0 / sum(w.shape))
        assert w.abs().max() <= limit and w.abs().max() > 0.3 * limit
    assert all(not b.any() for b in st.actor.b)
    for net, target in ((st.actor, st.target_actor), (st.critic, st.target_critic)):
        for p, q in zip(net.parameters(), target.parameters()):
            assert torch.equal(p, q) and p.data_ptr() != q.data_ptr()
    assert st.update_step == 0 and st.act_noise == pytest.approx(0.7)
    # another seed, another net; the same seed, the same net
    again = tagent.init_state(torch.Generator().manual_seed(0), "cpu")
    other = tagent.init_state(torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(again.actor.w[0], st.actor.w[0]) and not torch.equal(other.actor.w[0], st.actor.w[0])
    chain = init_chain(torch.Generator().manual_seed(0), [3, 6, 6, 2], "cpu")
    assert torch.equal(chain.w[0], st.actor.w[0])


def test_critic_apply_matches_jax():
    jagent, tagent = agents()
    jst = jagent.init_state(jax.random.PRNGKey(0))
    tst = ddpg_state_from_jax(tagent, np_tree(jst), "cpu")
    rng = np.random.default_rng(0)
    s = rng.uniform(-1, 1, (3, N_COLS)).astype(np.float32)
    a = rng.uniform(-1, 1, (2, N_COLS)).astype(np.float32)
    want = np.asarray(jagent.critic_apply(jst.critic, jnp.asarray(s), jnp.asarray(a)))
    with torch.no_grad():
        got = tagent.critic_apply(tst.critic, torch.from_numpy(s), torch.from_numpy(a)).numpy()
    assert got.shape == want.shape == (1, N_COLS)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("policy", ["zero", "random", "negate"])
@pytest.mark.parametrize("update_step", [2, 3])  # start_steps = 2: warmup on, then off
def test_act_matches_jax(policy, update_step):
    """Noise and start actions given; warmup on and off; the memory row gets
    no noise; all three start policies."""
    jagent, tagent = agents(start_policy=policy, negate_center_row=1)
    jst = jagent.init_state(jax.random.PRNGKey(1)).replace(update_step=jnp.asarray(update_step, jnp.int32))
    tst = ddpg_state_from_jax(tagent, np_tree(jst), "cpu")
    assert tst.update_step == update_step
    obs = np.random.default_rng(2).uniform(-1.5, 1.5, (3, N_COLS)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    k_start, k_noise = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k_noise, (2, N_COLS)))
    start = np.asarray(jagent.start_action(k_start, (2, N_COLS), jnp.asarray(obs)))
    want = np.asarray(jagent.act(jst, jnp.asarray(obs), key, learning=True))
    tobs = torch.from_numpy(obs)
    got = tagent.act(tst, tobs, learning=True, noise=torch.from_numpy(noise),
                     start=torch.from_numpy(start) if policy == "random" else None).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(got).max() <= 1.0
    det = tagent.act(tst, tobs, learning=False).numpy()
    np.testing.assert_allclose(det, np.asarray(jagent.act(jst, jnp.asarray(obs), key, learning=False)),
                               rtol=1e-6, atol=1e-6)
    if update_step > 2:  # past warmup: noise on the first row, none on the memory row
        np.testing.assert_array_equal(got[-1], det[-1])
        assert np.abs(got[0] - det[0]).max() > 0.1
    elif policy == "zero":
        assert not got.any()
    # without the doors the port draws from its generator, reproducibly
    a1 = tagent.act(tst, tobs, torch.Generator().manual_seed(3))
    a2 = tagent.act(tst, tobs, torch.Generator().manual_seed(3))
    assert torch.equal(a1, a2)


def batches(n, size, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield (rng.uniform(-1, 1, (3, size)).astype(np.float32),
               rng.uniform(-1, 1, (2, size)).astype(np.float32),
               rng.uniform(-1, 0, (size,)).astype(np.float32),
               (rng.uniform(0, 1, (size,)) < 0.2).astype(np.float32),
               rng.uniform(-1, 1, (3, size)).astype(np.float32))


def test_learn_batch_three_updates_match_jax():
    """Three consecutive updates from a carried-over state whose Adam moments
    and count are already non-trivial (two JAX updates first), one batch
    each: networks, targets, both Adam moments and both losses after every
    update (atol 1e-6, rtol 1e-5). Three, because the first step after a
    carry-over would hide an offset in Adam's step count."""
    jagent, tagent = agents()
    jst = jagent.init_state(jax.random.PRNGKey(2))
    learn = jax.jit(jagent.learn_batch)
    for batch in batches(2, 32, seed=10):
        jst = learn(jst, tuple(jnp.asarray(x) for x in batch))
    tst = ddpg_state_from_jax(tagent, np_tree(jst), "cpu")
    assert float(tst.opt_actor.state[tst.actor.w[0]]["step"]) == 2.0
    critic_before = copy_chain(tst.critic)
    tol = dict(atol=1e-6, rtol=1e-5)
    for batch in batches(3, 32, seed=11):
        jst = learn(jst, tuple(jnp.asarray(x) for x in batch))
        out = tagent.learn_batch(tst, tuple(torch.from_numpy(x) for x in batch))
        assert out is tst
        for name in ("actor", "critic", "target_actor", "target_critic"):
            assert_chain_close(getattr(tst, name), getattr(jst, name), **tol)
        for opt, chain, jopt in ((tst.opt_actor, tst.actor, jst.opt_actor),
                                 (tst.opt_critic, tst.critic, jst.opt_critic)):
            mu, nu = adam_moments(opt, chain)
            assert_chain_close(mu, jopt[0].mu, **tol)
            assert_chain_close(nu, jopt[0].nu, **tol)
        np.testing.assert_allclose(tst.actor_loss.item(), float(jst.actor_loss), **tol)
        np.testing.assert_allclose(tst.critic_loss.item(), float(jst.critic_loss), **tol)
    assert float(tst.opt_critic.state[tst.critic.w[0]]["step"]) == 5.0 == float(jst.opt_critic[0].count)
    assert not torch.equal(tst.critic.w[0], critic_before.w[0])
    # the actor's loss went through the critic without leaving a gradient on it:
    # the critic's .grad is still the critic loss's own
    assert all(p.grad is not None for p in tst.actor.parameters())
    # targets moved by polyak, and are no alias of the behaviour nets
    assert not torch.equal(tst.target_actor.w[0], tst.actor.w[0])


def test_learn_many_runs_update_loops():
    _, tagent = agents(update_loops=3, batch_size=8)
    tst = tagent.init_state(torch.Generator().manual_seed(0), "cpu")
    rb = treplay.replay_init(64, 3, 2, "cpu")
    for batch in batches(1, 64, seed=4):
        treplay.replay_push_flat(rb, *(torch.from_numpy(x) for x in batch))
    tagent.learn_many(tst, rb, torch.Generator().manual_seed(1))
    assert float(tst.opt_actor.state[tst.actor.w[0]]["step"]) == 3.0
    assert np.isfinite(tst.critic_loss.item())


def push_both(jrb, trb, batch):
    jrb = jreplay.replay_push_flat(jrb, *(jnp.asarray(x) for x in batch))
    treplay.replay_push_flat(trb, *(torch.from_numpy(x) for x in batch))
    return jrb


def assert_replay_equal(trb, jrb):
    for name in ("s", "a", "r", "t", "sn"):
        np.testing.assert_array_equal(getattr(trb, name).numpy(), np.asarray(getattr(jrb, name)))
    assert (trb.ptr, trb.size) == (int(jrb.ptr), int(jrb.size))


@pytest.mark.parametrize("capacity,width", [(24, 8), (20, 8)], ids=["contiguous", "scatter"])
def test_replay_push_and_sample_match_jax(capacity, width):
    """Pushes past the wrap-around on the contiguous path (capacity divides by
    the push width) and on the scatter path, then `replay_sample` with
    `exclude_newest` on the wrapped buffer with the JAX offsets."""
    jrb, trb = jreplay.replay_init(capacity, 3, 2), treplay.replay_init(capacity, 3, 2, "cpu")
    for i, batch in enumerate(batches(4, width, seed=20)):
        jrb = push_both(jrb, trb, batch)
        assert_replay_equal(trb, jrb)
        if i == 1:  # before the wrap: start is slot 0
            assert trb.size < capacity
            key = jax.random.PRNGKey(8)
            offs = np.asarray(jax.random.randint(key, (16,), 0, max(int(jrb.size) - 4, 1)))
            want = jreplay.replay_sample(jrb, key, 16, 4)
            got = treplay.replay_sample(trb, 16, 4, offs=torch.from_numpy(offs))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert trb.size == capacity and trb.ptr == (4 * width) % capacity
    key = jax.random.PRNGKey(9)
    offs = np.asarray(jax.random.randint(key, (16,), 0, capacity - 4))
    want = jreplay.replay_sample(jrb, key, 16, 4)
    got = treplay.replay_sample(trb, 16, 4, offs=torch.from_numpy(offs))
    assert [tuple(g.shape) for g in got] == [(3, 16), (2, 16), (16,), (16,), (3, 16)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the port's own draw stays inside [0, size - exclude_newest): with one
    # valid logical slot every sample is the oldest entry, the one at ptr
    s, *_ = treplay.replay_sample(trb, 8, capacity - 1, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(s.numpy(), np.repeat(trb.s[:, trb.ptr:trb.ptr + 1].numpy(), 8, axis=1))


def test_replay_push_columns_shares_the_terminal_flag():
    jrb, trb = jreplay.replay_init(8, 3, 2), treplay.replay_init(8, 3, 2, "cpu")
    for terminal, batch in zip((False, True), batches(2, 4, seed=30)):
        s, a, r, _, sn = batch
        jrb = jreplay.replay_push_columns(jrb, jnp.asarray(s), jnp.asarray(a), jnp.asarray(r),
                                          terminal, jnp.asarray(sn))
        treplay.replay_push_columns(trb, torch.from_numpy(s), torch.from_numpy(a),
                                    torch.from_numpy(r), terminal, torch.from_numpy(sn))
    assert_replay_equal(trb, jrb)
    assert trb.t.tolist() == [0.0] * 4 + [1.0] * 4


def test_state_and_replay_round_trip_from_jax():
    """`ddpg_state_from_jax` / `replay_from_jax` carry every field over."""
    jagent, tagent = agents()
    jst = jagent.init_state(jax.random.PRNGKey(3))
    for batch in batches(2, 16, seed=40):
        jst = jagent.learn_batch(jst, tuple(jnp.asarray(x) for x in batch))
    jst = jst.replace(act_noise=jnp.asarray(0.35, jnp.float32), update_step=jnp.asarray(17, jnp.int32))
    tst = ddpg_state_from_jax(tagent, np_tree(jst), "cpu")
    for name in ("actor", "critic", "target_actor", "target_critic"):
        assert_chain_close(getattr(tst, name), getattr(jst, name), rtol=0, atol=0)
    mu, nu = adam_moments(tst.opt_critic, tst.critic)
    assert_chain_close(mu, jst.opt_critic[0].mu, rtol=0, atol=0)
    assert_chain_close(nu, jst.opt_critic[0].nu, rtol=0, atol=0)
    assert tst.update_step == 17 and tst.act_noise == pytest.approx(0.35)
    assert tst.critic_loss.item() == pytest.approx(float(jst.critic_loss))
    assert_chain_close(actor_from_jax(np_tree(jst.actor)), jst.actor, rtol=0, atol=0)
    jrb = jreplay.replay_init(20, 3, 2)
    for batch in batches(3, 8, seed=41):
        jrb = jreplay.replay_push_flat(jrb, *(jnp.asarray(x) for x in batch))
    assert_replay_equal(replay_from_jax(np_tree(jrb), "cpu"), jrb)
