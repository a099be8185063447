"""The port's tensor-parallel learn step (parallel/tp.py) against the port's
single-device `learn_batch` and the JAX package's `make_tp_learn_step`.

The setup of tests/test_parallel.py::test_tp_learn_step_matches_single_device
(ns 4, 8 actuators, learner batch 16, critic hidden 160, one sampled batch of
numpy draws), the JAX state passed to the port. The port's step runs on 8
spawned gloo ranks (`tests/torch_dp_ranks.py::tp_checks`), the critic split
over them: one step, and three steps chained on the sharded state (the Adam
moments sharded too), each gathered back to the single-device layout and
held within 1e-5 of the single-device step's networks and of JAX's; every
rank holds 160 / 8 rows of layer 0; the actor's gradient through the
sharded critic (the input-side operator's all-reduce) within 1e-6 of the
single-device gradient. A critic with a middle layer: JAX's layout raises
DuplicateSpecError, the port refuses it naming that fault.
"""

from concurrent.futures import ThreadPoolExecutor

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_ranks as dpr
import torch_mesh_ranks as ranks
from distributedconvrl_pde_control_tpu.agents.ddpg import DDPGAgent as JaxAgent
from distributedconvrl_pde_control_tpu.agents.ddpg import DDPGConfig as JaxConfig
from distributedconvrl_pde_control_tpu.parallel import tp as jtp
from distributedconvrl_pde_control_torch.agents.ddpg import DDPGAgent, DDPGConfig
from distributedconvrl_pde_control_torch.models.mlp import Chain, chain_to_numpy
from distributedconvrl_pde_control_torch.parallel import tp as ttp
from distributedconvrl_pde_control_torch.train import checkpoint

CFG = dict(ns=4, na_rows=1, n_actuators=8, batch_size=16, nna_scale=1.6,
           nna_scale_critic=8.0)  # critic hidden 160 = 8 x 20
STEPS = 3


def batch_np():
    rng = np.random.default_rng(0)
    return tuple(np.asarray(x, np.float32) for x in (
        rng.standard_normal((4, 16)), rng.standard_normal((1, 16)), rng.standard_normal(16),
        np.zeros(16), rng.standard_normal((4, 16))))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX's state, the port's single-device steps, JAX's TP step and the
    ranks' results."""
    jagent = JaxAgent(JaxConfig(**CFG))
    jstate = jagent.init_state(jax.random.PRNGKey(0))
    batch = batch_np()
    payload = {"cfg": CFG, "batch": batch, "steps": STEPS,
               "agent": flax.serialization.to_state_dict(jax.tree.map(np.array, jstate))}
    with ThreadPoolExecutor(1) as pool:
        on_ranks = pool.submit(ranks.run_world, dpr.tp_checks, 8,
                               str(tmp_path_factory.mktemp("tp")), payload)
        jbatch = tuple(jnp.asarray(x) for x in batch)
        jax_tp = jax.tree.map(np.asarray, jtp.make_tp_learn_step(jagent, jtp.make_tp_mesh(8))(
            jstate, jbatch))
        agent = DDPGAgent(DDPGConfig(**CFG))
        single = []
        state = checkpoint.ddpg_state_from_jax(agent, checkpoint._jax_like(payload["agent"]), "cpu")
        tbatch = tuple(torch.from_numpy(x) for x in batch)
        for _ in range(STEPS):
            agent.learn_batch(state, tbatch)
            single.append({n: chain_to_numpy(getattr(state, n)) for n in dpr.NETS}
                          | {"critic_loss": float(state.critic_loss)})
        got = on_ranks.result()
    return {"jax_tp": jax_tp, "single": single, "got": got, "payload": payload}


def assert_nets_close(got, want, atol):
    for name in dpr.NETS:
        for g, w in zip(got[name], want[name]):
            for k in ("w", "b"):
                np.testing.assert_allclose(g[k], np.asarray(w[k]), rtol=0, atol=atol)


def test_one_step_on_8_ranks_matches_single_device_and_jax(world):
    got, single, jax_tp = world["got"], world["single"], world["jax_tp"]
    assert_nets_close(got["one"], single[0], 1e-5)
    assert_nets_close(got["one"], {n: getattr(jax_tp, n) for n in dpr.NETS}, 1e-5)
    np.testing.assert_allclose(got["critic_loss"], single[0]["critic_loss"], atol=1e-5)
    np.testing.assert_allclose(got["critic_loss"], float(jax_tp.critic_loss), atol=1e-5)


def test_chained_sharded_steps_match_single_device(world):
    """Three steps on the sharded state (sharded Adam moments), gathered once
    at the end."""
    assert_nets_close(world["got"]["chained"], world["single"][-1], 1e-5)


def test_every_rank_holds_its_rows_of_layer_0(world):
    hidden = int(np.floor(20 * CFG["nna_scale_critic"]))
    assert world["got"]["rows"] == [[hidden // 8, CFG["ns"] + CFG["na_rows"]]] * 8


def test_actor_gradient_through_the_sharded_critic(world):
    """The gradient of -mean(Q(s, actor(s))) with respect to the actor's
    parameters through the sharded critic: every rank's shard contributes to
    the action's gradient, which the input-side operator all-reduces."""
    agent = DDPGAgent(DDPGConfig(**CFG))
    state = checkpoint.ddpg_state_from_jax(agent, checkpoint._jax_like(world["payload"]["agent"]),
                                           "cpu")
    s = torch.from_numpy(world["payload"]["batch"][0])
    loss = -torch.mean(agent.critic_apply(state.critic, s, agent.actor_apply(state.actor, s)))
    want = torch.autograd.grad(loss, list(state.actor.parameters()))
    for g, w in zip(world["got"]["actor_grads"], want):
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=1e-6 * max(w.abs().max(), 1e-3))
    assert max(np.abs(w.numpy()).max() for w in want) > 1e-3


def test_tp_of_one_rank_is_the_single_device_step():
    agent = DDPGAgent(DDPGConfig(**CFG))
    state = agent.init_state(torch.Generator().manual_seed(3), "cpu")
    batch = tuple(torch.from_numpy(x) for x in batch_np())
    got = ttp.make_tp_learn_step(agent, ttp.make_tp_mesh(1, "cpu"))(state, batch)
    agent.learn_batch(state, batch)
    for name in dpr.NETS:
        for g, w in zip(getattr(got, name).parameters(), getattr(state, name).parameters()):
            np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(), rtol=0, atol=1e-6)


def test_a_middle_layer_critic_is_refused_as_jax_cannot_lay_it_out():
    """JAX's critic_tp_spec gives a middle layer P('tp', 'tp'), which JAX
    refuses when it places the critic; the port refuses the critic naming
    that fault."""
    over = dict(CFG, drop_middle_layer_critic=False)
    jagent = JaxAgent(JaxConfig(**over))
    jstate = jagent.init_state(jax.random.PRNGKey(0))
    assert len(jstate.critic) == 3 and jtp.critic_tp_spec(jstate.critic)[1]["w"] == \
        jax.sharding.PartitionSpec("tp", "tp")
    with pytest.raises(Exception, match="duplicate entries") as exc:
        jtp.shard_agent_state(jstate, jtp.make_tp_mesh(8))
    assert type(exc.value).__name__ == "DuplicateSpecError"
    agent = DDPGAgent(DDPGConfig(**over))
    state = agent.init_state(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="DuplicateSpecError") as refusal:
        ttp.make_tp_learn_step(agent, ttp.make_tp_mesh(1, "cpu"))(state, batch_np())
    assert "tp.py:47" in str(refusal.value)
    with pytest.raises(ValueError, match="middle layer"):
        ttp.critic_tp_spec(Chain([np.zeros((2, 2))] * 3, [np.zeros(2)] * 3))
