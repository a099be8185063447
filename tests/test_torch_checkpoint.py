"""The port's light agent checkpoint against flax and the JAX package on the CPU.

The port writes `saves/agent_light.msgpack` with a MessagePack codec of its
own (`utils/flax_msgpack.py`): flax and the JAX package's `checkpoint.load`
must read what it writes, and it must read what they wrote, the shipped
artifacts included. The CLI tests train a fluid controller at a toy size
through the port's `--train --mesh 1x1`, evaluate it, and resume it.
"""

import dataclasses
import json
import os

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from distributedconvrl_pde_control_tpu.agents.ddpg import DDPGAgent as JAgent
from distributedconvrl_pde_control_tpu.agents.replay import replay_init as jreplay_init
from distributedconvrl_pde_control_tpu.configs import fluid as jfluid
from distributedconvrl_pde_control_tpu.experiments.run import build_setup
from distributedconvrl_pde_control_tpu.train import checkpoint as jcheckpoint
from distributedconvrl_pde_control_tpu.train.loop import TrainState, init_train_state
from distributedconvrl_pde_control_torch.agents.ddpg import DDPGAgent
from distributedconvrl_pde_control_torch.configs import fluid as tfluid
from distributedconvrl_pde_control_torch.configs import ks as tks
from distributedconvrl_pde_control_torch.experiments import run as trun
from distributedconvrl_pde_control_torch.models.mlp import chain_to_numpy
from distributedconvrl_pde_control_torch.train import checkpoint
from distributedconvrl_pde_control_torch.train.hooks import PDEHook
from distributedconvrl_pde_control_torch.utils import flax_msgpack

FLUID_ART, KS_ART = "artifacts/Fluid_16_256", "artifacts/KS22_sf_lh"


def fluid_agents(cfg=jfluid.FLUID_16_256):
    tcfg = tfluid.PRESETS[cfg.name] if cfg.name in tfluid.PRESETS else cfg
    return DDPGAgent(tfluid.fluid_agent_config(tcfg, 9)), JAgent(jfluid.fluid_agent_config(cfg, 9))


def jax_template(jagent):
    return TrainState(agent=jagent.init_state(jax.random.PRNGKey(0)),
                      replay=jreplay_init(1, jagent.cfg.ns, jagent.cfg.na_rows),
                      key=jax.random.PRNGKey(0))


def assert_state_matches_jax(state, jstate):
    """Every leaf of the port's DDPGState equals the JAX one's."""
    for name in ("actor", "critic", "target_actor", "target_critic"):
        for got, want in zip(chain_to_numpy(getattr(state, name)), getattr(jstate, name)):
            np.testing.assert_array_equal(got["w"], np.asarray(want["w"]))
            np.testing.assert_array_equal(got["b"], np.asarray(want["b"]))
    got = checkpoint.agent_state_dict(state)
    want = serialization.to_state_dict(jax.tree.map(np.asarray, jstate))
    for opt in ("opt_actor", "opt_critic"):
        assert int(got[opt]["0"]["count"]) == int(want[opt]["0"]["count"])
        for moment in ("mu", "nu"):
            for layer in got[opt]["0"][moment]:
                for k in ("w", "b"):
                    np.testing.assert_array_equal(got[opt]["0"][moment][layer][k],
                                                  want[opt]["0"][moment][layer][k])
    assert state.update_step == int(jstate.update_step)
    assert np.float32(state.act_noise) == np.float32(jstate.act_noise)
    assert float(state.critic_loss) == float(jstate.critic_loss)


# ------------------------------------------------------------------ codec
WRITTEN_VALUES = [0, 127, 128, 255, 256, 65536, 2**32, 2**63, "", "k" * 31, "k" * 32, "k" * 300,
                  b"", b"x" * 300, b"x" * 70000, [], [1] * 15, [1] * 16, [1] * 70000, {},
                  {str(i): i for i in range(16)}]
READ_VALUES = WRITTEN_VALUES + [-1, -32, -33, -129, -40000, -2**40, 1.5, None, True, False]


@pytest.mark.parametrize("value", WRITTEN_VALUES, ids=range(len(WRITTEN_VALUES)))
def test_codec_writes_the_bytes_msgpack_writes(value):
    raw = flax_msgpack.pack(value)
    assert raw == msgpack.packb(value, use_bin_type=True)
    assert flax_msgpack.unpack(raw) == value


@pytest.mark.parametrize("value", READ_VALUES, ids=range(len(READ_VALUES)))
def test_codec_reads_what_msgpack_writes(value):
    """The reader takes every type, as it reads files written elsewhere."""
    assert flax_msgpack.unpack(msgpack.packb(value, use_bin_type=True)) == value


@pytest.mark.parametrize("arr", [np.zeros((), np.float32), np.array(7, np.int32),
                                 np.arange(4, dtype=np.uint32),
                                 np.random.default_rng(0).standard_normal((340, 10)).astype(np.float32),
                                 np.zeros((0, 3), np.float32)],
                         ids=["f32-0d", "i32-0d", "u32", "f32-big", "empty-f32"])
def test_codec_arrays_match_flax(arr):
    """flax's ndarray (ext 1; a 0-d float32 is a fixext 16)."""
    tree = {"a": {"0": arr}}
    raw = flax_msgpack.pack(tree)
    assert raw == serialization.msgpack_serialize(tree)
    back, ref = flax_msgpack.unpack(raw)["a"]["0"], serialization.msgpack_restore(raw)["a"]["0"]
    assert back.dtype == ref.dtype and back.shape == ref.shape and np.array_equal(back, ref)


def test_codec_reads_flax_numpy_scalars():
    """flax writes a numpy scalar as ext 3; it reads back as that scalar."""
    raw = serialization.msgpack_serialize({"s": np.float32(2.5), "i": np.int64(-3)})
    got = flax_msgpack.unpack(raw)
    assert got == {"s": 2.5, "i": -3}
    assert type(got["s"]) is np.float32 and type(got["i"]) is np.int64
    with pytest.raises(TypeError):
        flax_msgpack.pack(np.float32(2.5))  # written as 0-d arrays only


def test_codec_refuses_what_it_does_not_know():
    with pytest.raises(ValueError, match="extension type 5"):
        flax_msgpack.unpack(msgpack.packb(msgpack.ExtType(5, b"abc")))
    bf16 = msgpack.ExtType(1, msgpack.packb(([2], "bfloat16", b"\0" * 4), use_bin_type=True))
    with pytest.raises(ValueError, match="bfloat16"):
        flax_msgpack.unpack(msgpack.packb({"x": bf16}, use_bin_type=True))
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.unpack(msgpack.packb(1) + b"\x01")
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.unpack(msgpack.packb("abcdef")[:3])
    for arr in (np.array(["a"]), np.zeros(2, np.float64)):  # written: float32, int32, uint32
        with pytest.raises(ValueError, match="dtype"):
            flax_msgpack.pack(arr)
    with pytest.raises(ValueError, match="non-negative"):
        flax_msgpack.pack(-1)
    for value in ({1: 2}, object(), None, True, 1.5, (1,), bytearray(b"x")):
        with pytest.raises(TypeError):
            flax_msgpack.pack(value)


# -------------------------------------------------------- agent checkpoint
@pytest.mark.parametrize("art", [FLUID_ART, KS_ART])
def test_port_reads_the_shipped_light_states(art):
    """The shipped light states, leaf for leaf as the JAX `checkpoint.load`
    gives them; the hook as well."""
    if art == FLUID_ART:
        agent, jagent = fluid_agents()
        template = jax_template(jagent)
    else:
        agent = tks.build_ks(tks.KS22, device="cpu").agent
        setup = build_setup("KS22")
        template = init_train_state(setup.env, setup.agent, jax.random.PRNGKey(0))
    state, hook = checkpoint.load_light(art, agent, device="cpu")
    ts, jhook = jcheckpoint.load(art, template)
    assert_state_matches_jax(state, ts.agent)
    assert state.update_step > 0 and float(state.critic_loss) != 0.0
    assert hook.rewards == list(jhook.rewards) and hook.bestreward == jhook.bestreward
    with open(os.path.join(art, "saves", "agent_light.msgpack"), "rb") as f:
        np.testing.assert_array_equal(flax_msgpack.unpack(f.read())["key"], np.asarray(ts.key))


def test_flax_and_jax_read_the_ports_file(tmp_path):
    """A state read from the shipped artifact, written back by the port: the
    bytes are flax's `to_bytes` of the same state with the key of seed 436,
    and `checkpoint.load` gives back every leaf."""
    agent, jagent = fluid_agents()
    state, hook = checkpoint.load_light(FLUID_ART, agent, device="cpu")
    checkpoint.save(str(tmp_path), hook, agent=state, seed=436)
    raw = (tmp_path / "saves" / "agent_light.msgpack").read_bytes()
    ts, _ = jcheckpoint.load(FLUID_ART, jax_template(jagent))
    want = {"agent": jax.tree.map(np.asarray, ts.agent), "key": np.asarray(jax.random.PRNGKey(436))}
    assert raw == serialization.to_bytes(want)
    part = serialization.from_bytes({"agent": jagent.init_state(jax.random.PRNGKey(1)),
                                     "key": jax.random.PRNGKey(1)}, raw)
    assert_state_matches_jax(state, part["agent"])
    ts2, hook2 = jcheckpoint.load(str(tmp_path), jax_template(jagent))
    assert_state_matches_jax(state, ts2.agent)
    assert hook2.bestreward == hook.bestreward and list(hook2.rewards) == hook.rewards


def test_round_trip_through_the_port(tmp_path):
    """A state after real updates (Adam moments and counts set, numbered
    save) comes back equal; the key gives back the seed; an agent of
    other widths is refused."""
    agent = DDPGAgent(tfluid.fluid_agent_config(tfluid.FLUID_16_256, 9))
    state = agent.init_state(torch.Generator().manual_seed(3), "cpu")
    g = torch.Generator().manual_seed(4)
    batch = (torch.randn((9, 16), generator=g), torch.rand((1, 16), generator=g),
             torch.randn(16, generator=g), torch.zeros(16), torch.randn((9, 16), generator=g))
    for _ in range(3):
        agent.learn_batch(state, batch)
    state.update_step, state.act_noise = 17, 0.3
    checkpoint.save(str(tmp_path), PDEHook(), number=2, agent=state, seed=2**40 + 5)
    back, hook = checkpoint.load_light(str(tmp_path), agent, number=2, device="cpu")
    with open(tmp_path / "saves" / "agent_light2.msgpack", "rb") as f:
        assert checkpoint.seed_of_key(flax_msgpack.unpack(f.read())["key"]) == 2**40 + 5
    assert hook.ep == 1
    assert checkpoint.jax_key(2**40 + 5).tolist() == [256, 5]  # the high word kept
    assert checkpoint.jax_key(436).tolist() == np.asarray(jax.random.PRNGKey(436)).tolist()
    want, got = checkpoint.agent_state_dict(state), checkpoint.agent_state_dict(back)
    assert flax_msgpack.pack(got) == flax_msgpack.pack(want)
    assert int(got["opt_critic"]["0"]["count"]) == 3 and np.abs(got["opt_actor"]["0"]["nu"]["0"]["w"]).max() > 0
    agent.learn_batch(back, batch)  # the loaded optimizers step on
    agent.learn_batch(state, batch)
    for a, b in zip(back.actor.parameters(), state.actor.parameters()):
        assert torch.equal(a, b)
    wide = DDPGAgent(tfluid.fluid_agent_config(tfluid.FLUID_16_256, 19))
    with pytest.raises(ValueError, match="layer sizes"):
        checkpoint.load_light(str(tmp_path), wide, number=2, device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        checkpoint.load_light("artifacts/KS22", agent, device="cpu")  # the full format


# --------------------------------------------------------------------- CLI
TOY = ["--mesh", "1x1", "--nx", "16", "--horizon", "0.2", "--cpu"]
TOY_TRAIN = TOY + ["--loops", "2", "--no-steps", "10", "--chunk-len", "10", "--n-envs", "2",
                   "--learner-batch", "8", "--capacity-per-dp", "2048", "--seed", "3"]


def test_cli_fluid_train_eval_resume(tmp_path, capsys):
    """`--train --mesh 1x1` at a toy size writes both halves of the light
    checkpoint, which the JAX `checkpoint.load` reads; `--eval --load-from`
    evaluates it; `--resume` continues it (counters, networks, accounting)."""
    out, out2 = str(tmp_path / "run"), str(tmp_path / "resumed")
    trun.main(["Fluid_16_256", "--train", *TOY_TRAIN, "--out", out])
    text = capsys.readouterr().out
    assert "loop 2/2" in text and f"saved to {out}; best reward" in text and "grid 16" in text
    assert sorted(os.listdir(os.path.join(out, "saves"))) == ["agent_light.msgpack", "hook.npz"]
    cfg = dataclasses.replace(jfluid.FLUID_16_256, nx=16, te=0.2)
    _, jagent = fluid_agents(cfg)
    ts, jhook = jcheckpoint.load(out, jax_template(jagent))
    assert int(ts.agent.update_step) == 20 and jhook.ep - 1 == 4
    assert np.asarray(ts.key).tolist() == [0, 3]

    trun.main(["Fluid_16_256", "--eval", *TOY, "--load-from", out, "--p-te", "0.06"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(res) == ["mesh", "grid", "trained", "no action"] and res["grid"] == 16
    assert np.isfinite(res["trained"]) and res["trained"] != res["no action"]

    trun.main(["Fluid_16_256", "--train", *TOY_TRAIN, "--resume", "--load-from", out,
               "--out", out2, "--loops", "1"])
    text = capsys.readouterr().out
    assert f"resuming from ep 4, best {jhook.bestreward:.4f}" in text
    agent = DDPGAgent(tfluid.fluid_agent_config(dataclasses.replace(tfluid.FLUID_16_256, nx=16), 9))
    state, hook = checkpoint.load_light(out2, agent, device="cpu")
    assert state.update_step == 30 and hook.ep - 1 == 6 and len(hook.rewards) == 6
    assert hook.rewards[:4] == list(jhook.rewards)
    assert hook.bestreward >= jhook.bestreward


def test_cli_fluid_train_multi(tmp_path, capsys):
    out = str(tmp_path / "multi")
    trun.main(["Fluid_16_256", "--train-multi", *TOY, "--chunk-len", "10", "--n-envs", "2",
               "--learner-batch", "8", "--capacity-per-dp", "2048", "--no-episodes", "1",
               "--n-experiments", "1", "--seed", "2", "--out", out])
    text = capsys.readouterr().out
    assert "STARTING EXPERIMENT # 1" in text and "best rewards per experiment: [" in text
    assert sorted(os.listdir(os.path.join(out, "saves"))) == ["agent_light1.msgpack", "hook1.npz"]
    raw = flax_msgpack.unpack(open(os.path.join(out, "saves", "agent_light1.msgpack"), "rb").read())
    assert raw["key"].tolist() == [0, 2 + 7919]


def test_cli_ks_batched_train_writes_the_agent_half(tmp_path, capsys):
    out = str(tmp_path / "ks")
    trun.main(["KS22", "--train", "--batched", "--cpu", "--n-envs", "4", "--total-steps", "20",
               "--chunk-len", "10", "--learner-batch", "16", "--seed", "9", "--capacity", "5000",
               "--out", out])
    capsys.readouterr()
    setup = build_setup("KS22")
    ts, hook = jcheckpoint.load(out, init_train_state(setup.env, setup.agent, jax.random.PRNGKey(0)))
    assert int(ts.agent.update_step) == 20 and np.asarray(ts.key).tolist() == [0, 9]
    state, _ = checkpoint.load_light(out, tks.build_ks(tks.KS22, device="cpu").agent, device="cpu")
    assert_state_matches_jax(state, ts.agent)
