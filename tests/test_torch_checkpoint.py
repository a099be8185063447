"""The port's agent checkpoints against flax and the JAX package on the CPU.

The port writes `saves/agent_light.msgpack` and the full
`saves/agent.msgpack` (with the replay) with a MessagePack codec of its own
(`utils/flax_msgpack.py`): flax and the JAX package's `checkpoint.load` must
read what it writes, and it must read what they wrote, the shipped artifacts
included (`artifacts/KS22` and `artifacts/KS200` store their replays in the
older row-major layout). The CLI tests train a fluid controller at a toy
size through the port's `--train --mesh 1x1`, evaluate it, and resume it,
and do the same for a KS controller through the fidelity loop.
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
from distributedconvrl_pde_control_torch.train import drivers as tdrivers
from distributedconvrl_pde_control_torch.train.loop import TrainState as TorchTrainState
from distributedconvrl_pde_control_torch.train.loop import resume_seed
from distributedconvrl_pde_control_torch.utils import flax_msgpack

FLUID_ART, KS_ART = "artifacts/Fluid_16_256", "artifacts/KS22_sf_lh"


def fluid_agents(cfg=jfluid.FLUID_16_256):
    tcfg = tfluid.PRESETS[cfg.name] if cfg.name in tfluid.PRESETS else cfg
    return (DDPGAgent(tfluid.fluid_agent_config(tcfg, 9, capacity=2048)),
            JAgent(jfluid.fluid_agent_config(cfg, 9)))


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
    state, hook = checkpoint.load(art, agent, device="cpu")
    state = state.agent
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
    state, hook = checkpoint.load(FLUID_ART, agent, device="cpu")
    state = state.agent
    checkpoint.save(str(tmp_path), TorchTrainState(state, None, None, key=checkpoint.jax_key(436)), hook,
                    include_replay=False)
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
    agent = DDPGAgent(tfluid.fluid_agent_config(tfluid.FLUID_16_256, 9, capacity=2048))
    state = agent.init_state(torch.Generator().manual_seed(3), "cpu")
    g = torch.Generator().manual_seed(4)
    batch = (torch.randn((9, 16), generator=g), torch.rand((1, 16), generator=g),
             torch.randn(16, generator=g), torch.zeros(16), torch.randn((9, 16), generator=g))
    for _ in range(3):
        agent.learn_batch(state, batch)
    state.update_step, state.act_noise = 17, 0.3
    checkpoint.save(str(tmp_path), TorchTrainState(state, None, None, key=checkpoint.jax_key(2**40 + 5)),
                    PDEHook(), number=2, include_replay=False)
    back, hook = checkpoint.load(str(tmp_path), agent, number=2, device="cpu")
    back = back.agent
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
    wide = DDPGAgent(tfluid.fluid_agent_config(tfluid.FLUID_16_256, 19, capacity=2048))
    with pytest.raises(ValueError, match="layer sizes"):
        checkpoint.load(str(tmp_path), wide, number=2, device="cpu")
    ks_agent = tks.build_ks(tks.KS22, device="cpu").agent
    ts, _ = checkpoint.load("artifacts/KS22", ks_agent, device="cpu")  # a full file only
    assert ts.replay.size > 0


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
    agent = DDPGAgent(tfluid.fluid_agent_config(dataclasses.replace(tfluid.FLUID_16_256, nx=16), 9,
                                                capacity=2048))
    state, hook = checkpoint.load(out2, agent, device="cpu")
    state = state.agent
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
    state, _ = checkpoint.load(out, tks.build_ks(tks.KS22, device="cpu").agent, device="cpu")
    assert_state_matches_jax(state.agent, ts.agent)


# ------------------------------------------------------- full checkpoint
def ks_pair(name="KS22", **over):
    """The JAX setup's TrainState template and the port's agent of a KS preset."""
    setup = build_setup(name, over or None)
    template = init_train_state(setup.env, setup.agent, jax.random.PRNGKey(0))
    return template, trun.ks_setup(dataclasses.replace(tks.PRESETS[name], **over), device="cpu")


def assert_replay_matches_jax(rb, jrb):
    """The port's row buffer against a JAX Replay, on values."""
    assert rb.ptr == int(jrb.ptr) and rb.size == int(jrb.size)
    for got, want in ((rb.s, jrb.s), (rb.a, jrb.a), (rb.r, jrb.r), (rb.t, jrb.t), (rb.sn, jrb.sn)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["KS22", "KS200"])
def test_port_reads_the_shipped_full_states(name):
    """artifacts/KS22 and artifacts/KS200 through the full reader: every leaf
    as the JAX `checkpoint.load` gives it, the row-major replay transposed
    (checked on values: ns = na = 1, so the shapes alone would not show a
    wrong layout), the key and the hook."""
    art = f"artifacts/{name}"
    template, setup = ks_pair(name)
    with open(os.path.join(art, "saves", "agent.msgpack"), "rb") as f:
        raw = flax_msgpack.unpack(f.read())
    assert raw["replay"]["s"].shape == (150_000, 1)  # stored row-major
    ts, hook = checkpoint.load(art, setup.agent, device="cpu")
    jts, jhook = jcheckpoint.load(art, template)
    assert_state_matches_jax(ts.agent, jts.agent)
    assert_replay_matches_jax(ts.replay, jts.replay)
    assert ts.replay.size > 1000 and np.abs(ts.replay.s.numpy()).max() > 0
    np.testing.assert_array_equal(ts.replay.s.numpy()[0], raw["replay"]["s"][:, 0])
    np.testing.assert_array_equal(ts.replay.buf.numpy()[:, 1], raw["replay"]["a"][:, 0])
    assert ts.key.tolist() == np.asarray(jts.key).tolist() == raw["key"].tolist()
    assert hook.rewards == list(jhook.rewards) and hook.bestepisode == jhook.bestepisode


def test_jax_reads_the_ports_full_file(tmp_path):
    """The shipped KS22 state written back by the port: the bytes are flax's
    `to_bytes` of the state JAX loads (slot-minor replay, the file's key),
    and the JAX `checkpoint.load` gives back every leaf."""
    template, setup = ks_pair()
    ts, hook = checkpoint.load("artifacts/KS22", setup.agent, device="cpu")
    checkpoint.save(str(tmp_path), ts, hook)
    raw = (tmp_path / "saves" / "agent.msgpack").read_bytes()
    jts, _ = jcheckpoint.load("artifacts/KS22", template)
    assert raw == serialization.to_bytes(jax.tree.map(np.asarray, jts))
    jts2, jhook2 = jcheckpoint.load(str(tmp_path), template)
    assert_state_matches_jax(ts.agent, jts2.agent)
    assert_replay_matches_jax(ts.replay, jts2.replay)
    assert jhook2.rewards == hook.rewards
    back, _ = checkpoint.load(str(tmp_path), setup.agent, device="cpu")
    assert back.key.tolist() == ts.key.tolist() and back.generator.initial_seed() == \
        resume_seed(checkpoint.seed_of_key(ts.key), hook.ep)


def test_a_replay_of_another_capacity_is_refused():
    """Neither the template's layout nor its transpose: JAX and the port refuse."""
    template, setup = ks_pair(capacity=1000)
    with pytest.raises(ValueError, match="row-major transpose"):
        jcheckpoint.load("artifacts/KS22", template)
    with pytest.raises(ValueError, match="row-major transpose"):
        checkpoint.load("artifacts/KS22", setup.agent, device="cpu")


def test_the_full_file_wins(tmp_path):
    """A directory with both files: the full one is read, as in JAX; with
    the light one alone, an empty replay of the agent's capacity."""
    template, setup = ks_pair()
    full, hook = checkpoint.load("artifacts/KS22", setup.agent, device="cpu")
    light, _ = checkpoint.load("artifacts/KS22_sf_lh", setup.agent, device="cpu")
    assert light.replay.size == 0 and light.replay.capacity == 150_000
    out = str(tmp_path)
    checkpoint.save(out, light, hook, include_replay=False)
    checkpoint.save(out, full, hook)
    ts, _ = checkpoint.load(out, setup.agent, device="cpu")
    jts, _ = jcheckpoint.load(out, template)
    assert ts.replay.size == int(jts.replay.size) == full.replay.size > 0
    assert_state_matches_jax(ts.agent, jts.agent)
    assert_state_matches_jax(full.agent, jts.agent)
    os.remove(os.path.join(out, "saves", "agent.msgpack"))
    ts, _ = checkpoint.load(out, setup.agent, device="cpu")
    assert ts.replay.size == 0
    assert_state_matches_jax(ts.agent, jcheckpoint.load(out, template)[0].agent)


# ---------------------------------------------------------------- KS CLI
KS_TOY = ["--cpu", "--config-overrides", '{"te": 0.5, "update_loops": 2}']


def test_cli_ks_train_eval_resume(tmp_path, capsys):
    """`KS22 --train` (the fidelity loop) writes the full checkpoint, which
    the JAX `checkpoint.load` reads; `--eval` reads it from --out without
    --load-from; `--resume` continues the episodes, the replay and the hook."""
    out, out2 = str(tmp_path / "run"), str(tmp_path / "resumed")
    trun.main(["KS22", "--train", *KS_TOY, "--loops", "2", "--no-steps", "15", "--seed", "4",
               "--out", out])
    text = capsys.readouterr().out
    assert "loop 2/2" in text and f"saved to {out}; best reward" in text
    assert sorted(os.listdir(os.path.join(out, "saves"))) == ["agent.msgpack", "hook.npz"]
    template, _ = ks_pair(te=0.5, update_loops=2)
    jts, jhook = jcheckpoint.load(out, template)
    assert jhook.ep - 1 == 6 and int(jts.replay.size) == 6 * 5 * 8 and int(jts.agent.update_step) == 0
    assert np.asarray(jts.key).tolist() == [0, 4]
    assert int(jts.agent.opt_actor[0].count) > 0  # learning ran

    trun.main(["KS22", "--eval", *KS_TOY, "--out", out, "--p-te", "2", "--p-t-action", "1"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == {"pre_control_mean_abs_dev", "post_control_mean_abs_dev", "suppression"}

    trun.main(["KS22", "--train", *KS_TOY, "--resume", "--load-from", out, "--out", out2,
               "--loops", "1", "--no-steps", "5"])
    text = capsys.readouterr().out
    assert f"resuming from ep 6, best {jhook.bestreward:.4f}" in text
    ts, hook = checkpoint.load(out2, tks.build_ks(tks.KS22, device="cpu").agent, device="cpu")
    assert hook.ep - 1 == 7 and ts.replay.size == 7 * 5 * 8 and hook.rewards[:6] == list(jhook.rewards)
    assert ts.key.tolist() == [0, 4]  # the file's key goes on


def test_a_resumed_run_draws_a_stream_of_its_own(tmp_path, capsys):
    """The key of a port-written file stays that of the first seed, so the
    resumed generator is seeded from it and the hook's episode count: a
    resume draws neither the original run's stream nor that of the resume
    before it; `--seed` on a resume re-seeds it."""
    def first_draws(gen):
        return torch.rand(8, generator=gen).tolist()

    out, out2 = str(tmp_path / "run"), str(tmp_path / "resumed")
    trun.main(["KS22", "--train", *KS_TOY, "--loops", "1", "--no-steps", "5", "--seed", "4",
               "--out", out])
    trun.main(["KS22", "--train", *KS_TOY, "--resume", "--load-from", out, "--out", out2,
               "--loops", "1", "--no-steps", "5"])
    capsys.readouterr()
    _, setup = ks_pair(te=0.5, update_loops=2)
    ts1, hook1 = checkpoint.load(out, setup.agent, device="cpu")
    ts2, hook2 = checkpoint.load(out2, setup.agent, device="cpu")
    assert ts1.key.tolist() == ts2.key.tolist() == [0, 4] and hook2.ep == hook1.ep + 1
    original = first_draws(torch.Generator().manual_seed(4))
    resumed, resumed_again = first_draws(ts1.generator), first_draws(ts2.generator)
    assert len({tuple(original), tuple(resumed), tuple(resumed_again)}) == 3
    ts1, hook1 = checkpoint.load(out, setup.agent, device="cpu")
    ts1, _ = tdrivers.train(setup, loops=0, seed=7, ts=ts1, hook=hook1, verbose=False)
    assert ts1.generator.initial_seed() == resume_seed(7, hook1.ep)
    assert first_draws(ts1.generator) not in (original, resumed)


def test_cli_ks_train_multi(tmp_path, capsys):
    """`KS22 --train-multi` writes numbered full saves per experiment."""
    out = str(tmp_path / "multi")
    trun.main(["KS22", "--train-multi", *KS_TOY, "--no-episodes", "1", "--n-experiments", "1",
               "--out", out])
    text = capsys.readouterr().out
    assert "STARTING EXPERIMENT # 1" in text and "best rewards per experiment: [" in text
    assert sorted(os.listdir(os.path.join(out, "saves"))) == ["agent1.msgpack", "hook1.npz"]
    template, _ = ks_pair(te=0.5, update_loops=2)
    jts, jhook = jcheckpoint.load(out, template, number=1)
    assert jhook.ep - 1 == 50 and np.asarray(jts.key).tolist() == [0, 609 + 7919]


def test_cli_ks_eval_takes_the_current_actor_without_a_best_one(tmp_path, capsys):
    """A checkpoint whose hook holds no best actor: `--eval` rolls the
    checkpoint's current actor (JAX run.py:1080-1082)."""
    _, setup = ks_pair()
    ts, _ = checkpoint.load("artifacts/KS22", setup.agent, device="cpu")
    checkpoint.save(str(tmp_path), ts, PDEHook(), include_replay=False)
    trun.main(["KS22", "--eval", "--cpu", "--load-from", str(tmp_path), "--p-te", "3",
               "--p-t-action", "1"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    from distributedconvrl_pde_control_torch.train.eval import actor_policy, rollout

    y = rollout(setup.env, actor_policy(setup.agent, ts.agent.actor), te=3.0, t_action=1.0)["y"]
    assert got == trun.suppression_of(y, 1.0, setup.env.dt)
    best = checkpoint.actor_from_jax(checkpoint.load_best_actor("artifacts/KS22"))
    assert not torch.equal(best.w[0], ts.agent.actor.w[0])  # a different actor


def test_cli_fluid_eval_defaults_to_the_run_directory(capsys):
    """`--eval` without --load-from reads --out, as JAX's `args.load_from or
    out_dir` does."""
    argv = ["Fluid_16_256", "--eval", *TOY, "--p-te", "0.04"]
    trun.main(argv + ["--load-from", FLUID_ART])
    want = capsys.readouterr().out.strip().splitlines()[-1]
    trun.main(argv + ["--out", FLUID_ART])
    assert capsys.readouterr().out.strip().splitlines()[-1] == want


def test_cli_fluid_resume_pool_matches_jax(tmp_path, monkeypatch, capsys):
    """`--train --mesh 1x1 --resume`: the resumed state's fields and reset
    pool are those of JAX's `trainer.init(PRNGKey(args.seed or cfg.seed))`,
    whose pool comes from init's default seed 0; `--seed 0` means the
    preset's seed."""
    from distributedconvrl_pde_control_tpu.parallel import multichip as jmc
    from distributedconvrl_pde_control_torch.parallel import multichip as tmc
    from jax.sharding import Mesh

    agent, _ = fluid_agents(dataclasses.replace(jfluid.FLUID_16_256, nx=16))
    state = agent.init_state(torch.Generator().manual_seed(0), "cpu")
    checkpoint.save(str(tmp_path), TorchTrainState(state, None, None), PDEHook(),
                    include_replay=False)
    seen = {}

    def stop(trainer, **kw):
        seen.update(state=kw["state"], pool=trainer.pool.clone(), seed=kw["seed"])
        return kw["state"], kw["hook"]

    monkeypatch.setattr(tmc, "train_sharded", stop)
    trun.main(["Fluid_16_256", "--train", *TOY, "--n-envs", "2", "--resume", "--seed", "0",
               "--load-from", str(tmp_path), "--out", str(tmp_path / "out")])
    capsys.readouterr()
    cfg = dataclasses.replace(jfluid.FLUID_16_256, nx=16, te=0.2)
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("dp", "sp"))
    jtr = jmc.ShardedFluidTrainer(cfg, mesh, jmc.ShardedTrainConfig(n_envs=2))
    jstate = jtr.init(jax.random.PRNGKey(0 or cfg.seed))
    np.testing.assert_array_equal(seen["pool"].numpy(), np.asarray(jtr.pool))
    np.testing.assert_array_equal(seen["state"].w.numpy(), np.asarray(jstate.w))
    assert seen["state"].generator.initial_seed() == cfg.seed == 436 and seen["seed"] == 0
