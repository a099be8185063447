"""The port's fluid trainer on dp x sp meshes of gloo CPU ranks
(parallel/multichip.py, agents/ddpg.py's dp gradient mean, the `--mesh` CLI)
against the JAX package on the conftest's virtual CPU mesh, with every JAX
draw passed in per dp group, and against the port on one rank.

One world of eight spawned ranks runs the trainer checks
(`tests/torch_mesh_ranks.py`): one 16-step chunk at 2x2 (the setup of JAX's
`test_multichip_trainer_one_step`: 16^2 grid, 4x4 actuators, 4 envs,
learner batch 8, with learning from step 2 and episodes ending at step 15),
the fixed-step evaluation at 2x2 and 1x1, the adaptive evaluation at 2x1,
`_error_flags` plus one train step at 2x4 (JAX's
`test_sharded_error_detection_2x4`), and a checkpoint's load at 2x2; the
JAX references run beside the ranks. The CLI tests spawn their own ranks.
Tolerances: parameters 1e-4 of each tensor's maximum, rewards 1e-4,
evaluations rel 1e-5 (the CLI's energies rel 1e-4); flags, finished steps,
replay sizes and episode counts exact; the networks bit-identical on every
rank.
"""

import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_mesh_ranks as ranks
from distributedconvrl_pde_control_tpu.configs import fluid as jfluid
from distributedconvrl_pde_control_tpu.experiments import run as jrun
from distributedconvrl_pde_control_tpu.parallel import multichip as jmc
from distributedconvrl_pde_control_torch.configs import fluid as tfluid
from distributedconvrl_pde_control_torch.experiments import run as trun
from distributedconvrl_pde_control_torch.parallel import multichip as tmc
from distributedconvrl_pde_control_torch.train.checkpoint import (
    actor_from_jax,
    agent_state_dict,
    load_best_actor,
)

SEED, POOL, STEPS, EVAL_STEPS = 5, 2, 16, 5
TINY = dict(nx=16, sensors_per_axis=4)
CHUNK = dict(TINY, adaptive=False, te=0.3, start_steps=3, update_after=2)
TCFG = dict(n_envs=4, batch_size=8, capacity_per_dp=1024, y0_pool_size=POOL)
LOAD_DIR = os.path.abspath("artifacts/Fluid_16_256")
ACTOR = load_best_actor(LOAD_DIR)


def jmesh(dp, sp):
    return Mesh(np.asarray(jax.devices()[:dp * sp]).reshape(dp, sp), ("dp", "sp"))


def cfgs(**over):
    return (dataclasses.replace(jfluid.FLUID_8, **over),
            dataclasses.replace(tfluid.FLUID_8, **over))


def jax_draws(jtr, key, n_steps):
    """Each dp group's draws of `n_steps` JAX train steps from `key`, by
    `_local_step`'s key chain with the dp index folded in."""
    acfg, bl = jtr.agent.cfg, jtr.tcfg.n_envs // jtr.n_dp
    push = bl * jtr.n_act
    out = [[] for _ in range(jtr.n_dp)]
    for step in range(n_steps):
        key, k_act, k_learn, k_reset = jax.random.split(key, 4)
        size = min((step + 1) * push, jtr.capacity_per_dp)
        for d in range(jtr.n_dp):
            ka, kl, kr = (jax.random.fold_in(k, d) for k in (k_act, k_learn, k_reset))
            _, k_noise = jax.random.split(ka)
            offs = [np.asarray(jax.random.randint(k, (jtr.tcfg.batch_size,), 0, size))
                    for k in jax.random.split(kl, jtr.tcfg.update_loops)]
            out[d].append({"noise": np.asarray(jax.random.normal(k_noise, (acfg.na_rows, push))),
                           "offs": np.stack(offs),
                           "idx": np.asarray(jax.random.randint(kr, (bl,), 0, POOL))})
    return out


def state_dict(js):
    return flax.serialization.to_state_dict(jax.tree.map(np.array, js))


def jax_chunk(dp, sp, over, n_steps, w=None):
    """The ranks' payload (JAX's initial state and draws) and the JAX chunk
    from it, to be run: (payload, run() -> (trainer, final state, records))."""
    jcfg, tcfg = cfgs(**over)
    jtr = jmc.ShardedFluidTrainer(jcfg, jmesh(dp, sp), jmc.ShardedTrainConfig(**TCFG))
    js0 = jtr.init(jax.random.PRNGKey(3), seed=SEED)
    if w is not None:
        js0 = js0.replace(w=jax.device_put(jnp.asarray(w), NamedSharding(jtr.mesh, jtr._w_spec)))
    draws = jax_draws(jtr, js0.key, n_steps)
    payload = {"kind": "fluid", "cfg": tcfg, "tcfg": TCFG, "mesh": (dp, sp), "seed": SEED,
               "state": state_dict(js0), "draws": draws, "row_axis": 1}

    def run():
        js1, packed = jtr.make_chunk_fn(n_steps)(js0)
        return jtr, jax.tree.map(np.asarray, js1), np.asarray(packed)

    return payload, run


def jax_eval(dp, sp, over):
    """The ranks' payload and the JAX evaluation rollout, to be run."""
    jcfg, tcfg = cfgs(**over)
    payload = {"kind": "fluid", "cfg": tcfg, "tcfg": TCFG, "n_steps": EVAL_STEPS,
               "t_action_steps": 1, "actor": ACTOR, "meshes": [(dp, sp)]}

    def run():
        jtr = jmc.ShardedFluidTrainer(jcfg, jmesh(dp, sp), jmc.ShardedTrainConfig(**TCFG))
        recs = jtr.make_eval_fn(EVAL_STEPS, 1)(jax.tree.map(jnp.asarray, ACTOR), jtr.eval_w0())
        return {k: np.asarray(v) for k, v in recs.items()}

    return payload, run


def flag_fields(n=16):
    w = np.zeros((4, n, n), np.float32)
    w[0] = np.repeat(np.arange(4.0, dtype=np.float32) * 50.0, n // 4)[:, None]  # jumps across sp blocks
    w[1] = 50.0  # large but smooth
    w[2, :, n // 2:] = 50.0  # a jump along x inside every block
    return w


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX references and the ranks' results of every check: the ranks
    run once their payloads are made, beside the JAX runs."""
    w = flag_fields()
    jobs = {"chunk": jax_chunk(2, 2, CHUNK, STEPS),
            "eval_fixed": jax_eval(2, 2, dict(TINY, adaptive=False)),
            "eval_adaptive": jax_eval(2, 1, dict(TINY, adaptive=True)),
            "flags": jax_chunk(2, 4, dict(TINY, check_max_value="y", adaptive=False), 1, w=w)}
    jobs["eval_fixed"][0]["meshes"] = [(2, 2), (1, 1)]
    jobs["flags"][0]["w"] = w
    load = {"cfg": cfgs(**TINY)[1], "tcfg": TCFG, "mesh": (2, 2), "load_dir": LOAD_DIR}
    with ThreadPoolExecutor(1) as pool:
        on_ranks = pool.submit(ranks.run_world, ranks.multichip_checks, 8,
                               str(tmp_path_factory.mktemp("mc")),
                               {"load": load, **{k: payload for k, (payload, _) in jobs.items()}})
        want = {k: run() for k, (_, run) in jobs.items()}
        got = on_ranks.result()
    return want, got


def test_chunk_2x2_parameters_and_accounting_match_jax(world):
    (jtr, js1, jpacked), got = world[0]["chunk"], world[1]["chunk"]
    for name in ("actor", "critic", "target_actor", "target_critic", "best_actor"):
        want = js1.best_actor if name == "best_actor" else getattr(js1.agent, name)
        for g, w in zip(got["params"][name], want):
            for k in ("w", "b"):
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-4 * np.abs(w[k]).max())
    assert got["ep_count"] == int(js1.ep_count) == 4
    assert got["best_episode"] == int(js1.best_episode) > 0
    np.testing.assert_allclose(got["best_reward"], float(js1.best_reward), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["mean_reward"], float(js1.mean_reward), atol=1e-4, rtol=0)
    assert got["packed"].shape == jpacked.shape == (5, STEPS, 4)
    for row in (0, 1, 3):
        np.testing.assert_array_equal(got["packed"][row], jpacked[row])
    np.testing.assert_allclose(got["packed"][2], jpacked[2], atol=1e-4, rtol=0)


def test_chunk_2x2_replay_per_dp_group_and_replicated_networks(world):
    (jtr, js1, _), got = world[0]["chunk"], world[1]["chunk"]
    sizes = np.asarray(js1.replay.size)
    assert sizes.tolist() == [STEPS * 2 * jtr.n_act] * 2  # 16 steps x 2 envs x 16 actuators
    every = got["every_rank"]
    assert len(every) == 4 and every[0][-1] == sizes[0]
    for other in every[1:]:
        np.testing.assert_array_equal(other, every[0])  # networks, counters: bit for bit


def test_eval_2x2_against_jax_and_one_rank(world):
    want, got = world[0]["eval_fixed"], world[1]["eval_fixed"]
    for mesh in ("2x2", "1x1"):
        for k in ("energy", "reward_mean"):
            np.testing.assert_allclose(got[mesh][k], want[k], rtol=0,
                                       atol=1e-5 * np.abs(want[k]).max())
        np.testing.assert_array_equal(got[mesh]["active"], want["active"])
    assert got["2x2"]["energy"].shape == (EVAL_STEPS, 4)


def test_adaptive_eval_2x1_against_jax(world):
    want, got = world[0]["eval_adaptive"], world[1]["eval_adaptive"]
    for k in ("energy", "reward_mean"):
        np.testing.assert_allclose(got["2x1"][k], want[k], rtol=0,
                                   atol=1e-5 * np.abs(want[k]).max())
    trials = got["2x1_trials"]
    assert len(trials) == 2 and min(trials) > 1


def test_load_2x2_reads_on_rank_0_and_gives_every_rank_the_same_bits(world):
    """`load_sharded` on a 2x2 mesh (the path of `--resume` and of the eval's
    fallback): every rank holds the agent that one process reads."""
    got = world[1]["load"]
    ttr = tmc.ShardedFluidTrainer(cfgs(**TINY)[1], (1, 1), tmc.ShardedTrainConfig(**TCFG),
                                  device="cpu")
    agent, hook = tmc.load_sharded(LOAD_DIR, ttr)
    want = ranks._flat(agent_state_dict(agent)).numpy()
    assert len(got["every_rank"]) == 4 and got["ep"] == hook.ep
    for every in got["every_rank"]:
        np.testing.assert_array_equal(every, want)


def test_error_flags_2x4_as_jax(world):
    """The detector on hand-built fields (jumps only across sp blocks flag,
    through the previous rank's boundary row), then one step from those
    fields: the blown-up corrupted envs 0 and 2 are flagged, the blown-up
    smooth env 1 is not."""
    (jtr, _, jpacked), got = world[0]["flags"], world[1]["flags"]
    assert got["flags"].tolist() == [True, False, True, False]
    w = flag_fields()
    spec = jtr._w_spec
    jflags = jax.jit(shard_map(jtr._error_flags, mesh=jtr.mesh, in_specs=(spec,),
                               out_specs=P("dp"), check_vma=False))(
        jax.device_put(jnp.asarray(w), NamedSharding(jtr.mesh, spec)))
    assert np.asarray(jflags).tolist() == got["flags"].tolist()
    np.testing.assert_array_equal(got["packed"][[0, 1, 3]], jpacked[[0, 1, 3]])
    # every field but env 3's exceeds max_value 3; env 1's is smooth
    assert got["packed"][0, 0].tolist() == [1, 1, 1, 0] and got["packed"][3, 0].tolist() == [1, 0, 1, 0]


def test_cli_eval_2x2_matches_the_jax_cli(tmp_path, capsys):
    argv = ["Fluid_16_256", "--eval", "--virtual-devices", "4", "--mesh", "2x2", "--load-from",
            "artifacts/Fluid_16_256", "--nx", "32", "--p-te", "0.1", "--cpu"]
    trun.main(argv + ["--out", str(tmp_path / "port")])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jrun.main(argv + ["--out", str(tmp_path / "jax")])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["mesh"] == want["mesh"] == "2x2" and got["grid"] == want["grid"] == 32
    for k in ("trained", "no action"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    assert got["trained"] < got["no action"]


def test_cli_train_2x2_is_read_by_the_1x1_eval_and_by_jax(tmp_path, capsys):
    """A 2x2 `--train` whose light save the 1x1 `--eval`, the JAX loader and a
    1x1 `--resume` read (the 2x2 load, read on rank 0 and broadcast to the
    ranks, is checked in the world's ranks)."""
    out, out2 = str(tmp_path / "run"), str(tmp_path / "resumed")
    common = ["--nx", "16", "--horizon", "0.2", "--loops", "1", "--no-steps", "10",
              "--chunk-len", "10", "--n-envs", "4", "--learner-batch", "8", "--capacity-per-dp",
              "2048", "--cpu"]
    trun.main(["Fluid_16_256", "--train", "--virtual-devices", "4", "--mesh", "2x2", *common,
               "--out", out])
    text = capsys.readouterr().out
    assert "[Fluid_16_256 sharded 2x2] loop 1/1" in text and "(mesh 2x2, grid 16)" in text
    assert sorted(os.listdir(os.path.join(out, "saves"))) == ["agent_light.msgpack", "hook.npz"]
    assert not [f for f in os.listdir(out) if f.startswith(".rank_")]

    trun.main(["Fluid_16_256", "--eval", "--mesh", "1x1", "--nx", "16", "--horizon", "0.2",
               "--load-from", out, "--p-te", "0.06", "--cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["mesh"] == "1x1" and np.isfinite([res["trained"], res["no action"]]).all()

    cfg = dataclasses.replace(jfluid.FLUID_16_256, nx=16, te=0.2)
    jtr = jmc.ShardedFluidTrainer(cfg, jmesh(1, 1), jmc.ShardedTrainConfig(n_envs=4))
    jagent, jhook = jmc.load_sharded(out, jtr)
    assert jhook.ep - 1 == 4 and int(jagent.update_step) == 10
    ttr = tmc.ShardedFluidTrainer(dataclasses.replace(tfluid.FLUID_16_256, nx=16, te=0.2), (1, 1),
                                  tmc.ShardedTrainConfig(n_envs=4), device="cpu")
    tagent, thook = tmc.load_sharded(out, ttr)
    for g, w in zip(tagent.actor.w, jagent.actor):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w["w"]))
    assert thook.rewards == list(jhook.rewards)
    best = actor_from_jax(jhook.best_actor)
    assert [tuple(t.shape) for t in best.w] == [(18, 9), (1, 18)]

    trun.main(["Fluid_16_256", "--train", "--mesh", "1x1", *common, "--resume", "--load-from", out,
               "--out", out2])
    assert f"resuming from ep 4, best {jhook.bestreward:.4f}" in capsys.readouterr().out
    ragent, rhook = tmc.load_sharded(out2, ttr)
    assert ragent.update_step == 20 and rhook.ep - 1 == 8 and rhook.rewards[:4] == thook.rewards


def test_cli_mesh_without_virtual_devices_exits_as_jax(capsys):
    with pytest.raises(SystemExit, match=r"mesh 2x2 needs 4 devices, have 1 \(hint: "
                                         r"--virtual-devices N\)"):
        trun.main(["Fluid_16_256", "--eval", "--mesh", "2x2", "--cpu", "--load-from",
                   "artifacts/Fluid_16_256"])
