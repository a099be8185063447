"""The port's sharded Keller-Segel solver and trainer
(parallel/keller_segel_sharded.py, parallel/multichip_keller_segel.py, the
`--mesh` CLI for KellerSegel10_16[_fast]) on gloo CPU ranks, against the JAX
package on the conftest's virtual CPU mesh and against the port's
single-device solver.

One world of four spawned ranks runs the solver at sp = 2 and 4 (one env
step of 10 RK4 substeps from a perturbed field under a random forcing), one
10-step chunk of the trainer at 2x2 from JAX's state with JAX's draws per dp
group (JAX's `test_multichip_keller_segel_trainer` setup: te = 0.06, 5
substeps, 4 envs, learner batch 8), and its evaluation at 2x2. The CLI test
spawns its own ranks. Tolerances: solver rel 1e-5 of the field's maximum,
parameters 1e-4 of each tensor's maximum or 1e-6 (the critic's output bias
stays near zero: 1.4e-4 after the chunk), rewards 1e-4, evaluation rel 1e-5,
the CLI's energies rel 1e-4; episode counts and replay sizes exact, the
networks bit-identical on every rank.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_mesh_ranks as ranks
from distributedconvrl_pde_control_tpu.configs import keller_segel as jkss
from distributedconvrl_pde_control_tpu.experiments import run as jrun
from distributedconvrl_pde_control_tpu.parallel.keller_segel_sharded import (
    KellerSegelShardedSolver as JSolver,
)
from distributedconvrl_pde_control_tpu.parallel.multichip import ShardedTrainConfig as JTCfg
from distributedconvrl_pde_control_tpu.parallel.multichip_keller_segel import (
    ShardedKellerSegelTrainer as JTrainer,
)
from distributedconvrl_pde_control_torch.configs import keller_segel as tkss
from distributedconvrl_pde_control_torch.experiments import run as trun
from distributedconvrl_pde_control_torch.ops.keller_segel import KellerSegelSolver
from distributedconvrl_pde_control_torch.train.checkpoint import load_best_actor
from test_torch_multichip import jax_draws, jmesh, state_dict

SEED, STEPS, EVAL_STEPS, NX, LX, DT, OS = 5, 10, 4, 100, 10.0, 0.006, 10
OVER = dict(te=0.06, oversampling=5)
TCFG = dict(n_envs=4, batch_size=8, capacity_per_dp=1024, y0_pool_size=2)
ARTIFACT = "artifacts/KellerSegel10_16"


def solver_inputs():
    rng = np.random.default_rng(0)
    y = np.ones((2, NX), np.float32)
    y[0] += 0.05 * rng.standard_normal(NX).astype(np.float32)
    y[1] += 0.05 * rng.standard_normal(NX).astype(np.float32)
    return {"y": y[None], "f": (0.1 * rng.standard_normal((1, NX))).astype(np.float32),
            "nx": NX, "lx": LX, "dt": DT, "os": OS}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jcfg = dataclasses.replace(jkss.KELLER_SEGEL_10_16, **OVER)
    tcfg = dataclasses.replace(tkss.KELLER_SEGEL_10_16, **OVER)
    jtr = JTrainer(jcfg, jmesh(2, 2), JTCfg(**TCFG))
    js0 = jtr.init(jax.random.PRNGKey(3), seed=SEED)
    chunk = {"kind": "kss", "cfg": tcfg, "tcfg": TCFG, "mesh": (2, 2), "seed": SEED,
             "state": state_dict(js0), "draws": jax_draws(jtr, js0.key, STEPS), "row_axis": 2}
    js1, packed = jtr.make_chunk_fn(STEPS)(js0)
    actor = jax.tree.map(np.asarray, js1.agent.actor)
    recs = jtr.make_eval_fn(EVAL_STEPS, 1)(js1.agent.actor, jtr.eval_w0())
    ev = {"kind": "kss", "cfg": tcfg, "tcfg": TCFG, "n_steps": EVAL_STEPS, "t_action_steps": 1,
          "actor": actor, "meshes": [(2, 2)]}
    p = {"solver": solver_inputs(), "chunk": chunk, "eval": ev}
    got = ranks.run_world(ranks.kss_checks, 4, str(tmp_path_factory.mktemp("kss")), p)
    return p, (jtr, jax.tree.map(np.asarray, js1), np.asarray(packed),
               {k: np.asarray(v) for k, v in recs.items()}), got


@pytest.mark.parametrize("s", [2, 4])
def test_sharded_solver_against_jax_and_single_device(world, s):
    p, _, got = world
    sp = p["solver"]
    want = np.asarray(jax.jit(shard_map(
        lambda yb, fb: JSolver(nx=NX, lx=LX, sp_axis="sp").step(yb, fb, DT, OS),
        mesh=jax.sharding.Mesh(np.asarray(jax.devices()[:s]), ("sp",)),
        in_specs=(P(None, "sp"), P("sp")), out_specs=P(None, "sp"), check_vma=False))(
            jnp.asarray(sp["y"][0]), jnp.asarray(sp["f"][0])))
    one = KellerSegelSolver(nx=NX, lx=LX).step(torch.from_numpy(sp["y"]), torch.from_numpy(sp["f"]),
                                               DT, OS).numpy()
    g = got["solver"][f"step_{s}"]
    assert g.shape == (1, 2, NX) and np.abs(one - sp["y"]).max() > 1e-4
    np.testing.assert_allclose(g[0], want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(g, one, rtol=0, atol=1e-5 * np.abs(one).max())


def test_trainer_chunk_2x2_matches_jax(world):
    _, (jtr, js1, jpacked, _), got = world
    c = got["chunk"]
    for name in ("actor", "critic", "target_actor", "target_critic", "best_actor"):
        want = js1.best_actor if name == "best_actor" else getattr(js1.agent, name)
        for g, w in zip(c["params"][name], want):
            for k in ("w", "b"):
                np.testing.assert_allclose(g[k], w[k], rtol=0,
                                           atol=max(1e-4 * np.abs(w[k]).max(), 1e-6))
    assert c["ep_count"] == int(js1.ep_count) == 4 and c["best_episode"] == int(js1.best_episode)
    np.testing.assert_allclose(c["best_reward"], float(js1.best_reward), atol=1e-4, rtol=0)
    np.testing.assert_allclose(c["mean_reward"], float(js1.mean_reward), atol=1e-4, rtol=0)
    for row in (0, 1, 3):
        np.testing.assert_array_equal(c["packed"][row], jpacked[row])
    np.testing.assert_allclose(c["packed"][2], jpacked[2], atol=1e-4, rtol=0)
    assert np.asarray(js1.replay.size).tolist() == [STEPS * 2 * jtr.n_act] * 2
    assert c["every_rank"][0][-1] == STEPS * 2 * jtr.n_act
    for other in c["every_rank"][1:]:
        np.testing.assert_array_equal(other, c["every_rank"][0])


def test_eval_2x2_matches_jax(world):
    _, (_, _, _, want), got = world
    g = got["eval"]["2x2"]
    for k in ("energy", "reward_mean"):
        np.testing.assert_allclose(g[k], want[k], rtol=0, atol=1e-5 * np.abs(want[k]).max())
    assert g["energy"].shape == (EVAL_STEPS, 4) and (g["energy"] > 0).all()


def test_cli_eval_1x2_matches_the_jax_evaluation(tmp_path, capsys):
    """`--virtual-devices 2 --mesh 1x2 --eval` of the full Keller-Segel
    checkpoint against the JAX CLI's computation (its trainer's eval rollout
    of the best actor, trained and without action). The JAX CLI itself cannot
    read a full checkpoint on a mesh: its `load_sharded` template has a
    replay of capacity 1 (ROADMAP queue 3); the port's reads it."""
    argv = ["KellerSegel10_16", "--eval", "--virtual-devices", "2", "--mesh", "1x2",
            "--load-from", ARTIFACT, "--p-te", "0.06"]
    with pytest.raises(ValueError, match="replay state shape"):
        jrun.main(argv + ["--out", str(tmp_path / "jax")])
    capsys.readouterr()
    trun.main(argv + ["--out", str(tmp_path / "port")])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jtr = JTrainer(jkss.KELLER_SEGEL_10_16, jmesh(1, 2), JTCfg(n_envs=1))
    actor = jax.tree.map(jnp.asarray, load_best_actor(ARTIFACT))
    want = {}
    for label, ta in (("trained", 0), ("no action", 10)):
        rec = jtr.make_eval_fn(10, t_action_steps=ta)(actor, jtr.eval_w0(1))
        want[label] = float(np.asarray(rec["energy"])[np.asarray(rec["active"])].mean())
    assert got["mesh"] == "1x2" and got["grid"] == NX
    for k in ("trained", "no action"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    assert got["trained"] != got["no action"]
