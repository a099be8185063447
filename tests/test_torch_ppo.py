"""The port's PPO agent, trainer and checkpoint against the JAX package.

Same numpy inputs through both: the heads, the log-probability and GAE at
1e-6; one `update` on JAX's permutations, with the gradient clip firing and
idle, and one `collect_and_update` iteration on KS22 (2 envs, the port's plain
K1) on every JAX draw, at 1e-5; the deterministic eval with its warmup and te
extension; `train_ppo`'s selection; and the checkpoint both ways on every
shipped PPO artifact, byte for byte in the msgpack file.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedconvrl_pde_control_tpu.agents import ppo as jppo
from distributedconvrl_pde_control_tpu.configs import ks as jks
from distributedconvrl_pde_control_tpu.train import checkpoint as jckpt
from distributedconvrl_pde_control_torch.agents import ppo as tppo
from distributedconvrl_pde_control_torch.configs import ks as tks
from distributedconvrl_pde_control_torch.experiments import run as trun
from distributedconvrl_pde_control_torch.train import checkpoint

ARTIFACTS = ["KS22_ppo", "KS22_ppo_ref", "KS22_ppo_lh", "KS22_ppo_ref_lh", "Fluid_8_ppo",
             "Fluid_8_ppo_lh", "KellerSegel10_16_ppo"]
SMALL = dict(ns=3, na=2, hidden=8)


def key(seed):
    return jax.random.PRNGKey(seed, impl="threefry2x32")


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def port_params(jparams, device="cpu"):
    return tppo.params_from_numpy(to_np(jparams), device)


def assert_params_close(got: dict, want, atol):
    got = tppo.params_to_numpy(got)
    for name in tppo.PARAM_NAMES:
        for g, w in zip(got[name], to_np(want[name])):
            for leaf in ("w", "b"):
                np.testing.assert_allclose(g[leaf], w[leaf], atol=atol, rtol=0,
                                           err_msg=f"{name} {leaf}")


def port_moments(jmoments) -> list:
    """optax's mu or nu tree in `param_tensors` order."""
    return [np.asarray(l[leaf]) for name in tppo.PARAM_NAMES for l in jmoments[name]
            for leaf in ("w", "b")]


# ----------------------------------------------------------------- network
def test_heads_logp_and_gae_match_jax():
    cfg = jppo.PPOConfig(**SMALL, gamma=0.9, gae_lambda=0.8)
    jagent, tagent = jppo.PPOAgent(cfg), tppo.PPOAgent(tppo.PPOConfig(**SMALL, gamma=0.9,
                                                                      gae_lambda=0.8))
    jparams = jagent._params(jagent.init_state(key(3)))
    params = port_params(jparams)
    rng = np.random.default_rng(0)
    obs = rng.uniform(-2, 2, (3, 40)).astype(np.float32)
    eps = np.array(jax.random.normal(key(4), (2, 40)))
    with torch.no_grad():
        mu, sig = tagent.dist(params, torch.from_numpy(obs))
        v = tagent.value(params, torch.from_numpy(obs))
        raw, env_a, logp = tagent.sample(params, torch.from_numpy(obs), torch.from_numpy(eps))
    jmu, jsig = jagent.dist(jparams, jnp.asarray(obs))
    jraw, jenv, jlogp = jagent.sample(jparams, jnp.asarray(obs), key(4))
    for got, want in ((mu, jmu), (sig, jsig), (v, jagent.value(jparams, jnp.asarray(obs))),
                      (raw, jraw), (env_a, jenv), (logp, jlogp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert np.abs(np.asarray(jraw)).max() > 1.0 >= np.abs(env_a.numpy()).max()  # the clip acts
    np.testing.assert_allclose(tagent._logp(mu, sig, raw).numpy(), np.asarray(jlogp), atol=1e-6)

    T, B = 7, 5
    r, vals = rng.standard_normal((2, T, B)).astype(np.float32)
    d = np.zeros((T, B), np.float32)
    d[2, 0] = d[5, 3] = d[6, 4] = 1.0
    last = rng.standard_normal(B).astype(np.float32)
    adv, ret = tagent.gae(*(torch.from_numpy(x) for x in (r, vals, d, last)))
    jadv, jret = jagent.gae(*(jnp.asarray(x) for x in (r, vals, d, last)))
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), atol=1e-6, rtol=0)


# ------------------------------------------------------------------ update
@pytest.mark.parametrize("max_norm,fires", [(1e-3, True), (1e6, False)], ids=["clip", "no-clip"])
def test_update_matches_jax(max_norm, fires):
    kw = dict(SMALL, n_epochs=3, n_microbatches=4, max_grad_norm=max_norm, learning_rate=3e-3)
    jagent, tagent = jppo.PPOAgent(jppo.PPOConfig(**kw)), tppo.PPOAgent(tppo.PPOConfig(**kw))
    jstate = jagent.init_state(key(5))
    rng = np.random.default_rng(1)
    n = 42  # 4 microbatches of 10, the tail of 2 dropped
    batch = {"obs": rng.uniform(-2, 2, (3, n)), "actions": rng.standard_normal((2, n)),
             "logp": rng.standard_normal(n) - 2.0, "adv": rng.standard_normal(n),
             "ret": rng.standard_normal(n)}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    k_up = key(6)
    perms = np.stack([np.asarray(jax.random.permutation(k, n))
                      for k in jax.random.split(k_up, kw["n_epochs"])])
    jnew, (j_aloss, j_closs) = jagent.update(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                             k_up)
    state = tagent.make_state(port_params(jagent._params(jstate)))
    grads_norm = []
    orig = tagent._apply_gradients

    def spy(state, params, grads):
        grads_norm.append(float(torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))))
        orig(state, params, grads)

    tagent._apply_gradients = spy
    state, losses = tagent.update(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                  perms=torch.from_numpy(perms))
    assert (max(grads_norm) > max_norm) == fires and len(grads_norm) == 12
    assert_params_close(tagent._params(state), jagent._params(jnew), atol=1e-5)
    adam = jnew.opt_state[1][0]
    assert state.adam_count == int(adam.count) == 12 and state.update_count == 1
    for got, want in ((state.adam_mu, adam.mu), (state.adam_nu, adam.nu)):
        for g, w in zip(got, port_moments(to_np(want))):
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0)
    np.testing.assert_allclose(losses[..., 0].numpy(), np.asarray(j_aloss), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(losses[..., 1].numpy(), np.asarray(j_closs), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------- one KS22 iteration
ITER = dict(rollout_len=8, n_microbatches=4, n_epochs=2, learning_rate=3e-4)
N_ENVS = 2


@functools.lru_cache(maxsize=None)
def jax_iteration():
    """A JAX `collect_and_update` on KS22 (episodes of 5 steps, so that envs
    finish and reset inside the rollout of 8), and every draw it made."""
    jsetup = jks.build_ks(dataclasses.replace(jks.KS22, fft_mode="native", te=0.5))
    cfg = jppo.PPOConfig(ns=jsetup.agent.cfg.ns, na=1, **ITER)
    agent = jppo.PPOAgent(cfg)
    init = jks.ks_random_init(jks.KS22)
    trainer = jppo.PPOTrainer(jsetup.env, agent, n_envs=N_ENVS, random_init=init)
    pstate = agent.init_state(key(7))
    k = key(8)
    k_init, k_roll, k_up = jax.random.split(k, 3)
    b = N_ENVS * 8
    step_keys = jax.random.split(k_roll, cfg.rollout_len)
    draws = dict(
        y0s=np.array(trainer._y0s(k_init)),
        eps=np.stack([np.asarray(jax.random.normal(kt, (1, b))) for kt in step_keys]),
        fresh=np.stack([np.asarray(trainer._y0s(kt)) for kt in step_keys]),
        perms=np.stack([np.asarray(jax.random.permutation(ke, cfg.rollout_len * b))
                        for ke in jax.random.split(k_up, cfg.n_epochs)]))
    new, mean_r = trainer.make_train_iter()(pstate, k)
    return to_np(agent._params(pstate)), draws, to_np(agent._params(new)), float(mean_r)


def test_train_iteration_matches_jax():
    params0, draws, want, want_r = jax_iteration()
    setup = tks.build_ks(dataclasses.replace(tks.KS22, te=0.5), device="cpu")
    agent = tppo.PPOAgent(tppo.PPOConfig(ns=setup.agent.cfg.ns, na=1, **ITER))
    trainer = tppo.PPOTrainer(setup.env, agent, n_envs=N_ENVS, random_init=setup.random_init)
    state = agent.make_state(tppo.params_from_numpy(params0, "cpu"))
    state, mean_r = trainer.make_train_iter()(
        state, torch.Generator().manual_seed(0),
        tppo.PPODraws(**{k: torch.from_numpy(v) for k, v in draws.items()}))
    assert abs(float(mean_r) - want_r) <= 1e-5 and want_r < 0
    assert_params_close(agent._params(state), want, atol=1e-5)
    assert state.adam_count == 8 and state.update_count == 1
    moved = max(np.abs(a["w"] - b["w"]).max() for a, b in zip(want["trunk"], params0["trunk"]))
    assert moved > 1e-4


def test_eval_mean_reward_matches_jax_with_warmup_past_te():
    """20 scored steps after 6 uncontrolled ones on envs whose episodes end
    at step 5: the te-extended clone and the warmup, as the JAX eval runs."""
    jsetup = jks.build_ks(dataclasses.replace(jks.KS22, fft_mode="native", te=0.5))
    jagent = jppo.PPOAgent(jppo.PPOConfig(ns=jsetup.agent.cfg.ns, na=1))
    jparams = jagent._params(jagent.init_state(key(9)))
    pool = np.stack([np.asarray(jks.ks_random_init(jks.KS22)(key(i))) for i in range(3)])
    jtr = jppo.PPOTrainer(jsetup.env, jagent, n_envs=3, y0_pool=pool)
    k = key(10)
    drawn = np.array(jtr._eval_y0s(k))
    want = jtr.eval_mean_reward(jparams, 20, key=k, warmup_steps=6)

    setup = tks.build_ks(dataclasses.replace(tks.KS22, te=0.5), device="cpu")
    agent = tppo.PPOAgent(tppo.PPOConfig(ns=setup.agent.cfg.ns, na=1))
    ttr = tppo.PPOTrainer(setup.env, agent, n_envs=3, y0_pool=torch.from_numpy(pool))
    got = ttr.eval_mean_reward(port_params(jparams), 20, warmup_steps=6,
                               y0s=torch.from_numpy(drawn))
    assert np.isfinite(want) and abs(got - want) <= 1e-6 + 1e-5 * abs(want)
    # the warmup changes what is scored
    assert abs(ttr.eval_mean_reward(port_params(jparams), 20, y0s=torch.from_numpy(drawn))
               - got) > 1e-6


@pytest.mark.parametrize("eval_every", [0, 2], ids=["rollout", "eval"])
def test_train_ppo_selects_as_jax_does(eval_every):
    """The best params are a copy of those after the selected iteration:
    the best mean rollout reward, or the best deterministic eval (every
    `eval_every` iterations and at the last)."""
    setup = tks.build_ks(dataclasses.replace(tks.KS22, te=0.5), device="cpu")
    agent = tppo.PPOAgent(tppo.PPOConfig(ns=setup.agent.cfg.ns, na=1, rollout_len=6,
                                         n_microbatches=2, n_epochs=1, hidden=8,
                                         learning_rate=3e-2))
    trainer = tppo.PPOTrainer(setup.env, agent, n_envs=2, random_init=setup.random_init)
    snaps = []
    it = trainer.make_train_iter
    trainer.make_train_iter = lambda: (lambda s, g: (lambda out: (
        snaps.append(tppo.params_to_numpy(agent._params(out[0]))) or out))(it()(s, g)))
    state, info = tppo.train_ppo(trainer, 5, torch.Generator().manual_seed(1), verbose=False,
                                 eval_every=eval_every, eval_steps=4)
    assert info["selection"] == ("eval" if eval_every else "rollout") and len(info["rewards"]) == 5
    if eval_every:
        assert [i for i, _ in info["evals"]] == [2, 4, 5]
        scores = dict(info["evals"])
    else:
        assert info["evals"] == []
        scores = {i + 1: r for i, r in enumerate(info["rewards"])}
    best = max(scores, key=scores.get)
    assert info["best_iter"] == best and info["best_reward"] == scores[best]
    for name in tppo.PARAM_NAMES:
        for g, w in zip(info["best_params"][name], snaps[best - 1][name]):
            np.testing.assert_array_equal(g["w"], w["w"])
    assert set(info) == {"rewards", "best_params", "best_reward", "best_iter", "evals",
                         "selection"}


# -------------------------------------------------------------- checkpoint
def jax_template(ns):
    agent = jppo.PPOAgent(jppo.PPOConfig(ns=ns, na=1))
    return agent.init_state(key(0))


@pytest.mark.parametrize("name", ARTIFACTS)
def test_shipped_ppo_checkpoint_both_ways(name, tmp_path):
    """The port reads every shipped PPO checkpoint leaf for leaf as JAX's
    `load_ppo` does, writes it back byte for byte, and JAX reads what the
    port writes."""
    path = f"artifacts/{name}"
    raw = open(f"{path}/saves/ppo.msgpack", "rb").read()
    ns = int(np.load(f"{path}/saves/ppo_info.npz")["best_['trunk'][0]['w']"].shape[1])
    jstate, jinfo = jckpt.load_ppo(path, jax_template(ns))
    agent = tppo.PPOAgent(tppo.PPOConfig(ns=ns, na=1))
    state, info = checkpoint.load_ppo(path, agent, device="cpu")
    assert_params_close(agent._params(state), jagent_params(jstate), atol=0)
    adam = jstate.opt_state[1][0]
    assert state.adam_count == int(adam.count) and state.update_count == int(jstate.update_count)
    for got, want in ((state.adam_mu, adam.mu), (state.adam_nu, adam.nu)):
        for g, w in zip(got, port_moments(to_np(want))):
            np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(info["rewards"], jinfo["rewards"])
    assert {k: info[k] for k in ("best_reward", "best_iter")} == {
        k: jinfo[k] for k in ("best_reward", "best_iter")}
    assert info.get("evals", []) == jinfo.get("evals", [])
    for n_ in tppo.PARAM_NAMES:
        for g, w in zip(info["best_params"][n_], to_np(jinfo["best_params"][n_])):
            np.testing.assert_array_equal(g["w"], w["w"])
            np.testing.assert_array_equal(g["b"], w["b"])

    out = tmp_path / "rt"
    checkpoint.save_ppo(str(out), state, info)
    assert (out / "saves" / "ppo.msgpack").read_bytes() == raw
    jstate2, jinfo2 = jckpt.load_ppo(str(out), jax_template(ns))
    for a, b in zip(jax.tree.leaves(to_np(jstate2)), jax.tree.leaves(to_np(jstate))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(to_np(jinfo2["best_params"])),
                    jax.tree.leaves(to_np(jinfo["best_params"]))):
        np.testing.assert_array_equal(a, b)
    with np.load(f"{path}/saves/ppo_info.npz") as z, np.load(out / "saves" / "ppo_info.npz") as z2:
        assert set(z.files) == set(z2.files)
        for k in z.files:
            if k != "meta":
                np.testing.assert_array_equal(z[k], z2[k])


def jagent_params(jstate):
    return {name: getattr(jstate, name) for name in tppo.PARAM_NAMES}


def test_port_written_ppo_run_reads_in_jax(tmp_path):
    """A port run's checkpoint (its own draws, Adam moments past step 0,
    eval selection) through JAX's `load_ppo`: every leaf equal."""
    setup = tks.build_ks(dataclasses.replace(tks.KS22, te=0.5), device="cpu")
    agent = tppo.PPOAgent(tppo.PPOConfig(ns=setup.agent.cfg.ns, na=1, rollout_len=4,
                                         n_microbatches=2, n_epochs=1))
    trainer = tppo.PPOTrainer(setup.env, agent, n_envs=2, random_init=setup.random_init)
    state, info = tppo.train_ppo(trainer, 2, torch.Generator().manual_seed(2), verbose=False,
                                 eval_every=1, eval_steps=3)
    checkpoint.save_ppo(str(tmp_path), state, info)
    jstate, jinfo = jckpt.load_ppo(str(tmp_path), jax_template(setup.agent.cfg.ns))
    assert_params_close(agent._params(state), jagent_params(jstate), atol=0)
    assert int(jstate.opt_state[1][0].count) == state.adam_count == 4  # 2 iterations x 2
    for g, w in zip(state.adam_nu, port_moments(to_np(jstate.opt_state[1][0].nu))):
        np.testing.assert_array_equal(g.numpy(), w)
    assert jinfo["selection"] == "eval" and jinfo["evals"] == [list(e) for e in info["evals"]]
    for n_ in tppo.PARAM_NAMES:
        for g, w in zip(info["best_params"][n_], to_np(jinfo["best_params"][n_])):
            np.testing.assert_array_equal(g["w"], w["w"])


# --------------------------------------------------------------------- CLI
def test_cli_ks22_ppo_train_then_eval(tmp_path, capsys):
    """`--ppo --train` at a toy size writes the PPO checkpoint with its eval
    selection; `--eval` rolls its best params and prints JAX's keys; a JAX
    `load_ppo` reads the run."""
    out = str(tmp_path / "ppo")
    trun.main(["KS22", "--train", "--ppo", "--cpu", "--iters", "2", "--n-envs", "2",
               "--eval-every", "1", "--eval-steps", "5", "--seed", "3", "--out", out,
               "--config-overrides", json.dumps({"te": 1.0})])
    text = capsys.readouterr().out
    assert f"saved PPO to {out}; best deterministic eval reward" in text
    jstate, jinfo = jckpt.load_ppo(out, jax_template(1))
    assert jinfo["selection"] == "eval" and len(jinfo["rewards"]) == 2
    assert json.load(open(f"{out}/config_overrides.json")) == {"te": 1.0}
    trun.main(["KS22", "--eval", "--ppo", "--cpu", "--load-from", out, "--p-te", "3",
               "--p-t-action", "1"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(res) == ["agent", "pre_control_mean_abs_dev", "post_control_mean_abs_dev",
                         "suppression"] and res["agent"] == "ppo"
    assert np.isfinite(res["suppression"])


def test_cli_ppo_eval_of_the_shipped_ks22_artifact_matches_jax(capsys):
    """The shipped KS22_ppo controller through `--eval --ppo` at te=20 (the
    port's plain K1), against the JAX CLI's numbers for the same protocol."""
    from distributedconvrl_pde_control_tpu.experiments import run as jrun

    argv = ["KS22", "--eval", "--ppo", "--load-from", "artifacts/KS22_ppo", "--p-te", "20",
            "--p-t-action", "10", "--cpu", "--out", "build/test_torch_ppo_eval"]
    jrun.main(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    trun.main(argv)
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == list(want)
    for k in ("pre_control_mean_abs_dev", "post_control_mean_abs_dev", "suppression"):
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]) + 1e-6, k


@pytest.mark.parametrize("preset,over,eval_args,keys", [
    ("KellerSegel10_16_fast", {"te": 0.03}, ["--p-te", "0.06", "--p-t-action", "0.03"],
     ["agent", "pre_control_mean_abs_dev", "post_control_mean_abs_dev", "suppression"]),
    ("Fluid_8", {"nx": 32, "sensors_per_axis": 4, "te": 0.06}, ["--p-te", "0.06"],
     ["agent", "mean_energy", "no_action", "mean_step_reward"]),
], ids=["keller-segel", "fluid"])
def test_cli_ppo_other_families(preset, over, eval_args, keys, tmp_path, capsys):
    """Keller-Segel (random_init fields) and fluid (a pool of 16 fields,
    and a held-out eval pool under --eval-warmup) through `--ppo --train`
    and `--eval --random-init` at toy sizes."""
    out = str(tmp_path / preset)
    trun.main([preset, "--train", "--ppo", "--cpu", "--iters", "1", "--n-envs", "2",
               "--eval-every", "1", "--eval-steps", "2", "--eval-warmup", "1", "--eval-pool", "2",
               "--out", out, "--config-overrides", json.dumps(over)])
    assert "saved PPO to" in capsys.readouterr().out
    ns = int(np.load(f"{out}/saves/ppo_info.npz")["best_['trunk'][0]['w']"].shape[1])
    state, info = checkpoint.load_ppo(out, tppo.PPOAgent(tppo.PPOConfig(ns=ns, na=1)),
                                      device="cpu")
    assert all(np.isfinite(t.detach().numpy()).all() for t in tppo.param_tensors(
        tppo.PPOAgent._params(state))) and np.isfinite(info["rewards"]).all()
    trun.main([preset, "--eval", "--ppo", "--cpu", "--load-from", out, "--random-init",
               "--seed", "4", *eval_args])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(res) == keys and all(np.isfinite(v) for v in list(res.values())[1:])
