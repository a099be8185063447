"""The port's KS22 controlled-rollout slice against the JAX package.

The shipped KS22 actor (artifacts/KS22/saves/hook.npz) is carried across
with `actor_from_jax` and driven through the port's `rollout` and the eval
half of `BatchedTrainer`; both run on the CPU (K1's plain version) and are
held against the same JAX functions on the same initial fields.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedconvrl_pde_control_tpu.configs import ks as jks
from distributedconvrl_pde_control_tpu.train.batched import BatchedTrainer as JaxBatchedTrainer
from distributedconvrl_pde_control_tpu.train.batched import BatchedTrainerConfig as JaxBTConfig
from distributedconvrl_pde_control_tpu.train.eval import actor_policy as jax_actor_policy
from distributedconvrl_pde_control_tpu.train.eval import rollout as jax_rollout
from distributedconvrl_pde_control_torch.configs import ks as tks
from distributedconvrl_pde_control_torch.experiments import run as trun
from distributedconvrl_pde_control_torch.train.batched import BatchedTrainer, BatchedTrainerConfig
from distributedconvrl_pde_control_torch.train.checkpoint import actor_from_jax, load_best_actor
from distributedconvrl_pde_control_torch.train.eval import actor_policy, rollout

ARTIFACT = "artifacts/KS22"
# 20 env steps of a chaotic field: f32 transform-order differences between
# torch.fft and XLA's FFT grow to ~1e-5; the tolerances leave 10x room
Y_ATOL = 1e-4
R_RTOL = 1e-4


@pytest.fixture(scope="module")
def actors():
    params = load_best_actor(ARTIFACT)
    jax_params = [{"w": jnp.asarray(p["w"]), "b": jnp.asarray(p["b"])} for p in params]
    return jax_params, actor_from_jax(params)


def test_load_best_actor_reads_hook_npz(actors):
    params = load_best_actor(ARTIFACT)
    with np.load(f"{ARTIFACT}/saves/hook.npz") as z:
        assert [p["w"].shape for p in params] == [(6, 1), (1, 6)]
        for i, p in enumerate(params):
            np.testing.assert_array_equal(p["w"], z[f"best_actor_w{i}"])
            np.testing.assert_array_equal(p["b"], z[f"best_actor_b{i}"])


def test_actor_forward_matches(actors):
    jax_params, actor = actors
    jagent = jks.build_ks(jks.KS22).agent
    tagent = tks.build_ks(tks.KS22, device="cpu").agent
    obs = np.random.default_rng(0).uniform(-1, 1, (1, 64)).astype(np.float32)
    want = np.asarray(jagent.actor_apply(jax_params, jnp.asarray(obs)))
    with torch.no_grad():
        got = tagent.actor_apply(actor, torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_rollout_matches_jax(actors):
    """20 steps from the standard y0, actuation from t=1.0."""
    jax_params, actor = actors
    js, ts = jks.build_ks(jks.KS22), tks.build_ks(tks.KS22, device="cpu")
    want = jax_rollout(js.env, jax_actor_policy(js.agent, jax_params), te=2.0, t_action=1.0)
    got = rollout(ts.env, actor_policy(ts.agent, actor), te=2.0, t_action=1.0)
    assert got["y"].shape == want["y"].shape == (20, 192)
    assert got["action"].shape == want["action"].shape == (20, 1, 8)
    assert got["steps"] == want["steps"] == 20 and got["completed"] and want["completed"]
    np.testing.assert_array_equal(got["active"], want["active"])
    np.testing.assert_array_equal(got["action"][:10], 0.0)
    np.testing.assert_allclose(got["y"], want["y"], rtol=0, atol=Y_ATOL)
    np.testing.assert_allclose(got["reward"], want["reward"], rtol=R_RTOL, atol=1e-7)
    np.testing.assert_allclose(got["action"], want["action"], rtol=R_RTOL, atol=1e-6)
    np.testing.assert_allclose(got["forcing"], want["forcing"], rtol=R_RTOL, atol=1e-5)
    np.testing.assert_allclose(got["time"], want["time"])


@pytest.mark.parametrize("te_s", [5.0, 0.5])  # 0.5: the te-override clone runs
@pytest.mark.parametrize("score", ["mean", "min"])
def test_eval_mean_reward_matches_jax(actors, te_s, score):
    """4 shared random ICs, 10 scored steps after 2 uncontrolled ones."""
    jax_params, actor = actors
    js = jks.build_ks(dataclasses.replace(jks.KS22, te=te_s))
    ts = tks.build_ks(dataclasses.replace(tks.KS22, te=te_s), device="cpu")
    y0s = np.stack([np.asarray(js.random_init(k)) for k in jax.random.split(jax.random.PRNGKey(3), 4)])
    jtr = JaxBatchedTrainer(js.env, js.agent, JaxBTConfig(n_envs=4), eval_y0_pool=y0s)
    key = jax.random.PRNGKey(0)
    drawn = np.array(jtr._fresh_eval_y0s(key, 4))
    want = jtr.eval_mean_reward(jax_params, 10, key=key, warmup_steps=2, score=score)
    ttr = BatchedTrainer(ts.env, ts.agent, BatchedTrainerConfig(n_envs=4))
    got = ttr.eval_mean_reward(actor, 10, warmup_steps=2, score=score, y0s=torch.from_numpy(drawn))
    assert np.isfinite(got) and got < 0
    np.testing.assert_allclose(got, want, rtol=R_RTOL)


def test_fresh_eval_y0s_sources():
    """Held-out pool first, then the training pool, then random_init, then
    the env's default y0 - the JAX trainer's order of IC sources."""
    ts = tks.build_ks(tks.KS22, device="cpu")
    cfg = BatchedTrainerConfig(n_envs=5)
    pool, eval_pool = torch.randn(3, 192), torch.randn(2, 192)

    def draw(**kw):
        return BatchedTrainer(ts.env, ts.agent, cfg, **kw)._fresh_eval_y0s(
            torch.Generator().manual_seed(0), 5)

    def rows_of(got, src):
        return all(any(torch.equal(g, s) for s in src) for g in got)

    assert rows_of(draw(y0_pool=pool, eval_y0_pool=eval_pool), eval_pool)
    assert rows_of(draw(y0_pool=pool, random_init=ts.random_init), pool)
    drawn = draw(random_init=ts.random_init)
    np.testing.assert_array_equal(drawn.numpy(), ts.random_init(torch.Generator().manual_seed(0), 5).numpy())
    assert rows_of(draw(), ts.env.y0[None])


def test_random_init_law():
    """generate_random_init (KSSetup.jl:288-298) as the JAX init computes it:
    8 unit-norm uniform sine coefficients, the field rescaled to ||y0|| = 30.
    The port draws the coefficients from a torch.Generator, so the check
    replays its draw through the JAX formula in numpy."""
    init = tks.ks_random_init(tks.KS22, device="cpu")
    got = init(torch.Generator().manual_seed(0), 5)
    assert got.shape == (5, 192) and got.dtype == torch.float32
    a = (torch.rand((5, 8), generator=torch.Generator().manual_seed(0)) * 2.0 - 1.0).numpy()
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    x = np.arange(1, 193, dtype=np.float32) * np.float32(22.0 / 192)
    harm = np.stack([np.sin(i * x / np.float32(2 * np.pi)) for i in range(1, 9)])
    want = a @ harm
    want *= 30.0 / np.linalg.norm(want, axis=-1, keepdims=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(torch.linalg.norm(got, dim=-1).numpy(), 30.0, rtol=1e-5)


def test_build_ks_refuses_unported_tiers():
    """The float32 ETDRK4 stepper builds; the reduced-precision transform
    tiers, ported now, build on both steppers (CNAB2's K1 stays float32) and
    only an unknown mode is refused; a carry without ETDRK4 stays a
    ValueError."""
    setup = tks.build_ks(dataclasses.replace(tks.KS22, stepper="etdrk4"), device="cpu")
    assert type(setup.env.step_fn.__self__).__name__ == "KSSolverETDRK4"
    assert setup.env.step_fn.__self__.oversampling == 1
    tier = tks.build_ks(dataclasses.replace(tks.KS22, stepper="etdrk4", fft_mode="matmul_hi"),
                        device="cpu")
    assert tier.env.step_fn.__self__.fft_mode == "matmul_hi"
    assert type(tks.build_ks(dataclasses.replace(tks.KS22, fft_mode="matmul_hi"),
                             device="cpu").env.step_fn.__self__).__name__ == "KSSolver"
    with pytest.raises(ValueError, match="unknown fft mode"):
        tks.build_ks(dataclasses.replace(tks.KS22, fft_mode="bf16"), device="cpu")
    with pytest.raises(ValueError):
        tks.build_ks(dataclasses.replace(tks.KS22, spectral_carry=True), device="cpu")


def test_cli_eval_at_nx_190_matches_the_jax_cli(tmp_path, capsys):
    """KS22 at nx = 190 (2 mod 4: K1's passes (2, 5) and a generic 19 on the
    card, its plain version here) against the JAX CLI's own run."""
    from distributedconvrl_pde_control_tpu.experiments import run as jrun

    argv = ["KS22", "--eval", "--load-from", ARTIFACT, "--config-overrides", '{"nx": 190}',
            "--p-te", "20", "--cpu"]
    trun.main(argv + ["--out", str(tmp_path / "port")])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jrun.main(argv + ["--out", str(tmp_path / "jax")])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert abs(got["suppression"] - want["suppression"]) <= 1e-5
    assert 0.0 < got["suppression"] < 1.0


def test_cli_eval_prints_the_three_keys(actors, capsys):
    """The CLI's numbers against the JAX CLI's formula (run.py:1128-1137)
    on the JAX rollout of the same actor and protocol (te=20, t_action=10)."""
    trun.main(["KS22", "--eval", "--load-from", ARTIFACT, "--p-te", "20", "--p-t-action", "10",
               "--cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"pre_control_mean_abs_dev", "post_control_mean_abs_dev", "suppression"}
    jax_params, _ = actors
    js = jks.build_ks(jks.KS22)
    y = jax_rollout(js.env, jax_actor_policy(js.agent, jax_params), te=20.0, t_action=10.0)["y"]
    act_start = int(round(10.0 / js.env.dt))
    pre = float(np.abs(y[max(0, act_start - 100):act_start]).mean())
    post = float(np.abs(y[-max(1, y.shape[0] // 10):]).mean())
    np.testing.assert_allclose(
        [out["pre_control_mean_abs_dev"], out["post_control_mean_abs_dev"], out["suppression"]],
        [pre, post, post / pre], rtol=R_RTOL)
