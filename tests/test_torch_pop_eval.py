"""The port's population evaluation scripts against the JAX package's on the
CPU: the shipped Keller-Segel fields of keys 7-10 against JAX's draws, one
Keller-Segel member and one fluid member cut in depth against what
eval_kss_pop.py and eval_fluid_pop.py compute, and the batched rollouts the
port's scripts use against one rollout per env.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eval_fluid_pop
import eval_fluid_pop_torch
import eval_kss_pop_torch
from distributedconvrl_pde_control_tpu.agents import policies as jpol
from distributedconvrl_pde_control_tpu.configs import keller_segel as jkss
from distributedconvrl_pde_control_tpu.experiments import run as jrun
from distributedconvrl_pde_control_tpu.train import checkpoint as jckpt
from distributedconvrl_pde_control_tpu.train import eval as jeval
from distributedconvrl_pde_control_tpu.train.loop import init_train_state
from distributedconvrl_pde_control_torch.configs import keller_segel as tkss
from distributedconvrl_pde_control_torch.experiments import run as trun
from distributedconvrl_pde_control_torch.train import checkpoint
from distributedconvrl_pde_control_torch.train.eval import (
    actor_policy,
    per_env_policy,
    rollout,
    rollouts,
)

KSS_POP = "artifacts/KellerSegel_popsearch_pop8"
FLUID_POP = "artifacts/Fluid_8_tp_pop8"
SMALL_FLUID = {"nx": 32}  # Fluid_8's 8x8 actuators and featurizer on a 32^2 grid
KSS_TE, KSS_T_ACTION = 0.9, 0.3  # 150 env steps, actuation from step 50


def _jax_actor(setup, run_dir):
    tmpl = init_train_state(setup.env, setup.agent, jax.random.PRNGKey(0))
    ts, hook = jckpt.load(run_dir, tmpl)
    return jax.tree.map(jnp.asarray, hook.best_actor if hook.best_actor is not None
                        else ts.agent.actor)


@pytest.mark.parametrize("seed", [7, 8, 9, 10])
def test_shipped_keller_segel_fields_are_jax_draws(seed):
    """configs/data_keller_segel_y0_key{seed}.npy is the JAX package's
    `random_init(PRNGKey(seed))` of KellerSegel10_16_fast, bit for bit."""
    want = jkss.build_keller_segel(jkss.KELLER_SEGEL_10_16_FAST).random_init(
        jax.random.PRNGKey(seed))
    np.testing.assert_array_equal(tkss.keller_segel_y0_key(seed), np.asarray(want, np.float32))


def test_unshipped_keller_segel_key_is_refused():
    with pytest.raises(ValueError, match="does not ship"):
        tkss.keller_segel_y0_key(11)


def test_keller_segel_member_matches_jax():
    """Member 0 of the Keller-Segel study from keys 7 and 9, cut to 150 env
    steps: eval_kss_pop.py's pre and post |u - 1| (JAX's rollout, one seed at a
    time) against the port's batched rollout, rel 1e-4 (float32 finite
    differences and products summed in other orders, over 150 steps)."""
    jsetup = jkss.build_keller_segel(jkss.KELLER_SEGEL_10_16_FAST)
    jpolicy = jeval.actor_policy(jsetup.agent, _jax_actor(jsetup, f"{KSS_POP}/member_00"))
    setup = tkss.build_keller_segel(tkss.KELLER_SEGEL_10_16_FAST, device="cpu")
    actor = checkpoint.load_actor(f"{KSS_POP}/member_00", setup.agent, device="cpu")
    got = eval_kss_pop_torch.member_row(setup, actor, [7, 9], te=KSS_TE, t_action=KSS_T_ACTION)
    act_start = int(round(KSS_T_ACTION / jsetup.env.dt))
    for s in (7, 9):
        tr = jeval.rollout(jsetup.env, jpolicy, y0=jsetup.random_init(jax.random.PRNGKey(s)),
                           te=KSS_TE, t_action=KSS_T_ACTION)
        dev = np.abs(np.asarray(tr["y"])[:, 0] - 1.0)  # eval_kss_pop.py's numbers
        want = {"pre": float(dev[max(0, act_start - 100):act_start].mean()),
                "post": float(dev[-len(dev) // 10:].mean())}
        for k in ("pre", "post"):
            assert got[s][k] == pytest.approx(want[k], rel=1e-4), (s, k)
    row = eval_kss_pop_torch.printed_row(0, got)
    assert list(row) == ["member", "seed7", "seed7_supp", "seed9", "seed9_supp"]


def test_fluid_member_matches_jax():
    """Member 0 of the Fluid_8_tp study and the two baselines on Fluid_8's
    env at 32^2, cut to 5 env steps: eval_fluid_pop.py's prefix means (JAX's
    rollouts, one policy at a time) against the port's one batched rollout,
    rel 1e-4 (float32 FFTs over adaptive RK4 substeps)."""
    jsetup = jrun.build_setup("Fluid_8", SMALL_FLUID)
    env = jsetup.env
    policies = {("member", 0): jeval.actor_policy(jsetup.agent,
                                                  _jax_actor(jsetup, f"{FLUID_POP}/member_00")),
                ("baseline", "negate"): jpol.NegatePolicy(
                    env.action_shape, center_row=jpol.negate_center_row(env.featurize)),
                ("baseline", "no_action"): jpol.ZeroPolicy(env.action_shape)}
    tes = (0.06, 0.1)
    rows = dict(eval_fluid_pop_torch.evaluate(FLUID_POP, "Fluid_8", 1, device="cpu", te=0.1,
                                              tes=tes, config_overrides=SMALL_FLUID))
    assert list(rows) == list(policies)
    for label, pol in policies.items():
        tr = jeval.energy_eval(env, pol, te=0.1)
        e, m = np.asarray(tr["energy"]), np.asarray(tr["active"])
        printed = eval_fluid_pop.prefix_means(tr, env, tes)
        for te in tes:
            n = int(round(te / env.dt))
            want = float(e[:n][m[:n]].mean())
            assert rows[label][f"te{te:g}"] == pytest.approx(want, rel=1e-4), (label, te)
            assert printed[f"te{te:g}"] == round(want, 3)
        if label[0] == "member":
            want_r = float(np.asarray(tr["reward"])[m].mean())
            assert rows[label]["mean_step_reward"] == pytest.approx(want_r, rel=1e-4)
    line = eval_fluid_pop_torch.printed_row(("member", 0), rows[("member", 0)])
    assert list(line) == ["member", "te0.06", "te0.1", "mean_step_reward"]
    json.dumps(line)


def _same_traces(batched, singles, rtol=1e-5):
    for i, single in enumerate(singles):
        for k in ("y", "reward", "action"):
            got, want = batched[k][:, i], single[k]
            assert np.abs(got - want).max() <= rtol * np.abs(want).max(), (i, k)
        np.testing.assert_array_equal(batched["active"][:, i], single["active"])


def test_batched_seeds_equal_one_rollout_per_seed():
    """The Keller-Segel script's batch of seeds against one rollout per seed:
    the same fields, actions and rewards (rel 1e-5: a batch's products may sum
    in another order) and the same active steps."""
    setup = tkss.build_keller_segel(tkss.KELLER_SEGEL_10_16_FAST, device="cpu")
    actor = checkpoint.load_actor(f"{KSS_POP}/member_01", setup.agent, device="cpu")
    policy = actor_policy(setup.agent, actor)
    y0s = torch.as_tensor(np.stack([tkss.keller_segel_y0_key(s) for s in (8, 10)]))
    batched = rollouts(setup.env, policy, y0s, te=0.3, t_action=0.06)
    _same_traces(batched, [rollout(setup.env, policy, y0=y0, te=0.3, t_action=0.06)
                           for y0 in y0s])


def test_batched_members_equal_one_rollout_per_member():
    """The fluid script's batch of members and baselines, each env with its own
    policy and adaptive step control, against one rollout per policy."""
    from distributedconvrl_pde_control_torch.agents.policies import ZeroPolicy

    setup = trun.build_setup(dataclasses.replace(trun.preset_config("Fluid_8"), **SMALL_FLUID),
                             device="cpu")
    pols = [actor_policy(setup.agent, checkpoint.load_actor(f"{FLUID_POP}/member_0{i}",
                                                            setup.agent, device="cpu"))
            for i in (1, 5)] + [ZeroPolicy(setup.env.action_shape)]
    y0s = setup.env.y0[None].expand(3, -1, -1).contiguous()
    batched = rollouts(setup.env, per_env_policy(pols), y0s, te=0.06)
    _same_traces(batched, [rollout(setup.env, p, te=0.06) for p in pols])
