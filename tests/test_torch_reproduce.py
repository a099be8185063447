"""reproduce_torch.py against reproduce.py on the CPU.

Three KS rows, one per loader kind: KS22 (the full checkpoint with a
row-major replay), KS22_global (the mono agent's light checkpoint on its
fixed y0) and KS200 -> KS500 (a transfer to another grid), each at te=20
with actuation from t=10. The port's y trace is held to the JAX rollout of
the same row at 1e-4 of the trace's largest value, and the printed numbers
to reproduce.py's `suppression`. On the CPU the port runs K1's plain version.
The KellerSegel10_16_fast row and the KellerSegel10_16_ppo row run at their
full te=12 against the JAX package's printed values, and the Fluid_8 energy
row, cut to 3 env steps, against the JAX package's rollout of it.
"""

import json

import jax

import numpy as np
import pytest

import reproduce
import reproduce_torch
from distributedconvrl_pde_control_tpu import configs as C
from distributedconvrl_pde_control_tpu.train.eval import actor_policy as jax_policy
from distributedconvrl_pde_control_tpu.train.eval import rollout as jax_rollout
from distributedconvrl_pde_control_torch.train.eval import actor_policy, rollout

TE, T_ACTION = 20.0, 10.0
ROWS = {
    "KS22 stabilization": lambda: reproduce.load_actor(lambda: C.build_ks(C.KS22),
                                                        "artifacts/KS22"),
    "KS22_global (mono, hand-tuned) stabilization": lambda: reproduce.load_actor(
        lambda: C.build_ks_global(C.KS22_GLOBAL), "artifacts/KS22_global"),
    "KS200 -> KS500 transfer": lambda: (
        C.build_ks(C.KS500), reproduce.load_actor(lambda: C.build_ks(C.KS200), "artifacts/KS200")[1]),
}


@pytest.fixture(scope="module")
def port_rows():
    return {row: (setup, actor) for row, setup, actor in reproduce_torch.ks_rows("cpu")
            if row in ROWS}


@pytest.mark.parametrize("row", list(ROWS))
def test_row_matches_reproduce(row, port_rows):
    setup, actor = port_rows[row]
    jsetup, jactor = ROWS[row]()
    got = rollout(setup.env, actor_policy(setup.agent, actor), te=TE, t_action=T_ACTION)["y"]
    want = np.asarray(jax_rollout(jsetup.env, jax_policy(jsetup.agent, jactor), te=TE,
                                  t_action=T_ACTION)["y"])
    assert got.shape == want.shape == (200, setup.env.y0.shape[0])
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-4 * scale
    assert np.abs(got[100:] - got[99]).max() > 0  # the controlled half moves
    out = reproduce_torch.suppression(setup, actor, TE, T_ACTION)
    ref = reproduce.suppression(jsetup, jactor, TE, T_ACTION)
    assert set(out) == set(ref) == {"pre", "post", "suppression"}
    for k in out:
        assert abs(out[k] - ref[k]) <= 1e-4 + 1e-3 * abs(ref[k])


def test_cli_prints_every_ks_row(capsys, monkeypatch):
    """`main` prints one JSON line per KS row of reproduce.py, then one per
    Keller-Segel DDPG row, then the Keller-Segel PPO row, with its keys, in
    its order, each beside the JAX package's value (the rollouts stubbed
    out)."""
    monkeypatch.setattr(reproduce_torch, "suppression",
                        lambda setup, actor, te, t_action: {"pre": te, "post": t_action,
                                                            "suppression": 0.5})
    monkeypatch.setattr(reproduce_torch, "regulation",
                        lambda setup, actor: {"pre": 0.4964, "post": 0.007})
    monkeypatch.setattr(reproduce_torch, "ppo_regulation",
                        lambda setup, policy: {"pre": 0.4903, "post": 0.2693})
    assert reproduce_torch.main(["--cpu", "--te", "3", "--t-action", "1"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert len(lines) == 26 and lines[0]["row"] == "KS22 stabilization"
    assert lines[19] == {"row": "KS200 (hyperopt winner) stabilization", "pre": 3.0, "post": 1.0,
                         "suppression": 0.5, "jax": 0.0212, "ok": False}
    assert sum("KS22_global" in line["row"] for line in lines) == 2
    assert [line["row"] for line in lines[20:25]] == list(reproduce_torch.JAX_KELLER_SEGEL_ROWS)
    assert [line["ok"] for line in lines[20:25]] == [False, True, True, True, True]
    assert lines[25] == {"row": "KellerSegel10_16_ppo regulation", "pre": 0.4903, "post": 0.2693,
                         "jax": {"pre": 0.4903, "post": 0.2693}, "ok": True}


def test_keller_segel_row_matches_jax():
    """The KellerSegel10_16_fast row at its full te=12 (2000 steps, actuation
    from t=4) from the JAX package's key-8 field, within the row's limits of
    JAX's printed value: pre within 1e-3, post within max(0.1 JAX, 0.0005)."""
    row, setup, actor = next(reproduce_torch.keller_segel_rows("cpu"))
    assert row == "KellerSegel10_16_fast regulation"
    got = reproduce_torch.regulation(setup, actor, ndigits=None)
    want = reproduce_torch.JAX_KELLER_SEGEL_ROWS[row]
    assert reproduce_torch.keller_segel_ok(got, want), (got, want)


def test_keller_segel_ppo_row_matches_jax():
    """The KellerSegel10_16_ppo row at its full te=12 (actuation from t=6)
    from the JAX package's key-7 field, which ships as data and is
    `random_init(PRNGKey(7))` of the JAX package, within the row's limits of
    JAX's printed value."""
    from distributedconvrl_pde_control_torch.configs.keller_segel import keller_segel_y0_key7

    jsetup = C.build_keller_segel(C.KELLER_SEGEL_10_16_FAST)
    want_y0 = np.asarray(jsetup.random_init(jax.random.PRNGKey(7, impl="threefry2x32")))
    np.testing.assert_array_equal(keller_segel_y0_key7(), want_y0)
    row, setup, policy = next(reproduce_torch.ppo_rows("cpu"))
    assert row == "KellerSegel10_16_ppo regulation"
    got = reproduce_torch.ppo_regulation(setup, policy, ndigits=None)
    want = reproduce_torch.JAX_PPO_ROWS[row]
    assert reproduce_torch.keller_segel_ok(got, want), (got, want)


def test_fluid_8_energy_row_matches_jax():
    """The Fluid_8 row's trained-actor energy, cut to 3 env steps (te=0.06)
    at the preset's 128^2 grid with the adaptive stepper, against the JAX
    package's `energy_eval` of the same actor in this test: the energy trace
    within 1e-4 of its value."""
    from distributedconvrl_pde_control_tpu.train.eval import energy_eval as jax_energy_eval
    from distributedconvrl_pde_control_torch.train.eval import energy_eval

    row, setup, actor = next(reproduce_torch.fluid_rows("cpu"))
    assert row == "Fluid_8 energy"
    got = energy_eval(setup.env, actor_policy(setup.agent, actor), te=0.06)
    jsetup, jactor = reproduce.load_actor(lambda: C.build_fluid(C.FLUID_8), "artifacts/Fluid_8")
    want = jax_energy_eval(jsetup.env, jax_policy(jsetup.agent, jactor), te=0.06)
    assert got["energy"].shape == (3,) and bool(np.asarray(got["active"]).all())
    np.testing.assert_allclose(got["energy"], np.asarray(want["energy"]), rtol=1e-4)
    np.testing.assert_allclose(got["mean_energy"], want["mean_energy"], rtol=1e-4)
