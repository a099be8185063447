"""reproduce_torch.py against reproduce.py on the CPU.

Three of its rows, one per loader kind: KS22 (the full checkpoint with a
row-major replay), KS22_global (the mono agent's light checkpoint on its
fixed y0) and KS200 -> KS500 (a transfer to another grid), each at te=20
with actuation from t=10. The port's y trace is held to the JAX rollout of
the same row at 1e-4 of the trace's largest value, and the printed numbers
to reproduce.py's `suppression`. On the CPU the port runs K1's plain version.
"""

import json

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
    """`main` prints one JSON line per KS row of reproduce.py, with its keys,
    in its order (the rollouts stubbed out)."""
    monkeypatch.setattr(reproduce_torch, "suppression",
                        lambda setup, actor, te, t_action: {"pre": te, "post": t_action,
                                                            "suppression": 0.5})
    assert reproduce_torch.main(["--cpu", "--te", "3", "--t-action", "1"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert len(lines) == 20 and lines[0]["row"] == "KS22 stabilization"
    assert lines[-1] == {"row": "KS200 (hyperopt winner) stabilization", "pre": 3.0, "post": 1.0,
                         "suppression": 0.5}
    assert sum("KS22_global" in line["row"] for line in lines) == 2
