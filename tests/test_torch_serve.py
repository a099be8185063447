"""The port's deployment surface against the JAX package on the CPU.

`build_control_step` (featurize + shared actor + clamp) against JAX's on the
shipped KS22, KellerSegel10_16_fast and Fluid_8 controllers, on the same
numpy field and observation; the `torch.export` round trip bit-equal to the
live step; the exported program loaded in a process where the port cannot be
imported; the serving probe's JSON line; the `--export-controller` and
`--serve` CLI. The card's round trip is `tests/test_torch_serve_gpu.py`.
"""

import inspect
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedconvrl_pde_control_tpu.experiments import export_controller as jexport
from distributedconvrl_pde_control_tpu.experiments import run as jrun
from distributedconvrl_pde_control_tpu.train import checkpoint as jckpt
from distributedconvrl_pde_control_tpu.train.loop import init_train_state
from distributedconvrl_pde_control_torch.experiments import export_controller as texport
from distributedconvrl_pde_control_torch.experiments import run as trun
from distributedconvrl_pde_control_torch.experiments import serve
from distributedconvrl_pde_control_torch.train import checkpoint

ROOT = Path(__file__).resolve().parent.parent
# (preset, run directory): the three families' shipped controllers
CONTROLLERS = [("KS22", "artifacts/KS22"),
               ("KellerSegel10_16_fast", "artifacts/KellerSegel_popsearch_pop8/member_00"),
               ("Fluid_8", "artifacts/Fluid_8")]
SERVE_KEYS = {"preset", "latency_ms_p50", "latency_ms_p99", "control_interval_ms", "headroom_x"}


def _port_step(preset, run_dir):
    setup = trun.build_setup(trun.preset_config(preset), device="cpu")
    actor = checkpoint.load_actor(str(ROOT / run_dir), setup.agent, device="cpu")
    return setup, actor, texport.build_control_step(setup, actor)


def _inputs(setup, seed):
    """A field near the preset's initial one and a random observation, as
    numpy, unbatched (the JAX env's shapes)."""
    rng = np.random.default_rng(seed)
    est = setup.env.reset()
    y0 = est.y[0].numpy()
    y = (y0 + 0.1 * np.abs(y0).max() * rng.standard_normal(y0.shape)).astype(np.float32)
    obs = rng.uniform(-1.0, 1.0, est.obs.shape[1:]).astype(np.float32)
    return y, obs


@pytest.mark.parametrize("preset,run_dir", CONTROLLERS, ids=[c[0] for c in CONTROLLERS])
def test_control_step_matches_jax(preset, run_dir):
    """The port's control step against JAX's `build_control_step` on the same
    field and observation: action and next observation within rel 1e-5 (float32
    products summed in other orders)."""
    jsetup = jrun.build_setup(preset)
    tmpl = init_train_state(jsetup.env, jsetup.agent, jax.random.PRNGKey(0))
    ts, hook = jckpt.load(str(ROOT / run_dir), tmpl)
    jactor = jax.tree.map(jnp.asarray, hook.best_actor or ts.agent.actor)
    jstep = jexport.build_control_step(jsetup, jactor)
    setup, _, tstep = _port_step(preset, run_dir)
    for seed in (0, 1):
        y, obs = _inputs(setup, seed)
        want_a, want_o = (np.asarray(x) for x in jstep(jnp.asarray(y), jnp.asarray(obs)))
        with torch.no_grad():
            got_a, got_o = tstep(torch.from_numpy(y)[None], torch.from_numpy(obs)[None])
        for got, want in ((got_a[0].numpy(), want_a), (got_o[0].numpy(), want_o)):
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
        assert np.abs(got_a.numpy()).max() <= setup.agent.cfg.act_limit


@pytest.mark.parametrize("preset,run_dir", CONTROLLERS, ids=[c[0] for c in CONTROLLERS])
def test_export_round_trip_is_the_live_step(preset, run_dir, tmp_path):
    """The exported program, saved and loaded back, returns bit for bit what
    the live step returns, over three chained steps; the manifest carries the
    JAX manifest's keys with the reset state's shapes."""
    setup, actor, step = _port_step(preset, run_dir)
    manifest = texport.export_controller(setup, actor, str(tmp_path), preset=preset)
    assert {"format", "preset", "platforms", "args", "results", "act_limit",
            "control_interval_s"} <= set(manifest)
    assert manifest["format"] == "torch.export" and manifest["platforms"] == ["cuda", "cpu"]
    est = setup.env.reset()
    assert [a["shape"] for a in manifest["args"]] == [list(est.y.shape), list(est.obs.shape)]
    assert manifest["control_interval_s"] == pytest.approx(setup.env.dt)
    program, loaded = texport.load_exported(str(tmp_path), device="cpu")
    assert loaded == json.loads((tmp_path / "manifest.json").read_text())
    y, obs = _inputs(setup, 2)
    y, live_obs = torch.from_numpy(y)[None], torch.from_numpy(obs)[None]
    exp_obs = live_obs
    with torch.no_grad():
        for _ in range(3):
            live_a, live_obs = step(y, live_obs)
            exp_a, exp_obs = program(y, exp_obs)
            assert torch.equal(live_a, exp_a) and torch.equal(live_obs, exp_obs)


LOADER = """
import json, os, sys
for name in ("distributedconvrl_pde_control_torch", "distributedconvrl_pde_control_tpu", "jax"):
    sys.modules[name] = None
import numpy as np
import torch
ARTIFACT, MANIFEST = {artifact!r}, {manifest!r}
{source}
program, manifest = load_exported(sys.argv[1], device="cpu")
y, obs = (torch.from_numpy(np.load(sys.argv[2])[k]) for k in ("y", "obs"))
with torch.no_grad():
    action, next_obs = program(y, obs)
np.savez(sys.argv[3], action=action.numpy(), next_obs=next_obs.numpy())
print(manifest["preset"])
"""


def loader_code() -> str:
    """A script that runs `load_exported`'s own source with the port blocked."""
    return LOADER.format(artifact=texport.ARTIFACT, manifest=texport.MANIFEST,
                         source=inspect.getsource(texport.load_exported))


def test_exported_controller_loads_without_the_port(tmp_path):
    """`load_exported` needs torch alone: its source, run in a process where
    neither package nor JAX can be imported, loads the KS22 controller and
    returns the live step's action and observation bit for bit."""
    setup, actor, step = _port_step(*CONTROLLERS[0])
    texport.export_controller(setup, actor, str(tmp_path / "ctrl"), preset="KS22")
    y, obs = _inputs(setup, 3)
    np.savez(tmp_path / "in.npz", y=y[None], obs=obs[None])
    res = subprocess.run([sys.executable, "-c", loader_code(), str(tmp_path / "ctrl"),
                          str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                         capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "KS22"
    with torch.no_grad():
        action, next_obs = step(torch.from_numpy(y)[None], torch.from_numpy(obs)[None])
    out = np.load(tmp_path / "out.npz")
    np.testing.assert_array_equal(out["action"], action.numpy())
    np.testing.assert_array_equal(out["next_obs"], next_obs.numpy())


def test_serve_prints_the_jax_keys(tmp_path, capsys):
    """The probe on a checkpoint and on its export: one JSON line each with
    JAX's keys, the KS control interval of 100 ms and a positive headroom."""
    setup, actor, _ = _port_step(*CONTROLLERS[0])
    texport.export_controller(setup, actor, str(tmp_path), preset="KS22")
    for argv in (["--load-from", str(ROOT / "artifacts/KS22")], ["--from-export", str(tmp_path)]):
        serve.main(["KS22", *argv, "--steps", "20", "--cpu"])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert set(line) == SERVE_KEYS
        assert line["control_interval_ms"] == pytest.approx(100.0)
        assert 0 < line["latency_ms_p50"] <= line["latency_ms_p99"] and line["headroom_x"] > 0
    with pytest.raises(SystemExit):
        serve.main(["KS22", "--cpu"])


def test_cli_export_controller_and_serve(tmp_path, capsys):
    """`run.py --eval --export-controller DIR` writes the program and its
    manifest (bit-equal to the live step of the same checkpoint), and
    `--eval --serve` prints the probe's line, for a Fluid_8 controller."""
    out = tmp_path / "fluid_ctrl"
    trun.main(["Fluid_8", "--eval", "--cpu", "--load-from", str(ROOT / "artifacts/Fluid_8"),
               "--export-controller", str(out)])
    assert "exported the controller" in capsys.readouterr().out
    assert (out / texport.ARTIFACT).exists()
    program, manifest = texport.load_exported(str(out))
    assert manifest["preset"] == "Fluid_8" and manifest["exported_on"] == "cpu"
    setup, _, step = _port_step(*CONTROLLERS[2])
    y, obs = _inputs(setup, 4)
    with torch.no_grad():
        want = step(torch.from_numpy(y)[None], torch.from_numpy(obs)[None])
        got = program(torch.from_numpy(y)[None], torch.from_numpy(obs)[None])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    trun.main(["KellerSegel10_16_fast", "--eval", "--cpu", "--serve", "--load-from",
               str(ROOT / "artifacts/KellerSegel_popsearch_pop8/member_00")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == SERVE_KEYS and line["preset"] == "KellerSegel10_16_fast"
