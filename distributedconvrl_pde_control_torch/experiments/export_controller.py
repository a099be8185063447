"""Ahead-of-time controller export: the deployment format of a trained policy.

Counterpart of ``distributedconvrl_pde_control_tpu/experiments/export_controller.py``
on `torch.export`. The deployed program (sensor field + previous observation
-> clamped actuator commands + next observation, the `control_step` that the
serving probe times, `experiments/serve.py`) is wrapped in a module whose
buffers are the trained weights, exported once at the shapes of
`env.reset()` (a batch of one) and saved as `controller.pt2` beside a
`manifest.json` with the calling convention. The saved program runs in any
process with torch alone: no module of this package, no checkpoint parsing.
It is exported on the setup's device; `load_exported(dir, device)` moves it
to another (`torch.export.passes.move_to_device_pass`), so a controller
exported on the card serves on a CPU box next to the plant.

    python -m distributedconvrl_pde_control_torch.experiments.run KS22 --eval \\
        --load-from artifacts/KS22 --export-controller build/ks22_ctrl
    python -m distributedconvrl_pde_control_torch.experiments.serve KS22 \\
        --from-export build/ks22_ctrl
"""

from __future__ import annotations

import json
import os

import torch

ARTIFACT = "controller.pt2"
MANIFEST = "manifest.json"


def build_control_step(setup, actor):
    """The minimal deployed program: featurize + shared-MLP actor + clamp (no
    exploration). `control_step(y, obs) -> (action, next_obs)` on a batch:
    y (B, ...) the field, obs (B, ns, n_actuators), action (B, na_rows,
    n_actuators); every actuator column of every env is one column of the
    shared actor. Shared by the serving probe and the exporter, so that the
    exported program is the one serve.py times."""
    env, agent = setup.env, setup.agent
    lim = float(agent.cfg.act_limit)

    def control_step(y, obs):
        b, ns, n_act = obs.shape
        cols = obs.permute(1, 0, 2).reshape(ns, b * n_act)
        a = torch.clamp(agent.actor_apply(actor, cols), -lim, lim)
        action = a.reshape(-1, b, n_act).permute(1, 0, 2)
        return action, env.featurize(y, obs, action)

    return control_step


class _Weights:
    """The `w`/`b` lists `models.mlp.apply_chain` reads, here the buffers of
    the exported module."""

    def __init__(self, w: list, b: list):
        self.w, self.b = w, b


class ControlStep(torch.nn.Module):
    """`build_control_step` as a module whose buffers `w{i}`/`b{i}` are the
    actor's weights, row-major (`checkpoint.actor_from_jax`'s layout, so that the
    program's products are the live step's); the featurizer's constants are
    captured by the trace."""

    def __init__(self, setup, actor):
        super().__init__()
        self.setup = setup
        self.n_layers = len(actor.w)
        for i, (w, b) in enumerate(zip(actor.w, actor.b)):
            self.register_buffer(f"w{i}", w.detach().contiguous().clone())
            self.register_buffer(f"b{i}", b.detach().contiguous().clone())

    def forward(self, y, obs):
        actor = _Weights([getattr(self, f"w{i}") for i in range(self.n_layers)],
                         [getattr(self, f"b{i}") for i in range(self.n_layers)])
        return build_control_step(self.setup, actor)(y, obs)


def _arg(name: str, x: torch.Tensor) -> dict:
    return {"name": name, "shape": list(x.shape), "dtype": str(x.dtype).removeprefix("torch.")}


def export_controller(setup, actor, out_dir, preset="", platforms=("cuda", "cpu")):
    """Export `control_step` with `actor`'s weights into `out_dir`.

    Writes `controller.pt2` (the `torch.export` program, exported on the
    device of `setup`'s env at the shapes of `env.reset()`) and
    `manifest.json`: the JAX manifest's keys (`format` "torch.export",
    `preset`, `platforms` the devices `load_exported` serves it on, `args`
    with shapes and dtypes, `results`, `act_limit`, `control_interval_s`)
    and `exported_on`, the export device. Returns the manifest."""
    est = setup.env.reset()
    module = ControlStep(setup, actor).eval()
    with torch.no_grad():
        program = torch.export.export(module, (est.y.clone(), est.obs.clone()), strict=False)
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, ARTIFACT))
    manifest = {
        "format": "torch.export",
        "preset": preset,
        "platforms": list(platforms),
        "exported_on": est.y.device.type,
        "args": [_arg("y", est.y), _arg("obs", est.obs)],
        "results": ["action (batch, na_rows, n_actuators)", "next_obs"],
        "act_limit": float(setup.agent.cfg.act_limit),
        "control_interval_s": float(setup.env.dt),
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def load_exported(out_dir, device=None):
    """(controller, manifest) of an exported controller: call it as
    `controller(y, obs) -> (action, next_obs)`. With `device` the program and
    its constants move there first. Needs only torch: no module of this
    package, no config, no checkpoint."""
    from torch.export.passes import move_to_device_pass

    program = torch.export.load(os.path.join(out_dir, ARTIFACT))
    if device is not None:
        program = move_to_device_pass(program, torch.device(device))
    with open(os.path.join(out_dir, MANIFEST)) as f:
        manifest = json.load(f)
    return program.module(), manifest
