"""The exported controller on the card.

Tests marked `gpu` need a CUDA device; they decide inside the test whether
there is one and skip without it. They import nothing of JAX:

    python -m pytest --noconftest tests/test_torch_serve_gpu.py -m gpu
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from distributedconvrl_pde_control_torch.experiments import export_controller as texport
from distributedconvrl_pde_control_torch.experiments import run as trun
from distributedconvrl_pde_control_torch.train import checkpoint

ROOT = Path(__file__).resolve().parent.parent
CONTROLLERS = [("KS22", "artifacts/KS22"),
               ("KellerSegel10_16_fast", "artifacts/KellerSegel_popsearch_pop8/member_00"),
               ("Fluid_8", "artifacts/Fluid_8")]


def _live(preset, run_dir, device):
    setup = trun.build_setup(trun.preset_config(preset), device=device)
    actor = checkpoint.load_actor(str(ROOT / run_dir), setup.agent, device=device)
    return setup, actor, texport.build_control_step(setup, actor)


@pytest.mark.gpu
@pytest.mark.parametrize("preset,run_dir", CONTROLLERS, ids=[c[0] for c in CONTROLLERS])
def test_cuda_export_round_trip(preset, run_dir, tmp_path):
    """Exported on the card, the program returns the live step's action and
    observation bit for bit there; moved to the CPU, bit for bit what the
    port's live step returns on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    setup, actor, step = _live(preset, run_dir, "cuda")
    manifest = texport.export_controller(setup, actor, str(tmp_path), preset=preset)
    assert manifest["exported_on"] == "cuda"
    rng = np.random.default_rng(0)
    est = setup.env.reset()
    y = est.y + 0.1 * est.y.abs().max() * torch.tensor(
        rng.standard_normal(tuple(est.y.shape)), dtype=torch.float32, device="cuda")
    obs = torch.tensor(rng.uniform(-1, 1, tuple(est.obs.shape)), dtype=torch.float32,
                       device="cuda")
    _, _, cpu_step = _live(preset, run_dir, "cpu")
    with torch.no_grad():
        for device, live in (("cuda", step), ("cpu", cpu_step)):
            program, _ = texport.load_exported(str(tmp_path), device=device)
            yd, od = y.to(device), obs.to(device)
            want, got = live(yd, od), program(yd, od)
            assert all(g.device.type == device and torch.equal(g, w) for g, w in zip(got, want))
