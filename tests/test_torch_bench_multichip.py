"""`bench_multichip_torch.py` and `parallel/dryrun.py` on gloo CPU ranks.

Each family's JSON line has the keys of `bench_multichip.py`'s line for that
family (JAX's bench run here on the conftest's virtual CPU devices, at the
same tiny size) plus `device` and `power_limit`; the CPU ranks' times are
only checked to be positive. `dryrun_multichip(2)` and `(8)` run the four
multi-rank programs one step each, as the JAX package's
tests/test_graft_entry.py runs its dry run.
"""

import contextlib
import io
import json

import pytest

import bench_multichip
import bench_multichip_torch
from distributedconvrl_pde_control_torch.parallel.dryrun import dryrun_multichip

FAMILIES = {  # family -> (JAX's point, the port's argv)
    "fluid": (lambda: bench_multichip.bench_point("2x1", 16, 2, 4, 2, 2, 8),
              ["--virtual", "2", "--meshes", "2x1", "--nx", "16", "--n-envs", "2", "--steps",
               "2", "--chunk-len", "2", "--batch-size", "8"]),
    "ks-dp": (lambda: bench_multichip.bench_point_ks_dp("2x1", 4, 2, 2, 8),
              ["--family", "ks-dp", "--virtual", "2", "--meshes", "2x1", "--n-envs", "4",
               "--steps", "2", "--chunk-len", "2", "--batch-size", "8"]),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_line_has_the_jax_benchs_keys(family):
    jax_point, argv = FAMILIES[family]
    want = jax_point()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bench_multichip_torch.main(argv) == 0
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert set(got) == set(want) | {"device", "power_limit"}
    assert got["metric"] == want["metric"] and got["mesh"] == want["mesh"] == "2x1"
    assert got["backend"] == "gloo" and got["device"] == "cpu" and got["power_limit"] is None
    assert got["ms_per_step"] > 0 and got["env_steps_per_sec"] > 0


def test_ks_dp_refuses_an_sp_axis():
    with pytest.raises(SystemExit, match="pure-dp mesh"):
        bench_multichip_torch.main(["--family", "ks-dp", "--virtual", "2", "--meshes", "1x2"])


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_multichip(n):
    got = dryrun_multichip(n, deadline_s=240.0)
    assert got["dp_records"] == (5, 2, 2 * n)
    assert len(got["population_evals"][0]) == len(got["population_evals"][1]) == 2
