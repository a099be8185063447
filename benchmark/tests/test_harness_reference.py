"""The plain reference against the port's CPU path at the tiny sizes: a
whole dry run of each cell (its compared steps, or its sampled control
steps and first steps) agrees to float32 round-off; and neither JAX nor the
JAX package is loaded, nor the port by the reference."""

import ast
import json
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.tiny import cell_names, dry_run

REFERENCE = harness.ROOT / "benchmark" / "reference"


@pytest.mark.parametrize("name", cell_names())
def test_reference_agrees_with_the_port_on_the_cpu(name):
    res = dry_run(name)
    assert res["correct"], res["checks"]
    for check in res["checks"].values():
        assert check["value"] <= 1e-5, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    rate = harness.find_cell(name).workload["rate_metric"]
    assert res["metrics"][rate]["value"] > 0 and res["metrics"]["setup_s"]["value"] > 0


def test_reference_imports_nothing_of_the_port():
    for path in REFERENCE.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("distributedconvrl_pde_control_torch", "jax",
                                               "distributedconvrl_pde_control_tpu"), (path, m)
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]);"
            "import benchmark.reference.ks, benchmark.reference.fluid, benchmark.reference.nets;"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code, str(harness.ROOT)], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    assert "distributedconvrl_pde_control_torch" not in json.loads(out)


def test_dry_runs_load_no_jax():
    """After a dry run of every cell, no module whose top-level name is
    jax, jaxlib, flax or the JAX package is loaded (whole names compared:
    the port's name begins with the JAX package's)."""
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]);"
            "from benchmark.tests.tiny import cell_names, dry_run;"
            "from benchmark import harness;"
            "[dry_run(n) for n in cell_names()];"
            "tops = {m.split('.')[0] for m in sys.modules};"
            "print(json.dumps([harness.forbidden_modules(),"
            " 'distributedconvrl_pde_control_torch' in tops]))")
    out = subprocess.run([sys.executable, "-c", code, str(harness.ROOT)], capture_output=True,
                         text=True, check=True, timeout=600).stdout.strip().splitlines()[-1]
    forbidden, port_loaded = json.loads(out)
    assert forbidden == [] and port_loaded
