"""The port's rank mesh (parallel/mesh.py), transpose-method FFT
(parallel/dfft.py), halo exchange (parallel/halo.py) and sharded NS steppers
(parallel/ns_sharded.py) on gloo CPU ranks, against the JAX package under
`shard_map` on the conftest's virtual CPU mesh and against the port on one
rank.

One world of four spawned ranks runs every check (sp = 2 on ranks 0-1, sp = 4
on all four; `tests/torch_mesh_ranks.py`); the JAX side runs in this process.
Two worlds of two ranks check the launcher: a collective a peer never joins
fails by the group's timeout, a healthy run outlives it.
The inputs are non-symmetric (a 16 x 32 grid, non-Hermitian spectra), so a
block in the wrong place shows. Tolerances: transforms rel 1e-5 of the
largest entry, steppers rel 1e-4, halo cells bit-equal, adaptive trial counts
equal.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import torch_mesh_ranks as ranks
from distributedconvrl_pde_control_tpu.ops.navier_stokes import initial_condition
from distributedconvrl_pde_control_tpu.parallel import dfft as jdfft
from distributedconvrl_pde_control_tpu.parallel import ns_sharded as jsh
from distributedconvrl_pde_control_tpu.parallel.halo import halo_exchange_1d as jhalo
from distributedconvrl_pde_control_tpu.parallel.mesh import make_dp_sp_mesh as jmake_mesh
from distributedconvrl_pde_control_torch.parallel import ns_sharded as tsh
from distributedconvrl_pde_control_torch.parallel.mesh import RankMesh, launch, make_dp_sp_mesh

SPS = (2, 4)
N, NU, DT, OS, TOL = 32, 5e-4, 0.01, 3, 1e-4


def inputs() -> dict:
    rng = np.random.default_rng(11)
    omg = np.stack([np.fft.ifft2(initial_condition(c, N, N, 1.0, 1.0, rng)).real
                    for c in (2, 3)]).astype(np.float32)
    return {
        "x": rng.standard_normal((2, 16, 32)).astype(np.float32),
        "w": (rng.standard_normal((2, 16, 32)) + 1j * rng.standard_normal((2, 16, 32))
              ).astype(np.complex64),
        "line": np.arange(32, dtype=np.float32).reshape(2, 16),
        "omg": omg, "forcing": (0.5 * rng.standard_normal((2, N, N))).astype(np.float32),
        "nu": NU, "dt": DT, "os": OS, "tol": TOL,
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    p = inputs()
    got = ranks.run_world(ranks.mesh_checks, 4, str(tmp_path_factory.mktemp("mesh")), p)
    return p, got


def sp_mesh(s):
    return Mesh(np.asarray(jax.devices()[:s]), ("sp",))


def close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def jax_map(fn, s, in_specs, out_specs, *args):
    return np.asarray(jax.jit(shard_map(fn, mesh=sp_mesh(s), in_specs=in_specs,
                                        out_specs=out_specs, check_vma=False))(*args))


@pytest.mark.parametrize("s", SPS)
def test_dfft2_against_jax_and_one_rank(world, s):
    p, got = world
    want = jax_map(lambda b: jdfft.dfft2(b, "sp"), s, P(None, "sp", None), P(None, None, "sp"),
                   jnp.asarray(p["x"]))
    close(got[f"dfft2_{s}"], want, 1e-5)
    close(got[f"dfft2_{s}"], np.fft.fft2(p["x"]), 1e-5)


@pytest.mark.parametrize("s", SPS)
def test_difft2_against_jax_and_one_rank(world, s):
    p, got = world
    want = jax_map(lambda b: jdfft.difft2(b, "sp"), s, P(None, None, "sp"), P(None, "sp", None),
                   jnp.asarray(p["w"]))
    close(got[f"difft2_{s}"], want, 1e-5)
    one = tsh.difft2_real(torch.from_numpy(p["w"])).numpy()
    close(got[f"difft2_real_{s}"], want.real, 1e-5)
    close(got[f"difft2_real_{s}"], one, 1e-5)
    close(got[f"difft2_{s}"], np.fft.ifft2(p["w"]), 1e-5)


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("s", SPS)
def test_halo_exchange_bit_equal_to_jax(world, s, periodic):
    p, got = world
    want = jax_map(lambda b: jhalo(b, "sp", halo=1, periodic=periodic), s, P(None, "sp"),
                   P(None, "sp"), jnp.asarray(p["line"]))
    np.testing.assert_array_equal(got[f"halo_{s}_{periodic}"], want)


def test_make_dp_sp_mesh_shapes():
    for n in (1, 2, 3, 4, 6, 8):
        assert make_dp_sp_mesh(n) == tuple(jmake_mesh(n).devices.shape)
    assert make_dp_sp_mesh(8, sp=2) == (4, 2)
    with pytest.raises(ValueError):
        make_dp_sp_mesh(6, sp=4)
    assert (RankMesh().shape, RankMesh(2, 4, 1, 3).rank) == ((1, 1), 7)


def test_mesh_constructors_default_to_the_card():
    """As the JAX package's meshes take jax.devices() (the accelerator), the
    port's are on the card unless the caller asks for the CPU: RankMesh and
    TPMesh default to "cuda", dp_mesh and make_tp_mesh build on "cuda" without
    a process group, launch defaults to the NCCL backend, and a trainer's
    one-device mesh takes the trainer's device."""
    import inspect

    from distributedconvrl_pde_control_torch.parallel import batched_dp, multichip, tp

    assert RankMesh().device == "cuda" and tp.TPMesh().device == "cuda"
    assert batched_dp.dp_mesh().device == "cuda" and tp.make_tp_mesh().device == "cuda"
    assert batched_dp.dp_mesh(device="cpu").device == "cpu"
    assert tp.make_tp_mesh(1, "cpu").device == "cpu"
    assert inspect.signature(launch).parameters["backend"].default == "nccl"
    assert multichip.mesh_of(None).device == "cuda" and multichip.mesh_of((1, 1), "cpu").device == "cpu"


def jax_step(name, s, p):
    ops = jsh.make_sharded_ops(N, N)
    solver = jsh.NSShardedSolverRI(nu=NU, sp_axis="sp")
    fns = {"step_real": lambda w, f, o: solver.step_real(w, f, o, DT, OS),
           "step_real_if": lambda w, f, o: solver.step_real_if(w, f, o, DT, OS),
           "step_real_adaptive": lambda w, f, o: solver.step_real_adaptive(w, f, o, DT,
                                                                           rtol=TOL, atol=TOL)}
    return jax_map(fns[name], s, (P(None, "sp", None), P(None, "sp", None),
                                  jax.tree.map(lambda _: P(None, "sp"), ops)),
                   P(None, "sp", None), jnp.asarray(p["omg"]), jnp.asarray(p["forcing"]), ops)


@pytest.mark.parametrize("name", ["step_real", "step_real_if", "step_real_adaptive"])
@pytest.mark.parametrize("s", SPS)
def test_sharded_ns_steppers_against_jax_and_one_rank(world, s, name):
    p, got = world
    one = tsh.NSShardedSolver(nu=NU)
    ops = tsh.make_sharded_ops(N, N, device="cpu")
    w, f = torch.from_numpy(p["omg"]), torch.from_numpy(p["forcing"])
    want_one = {"step_real": lambda: one.step_real(w, f, ops, DT, OS),
                "step_real_if": lambda: one.step_real_if(w, f, ops, DT, OS),
                "step_real_adaptive": lambda: one.step_real_adaptive(w, f, ops, DT, rtol=TOL,
                                                                     atol=TOL)}[name]().numpy()
    moved = np.abs(want_one - p["omg"]).max() / np.abs(p["omg"]).max()
    assert moved > 1e-3
    close(got[f"{name}_{s}"], want_one, 1e-4)
    close(got[f"{name}_{s}"], jax_step(name, s, p), 1e-4)
    if name == "step_real_adaptive":
        assert got[f"trials_{s}"] == [one.last_trials] * s and one.last_trials > 1


def test_mismatched_collective_fails_by_the_group_timeout(tmp_path, capsys):
    """Rank 0 sums over sp, rank 1 never joins: the group's timeout (3 s here)
    ends the run with an error seconds after the ranks start (rank 1 would
    hold for 120 s), never a hang. The line rank 0 printed before it still
    reaches the caller's stdout."""
    t0 = time.perf_counter()
    with pytest.raises(Exception, match="(?i)timed out"):
        ranks.run_world(ranks.mismatched_collective, 2, str(tmp_path), 120.0, timeout_s=3.0)
    assert time.perf_counter() - t0 < 60.0
    assert "rank 0 sums over sp" in capsys.readouterr().out


def test_launched_mesh_outlives_its_group_timeout(tmp_path, capsys):
    """A healthy mesh launched as the CLI launches it (no deadline) runs on
    well past its group's timeout (3 s here): the timeout bounds each
    collective, not the run. Rank 0's lines reach the caller's stdout."""
    t0 = time.perf_counter()
    total = launch(ranks.paced_collectives, 1, 2, 10, 0.5, backend="gloo",
                   store_dir=str(tmp_path), timeout_s=3.0)
    assert total == 20.0 and time.perf_counter() - t0 > 1.5 * 3.0
    out = capsys.readouterr().out.splitlines()
    assert out == [f"sum {i}: {2.0 * (i + 1)}" for i in range(10)]
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".rank_")]
