"""Kernels K1 and K2 on the card, the wrappers' refusal to fall back, and the
port's independence from JAX.

Tests marked `gpu` build a kernel with nvcc and compare it with its plain
version on a CUDA device; they decide inside the test whether there is one and skip
without it. Run them on a machine with a GPU:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributedconvrl_pde_control_torch.ops.kernels import build, ks_kernel, ns_advection
from distributedconvrl_pde_control_torch.ops.ks import KSSolver

ROOT = Path(__file__).resolve().parents[1]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("nx,os_,mu,batch,atol", [
    (192, 10, 0.0, 8, 2e-4), (64, 5, 0.02, 4, 1e-5), (192, 5, 0.0, 512, 2e-4),
    (192, 30, 0.0, 1000, 1e-3), (240, 30, 0.02, 33, 1e-3), (192, 30, 0.02, 1, 1e-3),
    (600, 30, 0.0, 37, 1e-3), (60, 5, 0.02, 3, 2e-4), (28, 5, 0.02, 9, 2e-4),
    (50, 30, 0.02, 7, 1e-3), (190, 30, 0.0, 33, 1e-3),
])
def test_k1_matches_plain_on_gpu(nx, os_, mu, batch, atol):
    _need_cuda()
    rng = np.random.default_rng(nx + batch)
    y = torch.tensor(rng.standard_normal((batch, nx)), dtype=torch.float32, device="cuda")
    f = torch.tensor(0.3 * rng.standard_normal((batch, nx)), dtype=torch.float32, device="cuda")
    solver = KSSolver(nx=nx, lx=22.0, dt=0.1, oversampling=os_, mu=mu, device="cuda")
    before = ks_kernel.KS_CNAB2.launches
    got = solver.step(y, f)
    torch.cuda.synchronize()
    assert ks_kernel.KS_CNAB2.launches == before + 1
    want = ks_kernel.ks_cnab2_plain(y, f, solver)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= atol


@pytest.mark.gpu
def test_k1_wrapper_rejects_bad_inputs_on_gpu():
    _need_cuda()
    solver = KSSolver(nx=192, lx=22.0, dt=0.1, oversampling=30, device="cuda")
    y = torch.zeros(4, 192, device="cuda")
    for bad in (y.double(), y.t().contiguous().t(), y[:, :190].contiguous()):
        with pytest.raises(ValueError):
            ks_kernel.KS_CNAB2(bad, y, solver.kernel_constants, 30, 0.1)
    ops, tw, pos, radices = solver.kernel_constants
    with pytest.raises(ValueError, match="radices"):
        ks_kernel.KS_CNAB2(y, y, (ops, tw, pos, radices[:-1]), 30, 0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("n,batch", [(32, 4), (16, 4), (8, 1), (128, 8), (256, 1), (256, 16),
                                     (512, 2), (1024, 1), (24, 3), (96, 2), (2048, 1)])
def test_k2_matches_plain_on_gpu(n, batch):
    """Spectra of standard-normal fields, the Pallas test's tolerance."""
    _need_cuda()
    rng = np.random.default_rng(n + batch)
    w = torch.fft.fft2(torch.tensor(rng.standard_normal((batch, n, n)), dtype=torch.float32,
                                    device="cuda"))
    c = ns_advection.fftfreq_constants(n, device="cuda")
    before = ns_advection.NS_ADVECTION.launches
    got = ns_advection.ns_advection(w, c)
    torch.cuda.synchronize()
    assert ns_advection.NS_ADVECTION.launches == before + 1
    want = ns_advection.ns_advection_plain(w, c)
    assert torch.isfinite(torch.view_as_real(got)).all()
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def _complex_spectra(rng, batch, n, scale=1.0):
    return torch.tensor(scale * (rng.standard_normal((batch, n, n))
                                 + 1j * rng.standard_normal((batch, n, n))),
                        dtype=torch.complex64, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,batch,chain", [(16, 2, False), (128, 1, False), (256, 1, False),
                                           (256, 16, False), (256, 1, True), (256, 16, True)])
def test_k2_non_hermitian_nyquist_on_gpu(n, batch, chain):
    """The solver's constants (positive Nyquist wavenumber) on spectra that
    are Hermitian nowhere: the packed inverses must drop what the reference
    drops with the real part. Both launch forms."""
    _need_cuda()
    from distributedconvrl_pde_control_torch.parallel.ns_sharded import make_sharded_ops

    c = make_sharded_ops(n, n, device="cuda")
    w = _complex_spectra(np.random.default_rng(n + batch), batch, n, float(n))
    before = ns_advection.NS_ADVECTION.launches
    got = ns_advection.NS_ADVECTION(w, c, chain=chain)
    torch.cuda.synchronize()
    assert ns_advection.NS_ADVECTION.launches == before + (3 if chain else 1)
    want = ns_advection.ns_advection_plain(w, c)
    assert torch.isfinite(torch.view_as_real(got)).all()
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("operands", ["lin_f", "lin_only", "f_only"])
@pytest.mark.parametrize("batch", [1, 16])
def test_k2_fused_operands_match_plain_on_gpu(batch, operands):
    """The optional operands of the function against their plain twin at
    the fluid path's grid, with the solver's constants and operator."""
    _need_cuda()
    from distributedconvrl_pde_control_torch.parallel.ns_sharded import make_sharded_ops

    n = 256
    c = make_sharded_ops(n, n, device="cuda")
    rng = np.random.default_rng(batch)
    w = torch.fft.fft2(torch.tensor(rng.standard_normal((batch, n, n)), dtype=torch.float32,
                                    device="cuda"))
    lin, f = (-5e-5 * c.k2).contiguous(), _complex_spectra(rng, batch, n, 0.1 * w.abs().max().item())
    kw = {"lin_f": dict(lin=lin, f=f), "lin_only": dict(lin=lin), "f_only": dict(f=f)}[operands]
    got = ns_advection.ns_advection(w, c, **kw)
    torch.cuda.synchronize()
    want = ns_advection.ns_rhs_plain(w, c, **kw)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("n,batch,substeps,chain", [(32, 2, 1, False), (256, 1, 5, False),
                                                    (256, 16, 2, False), (128, 2, 2, True)])
def test_k2_rk4_substeps_match_plain_on_gpu(n, batch, substeps, chain):
    """The library's RK4 loop, whose stages carry the stage state, the
    operator, the forcing and the combination, against the plain
    composition; the count is what the library reports having launched."""
    _need_cuda()
    from distributedconvrl_pde_control_torch.ops.navier_stokes import initial_condition
    from distributedconvrl_pde_control_torch.parallel.ns_sharded import make_sharded_ops

    c = make_sharded_ops(n, n, device="cuda")
    rng = np.random.default_rng(76)
    w = torch.tensor(np.stack([initial_condition(4, n, n, 1.0, 1.0, rng) for _ in range(batch)])
                     .astype(np.complex64), device="cuda")
    f = _complex_spectra(rng, batch, n, 0.05 * w.abs().max().item())
    lin = (-5e-5 * c.k2).contiguous()
    before = ns_advection.NS_ADVECTION.launches
    got = ns_advection.NS_ADVECTION.rk4(w, c, lin, f, 2.5e-4, substeps, chain=chain)
    torch.cuda.synchronize()
    assert ns_advection.NS_ADVECTION.launches == before + (12 if chain else 4) * substeps
    want = ns_advection.ns_rk4_plain(w, c, lin, f, 2.5e-4, substeps)
    assert (want - w).abs().max() > 0
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.gpu
def test_k2_wrapper_rejects_bad_inputs_on_gpu():
    _need_cuda()
    c = ns_advection.fftfreq_constants(32, device="cuda")
    w = torch.zeros(2, 32, 32, dtype=torch.complex64, device="cuda")
    for bad in (w.to(torch.complex128), w[0], w[:, :, :16].contiguous(), w.transpose(1, 2)):
        with pytest.raises(ValueError):
            ns_advection.NS_ADVECTION(bad, c)
    with pytest.raises(ValueError, match="float32 on cuda"):
        ns_advection.NS_ADVECTION(w, ns_advection.fftfreq_constants(32, device="cpu"))
    for kw in (dict(f=w[:1]), dict(f=w.to(torch.complex128)), dict(lin=c.k2.double()),
               dict(lin=c.k2[:16])):
        with pytest.raises(ValueError):
            ns_advection.NS_ADVECTION(w, c, **kw)
    with pytest.raises(ValueError, match="substeps"):
        ns_advection.NS_ADVECTION.rk4(w, c, c.k2, w, 0.1, 0)


@pytest.mark.gpu
def test_k2_device_route_at_6144_matches_plain_on_gpu():
    """Above the block route's shared-memory limit K2 takes its device route (it refused
    6144^2 until the route came): one launch, within the Pallas tolerance."""
    _need_cuda()
    n = 6144
    assert ns_advection.route(n) == "device"
    rng = np.random.default_rng(n)
    w = torch.fft.fft2(torch.tensor(rng.standard_normal((1, n, n)), dtype=torch.float32,
                                    device="cuda"))
    c = ns_advection.fftfreq_constants(n, device="cuda")
    before = ns_advection.NS_ADVECTION.launches
    got = ns_advection.NS_ADVECTION(w, c)
    torch.cuda.synchronize()
    assert ns_advection.NS_ADVECTION.launches == before + 1
    want = ns_advection.ns_advection_plain(w, c)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    with pytest.raises(ValueError, match="no chain form"):
        ns_advection.NS_ADVECTION(w, c, chain=True)


@pytest.mark.gpu
@pytest.mark.parametrize("nx,batch", [(4320, 2), (4320, 64), (4327, 2), (4327, 64), (8192, 2),
                                      (8192, 64)])
def test_k1_device_route_matches_plain_on_gpu(nx, batch):
    """K1 above its block route's limit: a split (4320, 8192) or Bluestein (4327, prime), 30
    substeps at ||y|| ~ 30 per row, one launch."""
    _need_cuda()
    assert ks_kernel.route(nx) == "device"
    rng = np.random.default_rng(nx + batch)
    y = torch.tensor(3.0 * rng.standard_normal((batch, nx)), dtype=torch.float32, device="cuda")
    f = torch.tensor(rng.standard_normal((batch, nx)), dtype=torch.float32, device="cuda")
    solver = KSSolver(nx=nx, lx=22.0 * nx / 192, dt=0.1, oversampling=30, mu=0.02, device="cuda")
    before = ks_kernel.KS_CNAB2.launches
    got = solver.step(y, f)
    torch.cuda.synchronize()
    assert ks_kernel.KS_CNAB2.launches == before + 1
    want = ks_kernel.ks_cnab2_plain(y, f, solver)
    assert torch.isfinite(got).all() and (got - want).abs().max().item() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4097, 4099])
def test_k2_device_route_matches_plain_on_gpu(n):
    """K2 above its limit: 4097 = 17 x 241 (generic stages in both levels), 4099 prime
    (Bluestein over 8640)."""
    _need_cuda()
    assert ns_advection.route(n) == "device"
    from distributedconvrl_pde_control_torch.parallel.ns_sharded import make_sharded_ops

    c = make_sharded_ops(n, n, device="cuda")
    w = _complex_spectra(np.random.default_rng(n), 1, n, float(n))
    before = ns_advection.NS_ADVECTION.launches
    got = ns_advection.ns_advection(w, c)
    torch.cuda.synchronize()
    assert ns_advection.NS_ADVECTION.launches == before + 1
    want = ns_advection.ns_advection_plain(w, c)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


FORCED_SMEM_LIMIT = 4096  # no block-route line of 192 points or 256^2 fits it


@pytest.mark.gpu
def test_k1_device_route_forced_equals_block_route_on_gpu(monkeypatch):
    """The device route forced at the main path's shape (16384 x 192, 30 substeps) equals the
    block route within K1's tolerance."""
    _need_cuda()
    rng = np.random.default_rng(192)
    y = torch.tensor(3.0 * rng.standard_normal((16384, 192)), dtype=torch.float32, device="cuda")
    f = torch.tensor(rng.standard_normal((16384, 192)), dtype=torch.float32, device="cuda")
    solver = KSSolver(nx=192, lx=22.0, dt=0.1, oversampling=30, mu=0.02, device="cuda")
    block = solver.step(y, f)
    monkeypatch.setattr(ks_kernel, "SMEM_LIMIT", FORCED_SMEM_LIMIT)
    assert ks_kernel.route(192) == "device"
    before = ks_kernel.KS_CNAB2.launches
    got = solver.step(y, f)
    torch.cuda.synchronize()
    assert ks_kernel.KS_CNAB2.launches == before + 1
    assert (got - block).abs().max().item() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 16])
def test_k2_device_route_forced_equals_block_route_on_gpu(monkeypatch, batch):
    """The device route forced at the fluid path's shape: `ns_rk4_substeps` at 256^2 equals the
    block route within K2's tolerance, one cooperative launch per stage."""
    _need_cuda()
    from distributedconvrl_pde_control_torch.ops.navier_stokes import initial_condition
    from distributedconvrl_pde_control_torch.parallel.ns_sharded import make_sharded_ops

    n = 256
    c = make_sharded_ops(n, n, device="cuda")
    rng = np.random.default_rng(76 + batch)
    w = torch.tensor(np.stack([initial_condition(4, n, n, 1.0, 1.0, rng) for _ in range(batch)])
                     .astype(np.complex64), device="cuda")
    f = _complex_spectra(rng, batch, n, 0.05 * w.abs().max().item())
    lin = (-5e-5 * c.k2).contiguous()
    block = ns_advection.ns_rk4_substeps(w, c, lin, f, 2.5e-4, 3)
    monkeypatch.setattr(ns_advection, "SMEM_LIMIT", FORCED_SMEM_LIMIT)
    assert ns_advection.route(n) == "device"
    before = ns_advection.NS_ADVECTION.launches
    got = ns_advection.ns_rk4_substeps(w, c, lin, f, 2.5e-4, 3)
    torch.cuda.synchronize()
    assert ns_advection.NS_ADVECTION.launches == before + 12
    assert (got - block).abs().max().item() <= 1e-4 * block.abs().max().item()


def test_k1_wrapper_never_falls_back():
    """A tensor off the CUDA device never reaches the plain version through
    the kernel handle, and a non-CPU, non-CUDA tensor is refused by the
    step entry point instead of being run some other way."""
    solver = KSSolver(nx=64, lx=22.0, dt=0.1, oversampling=5, device="cpu")
    y = torch.zeros(4, 64)
    before = ks_kernel.KS_CNAB2.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        ks_kernel.KS_CNAB2(y, y, solver.kernel_constants, 5, 0.1)
    meta = torch.empty(4, 64, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        ks_kernel.ks_cnab2_step(meta, meta, solver)
    assert ks_kernel.KS_CNAB2.launches == before


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No compiler, no kernel: the build says so instead of degrading."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load(ks_kernel.SOURCE)


def test_port_and_chip_smoke_import_no_jax():
    """Every module of the port, and chip_smoke.py, imports without pulling
    in jax, flax, optax or anything of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import distributedconvrl_pde_control_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'distributedconvrl_pde_control_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith(p.__name__)]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module of the port was imported
    # chip_smoke imports the port inside main(); none of its imports is JAX
    modules = [ln.split()[1] for ln in (ROOT / "chip_smoke.py").read_text().splitlines()
               if ln.strip().startswith(("import ", "from "))]
    assert "distributedconvrl_pde_control_torch.ops.kernels" in modules
    assert not [m for m in modules if m.split(".")[0] in
                ("jax", "jaxlib", "flax", "optax", "distributedconvrl_pde_control_tpu")]
