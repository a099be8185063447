"""The port's KS solver and kernel K1 against the JAX package.

The same numpy inputs go through the JAX `KSSolver(fft_mode="native").step`,
the Pallas kernel `KSPallasStepper(interpret=True).step` and the port's
`KSSolver.step` on the CPU (K1's plain torch.fft version), at the shapes and
tolerances of tests/test_pallas_kernels.py. The CUDA source of K1 itself is
run on the CPU too: compiled by the host C++ compiler against a small shim
that runs each CUDA thread of a block as a host thread.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributedconvrl_pde_control_tpu.ops.ks import KSSolver as JaxKSSolver
from distributedconvrl_pde_control_tpu.ops.pallas.ks_kernel import KSPallasStepper
from distributedconvrl_pde_control_tpu.ops.spectral import ks_rfft_operators as jax_ops
from distributedconvrl_pde_control_torch.ops.kernels import build, ks_kernel
from distributedconvrl_pde_control_torch.ops.ks import KSSolver
from distributedconvrl_pde_control_torch.ops.spectral import ks_rfft_operators

# (nx, oversampling, mu, batch, seed, y amplitude, forcing amplitude, atol):
# the three cases of tests/test_pallas_kernels.py, with their tolerances (the
# f32 gap between DFT-by-matmul and FFT after 10 or 5 substeps; 1e-5 where
# the only input is the small mu-disturbance)
CASES = [
    (192, 10, 0.0, 8, 0, 0.4, 0.2, 2e-4),
    (64, 5, 0.02, 4, 0, 0.0, 0.0, 1e-5),
    (192, 5, 0.0, 512, 1, 0.3, 0.1, 2e-4),
]


def _inputs(nx, batch, seed, amp_y, amp_f):
    rng = np.random.default_rng(seed)
    y = (amp_y * rng.standard_normal((batch, nx))).astype(np.float32)
    f = (amp_f * rng.standard_normal((batch, nx))).astype(np.float32)
    return y, f


def test_ks_rfft_operators_match():
    for nx, lx in ((192, 22.0), (240, 200.0), (64, 22.0)):
        for got, want in zip(ks_rfft_operators(nx, lx), jax_ops(nx, lx)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nx,os_,mu,batch,seed,amp_y,amp_f,atol", CASES)
def test_plain_step_matches_jax_and_pallas(nx, os_, mu, batch, seed, amp_y, amp_f, atol):
    y, f = _inputs(nx, batch, seed, amp_y, amp_f)
    jsolver = JaxKSSolver(nx=nx, lx=22.0, dt=0.1, oversampling=os_, mu=mu, fft_mode="native")
    want_native = np.asarray(jsolver.step(jnp.asarray(y), jnp.asarray(f)))
    want_pallas = np.asarray(KSPallasStepper(jsolver, interpret=True).step(jnp.asarray(y), jnp.asarray(f)))
    solver = KSSolver(nx=nx, lx=22.0, dt=0.1, oversampling=os_, mu=mu, device="cpu")
    got = solver.step(torch.from_numpy(y), torch.from_numpy(f)).numpy()
    assert got.shape == (batch, nx) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_native, rtol=0, atol=atol)
    np.testing.assert_allclose(got, want_pallas, rtol=0, atol=atol)


def test_solver_operators_match_jax():
    """float64 host composition cast to float32, as the JAX solver does."""
    jsolver = JaxKSSolver(nx=240, lx=200.0, dt=0.1, oversampling=30, mu=0.02)
    solver = KSSolver(nx=240, lx=200.0, dt=0.1, oversampling=30, mu=0.02, device="cpu")
    for name in ("g_alpha", "a_inv", "b_op", "dist_re", "dist_im"):
        np.testing.assert_array_equal(getattr(solver, name).numpy(),
                                      np.asarray(getattr(jsolver, name)), err_msg=name)


def test_kernel_constants_layout():
    """Padded operator rows and the twiddle table the kernel reads."""
    solver = KSSolver(nx=192, lx=22.0, dt=0.1, oversampling=30, device="cpu")
    ops, tw = solver.kernel_constants
    assert ops.shape == (6, 100) and tw.shape == (192, 2)
    for row, name in enumerate(("a_inv", "b_op", "g_alpha", "dist_re", "dist_im")):
        np.testing.assert_array_equal(ops[row, :97].numpy(), getattr(solver, name).numpy())
    assert not ops[:, 97:].any()
    w = ops[5, :97].numpy()
    assert w[0] == w[96] == np.float32(1 / 192) and np.all(w[1:96] == np.float32(2 / 192))
    # the exact zeros that make the DC/Nyquist imaginary parts drop out
    assert tw[0, 1] == tw[96, 1] == tw[48, 0] == tw[144, 0] == 0.0
    np.testing.assert_allclose(tw.numpy(), np.stack([np.cos(2 * np.pi * np.arange(192) / 192),
                                                     np.sin(2 * np.pi * np.arange(192) / 192)], 1),
                               atol=1e-7)


@pytest.mark.parametrize("nx,batch", [(64, 1), (192, 1), (192, 16384), (240, 16384), (600, 37)])
def test_launch_shape_fits_the_card(nx, batch):
    rows, threads = ks_kernel.launch_shape(nx, batch)
    assert rows % 4 == 0 and 4 <= rows <= 16
    assert threads % 32 == 0 and 32 <= threads <= 512
    assert ks_kernel.smem_bytes(nx, rows) <= ks_kernel.SMEM_LIMIT
    if nx == 192 and batch == 16384:
        assert (rows, threads, ks_kernel.smem_bytes(nx, rows)) == (16, 192, 54_624)


# ------------------------------------------------------------------------
# K1's CUDA source on the CPU. The shim maps the CUDA features the kernel
# uses onto the host: one std::thread per CUDA thread, std::barrier for
# __syncthreads, blocks one after another, shared memory as a static array.
_SHIM = r"""
#include <barrier>
#include <cmath>
#include <cstddef>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct Dim { int x; };
inline thread_local Dim threadIdx;
inline Dim blockIdx, blockDim;
inline std::unique_ptr<std::barrier<>> g_bar;
inline void __syncthreads() { g_bar->arrive_and_wait(); }
typedef int cudaError_t;
typedef void* cudaStream_t;
#define cudaSuccess 0
#define cudaFuncAttributeMaxDynamicSharedMemorySize 0
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "no error"; }
inline float4 g_smem[1 << 16];
template <class F> void emu_launch(int grid, int threads, F fn) {
  blockDim.x = threads;
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b;
    g_bar = std::make_unique<std::barrier<>>(threads);
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t) ts.emplace_back([=] { threadIdx.x = t; fn(); });
    for (auto& th : ts) th.join();
  }
}
"""


@pytest.fixture(scope="module")
def emulated_k1(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to run the CUDA source on the CPU")
    src = (build.CSRC_DIR / ks_kernel.SOURCE).read_text()
    launch = "ks_cnab2_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>("
    tail = "substeps, dt_os);\n  return (int)cudaGetLastError();"
    assert launch in src and tail in src, "K1's launch changed: update the emulation"
    src = (src.replace("#include <cuda_runtime.h>", _SHIM)
              .replace("extern __shared__ float4 smem4[];", "float4* smem4 = g_smem;")
              .replace(launch, "emu_launch(grid, threads, [&] { ks_cnab2_kernel(")
              .replace(tail, "substeps, dt_os); });\n  return (int)cudaGetLastError();"))
    d = tmp_path_factory.mktemp("k1emu")
    (d / "k1.cpp").write_text(src)
    subprocess.run([cxx, "-std=c++20", "-O2", "-pthread", "-shared", "-fPIC", "-w",
                    "-o", str(d / "k1.so"), str(d / "k1.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "k1.so"))
    lib.ks_cnab2_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.ks_cnab2_launch.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("nx,os_,mu,batch,seed,amp_y,amp_f,atol", CASES[:2] + [
    (192, 5, 0.0, 22, 1, 0.3, 0.1, 2e-4),  # two CTAs, the second one partial
    (240, 3, 0.0, 5, 2, 1.0, 0.2, 2e-4),  # KS200's grid
    (192, 30, 0.0, 6, 3, 3.0, 1.0, 1e-3),  # the slice's substeps at ||y|| ~ 30
])
def test_k1_source_matches_plain(emulated_k1, nx, os_, mu, batch, seed, amp_y, amp_f, atol):
    y, f = (torch.from_numpy(a) for a in _inputs(nx, batch, seed, amp_y, amp_f))
    solver = KSSolver(nx=nx, lx=22.0, dt=0.1, oversampling=os_, mu=mu, device="cpu")
    ops, tw = solver.kernel_constants
    rows, threads = ks_kernel.launch_shape(nx, batch)
    out = torch.full_like(y, float("nan"))
    err = emulated_k1.ks_cnab2_launch(y.data_ptr(), f.data_ptr(), ops.data_ptr(), tw.data_ptr(),
                                      out.data_ptr(), batch, nx, ops.shape[1], rows, threads,
                                      os_, 0.1 / os_, None)
    assert err == 0
    want = ks_kernel.ks_cnab2_plain(y, f, solver)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0, atol=atol)
