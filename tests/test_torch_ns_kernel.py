"""Kernel K2 (the NS advection term with the 2/3-rule mask) against the JAX
package.

The same numpy spectra go through the Pallas kernel in interpret mode, its
XLA comparator `xla_advection_ri` and the port's plain version, at the shape
and tolerance of tests/test_pallas_kernels.py (1e-4 of the largest value).
K2's CUDA source is run on the CPU too: compiled by the host C++ compiler
against a small shim that runs each CUDA thread of a block as a host thread.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributedconvrl_pde_control_tpu.ops.pallas.ns_advection import (
    PallasAdvection2D,
    xla_advection_ri,
)
from distributedconvrl_pde_control_torch.ops.kernels import build, ns_advection as k2
from distributedconvrl_pde_control_torch.ops.navier_stokes import initial_condition


def _spectra(n, batch, seed=0):
    """fft2 of standard-normal fields, as test_ns_advection_pallas_matches_xla."""
    rng = np.random.default_rng(seed)
    return np.fft.fft2(rng.standard_normal((batch, n, n))).astype(np.complex64)


def _case4_spectra(n, batch, seed=76):
    """Spectra of real case-4 vortex fields, what the solver feeds K2."""
    rng = np.random.default_rng(seed)
    return np.stack([initial_condition(4, n, n, 1.0, 1.0, rng)
                     for _ in range(batch)]).astype(np.complex64)


@pytest.mark.parametrize("n", [16, 32])
def test_constants_match_pallas(n):
    c = k2.fftfreq_constants(n, device="cpu")
    _, _, kx, ky, ik2, m23 = PallasAdvection2D(n=n)._consts()
    for got, want in ((c.kx, kx), (c.ky, ky), (c.inv_k2, ik2), (c.mask23, m23)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(c.kx_vec.numpy(), kx[0])
    np.testing.assert_array_equal(c.ky_vec.numpy(), ky[:, 0])
    assert c.inv_k2[0, 0] == 0.0
    lim = n // 3
    assert c.mask23[lim, lim] == 1.0 and c.mask23[lim + 1, 0] == 0.0 and c.mask23[0, n - lim] == 1.0
    ang = 2 * np.pi * np.arange(n // 2) / n
    np.testing.assert_allclose(c.twiddle.numpy(), np.stack([np.cos(ang), np.sin(ang)], 1), atol=1e-7)


@pytest.mark.parametrize("n,tile_b", [(32, 2), (16, 4)])
def test_plain_matches_pallas_and_xla(n, tile_b):
    w = _spectra(n, 4)
    wr, wi = jnp.asarray(w.real), jnp.asarray(w.imag)
    pr, pi = PallasAdvection2D(n=n, tile_b=tile_b, interpret=True)(wr, wi)
    xr, xi = xla_advection_ri(n)(wr, wi)
    got = k2.ns_advection(torch.from_numpy(w), k2.fftfreq_constants(n, device="cpu")).numpy()
    assert got.shape == (4, n, n) and got.dtype == np.complex64
    for want_r, want_i in ((pr, pi), (xr, xi)):
        want = np.asarray(want_r) + 1j * np.asarray(want_i)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_flops_bytes_and_tile():
    assert k2.min_bytes(256, 1) == 16 * 256 * 256
    # two packed complex inverses and one real forward: 2.5 complex 2D FFTs
    assert k2.flops(256, 1) == 2.5 * 5 * 65536 * 16 + 30 * 65536
    assert 1e3 * k2.min_bytes(256, 1) / 3.35e12 > 1e3 * k2.flops(256, 1) / 67e12  # bound by bytes
    assert k2.flops(256, 16) == 16 * k2.flops(256, 1)
    assert [k2.column_tile(n) for n in (8, 16, 256, 512, 1024)] == [8, 8, 8, 8, 4]


def test_k2_wrapper_never_falls_back():
    """A CPU tensor never reaches the plain version through the kernel
    handle, and a tensor that is neither on the CPU nor on a CUDA device is
    refused instead of being run some other way."""
    c = k2.fftfreq_constants(16, device="cpu")
    w = torch.zeros(2, 16, 16, dtype=torch.complex64)
    before = k2.NS_ADVECTION.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        k2.NS_ADVECTION(w, c)
    with pytest.raises(RuntimeError, match="CUDA"):
        k2.ns_advection(torch.empty(2, 16, 16, dtype=torch.complex64, device="meta"), c)
    assert k2.NS_ADVECTION.launches == before
    with pytest.raises(ValueError, match="square"):
        k2.advection_constants(np.zeros(16), np.zeros(8), device="cpu")


# ------------------------------------------------------------------------
# K2's CUDA source on the CPU. The shim maps the CUDA features the kernels
# use onto the host: one std::thread per CUDA thread, std::barrier for
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
#define __restrict__
#define __launch_bounds__(x)
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
struct Dim { int x; };
inline thread_local Dim threadIdx;
inline Dim blockIdx, blockDim;
inline std::unique_ptr<std::barrier<>> g_bar;
inline void __syncthreads() { g_bar->arrive_and_wait(); }
typedef int cudaError_t;
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "no error"; }
inline float2 g_smem[1 << 13];
template <class F> void emu_launch(int grid, int threads, size_t smem_bytes, F fn) {
  if (smem_bytes > sizeof(g_smem)) throw 1;
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
_LAUNCH = re.compile(r"(\w+)<<<(\w+), (\w+), (\w+), st>>>\(([^;]*)\);")


@pytest.fixture(scope="module")
def emulated_k2(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to run the CUDA source on the CPU")
    src = (build.CSRC_DIR / k2.SOURCE).read_text()
    assert len(_LAUNCH.findall(src)) == 3, "K2's launches changed: update the emulation"
    src = (src.replace("#include <cuda_runtime.h>", _SHIM)
              .replace("extern __shared__ float2 smem[];", "float2* smem = g_smem;"))
    src = _LAUNCH.sub(r"emu_launch(\2, \3, \4, [&] { \1(\5); });", src)
    d = tmp_path_factory.mktemp("k2emu")
    (d / "k2.cpp").write_text(src)
    subprocess.run([cxx, "-std=c++20", "-O2", "-pthread", "-shared", "-fPIC", "-w",
                    "-o", str(d / "k2.so"), str(d / "k2.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "k2.so"))
    lib.ns_advection_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.ns_advection_launch.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("n,batch,kind", [
    (32, 4, "normal"),  # the Pallas test's shape
    (16, 4, "normal"),  # two column tiles
    (8, 1, "normal"),  # one tile, the smallest grid
    (64, 2, "case4"),  # spectra of real vortex fields, positive-Nyquist wavenumbers
])
def test_k2_source_matches_plain(emulated_k2, n, batch, kind):
    if kind == "normal":
        w, c = torch.from_numpy(_spectra(n, batch)), k2.fftfreq_constants(n, device="cpu")
    else:
        from distributedconvrl_pde_control_torch.ops.spectral import fft_wavenumbers

        k = fft_wavenumbers(n, 1.0)
        w, c = torch.from_numpy(_case4_spectra(n, batch)), k2.advection_constants(k, k, device="cpu")
    out = torch.full_like(w, float("nan"))
    scratch = torch.empty((batch, k2.FIELDS, n, n), dtype=torch.complex64)
    err = emulated_k2.ns_advection_launch(
        w.data_ptr(), c.kx_vec.data_ptr(), c.ky_vec.data_ptr(), c.inv_k2.data_ptr(),
        c.mask23.data_ptr(), c.twiddle.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        batch, n, n.bit_length() - 1, k2.column_tile(n), None)
    assert err == 0
    want = k2.ns_advection_plain(w, c)
    scale = want.abs().max().item()
    assert scale > 0
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0, atol=1e-4 * scale)
    # far inside the Pallas tolerance: float32 FFT rounding only
    assert (out - want).abs().max().item() <= 2e-6 * scale
