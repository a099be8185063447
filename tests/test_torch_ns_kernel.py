"""Kernel K2 (the NS advection term with the 2/3-rule mask) against the JAX
package.

The same numpy spectra go through the Pallas kernel in interpret mode, its
XLA comparator `xla_advection_ri` and the port's plain version, at the shape
and tolerance of tests/test_pallas_kernels.py (1e-4 of the largest value).
K2's CUDA source is run on the CPU too: compiled by the host C++ compiler
against a small shim that runs each CUDA thread of a block as a host thread,
and the blocks of a thread-block cluster at once, each with its own shared
memory, which the others reach as the card's distributed shared memory.
"""

import ctypes
import inspect
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
from distributedconvrl_pde_control_torch.ops.kernels import build, device_route, ns_advection as k2
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


@pytest.mark.parametrize("n,tile_b", [(32, 2), (16, 4), (12, 4), (24, 2), (45, 2), (48, 2),
                                      (96, 1), (176, 1)])
def test_plain_matches_pallas_and_xla(n, tile_b):
    batch = 4 if n <= 48 else 2  # grids other than powers of two too, odd ones included
    w = _spectra(n, batch)
    wr, wi = jnp.asarray(w.real), jnp.asarray(w.imag)
    pr, pi = PallasAdvection2D(n=n, tile_b=tile_b, interpret=True)(wr, wi)
    xr, xi = xla_advection_ri(n)(wr, wi)
    got = k2.ns_advection(torch.from_numpy(w), k2.fftfreq_constants(n, device="cpu")).numpy()
    assert got.shape == (batch, n, n) and got.dtype == np.complex64
    for want_r, want_i in ((pr, pi), (xr, xi)):
        want = np.asarray(want_r) + 1j * np.asarray(want_i)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_flops_bytes_and_tile():
    assert k2.min_bytes(256, 1) == 16 * 256 * 256
    # two packed complex inverses and one real forward: 2.5 complex 2D FFTs
    assert k2.flops(256, 1) == 2.5 * 5 * 65536 * 16 + 30 * 65536
    assert 1e3 * k2.min_bytes(256, 1) / 3.35e12 > 1e3 * k2.flops(256, 1) / 67e12  # bound by bytes
    assert k2.flops(256, 16) == 16 * k2.flops(256, 1)
    # the column tile: wide where the batch fills the card, never above the shared-memory target
    assert [k2.column_tile(n, 1) for n in (8, 16, 256, 512, 1024)] == [2, 2, 2, 2, 4]
    assert [k2.column_tile(n, 16) for n in (8, 256, 512, 1024)] == [2, 16, 8, 4]
    assert [k2.row_pairs(n, b) for n, b in ((256, 1), (256, 16), (1024, 16), (8, 1))] == [1, 4, 1, 1]
    # every grid: an even tile, no wider than the grid (a partial last tile where it does not
    # divide n), within the target up to 1024 and within the card's limit up to line_limit
    for n in (8, 12, 45, 96, 176, 256, 384, 1024, 2039, 2048, 4096):
        for b in (1, 16):
            tc, ppc = k2.column_tile(n, b), k2.row_pairs(n, b)
            assert tc % 2 == 0 and 2 <= tc <= max(2, n) and ppc >= 1
            need = max(k2.smem_bytes(i, n, tc, ppc) for i in range(3))
            assert need <= (k2.SMEM_TARGET if n <= 1024 else k2.SMEM_LIMIT)
            k2.check_grid(n)
    assert (k2.column_tile(96, 16), k2.column_tile(176, 16), k2.column_tile(45, 16)) == (8, 8, 4)


def test_k2_grid_limits():
    """Every n >= 8 up to the shared-memory limit of its kind takes the block
    route, computed from smem_bytes; above it the device route (no refusal
    but n < 8)."""
    # the limit of each kind: even and odd, with factors 2, 3 and 5 only or another prime
    assert [k2.line_limit(n) for n in (4096, 3645, 2638, 2527)] == [4304, 4008, 2641, 2527]
    for n in (8, 9, 45, 176, 2039, 2048, 4096, 3645, 2638, 2527):
        k2.check_grid(n)
        assert max(k2.smem_bytes(i, n, 2, 1) for i in range(3)) <= k2.SMEM_LIMIT
        assert k2.route(n) == "block"
    with pytest.raises(ValueError, match="n >= 8"):
        k2.check_grid(7)
    for n, limit in ((4320, 4304), (6144, 4304), (6561, 4008), (2642, 2641), (4097, 2527)):
        assert n > limit == k2.line_limit(n) and k2.route(n) == "device"
        k2.check_grid(n)
    assert k2.twiddle_length(45) == 45 and k2.twiddle_length(96) == 48


# What an H100 80GB HBM3 reports: clusters of c blocks of the cluster route resident at once
# (`ns_advection_cluster_capacity`: one block an SM), on its 132 SMs
H100_RESIDENT = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 9: 9, **dict.fromkeys(
    range(10, 17), 7)}


def test_k2_cluster_route_choice():
    """Which kernel runs a stage follows from n, the batch and what the card reports (its SM
    count, and how many clusters of c blocks it holds at once) alone: of the clusters that hold
    one field, those with the fewest waves, the largest; the cluster route where its blocks fill
    CLUSTER_FILL of the SMs over those waves, the cooperative kernel elsewhere."""
    choose = k2.cluster_size
    assert list(inspect.signature(choose).parameters) == ["n", "batch", "sms", "resident"]

    def h100(n, batch):
        return choose(n, batch, 132, H100_RESIDENT.get)

    # the fluid training cell's grid: 6 blocks a field at batch 16 (17 clusters of 6 resident,
    # 15 of 7 or 8: one wave, 96 of 132 SMs), two waves of them at 32; the cooperative kernel
    # at batch 1, 4 and 8 (64 and 72 blocks), where it was the faster (chip_smoke.py phase 12)
    assert k2.cluster_smem_bytes(256, 5) == 0 < k2.cluster_smem_bytes(256, 6) <= k2.SMEM_LIMIT
    assert [h100(256, b) for b in (1, 4, 8, 16, 32)] == [0, 0, 0, 6, 6]
    assert h100(96, 16) == 6
    assert h100(384, 16) == 0  # 16 fields of 384^2 need three waves of 7 clusters of 16
    # the device route's grids never take it, nor a field that 16 blocks do not hold
    for n in (4097, 4320, 6144, 8192):
        assert k2.route(n) == "device" and all(h100(n, b) == 0 for b in (1, 16, 4096))
    for n in (406, 512, 1024, 2048):
        assert k2.route(n) == "block" and k2.cluster_smem_bytes(n, 16) == 0
        assert all(h100(n, b) == 0 for b in (1, 16, 4096))
    # nor a cluster that the card cannot place
    assert choose(256, 16, 132, lambda c: 0) == 0
    assert choose(256, 16, 132, lambda c: H100_RESIDENT[c] if c != 6 else 0) == 0  # 7: 2 waves
    # the rule over a sweep of shapes and two cards
    for n in (8, 12, 28, 45, 96, 128, 176, 256, 320, 384, 405, 406):
        for sms, resident in ((132, H100_RESIDENT.get), (114, lambda c: 114 // c)):
            fits = [c for c in k2.CLUSTER_SIZES if k2.cluster_smem_bytes(n, c)]
            for batch in range(1, 70):
                c = choose(n, batch, sms, resident)
                if not fits:
                    assert c == 0
                    continue
                waves = {d: -(-batch // resident(d)) for d in fits}
                best = min(waves.values())
                pick = max(d for d in fits if waves[d] == best)
                fills = batch * pick >= k2.CLUSTER_FILL * best * sms
                assert c == (pick if fills else 0), (n, sms, batch, c, pick)


def test_k2_cluster_shape_matches_source(emulated_k2):
    """The wrapper's account of the cluster route's shared memory is the source's, at every
    grid up to the largest that a cluster holds and every cluster size."""
    for n in range(8, 410):
        for c in k2.CLUSTER_SIZES:
            assert emulated_k2.ns_advection_cluster_smem_bytes(n, c) == k2.cluster_smem_bytes(n, c)


# above the block route's limits: (n, the split's levels or Bluestein's m)
ROUTE_CASES = [(4320, (60, 72)), (6144, (64, 96)), (6561, (81, 81)), (2642, (2, 1321)),
               (4097, (17, 241)), (4099, 8640), (8192, (64, 128))]


@pytest.mark.parametrize("n,want", ROUTE_CASES)
def test_k2_device_route_plan(n, want):
    """Each grid the block route cannot take gets a device plan: a split whose levels the block
    route takes as lines, or Bluestein of a 5-smooth m >= 2n - 1 that splits so."""
    assert k2.route(n) == "device"
    plan = device_route.device_plan(n, k2.SMEM_LIMIT)
    assert all(length <= k2.line_limit(length) for length in plan.levels)
    assert int(np.prod(plan.levels)) == plan.m and plan.smem <= k2.SMEM_LIMIT
    if plan.bluestein:
        assert plan.m == want and plan.m >= 2 * n - 1 and set(
            device_route._factor_radices(plan.m)) <= {2, 3, 4, 5}
    else:
        assert plan.levels == want and plan.m == n
    assert k2.dm_work_floats(1, n, plan) == 2 * n * ((n + 1) // 2) + (
        4 * n * plan.m if plan.bluestein else 0)


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
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define DM_THREADS 64
#define CLUSTER_THREADS 64
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct Dim { int x; };
inline thread_local Dim threadIdx, blockIdx;
inline Dim blockDim, gridDim;
inline thread_local std::barrier<>* tl_bar;
inline thread_local void* tl_smem;
inline std::barrier<>* g_grid_bar;
inline void __syncthreads() { tl_bar->arrive_and_wait(); }
inline void grid_sync() { g_grid_bar->arrive_and_wait(); }
typedef int cudaError_t;
typedef void* cudaStream_t;
#define cudaSuccess 0
#define cudaErrorInvalidValue 1
#define cudaErrorInvalidConfiguration 9
#define cudaFuncAttributeMaxDynamicSharedMemorySize 0
#define cudaDevAttrMultiProcessorCount 0
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "no error"; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 3; return 0; }  // three "SMs"
template <class F> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return 0;
}
inline float2 g_smem[1 << 15];
template <class F> void emu_launch(int grid, int threads, size_t smem_bytes, F fn) {
  if (smem_bytes > sizeof(g_smem)) throw 1;
  blockDim.x = threads;
  gridDim.x = grid;
  for (int b = 0; b < grid; ++b) {  // blocks one after another
    std::barrier<> bar(threads);
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, b, t] { blockIdx.x = b; threadIdx.x = t; tl_bar = &bar; tl_smem = g_smem; fn(); });
    for (auto& th : ts) th.join();
  }
}
// a cooperative launch: every thread of every block at once, grid_sync a barrier of all of them
template <class K, class... A> int host_cooperative_launch(K kernel, int grid, int threads,
                                                           size_t smem, A... args) {
  blockDim.x = threads;
  gridDim.x = grid;
  std::barrier<> all(grid * threads);
  g_grid_bar = &all;
  std::vector<std::unique_ptr<std::barrier<>>> bars;
  std::vector<std::vector<float2>> mem;
  for (int b = 0; b < grid; ++b) {
    bars.push_back(std::make_unique<std::barrier<>>(threads));
    mem.emplace_back(smem / sizeof(float2) + 1);
  }
  std::vector<std::thread> ts;
  for (int b = 0; b < grid; ++b)
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, b, t] {
        blockIdx.x = b; threadIdx.x = t; tl_bar = bars[b].get(); tl_smem = mem[b].data();
        kernel(args...);
      });
  for (auto& th : ts) th.join();
  return 0;
}
// a cluster launch: the clusters one after another, the blocks of one at once, each with its
// own shared memory (NaN until written); the cluster barrier a barrier of all their threads
inline thread_local int tl_rank;
inline thread_local float2* const* tl_cluster_smem;
inline thread_local std::barrier<>* tl_cluster_bar;
inline int cluster_rank() { return tl_rank; }
inline void cluster_sync() { tl_cluster_bar->arrive_and_wait(); }
inline float2* cluster_map(float2* p, int rank) {
  return tl_cluster_smem[rank] + (p - static_cast<float2*>(tl_smem));
}
inline void store_pair(float2* dst, float2 a, float2 b) { dst[0] = a; dst[1] = b; }
template <class K, class... A> int host_cluster_launch(K kernel, int grid, int cluster, int threads,
                                                       size_t smem, A... args) {
  if (grid % cluster) return 9;
  blockDim.x = threads;
  gridDim.x = grid;
  for (int g = 0; g < grid / cluster; ++g) {
    std::barrier<> all(cluster * threads);
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    std::vector<std::vector<float2>> mem;
    std::vector<float2*> ptrs;
    for (int r = 0; r < cluster; ++r) {
      bars.push_back(std::make_unique<std::barrier<>>(threads));
      mem.emplace_back(smem / sizeof(float2) + 1, float2{NAN, NAN});
    }
    for (auto& m : mem) ptrs.push_back(m.data());
    std::vector<std::thread> ts;
    for (int r = 0; r < cluster; ++r)
      for (int t = 0; t < threads; ++t)
        ts.emplace_back([&, r, t] {
          blockIdx.x = g * cluster + r; threadIdx.x = t; tl_bar = bars[r].get();
          tl_smem = mem[r].data(); tl_rank = r; tl_cluster_smem = ptrs.data(); tl_cluster_bar = &all;
          kernel(args...);
        });
    for (auto& th : ts) th.join();
  }
  return 0;
}
"""
_LAUNCH = re.compile(r"([\w<>]+)<<<(\w+), (\w+), (\w+), st>>>\(([^;]*)\);")


@pytest.fixture(scope="module")
def emulated_k2(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to run the CUDA source on the CPU")
    src = (build.CSRC_DIR / k2.SOURCE).read_text()
    assert len(_LAUNCH.findall(src)) == 3, "K2's launches changed: update the emulation"
    src = (src.replace("#include <cuda_runtime.h>", _SHIM)
              .replace("extern __shared__ float2 smem[];",
                       "float2* smem = static_cast<float2*>(tl_smem);")
              .replace("extern __shared__ __align__(16) float2 smem[];",
                       "float2* smem = static_cast<float2*>(tl_smem);"))
    src = _LAUNCH.sub(r"emu_launch(\2, \3, \4, [&] { \1(\5); });", src)
    d = tmp_path_factory.mktemp("k2emu")
    (d / "k2.cpp").write_text(src)
    subprocess.run([cxx, "-std=c++20", "-O2", "-pthread", "-shared", "-fPIC", "-w",
                    "-I", str(build.CSRC_DIR),
                    "-o", str(d / "k2.so"), str(d / "k2.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "k2.so"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ns_advection_launch.argtypes = [ptr] * 10 + [i32] * 5 + [ptr] * 2
    lib.ns_advection_launch.restype = ctypes.c_int
    lib.ns_advection_rk4_launch.argtypes = [ptr] * 11 + [ctypes.c_double] + [i32] * 6 + [ptr] * 2
    lib.ns_advection_rk4_launch.restype = ctypes.c_int
    lib.ns_advection_smem_bytes.argtypes = [i32] * 4
    lib.ns_advection_smem_bytes.restype = ctypes.c_size_t
    lib.ns_advection_dm_launch.argtypes = [ptr] * 9 + [i32] * 2 + [ptr, i32] + [ptr] * 7
    lib.ns_advection_dm_launch.restype = ctypes.c_int
    lib.ns_advection_dm_rk4_launch.argtypes = ([ptr] * 10 + [ctypes.c_double] + [i32] * 3
                                               + [ptr, i32] + [ptr] * 7)
    lib.ns_advection_dm_rk4_launch.restype = ctypes.c_int
    lib.ns_advection_dm_work_floats.argtypes = [i32] * 4
    lib.ns_advection_dm_work_floats.restype = ctypes.c_size_t
    lib.ns_advection_cluster_launch.argtypes = [ptr] * 9 + [i32] * 3 + [ptr] * 2
    lib.ns_advection_cluster_launch.restype = ctypes.c_int
    lib.ns_advection_cluster_rk4_launch.argtypes = ([ptr] * 10 + [ctypes.c_double] + [i32] * 4
                                                    + [ptr] * 2)
    lib.ns_advection_cluster_rk4_launch.restype = ctypes.c_int
    lib.ns_advection_cluster_smem_bytes.argtypes = [i32] * 2
    lib.ns_advection_cluster_smem_bytes.restype = ctypes.c_size_t
    return lib


def _emulate(lib, w, c, tc, ppc, lin=None, f=None, cluster=0):
    """The CUDA source's launch chain on CPU tensors, as the wrapper calls it;
    with `cluster` > 0 the cluster route on clusters of that many blocks."""
    batch, n = w.shape[0], c.n
    out = torch.full_like(w, float("nan"))
    if cluster:
        before = k2.NS_ADVECTION.cluster_launches
        launched = ctypes.c_int(0)
        err = lib.ns_advection_cluster_launch(
            w.data_ptr(), *c.pointers, out.data_ptr(),
            None if lin is None else lin.data_ptr(), None if f is None else f.data_ptr(),
            batch, n, cluster, None, ctypes.byref(launched))
        assert err == 0 and launched.value == 1  # one launch of `batch` clusters
        k2.NS_ADVECTION._count(err, launched, cluster=True)  # counted as the wrapper counts it
        assert k2.NS_ADVECTION.cluster_launches == before + 1
        return out
    scratch = torch.full((batch, k2.PACKED, n, n), float("nan"), dtype=torch.complex64)
    launched = ctypes.c_int(0)
    err = lib.ns_advection_launch(
        w.data_ptr(), *c.pointers, scratch.data_ptr(), out.data_ptr(),
        None if lin is None else lin.data_ptr(), None if f is None else f.data_ptr(),
        batch, n, tc, ppc, 0, None, ctypes.byref(launched))
    assert err == 0 and launched.value == 3  # the chain form: one launch per pass
    return out


def _solver_constants(n):
    from distributedconvrl_pde_control_torch.ops.spectral import fft_wavenumbers

    k = fft_wavenumbers(n, 1.0)  # the Nyquist wavenumber is positive
    return k2.advection_constants(k, k, device="cpu")


def _k2_inputs(n, batch, kind):
    """(w, constants): "normal" is the Pallas test's input with its constants;
    "case4" spectra of real vortex fields with the solver's constants;
    "nyquist" adds non-Hermitian content on the Nyquist row and column to
    "normal" spectra and "complex" is non-Hermitian everywhere, both with
    the solver's constants: the reference drops what the real part drops."""
    if kind == "normal":
        return torch.from_numpy(_spectra(n, batch)), k2.fftfreq_constants(n, device="cpu")
    if kind == "case4":
        return torch.from_numpy(_case4_spectra(n, batch)), _solver_constants(n)
    rng = np.random.default_rng(n + batch)
    w = _spectra(n, batch, seed=3)
    noise = (rng.standard_normal((batch, n, n)) + 1j * rng.standard_normal((batch, n, n))) * n
    if kind == "nyquist":
        keep = np.zeros((n, n), bool)
        keep[n // 2, :] = keep[:, n // 2] = True
        noise = noise * keep
    return torch.from_numpy((w + noise).astype(np.complex64)), _solver_constants(n)


def _assert_close(got, want, limit=2e-6):
    scale = want.abs().max().item()
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4 * scale)
    # far inside the Pallas tolerance: float32 FFT rounding only
    assert (got - want).abs().max().item() <= limit * scale


# The chain form (cluster 0; ids as before the cluster route came) and the cluster route on
# clusters of 2 and 4 blocks (tc and ppc unused): (n, batch, kind, tc, ppc, cluster)
@pytest.mark.parametrize("n,batch,kind,tc,ppc,cluster", [
    # the Pallas test's shape; line groups of 3 + 2 stages
    pytest.param(32, 4, "normal", 4, 1, 0, id="32-4-normal"),
    # two column tiles; row tiles of 4, 4 and 1 pairs
    pytest.param(16, 4, "normal", 8, 4, 0, id="16-4-normal"),
    # the smallest grid, one group of 3 stages
    pytest.param(8, 1, "normal", 4, 1, 0, id="8-1-normal"),
    pytest.param(8, 2, "normal", 8, 2, 0, id="8-2-normal-8-2"),  # one column tile as wide as the grid
    # spectra of real vortex fields, positive-Nyquist wavenumbers
    pytest.param(64, 2, "case4", 16, 2, 0, id="64-2-case4"),
    # non-Hermitian Nyquist row and column; the narrowest tile
    pytest.param(16, 2, "nyquist", 2, 1, 0, id="16-2-nyquist-2-1"),
    pytest.param(32, 2, "complex", 8, 3, 0, id="32-2-complex-8-3"),  # non-Hermitian everywhere
    pytest.param(128, 1, "nyquist", 4, 1, 0, id="128-1-nyquist-4-1"),  # Fluid_8's grid: 4 + 3 stages
    # the fluid path's grid at batch 1: 4 + 4 stages
    pytest.param(256, 1, "complex", 4, 1, 0, id="256-1-complex-4-1"),
    # grids other than powers of two: mixed-radix passes
    pytest.param(12, 3, "normal", 4, 2, 0, id="12-3-normal"),  # one pass (4, 3)
    # passes (4, 2), 3; tiles of 10 columns, the last one of 4
    pytest.param(24, 2, "nyquist", 10, 2, 0, id="24-2-nyquist-10-2"),
    pytest.param(45, 2, "normal", 4, 3, 0, id="45-2-normal"),  # odd: passes (3, 3), 5; no Nyquist
    # odd, non-Hermitian everywhere, the narrowest tile
    pytest.param(45, 1, "complex", 2, 1, 0, id="45-1-complex-2-1"),
    # passes (4, 4), 3; tiles of 14 columns, the last one of 6
    pytest.param(48, 2, "case4", 14, 2, 0, id="48-2-case4-14-2"),
    pytest.param(96, 1, "nyquist", 8, 1, 0, id="96-1-nyquist-8-1"),  # passes (4, 4), (2, 3)
    pytest.param(176, 1, "case4", 8, 1, 0, id="176-1-case4"),  # (4, 4), then 11: a generic stage
    # the cluster route: each block's columns and row pairs in its shared memory
    pytest.param(16, 2, "nyquist", 0, 0, 2, id="cluster-16-2-nyquist-c2"),
    pytest.param(32, 3, "complex", 0, 0, 4, id="cluster-32-3-complex-c4"),
    pytest.param(32, 1, "case4", 0, 0, 2, id="cluster-32-1-case4-c2"),
    pytest.param(24, 2, "nyquist", 0, 0, 4, id="cluster-24-2-nyquist-c4"),  # mixed radix: 6 columns
    pytest.param(45, 2, "normal", 0, 0, 4, id="cluster-45-2-normal-c4"),  # odd: a last tile of 9
    pytest.param(45, 1, "complex", 0, 0, 2, id="cluster-45-1-complex-c2"),
    pytest.param(28, 3, "case4", 0, 0, 2, id="cluster-28-3-case4-c2"),  # 4 x 7: a generic stage
    pytest.param(28, 1, "nyquist", 0, 0, 4, id="cluster-28-1-nyquist-c4"),  # tiles 8, 8, 8, 4
    # more blocks than tiles and row pairs: blocks with no columns and no rows
    pytest.param(8, 2, "normal", 0, 0, 16, id="cluster-8-2-normal-c16"),
    # cluster sizes that divide neither n nor the row pairs
    pytest.param(32, 2, "case4", 0, 0, 7, id="cluster-32-2-case4-c7"),
    pytest.param(45, 1, "nyquist", 0, 0, 3, id="cluster-45-1-nyquist-c3"),
])
def test_k2_source_matches_plain(emulated_k2, n, batch, kind, tc, ppc, cluster):
    w, c = _k2_inputs(n, batch, kind)
    if cluster:
        assert emulated_k2.ns_advection_cluster_smem_bytes(n, cluster) == \
            k2.cluster_smem_bytes(n, cluster) > 0
    for which in range(3 if not cluster else 0):
        assert emulated_k2.ns_advection_smem_bytes(which, n, tc, ppc) == k2.smem_bytes(which, n, tc, ppc)
    _assert_close(_emulate(emulated_k2, w, c, tc, ppc, cluster=cluster), k2.ns_advection_plain(w, c))


def _noise_spectra(rng, batch, n, scale):
    return torch.from_numpy((scale * (rng.standard_normal((batch, n, n))
                                      + 1j * rng.standard_normal((batch, n, n)))).astype(np.complex64))


@pytest.mark.parametrize("operands", ["lin_f", "lin_only", "f_only"])
@pytest.mark.parametrize("n,batch,kind,cluster", [
    pytest.param(16, 2, "nyquist", 0, id="16-2-nyquist"),
    pytest.param(32, 3, "case4", 0, id="32-3-case4"),
    pytest.param(45, 2, "case4", 0, id="45-2-case4"),
    # the cluster route (the chain form above)
    pytest.param(32, 2, "case4", 4, id="cluster-32-2-case4-c4"),
    pytest.param(24, 3, "nyquist", 2, id="cluster-24-3-nyquist-c2"),
    pytest.param(45, 1, "case4", 4, id="cluster-45-1-case4-c4"),
    pytest.param(28, 2, "case4", 2, id="cluster-28-2-case4-c2"),
])
def test_k2_source_fused_operands_match_plain(emulated_k2, n, batch, kind, cluster, operands):
    """The optional operands of the function's launch against their plain
    twin, on the solver's constants and operator."""
    w, c = _k2_inputs(n, batch, kind)
    lin, f = -5e-3 * c.k2, _noise_spectra(np.random.default_rng(11), batch, n, 0.1 * w.abs().max().item())
    kw = {"lin_f": dict(lin=lin, f=f), "lin_only": dict(lin=lin), "f_only": dict(f=f)}[operands]
    got = _emulate(emulated_k2, w, c, 4, 2, cluster=cluster, **kw)
    _assert_close(got, k2.ns_rhs_plain(w, c, **kw), limit=4e-6)
    assert k2.ns_advection(w, c, **kw).equal(k2.ns_rhs_plain(w, c, **kw))  # the CPU route


@pytest.mark.parametrize("n,batch,kind,substeps,dt,cluster", [
    pytest.param(16, 2, "case4", 1, 2.5e-4, 0, id="16-2-case4-1-0.00025"),
    # the states alternate between the two work fields
    pytest.param(32, 1, "case4", 3, 2.5e-4, 0, id="32-1-case4-3-0.00025"),
    pytest.param(8, 1, "case4", 2, 1e-3, 0, id="8-1-case4-2-0.001"),  # the smallest grid
    # stage states that are not Hermitian on the Nyquist lines
    pytest.param(16, 3, "nyquist", 2, 2.5e-4, 0, id="16-3-nyquist-2-0.00025"),
    pytest.param(32, 2, "complex", 1, 1e-4, 0, id="32-2-complex-1-0.0001"),  # nor anywhere
    # a long substep: the stage arithmetic carries weight
    pytest.param(64, 1, "case4", 1, 1e-3, 0, id="64-1-case4-1-0.001"),
    pytest.param(24, 2, "nyquist", 2, 2.5e-4, 0, id="24-2-nyquist-2-0.00025"),  # mixed radix
    pytest.param(45, 1, "case4", 2, 1e-3, 0, id="45-1-case4-2-0.001"),  # odd
    # the cluster route (the chain form above)
    pytest.param(16, 3, "nyquist", 2, 2.5e-4, 2, id="cluster-16-3-nyquist-c2"),
    pytest.param(32, 2, "case4", 3, 1e-3, 4, id="cluster-32-2-case4-c4"),
    pytest.param(24, 1, "case4", 2, 1e-3, 4, id="cluster-24-1-case4-c4"),
    pytest.param(45, 2, "case4", 1, 1e-3, 2, id="cluster-45-2-case4-c2"),
    pytest.param(28, 1, "nyquist", 2, 1e-3, 4, id="cluster-28-1-nyquist-c4"),
])
def test_k2_source_rk4_matches_plain(emulated_k2, n, batch, kind, substeps, dt, cluster):
    """The library's loop of RK4 substeps (four stage launches each with the
    stage state, the operator, the forcing and, in the fourth, the
    combination folded in; states alternating between two work fields)
    against the plain composition."""
    w, c = _k2_inputs(n, batch, kind)
    f = _noise_spectra(np.random.default_rng(5), batch, n, 0.05 * w.abs().max().item())
    lin = -5e-3 * c.k2
    out = torch.full_like(w, float("nan"))
    work = torch.full((5, batch, n, n), float("nan"), dtype=torch.complex64)
    launched = ctypes.c_int(0)
    if cluster:  # no scratch: the intermediates live in the clusters' shared memory
        before = (k2.NS_ADVECTION.launches, k2.NS_ADVECTION.cluster_launches)
        err = emulated_k2.ns_advection_cluster_rk4_launch(
            w.data_ptr(), *c.pointers, work.data_ptr(), out.data_ptr(), lin.data_ptr(),
            f.data_ptr(), dt, substeps, batch, n, cluster, None, ctypes.byref(launched))
        assert err == 0 and launched.value == 4 * substeps  # one launch per stage
        k2.NS_ADVECTION._count(err, launched, cluster=True)
        assert (k2.NS_ADVECTION.launches - before[0], k2.NS_ADVECTION.cluster_launches
                - before[1]) == (4 * substeps, 4 * substeps)
    else:
        scratch = torch.full((batch, k2.PACKED, n, n), float("nan"), dtype=torch.complex64)
        err = emulated_k2.ns_advection_rk4_launch(
            w.data_ptr(), *c.pointers, scratch.data_ptr(), work.data_ptr(), out.data_ptr(),
            lin.data_ptr(), f.data_ptr(), dt, substeps, batch, n, 4, 2, 0, None,
            ctypes.byref(launched))
        assert err == 0 and launched.value == 3 * 4 * substeps  # four stages, each a chain of three
    want = k2.ns_rk4_plain(w, c, lin, f, dt, substeps)
    assert (want - w).abs().max() > 1e-4 * w.abs().max()  # the substeps moved the state
    _assert_close(out, want)
    assert k2.ns_rk4_substeps(w, c, lin, f, dt, substeps).equal(want)  # the CPU route
    with pytest.raises(RuntimeError, match="CUDA"):
        k2.NS_ADVECTION.rk4(w, c, lin, f, dt, substeps)


def test_k2_stage_operands_are_checked():
    c = k2.fftfreq_constants(16, device="cpu")
    with pytest.raises(ValueError, match="contiguous"):
        k2.AdvectionConstants(n=16, kx=c.kx, ky=c.ky, k2=c.k2, inv_k2=c.inv_k2, mask23=c.mask23,
                              kx_vec=c.kx_vec, ky_vec=c.ky_vec[:8], twiddle=c.twiddle)
    with pytest.raises(ValueError, match="float32"):
        k2.AdvectionConstants(n=16, kx=c.kx, ky=c.ky, k2=c.k2, inv_k2=c.inv_k2.double(),
                              mask23=c.mask23, kx_vec=c.kx_vec, ky_vec=c.ky_vec, twiddle=c.twiddle)
    assert len(c.pointers) == 5 and c.pointers[2] == c.inv_k2.data_ptr() and c.device.type == "cpu"


# ------------------------------------------------------------------------
# K2's device route through the CUDA source on the CPU, its blocks run at once as host threads
# so that its grid barriers hold. Plans are made at a shared-memory limit that forces them
# where the grid is small: (n, batch, kind, limit, levels, Bluestein's m or 0)
DM_CASES = [
    pytest.param(16, 2, "nyquist", 232_448, (4, 4), 0, id="16-2-nyquist"),  # a two-level split
    pytest.param(24, 3, "normal", 232_448, (4, 6), 0, id="24-3-normal"),
    pytest.param(45, 2, "complex", 232_448, (5, 9), 0, id="45-2-complex"),  # odd: no Nyquist line
    pytest.param(32, 1, "case4", 172, (2, 4, 4), 0, id="32-1-case4-3lv"),  # three levels
    pytest.param(22, 2, "case4", 232_448, (2, 11), 0, id="22-2-case4"),  # a generic 11 in a level
    pytest.param(13, 2, "nyquist", 232_448, (5, 5), 25, id="13-2-nyquist-bluestein"),  # prime
    pytest.param(14, 1, "complex", 172, (3, 3, 3), 27, id="14-1-complex-bluestein-3lv"),
]


def _k2_dm_buffers(c, batch, plan):
    tables = device_route.host_tables(plan)

    def f32(a):
        return None if a is None else torch.tensor(a, dtype=torch.float32)

    tw, chirp, bh = f32(tables["twiddle"]), f32(tables["chirp"]), f32(tables["bh"])
    pos = torch.tensor(tables["pos"], dtype=torch.int32)
    desc = device_route.descriptor(plan)
    floats = k2.dm_work_floats(batch, c.n, plan)
    work = torch.full((floats,), float("nan"))
    scratch = torch.full((batch, k2.PACKED, c.n, c.n), float("nan"), dtype=torch.complex64)
    keep = (tw, chirp, bh, pos, work)  # alive through the call
    return keep, scratch, (desc.ctypes.data, len(desc), tw.data_ptr(), pos.data_ptr(),
                           device_route.ptr(chirp), device_route.ptr(bh), work.data_ptr())


@pytest.mark.parametrize("n,batch,kind,limit,levels,m", DM_CASES)
def test_k2_device_route_source_matches_plain(emulated_k2, n, batch, kind, limit, levels, m):
    """The device route's kernel (line transforms as levels through device memory, one
    cooperative launch) against the plain version, with the operands lin and f."""
    w, c = _k2_inputs(n, batch, kind)
    plan = device_route.device_plan(n, limit)
    assert plan.levels == levels and plan.bluestein == bool(m) and (not m or plan.m == m)
    assert emulated_k2.ns_advection_dm_work_floats(batch, n, plan.m, plan.bluestein) == \
        k2.dm_work_floats(batch, n, plan)
    _keep, scratch, dm = _k2_dm_buffers(c, batch, plan)
    lin = -5e-3 * c.k2
    f = _noise_spectra(np.random.default_rng(12), batch, n, 0.1 * w.abs().max().item())
    for kw in ({}, dict(lin=lin, f=f)):
        out = torch.full_like(w, float("nan"))
        launched = ctypes.c_int(0)
        err = emulated_k2.ns_advection_dm_launch(
            w.data_ptr(), *c.pointers[:4], scratch.data_ptr(), out.data_ptr(),
            kw["lin"].data_ptr() if kw else None, kw["f"].data_ptr() if kw else None,
            batch, n, *dm, None, ctypes.byref(launched))
        assert err == 0 and launched.value == 1  # one cooperative launch
        _assert_close(out, k2.ns_rhs_plain(w, c, **kw), limit=4e-6)


@pytest.mark.parametrize("n,batch,limit,substeps", [(16, 2, 232_448, 2), (13, 1, 232_448, 1),
                                                    (24, 1, 400, 2)])
def test_k2_device_route_rk4_matches_plain(emulated_k2, n, batch, limit, substeps):
    """The library's RK4 loop on the device route: one cooperative launch per stage."""
    w, c = _k2_inputs(n, batch, "case4")
    plan = device_route.device_plan(n, limit)
    _keep, scratch, dm = _k2_dm_buffers(c, batch, plan)
    f = _noise_spectra(np.random.default_rng(5), batch, n, 0.05 * w.abs().max().item())
    lin = -5e-3 * c.k2
    out = torch.full_like(w, float("nan"))
    work = torch.full((5, batch, n, n), float("nan"), dtype=torch.complex64)
    launched = ctypes.c_int(0)
    err = emulated_k2.ns_advection_dm_rk4_launch(
        w.data_ptr(), *c.pointers[:4], scratch.data_ptr(), work.data_ptr(), out.data_ptr(),
        lin.data_ptr(), f.data_ptr(), 1e-3, substeps, batch, n, *dm, None, ctypes.byref(launched))
    assert err == 0 and launched.value == 4 * substeps
    want = k2.ns_rk4_plain(w, c, lin, f, 1e-3, substeps)
    assert (want - w).abs().max() > 1e-4 * w.abs().max()
    _assert_close(out, want)
