"""The port's KS solver and kernel K1 against the JAX package.

The same numpy inputs go through the JAX `KSSolver(fft_mode="native").step`,
the Pallas kernel `KSPallasStepper(interpret=True).step` and the port's
`KSSolver.step` on the CPU (K1's plain torch.fft version), at the shapes and
tolerances of tests/test_pallas_kernels.py. The CUDA source of K1 itself is
run on the CPU too: compiled by the host C++ compiler against a small shim
that runs each CUDA thread of a block as a host thread.
"""

import ctypes
import dataclasses
import json
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributedconvrl_pde_control_tpu.ops.ks import KSSolver as JaxKSSolver
from distributedconvrl_pde_control_tpu.ops.pallas.ks_kernel import KSPallasStepper
from distributedconvrl_pde_control_tpu.ops.spectral import ks_rfft_operators as jax_ops
from distributedconvrl_pde_control_torch.ops.kernels import build, device_route, ks_kernel
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
# grids that are not multiples of 4, at the same tolerance: odd nx (no Nyquist
# bin) and nx = 2 mod 4 (KS22 at nx=190 through --config-overrides)
OTHER_GRIDS = [
    (45, 5, 0.02, 4, 2, 0.4, 0.2, 2e-4),
    (50, 5, 0.0, 3, 3, 0.4, 0.2, 2e-4),
    (90, 10, 0.02, 2, 4, 0.4, 0.2, 2e-4),
    (190, 10, 0.0, 5, 5, 0.4, 0.2, 2e-4),
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


@pytest.mark.parametrize("nx,os_,mu,batch,seed,amp_y,amp_f,atol", CASES + OTHER_GRIDS)
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
    """Operator rows, the twiddle and position tables and the stage radices
    the kernel reads."""
    solver = KSSolver(nx=192, lx=22.0, dt=0.1, oversampling=30, device="cpu")
    ops, tw, pos, radices = solver.kernel_constants
    assert ops.shape == (5, 97) and tw.shape == (192, 2) and pos.shape == (192,)
    for row, name in enumerate(("a_inv", "b_op", "g_alpha", "dist_re", "dist_im")):
        np.testing.assert_array_equal(ops[row].numpy(), getattr(solver, name).numpy())
    # the exact zeros of the quarter turns
    assert tw[0, 1] == tw[96, 1] == tw[48, 0] == tw[144, 0] == 0.0
    np.testing.assert_allclose(tw.numpy(), np.stack([np.cos(2 * np.pi * np.arange(192) / 192),
                                                     np.sin(2 * np.pi * np.arange(192) / 192)], 1),
                               atol=1e-7)
    assert radices.dtype == np.int32 and radices.tolist() == [4, 4, 4, 3]
    assert pos.dtype == torch.int32 and sorted(pos.tolist()) == list(range(192))
    # 1 = 1 + 4*0 + ...: the first stage's sub-block 1 of 48 points; 4 = 0 + 4*1: the second's
    assert pos[0] == 0 and pos[1] == 48 and pos[4] == 12 and pos[64] == 1


@pytest.mark.parametrize("nx,want", [(64, [4, 4, 4]), (192, [4, 4, 4, 3]), (240, [4, 4, 3, 5]),
                                     (600, [4, 2, 3, 5, 5]), (28, [4, 7]), (404, [4, 101]),
                                     (45, [3, 3, 5]), (50, [2, 5, 5]), (190, [2, 5, 19]),
                                     (250, [2, 5, 5, 5])])
def test_factor_radices_and_positions(nx, want):
    """Every preset's grid factors into the kernel's butterflies; another
    factor stays as it is (the generic stage). The position table is the
    permutation an in-place mixed-radix transform leaves, checked against a
    numpy model of its stages."""
    radices = ks_kernel.factor_radices(nx)
    assert radices == want and int(np.prod(radices)) == nx
    pos = ks_kernel.digit_reversed_positions(nx, radices)
    rng = np.random.default_rng(nx)
    x = rng.standard_normal(nx) + 1j * rng.standard_normal(nx)
    z, length = x.copy(), nx
    for r in radices:  # decimation in frequency, in place
        sub = length // r
        for start in range(0, nx, length):
            blk = z[start:start + length].reshape(r, sub)  # [m][p]
            out = np.fft.fft(blk, axis=0) * np.exp(-2j * np.pi * np.outer(np.arange(r), np.arange(sub)) / length)
            z[start:start + length] = out.reshape(-1)
        length = sub
    np.testing.assert_allclose(z[pos], np.fft.fft(x), atol=1e-9 * nx)


@pytest.mark.parametrize("nx,batch", [(64, 1), (192, 1), (192, 2), (192, 5), (192, 16384),
                                      (240, 16384), (600, 37), (404, 9)])
def test_launch_shape_fits_the_card(nx, batch):
    pairs, threads = ks_kernel.launch_shape(nx, batch)
    generic = nx == 404
    assert pairs in (1, 2, 4, 8) and (pairs == 1 or pairs < batch + 1)
    assert threads % 32 == 0 and 32 <= threads <= ks_kernel.MAX_THREADS
    assert ks_kernel.smem_bytes(nx, pairs, generic) <= ks_kernel.SMEM_TARGET
    if nx == 192:
        want = {1: (1, 128), 2: (1, 128), 5: (4, 128), 16384: (8, 128)}[batch]
        assert (pairs, threads) == want
        if batch == 16384:  # four CTAs of 16 rows fit an SM's shared memory
            assert ks_kernel.smem_bytes(nx, pairs) == 53_780


def test_line_limit():
    """The largest grid whose CTA of one row pair fits the card's shared
    memory: with butterflies only and with a generic stage. Up to it the
    block route, above it the device route."""
    for nx, generic, limit in ((192, False, 4303), (45, False, 4303), (28, True, 3748),
                               (190, True, 3748)):
        assert ks_kernel.line_limit(nx) == limit
        assert ks_kernel.smem_bytes(limit, 1, generic) <= ks_kernel.SMEM_LIMIT
        assert ks_kernel.smem_bytes(limit + 1, 1, generic) > ks_kernel.SMEM_LIMIT
        assert ks_kernel.route(nx) == "block"
    assert ks_kernel.launch_shape(4303, 1)[0] == 1  # one row pair where nothing more fits
    # each kind's grids on both sides of its limit: factors 2, 3, 5 (4050, 4320); another prime
    # factor (3748 = 4 * 937, 3749 = 23 * 163)
    assert [ks_kernel.route(nx) for nx in (4050, 4320, 3748, 3749)] == [
        "block", "device", "block", "device"]


# above the block route's limits (the line_limit cases, the KS transfer's nx = 6000 and the
# card's test grids): (nx, the split's levels or Bluestein's m)
ROUTE_CASES = [(4304, (16, 269)), (3749, (23, 163)), (4320, (60, 72)), (4327, 8748),
               (6000, (75, 80)), (8192, (64, 128))]


@pytest.mark.parametrize("nx,want", ROUTE_CASES)
def test_k1_device_route_plan(nx, want):
    """Each grid the block route cannot take gets a device plan: a split whose levels the
    block route takes as lines, or Bluestein of a 5-smooth m >= 2 nx - 1 that splits so."""
    assert ks_kernel.route(nx) == "device"
    plan = device_route.device_plan(nx, ks_kernel.SMEM_LIMIT)
    assert all(length <= ks_kernel.line_limit(length) for length in plan.levels)
    assert int(np.prod(plan.levels)) == plan.m and plan.smem <= ks_kernel.SMEM_LIMIT
    if plan.bluestein:
        assert plan.m == want and plan.m >= 2 * nx - 1
        assert set(ks_kernel.factor_radices(plan.m)) <= {2, 3, 4, 5}
    else:
        assert plan.levels == want and plan.m == nx


def _levels(x, plan, tw, inverse):
    """A split transform of length plan.m composed in float64 from the plan's twiddle
    table: np.fft for each level's sub-transforms (the block route's code, tested above),
    the table for the twiddles between levels."""
    m, z = plan.m, x.astype(np.complex128)
    twc = tw[:, 0] + 1j * tw[:, 1]
    order = list(zip(plan.levels, plan.strides))
    for length, stride in (order if inverse else order[::-1]):
        v = z.reshape(m // (length * stride), length, stride)
        t = twc[np.outer(np.arange(length), np.arange(stride)) * (m // (length * stride))]
        v = length * np.fft.ifft(v, axis=1) * t if inverse else np.fft.fft(v * np.conj(t), axis=1)
        z = v.reshape(-1)
    return z


def _device_transform(x, plan, tables, inverse):
    """The device route's transform of one line composed in float64 from its host tables:
    natural order in and real-space order out (inverse), or the reverse (forward)."""
    if not plan.bluestein:
        return _levels(x, plan, tables["twiddle"], inverse)
    n, m, inner = plan.n, plan.m, plan.levels[-1]
    chirp = tables["chirp"][:, 0] + 1j * tables["chirp"][:, 1]
    chirp = chirp if inverse else np.conj(chirp)
    bh = tables["bh"][0 if inverse else 1]
    slots = tables["pos"][-inner:]
    base = np.arange(0, m, inner)[:, None]
    spec = np.empty(m, np.complex128)  # the kernel's spectrum back from the slot order
    spec[(base + np.arange(inner)).ravel()] = (bh[:, 0] + 1j * bh[:, 1])[(base + slots).ravel()]
    split = dataclasses.replace(plan, n=m, bluestein=False)
    a = np.zeros(m, np.complex128)
    a[:n] = x * chirp
    y = _levels(_levels(a, split, tables["twiddle"], True) * spec, split, tables["twiddle"], False)
    return y[:n] * chirp


@pytest.mark.parametrize("n,limit,levels,m", [
    (6, 232_448, (2, 3), 0), (15, 232_448, (3, 5), 0), (16, 232_448, (4, 4), 0),
    (97, 232_448, (10, 20), 200), (190, 232_448, (10, 19), 0), (4327, 232_448, (81, 108), 8748),
    (64, 172, (4, 4, 4), 0), (31, 172, (4, 4, 4), 64),
])
def test_device_plan_tables_compose_the_dft(n, limit, levels, m):
    """The device route's host tables (split twiddles, Bluestein's chirp and kernel spectrum
    in the innermost level's slot order), composed in float64 numpy as the kernels compose
    them, equal np.fft both ways."""
    plan = device_route.device_plan(n, limit)
    assert plan.levels == levels and plan.bluestein == bool(m) and (not m or plan.m == m)
    tables = device_route.host_tables(plan)
    assert tables["twiddle"].shape == (plan.m, 2) and len(tables["pos"]) == sum(plan.levels)
    if plan.bluestein:
        assert tables["chirp"].shape == (n, 2) and tables["bh"].shape == (2, plan.m, 2)
    desc = device_route.descriptor(plan)
    assert desc[:4].tolist() == [n, plan.m, int(plan.bluestein), len(levels)]
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    at = device_route.real_positions(plan)
    assert sorted(at.tolist()) == list(range(n))
    inv = _device_transform(x, plan, tables, inverse=True)
    np.testing.assert_allclose(inv[at], n * np.fft.ifft(x), rtol=0, atol=1e-12 * n)
    scrambled = np.empty(n, np.complex128)
    scrambled[at] = x
    np.testing.assert_allclose(_device_transform(scrambled, plan, tables, inverse=False),
                               np.fft.fft(x), rtol=0, atol=1e-12 * n)


def test_cli_ks_transfer_to_lx_5000_matches_the_jax_cli(tmp_path, capsys):
    """The paper's zero-shot transfer to a 10x larger domain: KS200's batched controller on
    KS500 at Lx = 5000, nx = 6000 (K1's device route on the card, its plain version here),
    the port's CLI against the JAX CLI's own run."""
    from distributedconvrl_pde_control_tpu.experiments import run as jrun
    from distributedconvrl_pde_control_torch.experiments import run as trun

    argv = ["KS500", "--eval", "--load-from", "artifacts/KS200_batched_lh", "--config-overrides",
            '{"lx": 5000.0, "nx": 6000, "n_actuators": 2000}', "--p-te", "20", "--cpu"]
    assert ks_kernel.route(6000) == "device"
    trun.main(argv + ["--out", str(tmp_path / "port")])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jrun.main(argv + ["--out", str(tmp_path / "jax")])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert abs(got["suppression"] - want["suppression"]) <= 1e-5
    assert 0.0 < got["suppression"] < 1.0


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
#define __noinline__
#define __restrict__
#define __launch_bounds__(x)
#define DM_THREADS 64
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline unsigned __umulhi(unsigned a, unsigned b) { return (unsigned)(((unsigned long long)a * b) >> 32); }
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
inline float4 g_smem[1 << 14];
template <class F> void emu_launch(int grid, int threads, F fn) {  // blocks one after another
  blockDim.x = threads;
  gridDim.x = grid;
  for (int b = 0; b < grid; ++b) {
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
  std::vector<std::vector<float4>> mem;
  for (int b = 0; b < grid; ++b) {
    bars.push_back(std::make_unique<std::barrier<>>(threads));
    mem.emplace_back(smem / sizeof(float4) + 1);
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
"""


@pytest.fixture(scope="module")
def emulated_k1(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to run the CUDA source on the CPU")
    src = (build.CSRC_DIR / ks_kernel.SOURCE).read_text()
    launch = "ks_cnab2_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>("
    tail = "lgp, substeps, dt_os);\n  return (int)cudaGetLastError();"
    assert launch in src and tail in src, "K1's launch changed: update the emulation"
    src = (src.replace("#include <cuda_runtime.h>", _SHIM)
              .replace("extern __shared__ float4 smem4[];",
                       "float4* smem4 = static_cast<float4*>(tl_smem);")
              .replace(launch, "emu_launch(grid, threads, [&] { ks_cnab2_kernel(")
              .replace(tail, "lgp, substeps, dt_os); });\n  return (int)cudaGetLastError();"))
    d = tmp_path_factory.mktemp("k1emu")
    (d / "k1.cpp").write_text(src)
    subprocess.run([cxx, "-std=c++20", "-O2", "-pthread", "-shared", "-fPIC", "-w",
                    "-I", str(build.CSRC_DIR),
                    "-o", str(d / "k1.so"), str(d / "k1.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "k1.so"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ks_cnab2_launch.argtypes = [ptr] * 6 + [i32] * 2 + [ptr] + [i32] * 4 + [ctypes.c_float, ptr]
    lib.ks_cnab2_launch.restype = ctypes.c_int
    lib.ks_cnab2_smem_bytes.argtypes = [i32] * 3
    lib.ks_cnab2_smem_bytes.restype = ctypes.c_size_t
    lib.ks_cnab2_dm_launch.argtypes = ([ptr] * 6 + [i32] + [ptr] * 4 + [i32] * 2
                                       + [ctypes.c_float, ptr])
    lib.ks_cnab2_dm_launch.restype = ctypes.c_int
    lib.ks_cnab2_dm_work_floats.argtypes = [i32] * 4
    lib.ks_cnab2_dm_work_floats.restype = ctypes.c_size_t
    return lib


@pytest.mark.parametrize("nx,os_,mu,batch,seed,amp_y,amp_f,atol", CASES[:2] + [
    (192, 5, 0.0, 22, 1, 0.3, 0.1, 2e-4),  # two CTAs of 8 pairs, the second one partial
    (192, 5, 0.0, 69, 1, 0.3, 0.1, 2e-4),  # five CTAs, the last one partial, with an odd row
    (240, 3, 0.0, 5, 2, 1.0, 0.2, 2e-4),  # KS200's grid: factors 4, 4, 3, 5; an odd batch
    (192, 30, 0.0, 6, 3, 3.0, 1.0, 1e-3),  # the slice's substeps at ||y|| ~ 30
    (192, 30, 0.02, 1, 4, 3.0, 1.0, 1e-3),  # the rollout's single row, with the disturbance
    (60, 4, 0.02, 3, 5, 0.5, 0.2, 2e-4),  # a small grid with a factor 5 and a factor 3
    (600, 2, 0.0, 2, 6, 0.5, 0.2, 2e-4),  # KS500's grid: factors 4, 2, 3, 5, 5
    (28, 4, 0.02, 7, 7, 0.5, 0.2, 2e-4),  # a factor 7: the generic out-of-place stage
    (96, 4, 0.0, 3, 8, 0.5, 0.2, 2e-4),  # passes (4, 4) and (2, 3): the turn in a pass of two stages
    (160, 3, 0.0, 2, 9, 0.5, 0.2, 2e-4),  # passes (4, 4) and (2, 5)
    (144, 3, 0.02, 4, 10, 0.5, 0.2, 2e-4),  # passes (4, 4) and (3, 3)
    (256, 3, 0.0, 2, 11, 0.5, 0.2, 2e-4),  # two passes (4, 4)
    (36, 4, 0.0, 5, 12, 0.5, 0.2, 2e-4),  # passes (4, 3) and 3: the turn in a single stage
    (8, 4, 0.02, 2, 13, 0.5, 0.2, 2e-4),  # the one pass (4, 2) is the turn
    (45, 4, 0.02, 3, 21, 0.5, 0.2, 2e-4),  # odd nx: passes (3, 3), 5; no Nyquist bin
    (50, 4, 0.02, 5, 22, 0.5, 0.2, 2e-4),  # nx = 2 mod 4: passes (2, 5), 5
    (90, 4, 0.0, 4, 23, 0.5, 0.2, 2e-4),  # passes (2, 3), (3, 5)
    (190, 3, 0.02, 3, 24, 0.5, 0.2, 2e-4),  # passes (2, 5), 19: a generic innermost stage
])
def test_k1_source_matches_plain(emulated_k1, nx, os_, mu, batch, seed, amp_y, amp_f, atol):
    y, f = (torch.from_numpy(a) for a in _inputs(nx, batch, seed, amp_y, amp_f))
    solver = KSSolver(nx=nx, lx=22.0, dt=0.1, oversampling=os_, mu=mu, device="cpu")
    ops, tw, pos, radices = solver.kernel_constants
    pairs, threads = ks_kernel.launch_shape(nx, batch)
    generic = any(int(r) not in ks_kernel.BUTTERFLIES for r in radices)
    assert emulated_k1.ks_cnab2_smem_bytes(nx, pairs, generic) == ks_kernel.smem_bytes(nx, pairs, generic)
    out = torch.full_like(y, float("nan"))
    err = emulated_k1.ks_cnab2_launch(y.data_ptr(), f.data_ptr(), ops.data_ptr(), tw.data_ptr(),
                                      pos.data_ptr(), out.data_ptr(), batch, nx, radices.ctypes.data,
                                      len(radices), pairs.bit_length() - 1, threads, os_, 0.1 / os_, None)
    assert err == 0
    want = ks_kernel.ks_cnab2_plain(y, f, solver)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0, atol=atol)
    # an FFT's rounding, far inside the DFT-by-matmul tolerance above
    assert np.abs(out.numpy() - want.numpy()).max() <= 0.05 * atol + 2e-6 * np.abs(want.numpy()).max()


# K1's device route through the CUDA source on the CPU, its blocks run at once as host threads
# so that its grid barriers hold: (nx, oversampling, mu, batch, seed, y amplitude, forcing
# amplitude, shared-memory limit of the plan, the plan's levels, Bluestein's m or 0)
DM_CASES = [
    (48, 4, 0.02, 5, 30, 0.5, 0.2, 232_448, (6, 8), 0),  # a two-level split; an odd batch
    (45, 4, 0.02, 3, 31, 0.5, 0.2, 232_448, (5, 9), 0),  # odd nx: no Nyquist bin
    (50, 4, 0.0, 4, 32, 0.5, 0.2, 232_448, (5, 10), 0),  # nx = 2 mod 4
    (190, 3, 0.02, 3, 33, 0.5, 0.2, 232_448, (10, 19), 0),  # a generic 19-point stage in a level
    (192, 30, 0.02, 6, 34, 3.0, 1.0, 232_448, (12, 16), 0),  # the slice's substeps at ||y|| ~ 30
    (64, 3, 0.0, 2, 35, 0.5, 0.2, 172, (4, 4, 4), 0),  # three levels, one sub-line per tile
    (97, 3, 0.02, 3, 36, 0.5, 0.2, 232_448, (10, 20), 200),  # prime: Bluestein
    (31, 3, 0.0, 1, 37, 0.5, 0.2, 172, (4, 4, 4), 64),  # Bluestein on three levels, one row
]


def _k1_device_route(lib, y, f, solver, plan):
    tables = device_route.host_tables(plan)
    desc = device_route.descriptor(plan)

    def f32(a):
        return None if a is None else torch.tensor(a, dtype=torch.float32)

    tw, chirp, bh = f32(tables["twiddle"]), f32(tables["chirp"]), f32(tables["bh"])
    pos = torch.tensor(tables["pos"], dtype=torch.int32)
    batch, nx = y.shape
    floats = ks_kernel.dm_work_floats(batch, nx, plan)
    assert lib.ks_cnab2_dm_work_floats(batch, nx, plan.m, plan.bluestein) == floats
    work = torch.full((floats,), float("nan"))
    out = torch.full_like(y, float("nan"))
    ops = solver.kernel_constants[0]
    err = lib.ks_cnab2_dm_launch(y.data_ptr(), f.data_ptr(), ops.data_ptr(), out.data_ptr(),
                                 work.data_ptr(), desc.ctypes.data, len(desc), tw.data_ptr(),
                                 pos.data_ptr(), device_route.ptr(chirp), device_route.ptr(bh),
                                 batch, solver.oversampling, solver.dt / solver.oversampling, None)
    assert err == 0
    return out


@pytest.mark.parametrize("nx,os_,mu,batch,seed,amp_y,amp_f,limit,levels,m", DM_CASES)
def test_k1_device_route_source_matches_plain(emulated_k1, nx, os_, mu, batch, seed, amp_y, amp_f,
                                              limit, levels, m):
    """The device route's kernel (levels through a workspace, one cooperative launch) against
    the plain version, at the block route's tolerances."""
    y, f = (torch.from_numpy(a) for a in _inputs(nx, batch, seed, amp_y, amp_f))
    solver = KSSolver(nx=nx, lx=22.0, dt=0.1, oversampling=os_, mu=mu, device="cpu")
    plan = device_route.device_plan(nx, limit)
    assert plan.levels == levels and plan.bluestein == bool(m) and (not m or plan.m == m)
    out = _k1_device_route(emulated_k1, y, f, solver, plan)
    want = ks_kernel.ks_cnab2_plain(y, f, solver)
    atol = 1e-3 if os_ == 30 else 2e-4
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0, atol=atol)
    assert np.abs(out.numpy() - want.numpy()).max() <= 0.05 * atol + 2e-6 * np.abs(want.numpy()).max()
