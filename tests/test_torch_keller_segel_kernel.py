"""Kernel K3 (the Keller-Segel RK4 env step) on the CPU.

K3's CUDA source is compiled by the host C++ compiler against a small shim
and held to the eager step (`KellerSegelSolver._rk4`, its plain version) at
float32 rounding. The shim runs each warp of a block as 32 host threads, one
warp after another (K3's warps share nothing); a warp shuffle is a per-warp
array written, a barrier of the warp's threads, then read, in two arrays
used in turn so that one barrier a shuffle suffices. The host compiler
emits no fused multiply-add here, so the shim rounds as the eager step does
but for the reciprocals K3 multiplies by where the CPU divides.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from distributedconvrl_pde_control_torch.ops import keller_segel as ks_ops
from distributedconvrl_pde_control_torch.ops.keller_segel import KellerSegelSolver
from distributedconvrl_pde_control_torch.ops.kernels import build
from distributedconvrl_pde_control_torch.ops.kernels import keller_segel_kernel as k3

DX, DT, CHI = 0.1, 0.006, 5.6  # the preset's grid spacing at every nx: lx = nx / 10

_SHIM = r"""
#include <barrier>
#include <cstddef>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
struct Dim { int x; };
inline thread_local Dim threadIdx, blockIdx;
inline Dim blockDim, gridDim;
struct Warp {
  std::barrier<> bar{32};
  float slot[2][32];
};
inline thread_local Warp* tl_warp;
inline thread_local int tl_turn;
// the value of lane (own + delta); out of the warp: its own, as on the card
inline float emu_shfl(float v, int delta) {
  const int lane = threadIdx.x & 31, src = lane + delta;
  float* s = tl_warp->slot[tl_turn];
  tl_turn ^= 1;
  s[lane] = v;
  tl_warp->bar.arrive_and_wait();
  return (src < 0 || src > 31) ? v : s[src];
}
inline float __shfl_up_sync(unsigned, float v, int delta) { return emu_shfl(v, -delta); }
inline float __shfl_down_sync(unsigned, float v, int delta) { return emu_shfl(v, delta); }
typedef int cudaError_t;
typedef void* cudaStream_t;
#define cudaSuccess 0
#define cudaErrorInvalidValue 1
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "no error"; }
template <class F> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return 0;
}
template <class F> void emu_launch(int grid, int threads, F fn) {  // warp after warp
  blockDim.x = threads;
  gridDim.x = grid;
  for (int b = 0; b < grid; ++b)
    for (int w = 0; w < threads / 32; ++w) {
      Warp warp;
      std::vector<std::thread> ts;
      for (int t = 0; t < 32; ++t)
        ts.emplace_back([&, b, w, t] {
          blockIdx.x = b; threadIdx.x = 32 * w + t; tl_warp = &warp; tl_turn = 0; fn();
        });
      for (auto& th : ts) th.join();
    }
}
"""


@pytest.fixture(scope="module")
def emulated_k3(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to run the CUDA source on the CPU")
    src = (build.CSRC_DIR / k3.SOURCE).read_text()
    launch = "ksg_rk4_kernel<P><<<grid, kWarps * 32, 0, stream>>>("
    tail = "substeps);\n  return (int)cudaGetLastError();"
    assert launch in src and tail in src, "K3's launch changed: update the emulation"
    src = (src.replace("#include <cuda_runtime.h>", _SHIM)
              .replace(launch, "emu_launch(grid, kWarps * 32, [&] { ksg_rk4_kernel<P>(")
              .replace(tail, "substeps); });\n  return (int)cudaGetLastError();"))
    d = tmp_path_factory.mktemp("k3emu")
    (d / "k3.cpp").write_text(src)
    subprocess.run([cxx, "-std=c++20", "-O2", "-pthread", "-shared", "-fPIC", "-w",
                    "-o", str(d / "k3.so"), str(d / "k3.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "k3.so"))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ksg_rk4_launch.argtypes = [ptr] * 3 + [i32] * 3 + [f32] * 6 + [ptr]
    lib.ksg_rk4_launch.restype = ctypes.c_int
    lib.ksg_rk4_max_nx.restype = ctypes.c_int
    return lib


def _run(lib, y, f, oversampling):
    """K3's source on the CPU: y (B, 2, nx), f (B, nx) float32."""
    y, f = y.contiguous(), f.contiguous()
    out = torch.full_like(y, float("nan"))
    batch, _, nx = y.shape
    err = lib.ksg_rk4_launch(y.data_ptr(), f.data_ptr(), out.data_ptr(), batch, nx, oversampling,
                             *k3.coefficients(DT, oversampling, DX, CHI), None)
    assert err == 0
    return out


def _fields(batch, nx, seed):
    """Cell densities and attractant near 1 with structure on every scale,
    and a forcing of the actions' size."""
    rng = np.random.default_rng(seed)
    y = 1.0 + 0.3 * rng.standard_normal((batch, 2, nx))
    f = 0.5 * rng.standard_normal((batch, nx))
    return torch.tensor(y, dtype=torch.float32), torch.tensor(f, dtype=torch.float32)


def _gap(got, want):
    """Largest difference over the field's largest value."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def test_source_limit_is_the_wrappers(emulated_k3):
    assert emulated_k3.ksg_rk4_max_nx() == k3.MAX_NX == 256


# nx: the preset's 100 (4 points a lane), odd 37 (point nx-1 inside a lane),
# 65 (P changes from 2 to 3), K3's limit 256 (all 32 lanes, 8 points each)
@pytest.mark.parametrize("nx,batch,oversampling", [
    (100, 1, 50), (100, 3, 10), (100, 33, 1), (37, 3, 50), (37, 33, 10), (37, 1, 1),
    (65, 1, 10), (65, 3, 1), (65, 33, 50), (256, 3, 50), (256, 1, 10), (256, 33, 1),
])
def test_k3_source_matches_the_eager_step(emulated_k3, nx, batch, oversampling):
    """Float32 rounding only: K3 lies within 2e-6 of the field's size of the
    float32 eager step and of the eager step in float64, as far as the
    float32 eager step lies from the float64 one (up to 9.3e-7 here)."""
    y, f = _fields(batch, nx, seed=nx + batch + oversampling)
    solver = KellerSegelSolver(nx=nx, lx=DX * nx)
    got = _run(emulated_k3, y, f, oversampling)
    want = solver.step(y, f, DT, oversampling)
    exact = solver.step(y.double(), f.double(), DT, oversampling)
    assert torch.isfinite(got).all()
    assert max(_gap(got, want), _gap(got, exact), _gap(want, exact)) <= 2e-6
    assert _gap(got, y) > 1e-3  # the step moved the field


@pytest.mark.parametrize("nx", [100, 37, 256])
def test_k3_source_clamps_both_ends(emulated_k3, monkeypatch, nx):
    """Steep fields at both ends: the end points follow the clamped eager
    step (w[-1] := w[0], w[nx] := w[nx-1]), and the same step with periodic
    ghost values would move them by far more than rounding."""
    x = np.linspace(0.0, 1.0, nx)
    y = np.stack([1.0 + np.exp(-x / 0.05) + 2.0 * np.exp((x - 1.0) / 0.05),
                  1.0 + 3.0 * x ** 4])[None]
    y = torch.tensor(y, dtype=torch.float32)
    f = torch.zeros((1, nx))
    solver = KellerSegelSolver(nx=nx, lx=DX * nx)
    got = _run(emulated_k3, y, f, 10)
    want = solver.step(y, f, DT, 10)
    ends = [0, 1, nx - 2, nx - 1]
    assert _gap(got[..., ends], want[..., ends]) <= 1e-6
    monkeypatch.setattr(ks_ops, "_clamped_shifts",
                        lambda w: (torch.roll(w, 1, -1), torch.roll(w, -1, -1)))
    periodic = solver.step(y, f, DT, 10)
    for i in (0, nx - 1):
        assert _gap(periodic[..., i], want[..., i]) > 1e-3, i


def test_k3_source_refuses_bad_sizes(emulated_k3):
    y, f = _fields(1, 257, seed=0)
    args = (y.data_ptr(), f.data_ptr(), y.data_ptr())
    consts = k3.coefficients(DT, 10, DX, CHI)
    for batch, nx, os_ in ((1, 257, 10), (0, 100, 10), (1, 0, 10), (1, 100, 0)):
        assert emulated_k3.ksg_rk4_launch(*args, batch, nx, os_, *consts, None) != 0


def test_coefficients_round_as_the_eager_step():
    """Each constant is the float32 of the double the Python code forms; the
    differences' scalars are float32 reciprocals."""
    c = k3.coefficients(DT, 50, 0.1, CHI)
    h = DT / 50
    want = [np.float32(1.0) / np.float32(0.2), np.float32(1.0) / np.float32(0.1 * 0.1),
            np.float32(5.6), np.float32(0.5 * h), np.float32(h), np.float32(h / 6.0)]
    assert c == tuple(float(w) for w in want)
    assert all(float(np.float32(v)) == v for v in c)
    assert k3.flops(16384, 100, 50) == 120 * 16384 * 100 * 50


def test_wrapper_refuses_cpu_tensors():
    y, f = _fields(2, 100, seed=1)
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        k3.KELLER_SEGEL_RK4(y, f, DT, 10, 0.1, CHI)
