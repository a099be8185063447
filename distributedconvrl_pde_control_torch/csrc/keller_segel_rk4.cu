// Keller-Segel finite-difference RK4 env step (kernel K3) for Hopper (sm_90a).
//
// Replaces no kernel of the JAX package, which steps Keller-Segel in XLA: it
// takes the place of the port's CUDA graph of the step's library kernels
// (ops/keller_segel.py::KellerSegelSolver._rk4 and rhs, 96 elementwise
// kernels a substep, 4,800 a step at 50 substeps). One launch advances a
// batch of states y (batch, 2, nx), rows u and v, under a constant forcing
// f (batch, nx) by `substeps` classic RK4 substeps of
//
//   u_t = u_xx + u - chi u_x v_x - chi u v_xx - u^2
//   v_t = v_xx - v + u + f
//
// with central differences whose ghost values are the end values
// (KellerSegelSetup.jl:221-224: w[-1] := w[0], w[nx] := w[nx-1]), and writes
// the result to out (batch, 2, nx).
//
// Design. One warp owns one env for the whole step. Lane l holds the P
// contiguous points l*P .. l*P + P-1 of u, v and f in registers (P =
// ceil(nx / 32), a template parameter: 4 at nx = 100, where lanes 25-31 only
// pass values along), beside the substep's stage input and its RK4 sum. The
// neighbours across a lane boundary come from the previous and next lanes by
// warp shuffles, four per right-hand side; lane 0 and the lane that holds
// point nx-1 take the clamped ends instead. Nothing leaves the registers
// between substeps: the state and forcing are read once and the result
// written once. Warps are independent (no shared memory, no barrier), 8 to a
// block, one block per 8 envs.
//
// Arithmetic. Float32 throughout, in the order of the eager PyTorch code (left
// to right, as Python groups it). A division by a scalar runs on the card as
// a multiplication by the scalar's float32 reciprocal, and the host passes
// those reciprocals (1 / 2dx, 1 / dx^2) as it passes chi and the RK4 weights
// h/2, h and h/6: each formed in double as the Python code forms it, rounded
// to float32. nvcc contracts a product and a sum into one fused multiply-add
// where the eager code rounds twice, so the result differs from the eager
// step by float32 rounding only.
//
// What bounds it. Operations: a point and substep needs 120 floating-point
// operations as the equations are written (24 a right-hand side, 4 of them,
// 3 stage inputs and the RK4 combination), against 20 bytes a point read or
// written once a step. At 16,384 envs x 100 points x 50 substeps that is 9.8
// GFLOP, 0.1467 ms at 67 TFLOP/s, against 32.8 MB, 0.0098 ms at 3.35 TB/s.
// The work is a stencil with no matrix product, so the limit in practice is
// instruction issue: ~100 instructions a point and substep after contraction
// (the clamps' selects included) and 16 shuffles a lane, with up to 7 of 32
// lanes idle at nx = 100.
//
// Plain C interface (built by nvcc, loaded with ctypes): the launch returns a
// cudaError_t code, 0 on success, checked by the Python wrapper.

#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;     // envs (warps) of a block
constexpr int kMaxPoints = 8; // points a lane holds at most: nx <= 256
constexpr unsigned kFull = 0xffffffffu;

struct Coef {
  float inv_2dx, inv_dx2, chi, h_half, h, h_sixth;
};

// dy/dt of the lane's P points of (u, v) under forcing g (KellerSegelSolver.rhs).
// first: the lane holds point 0; last: the lane's index of point nx-1, else -1.
template <int P>
__device__ __forceinline__ void rhs(const float (&u)[P], const float (&v)[P], const float (&g)[P],
                                    float (&du)[P], float (&dv)[P], bool first, int last,
                                    const Coef& c) {
  const float u_prev = __shfl_up_sync(kFull, u[P - 1], 1);
  const float v_prev = __shfl_up_sync(kFull, v[P - 1], 1);
  const float u_next = __shfl_down_sync(kFull, u[0], 1);
  const float v_next = __shfl_down_sync(kFull, v[0], 1);
#pragma unroll
  for (int j = 0; j < P; ++j) {
    float um, vm, up, vp;
    if (j == 0) {
      um = first ? u[0] : u_prev;
      vm = first ? v[0] : v_prev;
    } else {
      um = u[j - 1];
      vm = v[j - 1];
    }
    if (j == P - 1) {
      up = j == last ? u[j] : u_next;
      vp = j == last ? v[j] : v_next;
    } else {
      up = j == last ? u[j] : u[j + 1];
      vp = j == last ? v[j] : v[j + 1];
    }
    const float d1u = (up - um) * c.inv_2dx;
    const float d1v = (vp - vm) * c.inv_2dx;
    const float d2u = (um - 2.0f * u[j] + up) * c.inv_dx2;
    const float d2v = (vm - 2.0f * v[j] + vp) * c.inv_dx2;
    dv[j] = d2v - v[j] + u[j] + g[j];
    du[j] = d2u + u[j] - c.chi * d1u * d1v - c.chi * u[j] * d2v - u[j] * u[j];
  }
}

template <int P>
__global__ void __launch_bounds__(kWarps * 32)
    ksg_rk4_kernel(const float* __restrict__ y, const float* __restrict__ f,
                   float* __restrict__ out, int batch, int nx, Coef c, int substeps) {
  const int env = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (env >= batch) return;  // the whole warp: no shuffle waits for it
  const int lane = threadIdx.x & 31;
  const int i0 = lane * P;
  const size_t row = (size_t)env * nx;
  float u[P], v[P], g[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int i = i0 + j;
    const bool in = i < nx;
    u[j] = in ? y[2 * row + i] : 0.0f;
    v[j] = in ? y[2 * row + nx + i] : 0.0f;
    g[j] = in ? f[row + i] : 0.0f;
  }
  const bool first = lane == 0;
  const int last = (nx - 1 >= i0 && nx - 1 < i0 + P) ? nx - 1 - i0 : -1;

#pragma unroll 1
  for (int s = 0; s < substeps; ++s) {
    float k1u[P], k1v[P], ku[P], kv[P], k3u[P], k3v[P], su[P], sv[P];
    rhs<P>(u, v, g, k1u, k1v, first, last, c);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      su[j] = u[j] + c.h_half * k1u[j];
      sv[j] = v[j] + c.h_half * k1v[j];
    }
    rhs<P>(su, sv, g, ku, kv, first, last, c);  // k2
#pragma unroll
    for (int j = 0; j < P; ++j) {
      su[j] = u[j] + c.h_half * ku[j];
      sv[j] = v[j] + c.h_half * kv[j];
    }
    rhs<P>(su, sv, g, k3u, k3v, first, last, c);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      // k1 + 2 (k2 + k3), the first two terms of the RK4 sum, in k1
      k1u[j] = k1u[j] + 2.0f * (ku[j] + k3u[j]);
      k1v[j] = k1v[j] + 2.0f * (kv[j] + k3v[j]);
      su[j] = u[j] + c.h * k3u[j];
      sv[j] = v[j] + c.h * k3v[j];
    }
    rhs<P>(su, sv, g, ku, kv, first, last, c);  // k4
#pragma unroll
    for (int j = 0; j < P; ++j) {
      u[j] = u[j] + c.h_sixth * (k1u[j] + ku[j]);
      v[j] = v[j] + c.h_sixth * (k1v[j] + kv[j]);
    }
  }

#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int i = i0 + j;
    if (i < nx) {
      out[2 * row + i] = u[j];
      out[2 * row + nx + i] = v[j];
    }
  }
}

template <int P>
int launch(const float* y, const float* f, float* out, int batch, int nx, Coef c, int substeps,
           cudaStream_t stream) {
  const int grid = (batch + kWarps - 1) / kWarps;
  ksg_rk4_kernel<P><<<grid, kWarps * 32, 0, stream>>>(y, f, out, batch, nx, c, substeps);
  return (int)cudaGetLastError();
}

template <int P>
int blocks_per_sm(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ksg_rk4_kernel<P>,
                                                            kWarps * 32, 0);
}

// fn(std::integral_constant<int, P>) for the points a lane holds at grid size nx.
template <class F>
int with_points(int nx, F fn) {
  switch ((nx + 31) / 32) {
    case 1: return fn(std::integral_constant<int, 1>());
    case 2: return fn(std::integral_constant<int, 2>());
    case 3: return fn(std::integral_constant<int, 3>());
    case 4: return fn(std::integral_constant<int, 4>());
    case 5: return fn(std::integral_constant<int, 5>());
    case 6: return fn(std::integral_constant<int, 6>());
    case 7: return fn(std::integral_constant<int, 7>());
    default: return fn(std::integral_constant<int, kMaxPoints>());
  }
}

}  // namespace

extern "C" {

// The largest nx the kernel takes: 32 lanes of kMaxPoints points.
int ksg_rk4_max_nx() { return 32 * kMaxPoints; }

// y, out: (batch, 2, nx) float32; f: (batch, nx) float32, all contiguous on
// one device; the six constants as the wrapper forms them (inv_2dx = 1 / 2dx,
// inv_dx2 = 1 / dx^2, chi, and h/2, h, h/6 for h = dt / substeps). The
// Python wrapper checks the tensors.
int ksg_rk4_launch(const float* y, const float* f, float* out, int batch, int nx, int substeps,
                   float inv_2dx, float inv_dx2, float chi, float h_half, float h, float h_sixth,
                   void* stream) {
  if (batch < 1 || nx < 1 || nx > 32 * kMaxPoints || substeps < 1)
    return (int)cudaErrorInvalidValue;
  const Coef c{inv_2dx, inv_dx2, chi, h_half, h, h_sixth};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_points(nx, [&](auto p) {
    return launch<decltype(p)::value>(y, f, out, batch, nx, c, substeps, s);
  });
}

// Blocks of kWarps envs that an SM holds at once at grid size nx (the
// instantiation the launch picks); returns a cudaError_t code.
int ksg_rk4_blocks_per_sm(int nx, int* blocks) {
  return with_points(nx, [&](auto p) { return blocks_per_sm<decltype(p)::value>(blocks); });
}

const char* ksg_rk4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
