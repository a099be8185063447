// Fused Kuramoto-Sivashinsky CNAB2 env step (kernel K1) for Hopper (sm_90a).
//
// Replaces distributedconvrl_pde_control_tpu/ops/pallas/ks_kernel.py::
// KSPallasStepper._kernel: one launch advances a batch of real fields
// y (batch, nx) under a constant forcing f (batch, nx) by `substeps` CNAB2
// substeps and writes irdft(u_hat) to out (batch, nx). Per substep:
//
//   u = irdft(u_hat);  N = G * rdft(u^2),  G = -0.5i * alpha
//   u_hat <- A_inv * (B * u_hat + 1.5 dt N - 0.5 dt N_prev + dt f_hat) + dist_hat
//
// with N_prev for the first substep taken from rdft(y^2), f_hat scaled by
// dt, and the disturbance added outside the A_inv solve.
//
// Design. One CTA owns `pairs` pairs of env rows (a power of two, up to 8)
// for the whole step: their half spectra (u_hat, N_prev, f_hat, nx/2 + 1
// bins each) and one complex work line of nx points per pair stay in shared
// memory for every substep; only y and f are read and out written in device
// memory. The two real rows of a pair ride one complex transform as its real
// and imaginary part and are split (after a forward transform) or merged
// (before an inverse one) by Hermitian symmetry, which is exact; the DC and
// Nyquist bins enter the inverse by their real parts only, as in irfft.
//
// The transforms are in-place mixed-radix FFTs over the factors of nx (4, 2,
// 3 and 5 as butterflies in registers; any other factor by a generic
// out-of-place stage, so every nx is taken, odd ones included; the
// butterflies and a pass's stages are csrc/radix.cuh, shared with K2).
// Neighbouring butterfly stages share a pass: a thread loads up to 16 points,
// runs both stages on them in registers and stores them, so 192 =
// (4*4)(4*3) is two passes over shared memory where the first version
// summed 192-term DFTs. The inverse is
// decimation in frequency (natural order in, digit-reversed out) and the
// forward decimation in time (digit-reversed in, natural out); between them
// the field is only squared, pointwise, so no stage ever permutes data: only
// the first load and the last store go through the position table `pos`. In
// a substep the innermost pass is where the transform turns round: it runs
// its inverse stages, squares and runs its forward stages on the same
// registers. A substep at nx = 192 is thus three passes and the spectral
// pass, one barrier each; the split, the CNAB2 update and the merge for the
// next inverse are one pass (a thread owns bins k and nx - k of a pair; bin
// 0, and for even nx the Nyquist bin nx/2, is its own mirror, and for odd nx
// no other bin is).
// Work lines are laid out [point][pair], so that neighbouring threads take
// the same task of neighbouring pairs: consecutive shared-memory words
// whatever the stage's stride, and one broadcast twiddle read.
//
// What bounds it. The kernel reads 2 and writes 1 float per grid point and
// env step (37.7 MB at batch 16384, nx 192: ~11 us at 3.35 TB/s). The step
// itself needs ~0.27 MFLOP per row at nx=192 and 30 substeps, counting 62
// real FFTs at 2.5*nx*log2(nx) flops plus the per-bin update
// (`ks_kernel.flops_per_row`; ~0.067 ms at 16384 rows on 67 TFLOP/s), so
// the function is bound by arithmetic, not by memory. The design keeps all
// substep state on chip and runs its transforms at the FFT's count; what
// remains is the shared-memory traffic of its passes (each reads and writes
// the line once, the spectral pass also three half spectra), one barrier per
// pass, and the registers of the 16-point passes (128 per thread, so an SM
// holds 512 threads). Everything is float32.
//
// Limits and routes. A CTA of one row pair needs ~54 B of shared memory per
// grid point (~62 with a generic stage), so this design (the block route)
// takes nx up to 4,303 (3,748). Above that the Python wrapper launches the
// device route below (ks_cnab2_dm_kernel): the same step with the half
// spectra and work lines in a workspace in device memory and the transforms
// as dm_fft.cuh's levels, a split of nx or Bluestein. It refuses only a
// workspace that does not fit the device's memory, and names the bytes.
//
// Plain C interface (built by nvcc, loaded with ctypes): every call returns
// a cudaError_t code, 0 on success, checked by the Python wrapper.

#include <cuda_runtime.h>
#include <stddef.h>
#ifdef __CUDACC__
#include <cooperative_groups.h>
#endif

namespace {

#include "radix.cuh"
#include "dm_fft.cuh"

constexpr int kOps = 5;  // a_inv, b, g_alpha, dist_re, dist_im
constexpr int kMaxFactors = 16;
constexpr int kMaxThreads = 512;

// The transform of one grid size: nx is the product of the radices of its
// `passes` passes, in the order of the inverse (decimation in frequency)
// transform. A pass runs one stage of radix r1 or, with r2 > 1, two stages
// (r1, then r2) on points a thread keeps in registers between them. Pass s
// works on blocks of len_s = nx / (r1 r2 of the passes before) points;
// magic[s] = floor(2^32 / sub) + 1 divides a task index by sub = len_s /
// (r1 r2) with one multiply (sub > 1).
struct Plan {
  int nx, passes;
  int r1[kMaxFactors], r2[kMaxFactors];
  unsigned magic[kMaxFactors];
};

struct Smem {
  float4* u;    // [nfh][pairs] u_hat of the pair's rows: (re a, im a, re b, im b)
  float4* np;   // previous nonlinear term, same layout
  float4* f;    // forcing spectrum * dt, same layout
  float2* z;    // [nx][pairs] work line: row a in .x, row b in .y
  float2* z2;   // second work line, only with a generic stage (else = z)
  float2* tw;   // nx twiddles (cos, sin)(2*pi*i/nx)
  float* ops;   // [kOps][nfh]
  int* pos;     // position of natural index j in digit-reversed order
};

__host__ __device__ inline size_t smem_floats(int nx, int pairs, int generic) {
  const size_t nfh = nx / 2 + 1;
  return 3 * 4 * nfh * pairs + 2 * (size_t)nx * pairs * (generic ? 2 : 1) + 2 * (size_t)nx +
         kOps * nfh + nx;
}

__device__ inline Smem carve(float4* base, int nx, int pairs, int generic) {
  const size_t nfh = nx / 2 + 1;
  Smem s;
  s.u = base;
  s.np = s.u + nfh * pairs;
  s.f = s.np + nfh * pairs;
  s.z = reinterpret_cast<float2*>(s.f + nfh * pairs);
  s.z2 = generic ? s.z + (size_t)nx * pairs : s.z;
  s.tw = s.z2 + (size_t)nx * pairs;
  s.ops = reinterpret_cast<float*>(s.tw + nx);
  s.pos = reinterpret_cast<int*>(s.ops + kOps * nfh);
  return s;
}

// exp(+-2 pi i idx / nx), idx < nx; + for the inverse
template <bool kInverse>
__device__ inline float2 twiddle_at(const float2* tw, int idx) {
  float2 t = tw[idx];
  if (!kInverse) t.y = -t.y;
  return t;
}
template <bool kInverse>
struct Table {  // pass_stages' twiddle lookup
  const float2* tw;
  __device__ float2 operator()(int idx) const { return twiddle_at<kInverse>(tw, idx); }
};

enum PassMode { kInversePass = 0, kForwardPass = 1, kTurnPass = 2 };

// One pass of the in-place transforms of all pairs, on blocks of `len`
// points: a thread takes the R1 * R2 points p + q * sub (sub = len / (R1 *
// R2)) of one block of one pair. kInversePass: decimation-in-frequency stages
// with exp(+i); kForwardPass: decimation-in-time stages with exp(-i);
// kTurnPass (sub == 1, the innermost pass): the inverse stages, the square of
// both components of every point, and the forward stages on the same
// registers, which is where the transform turns round in a substep.
template <int R1, int R2, int kMode>
__device__ inline void fft_pass(float2* z, const float2* tw, int nx, int len, unsigned magic,
                                int pairs, int lgp) {
  constexpr int R = R1 * R2;
  const int sub = len / R, tasks = (nx / R) << lgp, step = sub << lgp;
  const int tw1 = nx / len, tw2 = tw1 * R1;
  for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
    const int pair = t & (pairs - 1), j = t >> lgp;
    const int blk = sub == 1 ? j : (int)__umulhi((unsigned)j, magic);
    const int p = j - blk * sub;
    float2* base = z + ((size_t)(blk * len + p) << lgp) + pair;
    float2 x[R];
#pragma unroll
    for (int q = 0; q < R; ++q) x[q] = base[q * step];
    if (kMode != kForwardPass)
      pass_stages<R1, R2, true, true>(x, Table<true>{tw}, p, sub, tw1, tw2);
    if (kMode == kTurnPass) {
#pragma unroll
      for (int q = 0; q < R; ++q) x[q] = make_float2(x[q].x * x[q].x, x[q].y * x[q].y);
    }
    if (kMode != kInversePass)
      pass_stages<R1, R2, false, false>(x, Table<false>{tw}, p, sub, tw1, tw2);
#pragma unroll
    for (int q = 0; q < R; ++q) base[q * step] = x[q];
  }
  __syncthreads();
}

// The same stage for any radix r, out of place (z -> z2): a thread computes
// one output point as an r-term sum.
template <bool kInverse, bool kDif>
__device__ inline void fft_stage_generic(const float2* z, float2* z2, const float2* tw, int nx,
                                         int r, int len, int pairs, int lgp, bool square) {
  const int sub = len / r, tasks = nx << lgp, tw_mul = nx / len, root_mul = nx / r;
  for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
    const int pair = t & (pairs - 1), o = t >> lgp;
    const int blk = o / len, rem = o - blk * len;
    const int k = rem / sub, p = rem - k * sub;
    float2 acc = make_float2(0.f, 0.f);
    int mk = 0;  // (m * k) mod r
    for (int m = 0; m < r; ++m) {
      float2 x = z[((size_t)(blk * len + p + m * sub) << lgp) + pair];
      if (square) x = make_float2(x.x * x.x, x.y * x.y);
      int idx = mk * root_mul + (kDif ? 0 : p * m * tw_mul);
      if (idx >= nx) idx -= nx;
      acc = cadd(acc, cmul(x, twiddle_at<kInverse>(tw, idx)));
      mk += k;
      if (mk >= r) mk -= r;
    }
    if (kDif) acc = cmul(acc, twiddle_at<kInverse>(tw, p * k * tw_mul));
    z2[((size_t)o << lgp) + pair] = acc;
  }
  __syncthreads();
}

template <int kMode>
__device__ inline void run_pass(Smem& s, const Plan& plan, int pass, int len, int pairs, int lgp,
                                bool square) {
  const int r1 = plan.r1[pass], r2 = plan.r2[pass];
  const unsigned magic = plan.magic[pass];
#define KS_PASS(A, B)                                                            \
  case A * 8 + B:                                                                \
    fft_pass<A, B, kMode>(s.z, s.tw, plan.nx, len, magic, pairs, lgp);           \
    return;
  switch (r1 * 8 + r2) {
    KS_PASS(4, 4) KS_PASS(4, 3) KS_PASS(4, 2) KS_PASS(2, 3) KS_PASS(2, 5) KS_PASS(3, 3)
    KS_PASS(3, 5) KS_PASS(4, 1) KS_PASS(2, 1) KS_PASS(3, 1) KS_PASS(5, 1)
    default: break;
  }
#undef KS_PASS
  // any other radix: one stage, out of place (never a turn pass)
  if (kMode == kInversePass)
    fft_stage_generic<true, true>(s.z, s.z2, s.tw, plan.nx, r1, len, pairs, lgp, false);
  else
    fft_stage_generic<false, false>(s.z, s.z2, s.tw, plan.nx, r1, len, pairs, lgp, square);
  float2* done = s.z2;
  s.z2 = s.z;
  s.z = done;
}

// Unscaled inverse transforms of the work lines: natural order in,
// digit-reversed out. With `turn` the innermost pass also squares the points
// and runs its forward stages (kTurnPass); forward_lines(skip = 1) finishes
// that forward transform. The caller synchronises before; ends in a barrier.
__device__ inline void inverse_lines(Smem& s, const Plan& plan, int pairs, int lgp, bool turn) {
  int len = plan.nx;
  for (int pass = 0; pass < plan.passes; ++pass) {
    if (turn && pass == plan.passes - 1)
      run_pass<kTurnPass>(s, plan, pass, len, pairs, lgp, false);
    else
      run_pass<kInversePass>(s, plan, pass, len, pairs, lgp, false);
    len /= plan.r1[pass] * plan.r2[pass];
  }
}

// Forward transforms: digit-reversed order in, natural out, leaving out the
// `skip` innermost passes; `square` squares the points as the first pass
// reads them (a generic stage only: the butterflies square in the turn pass).
__device__ inline void forward_lines(Smem& s, const Plan& plan, int pairs, int lgp, int skip,
                                     bool square) {
  int len = 1;
  for (int pass = plan.passes - 1; pass >= 0; --pass) {
    len *= plan.r1[pass] * plan.r2[pass];
    if (pass >= plan.passes - skip) continue;
    run_pass<kForwardPass>(s, plan, pass, len, pairs, lgp, square && pass == plan.passes - 1);
  }
}

enum Mode { kInitU = 0, kInitN = 1, kInitF = 2, kSubstep = 3 };

// One pass over the bins k <= nx/2 of all pairs: split the transformed work
// line into the rows' half spectra X, use them as `mode` says, and (from
// kInitF on) merge u_hat / nx back into the work line for the next inverse.
__device__ inline void spectral_pass(const Smem& s, int mode, int nx, int pairs, int lgp,
                                     float dt_os, float inv_nx) {
  const int nfh = nx / 2 + 1, tasks = nfh << lgp;
  const float dt2 = 0.5f * dt_os, dt32 = 1.5f * dt_os;
  const float* a_inv = s.ops;
  const float* b = s.ops + nfh;
  const float* ga = s.ops + 2 * nfh;
  const float* dre = s.ops + 3 * nfh;
  const float* dim = s.ops + 4 * nfh;
  for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
    const int pair = t & (pairs - 1), k = t >> lgp;
    const int km = k ? nx - k : 0;
    float2* zk = s.z + ((size_t)k << lgp) + pair;
    float2* zm = s.z + ((size_t)km << lgp) + pair;
    const float2 za = *zk, zb = make_float2(zm->x, -zm->y);
    // X of row a = (Z[k] + conj Z[-k]) / 2, of row b = (Z[k] - conj Z[-k]) / (2i)
    const float xar = 0.5f * (za.x + zb.x), xai = 0.5f * (za.y + zb.y);
    const float xbr = 0.5f * (za.y - zb.y), xbi = -0.5f * (za.x - zb.x);
    const size_t i = ((size_t)k << lgp) + pair;
    if (mode == kInitU) {
      s.u[i] = make_float4(xar, xai, xbr, xbi);
      continue;
    }
    const float g = ga[k];
    if (mode == kInitN) {
      s.np[i] = make_float4(g * xai, -g * xar, g * xbi, -g * xbr);
      continue;
    }
    float4 u = s.u[i];
    if (mode == kInitF) {
      s.f[i] = make_float4(xar * dt_os, xai * dt_os, xbr * dt_os, xbi * dt_os);
    } else {
      const float4 n = make_float4(g * xai, -g * xar, g * xbi, -g * xbr);
      const float4 np = s.np[i], f = s.f[i];
      const float ai = a_inv[k], bk = b[k], dr = dre[k], di = dim[k];
      u.x = ai * (bk * u.x + dt32 * n.x - dt2 * np.x + f.x) + dr;
      u.y = ai * (bk * u.y + dt32 * n.y - dt2 * np.y + f.y) + di;
      u.z = ai * (bk * u.z + dt32 * n.z - dt2 * np.z + f.z) + dr;
      u.w = ai * (bk * u.w + dt32 * n.w - dt2 * np.w + f.w) + di;
      s.u[i] = u;
      s.np[i] = n;
    }
    // Z[k] = A[k] + i B[k] with A, B the Hermitian extensions of the rows'
    // spectra; DC and Nyquist by their real parts, as irfft takes them
    if (km == k || k == 0) {
      *zk = make_float2(u.x * inv_nx, u.z * inv_nx);
    } else {
      *zk = make_float2((u.x - u.w) * inv_nx, (u.y + u.z) * inv_nx);
      *zm = make_float2((u.x + u.w) * inv_nx, (u.z - u.y) * inv_nx);
    }
  }
  __syncthreads();
}

// Rows [row0, row0 + 2 * pairs) of src (batch, nx) into the work line at
// their digit-reversed positions, squared if asked; rows past the batch are
// zero. Ends in a barrier.
__device__ inline void load_rows(const Smem& s, const float* __restrict__ src, int batch, int nx,
                                 int pairs, int lgp, int row0, bool square) {
  float* zf = reinterpret_cast<float*>(s.z);
  for (int e = threadIdx.x; e < 2 * pairs * nx; e += blockDim.x) {
    const int r = e / nx, j = e - r * nx;
    const int row = row0 + r;
    const float v = row < batch ? src[(size_t)row * nx + j] : 0.f;
    zf[2 * (((size_t)s.pos[j] << lgp) + (r >> 1)) + (r & 1)] = square ? v * v : v;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kMaxThreads)
ks_cnab2_kernel(const float* __restrict__ y, const float* __restrict__ f,
                const float* __restrict__ ops, const float2* __restrict__ twiddle,
                const int* __restrict__ pos, float* __restrict__ out, int batch, Plan plan,
                int generic, int pairs, int lgp, int substeps, float dt_os) {
  extern __shared__ float4 smem4[];
  const int nx = plan.nx, nfh = nx / 2 + 1;
  Smem s = carve(smem4, nx, pairs, generic);
  const int row0 = blockIdx.x * 2 * pairs;
  const float inv_nx = 1.0f / (float)nx;
  // the innermost pass turns round if it is a butterfly pass; a generic stage squares as it reads
  const bool turn = plan.r1[plan.passes - 1] <= 5;

  for (int i = threadIdx.x; i < nx; i += blockDim.x) {
    s.tw[i] = twiddle[i];
    s.pos[i] = pos[i];
  }
  for (int i = threadIdx.x; i < kOps * nfh; i += blockDim.x) s.ops[i] = ops[i];
  __syncthreads();
  load_rows(s, y, batch, nx, pairs, lgp, row0, false);
  forward_lines(s, plan, pairs, lgp, 0, false);
  spectral_pass(s, kInitU, nx, pairs, lgp, dt_os, inv_nx);  // u_hat = rdft(y)
  load_rows(s, y, batch, nx, pairs, lgp, row0, true);
  forward_lines(s, plan, pairs, lgp, 0, false);
  spectral_pass(s, kInitN, nx, pairs, lgp, dt_os, inv_nx);  // N_prev = G rdft(y^2)
  load_rows(s, f, batch, nx, pairs, lgp, row0, false);
  forward_lines(s, plan, pairs, lgp, 0, false);
  spectral_pass(s, kInitF, nx, pairs, lgp, dt_os, inv_nx);  // f_hat = dt rdft(f)

  for (int step = 0; step < substeps; ++step) {
    inverse_lines(s, plan, pairs, lgp, turn);                  // u, and with `turn` u^2
    forward_lines(s, plan, pairs, lgp, turn ? 1 : 0, !turn);  // rdft(u^2)
    spectral_pass(s, kSubstep, nx, pairs, lgp, dt_os, inv_nx);
  }
  inverse_lines(s, plan, pairs, lgp, false);
  const float* zf = reinterpret_cast<const float*>(s.z);
  for (int e = threadIdx.x; e < 2 * pairs * nx; e += blockDim.x) {
    const int r = e / nx, j = e - r * nx;
    const int row = row0 + r;
    if (row < batch)
      out[(size_t)row * nx + j] = zf[2 * (((size_t)s.pos[j] << lgp) + (r >> 1)) + (r & 1)];
  }
}

// ------------------------------------------------------------ the device route
// The same step for nx whose row pair does not fit one block: the half
// spectra and one work line per row pair live in a workspace in device
// memory, and the transforms run as dm_fft.cuh's levels (a split of nx, or
// Bluestein). One cooperative launch per env step; every phase ends in a
// grid barrier. A substep is the levels' inverse, the square and the
// forward as one turn (four phases for a two-level split), then the
// spectral pass. Work lines hold row a in .x and row b in .y as above, the
// spectrum in natural order and real space in dm::real_pos order.
struct DmWork {
  float4* u;   // [line][nfh] u_hat of the pair's rows: (re a, im a, re b, im b)
  float4* np;  // previous nonlinear term, same layout
  float4* f;   // forcing spectrum * dt, same layout
  float2* z;   // [line][nx] work lines
  float2* w;   // [line][m] Bluestein's work lines (null for a split)
};

// Rows of src (batch, nx) into the work lines at their real-space places,
// squared if asked; rows past the batch are zero.
__device__ void dm_load_rows(const dm::Plan& p, float2* z, const float* __restrict__ src,
                             int batch, long long lines, bool square) {
  const int nx = p.n;
  float* zf = reinterpret_cast<float*>(z);
  for (long long e = dm::thread_index(); e < lines * 2 * nx; e += dm::thread_count()) {
    const long long row = e / nx;
    const int j = (int)(e - row * nx);
    const float v = row < batch ? src[e] : 0.f;
    zf[2 * ((row >> 1) * nx + dm::real_pos(p, j)) + (row & 1)] = square ? v * v : v;
  }
  grid_sync();
}

// spectral_pass over the work lines in device memory.
__device__ void dm_spectral(const DmWork& wk, const float* __restrict__ ops, int mode, int nx,
                            long long lines, float dt_os, float inv_nx) {
  const int nfh = nx / 2 + 1;
  const float dt2 = 0.5f * dt_os, dt32 = 1.5f * dt_os;
  for (long long i = dm::thread_index(); i < lines * nfh; i += dm::thread_count()) {
    const long long line = i / nfh;
    const int k = (int)(i - line * nfh), km = k ? nx - k : 0;
    float2* zk = wk.z + line * nx + k;
    float2* zm = wk.z + line * nx + km;
    const float2 za = *zk, zb = make_float2(zm->x, -zm->y);
    const float xar = 0.5f * (za.x + zb.x), xai = 0.5f * (za.y + zb.y);
    const float xbr = 0.5f * (za.y - zb.y), xbi = -0.5f * (za.x - zb.x);
    if (mode == kInitU) {
      wk.u[i] = make_float4(xar, xai, xbr, xbi);
      continue;
    }
    const float g = ops[2 * nfh + k];
    if (mode == kInitN) {
      wk.np[i] = make_float4(g * xai, -g * xar, g * xbi, -g * xbr);
      continue;
    }
    float4 u = wk.u[i];
    if (mode == kInitF) {
      wk.f[i] = make_float4(xar * dt_os, xai * dt_os, xbr * dt_os, xbi * dt_os);
    } else {
      const float4 n = make_float4(g * xai, -g * xar, g * xbi, -g * xbr);
      const float4 np = wk.np[i], f = wk.f[i];
      const float ai = ops[k], bk = ops[nfh + k], dr = ops[3 * nfh + k], di = ops[4 * nfh + k];
      u.x = ai * (bk * u.x + dt32 * n.x - dt2 * np.x + f.x) + dr;
      u.y = ai * (bk * u.y + dt32 * n.y - dt2 * np.y + f.y) + di;
      u.z = ai * (bk * u.z + dt32 * n.z - dt2 * np.z + f.z) + dr;
      u.w = ai * (bk * u.w + dt32 * n.w - dt2 * np.w + f.w) + di;
      wk.u[i] = u;
      wk.np[i] = n;
    }
    if (km == k || k == 0) {
      *zk = make_float2(u.x * inv_nx, u.z * inv_nx);
    } else {
      *zk = make_float2((u.x - u.w) * inv_nx, (u.y + u.z) * inv_nx);
      *zm = make_float2((u.x + u.w) * inv_nx, (u.z - u.y) * inv_nx);
    }
  }
  grid_sync();
}

__global__ void __launch_bounds__(dm::kThreads)
ks_cnab2_dm_kernel(const float* __restrict__ y, const float* __restrict__ f,
                   const float* __restrict__ ops, float* __restrict__ out, DmWork wk,
                   dm::Plan p, int batch, int substeps, float dt_os) {
  extern __shared__ float4 smem4[];
  float2* smem = reinterpret_cast<float2*>(smem4);
  const int nx = p.n;
  const long long lines = (batch + 1) / 2;
  const float inv_nx = 1.0f / (float)nx;
  const dm::Lines zl = dm::contiguous(wk.z, lines, nx), wl = dm::contiguous(wk.w, lines, p.m);
  dm_load_rows(p, wk.z, y, batch, lines, false);
  dm::forward(p, zl, wl, smem);
  dm_spectral(wk, ops, kInitU, nx, lines, dt_os, inv_nx);  // u_hat = rdft(y)
  dm_load_rows(p, wk.z, y, batch, lines, true);
  dm::forward(p, zl, wl, smem);
  dm_spectral(wk, ops, kInitN, nx, lines, dt_os, inv_nx);  // N_prev = G rdft(y^2)
  dm_load_rows(p, wk.z, f, batch, lines, false);
  dm::forward(p, zl, wl, smem);
  dm_spectral(wk, ops, kInitF, nx, lines, dt_os, inv_nx);  // f_hat = dt rdft(f)
  for (int step = 0; step < substeps; ++step) {
    dm::inverse_square_forward(p, zl, wl, smem);  // rdft(irdft(u_hat)^2)
    dm_spectral(wk, ops, kSubstep, nx, lines, dt_os, inv_nx);
  }
  dm::inverse(p, zl, wl, smem);
  const float* zf = reinterpret_cast<const float*>(wk.z);
  for (long long e = dm::thread_index(); e < (long long)batch * nx; e += dm::thread_count()) {
    const long long row = e / nx;
    out[e] = zf[2 * ((row >> 1) * nx + dm::real_pos(p, e - row * nx)) + (row & 1)];
  }
}

}  // namespace

extern "C" {

size_t ks_cnab2_smem_bytes(int nx, int pairs, int generic) {
  return smem_floats(nx, pairs, generic) * sizeof(float);
}

// y, f, out: (batch, nx) float32; ops: (5, nx/2 + 1); twiddle: (nx, 2); pos:
// (nx) int32; radix: the `stages` factors of nx in the order of the inverse
// stages. Neighbouring factors that `shares_pass` lists share a pass. pairs = 2^lgp row pairs per CTA;
// generic: some factor is none of 2, 3, 4, 5 (the kernel then keeps a second
// work line). The Python wrapper checks and picks pairs and threads.
int ks_cnab2_launch(const float* y, const float* f, const float* ops, const float* twiddle,
                    const int* pos, float* out, int batch, int nx, const int* radix, int stages,
                    int lgp, int threads, int substeps, float dt_os, void* stream) {
  if (stages < 1 || stages > kMaxFactors || threads < 32 || threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  Plan plan;
  plan.nx = nx;
  plan.passes = 0;
  int len = nx, generic = 0;
  for (int s = 0; s < stages; ++s) {
    const int r1 = radix[s];
    int r2 = 1;
    if (r1 < 2 || len % r1) return (int)cudaErrorInvalidValue;
    if (r1 > 5) generic = 1;
    if (s + 1 < stages && shares_pass(r1, radix[s + 1]) && len % (r1 * radix[s + 1]) == 0)
      r2 = radix[++s];
    const int sub = len / (r1 * r2);
    plan.r1[plan.passes] = r1;
    plan.r2[plan.passes] = r2;
    plan.magic[plan.passes] = sub > 1 ? (unsigned)(0x100000000ull / (unsigned)sub) + 1u : 0u;
    ++plan.passes;
    len = sub;
  }
  if (len != 1) return (int)cudaErrorInvalidValue;
  const int pairs = 1 << lgp;
  const size_t smem = ks_cnab2_smem_bytes(nx, pairs, generic);
  static size_t allowed = 0;  // more than the default 48 KB must be allowed first
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(ks_cnab2_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  const int grid = (batch + 2 * pairs - 1) / (2 * pairs);
  ks_cnab2_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      y, f, ops, reinterpret_cast<const float2*>(twiddle), pos, out, batch, plan, generic, pairs,
      lgp, substeps, dt_os);
  return (int)cudaGetLastError();
}

// Floats of the device route's workspace, which the Python wrapper
// allocates: three half spectra (float4 per bin) and one work line per row
// pair, and Bluestein's work lines of m points.
size_t ks_cnab2_dm_work_floats(int batch, int nx, int m, int bluestein) {
  const size_t lines = (batch + 1) / 2, nfh = nx / 2 + 1;
  return lines * (12 * nfh + 2 * (size_t)nx + (bluestein ? 2 * (size_t)m : 0));
}

// The device route: y, f, out, ops as in ks_cnab2_launch; work: the
// workspace of ks_cnab2_dm_work_floats; desc, tw, pos, chirp, bh: the plan
// and its tables (ops/kernels/device_route.py; chirp and bh null for a
// split). One cooperative launch.
int ks_cnab2_dm_launch(const float* y, const float* f, const float* ops, float* out, float* work,
                       const int* desc, int ndesc, const float* tw, const int* pos,
                       const float* chirp, const float* bh, int batch, int substeps,
                       float dt_os, void* stream) {
  dm::Plan p;
  if (batch < 1 || substeps < 0 || dm::make_plan(desc, ndesc, tw, pos, chirp, bh, &p))
    return (int)cudaErrorInvalidValue;
  const size_t lines = (batch + 1) / 2, nfh = p.n / 2 + 1;
  DmWork wk;
  wk.u = reinterpret_cast<float4*>(work);
  wk.np = wk.u + lines * nfh;
  wk.f = wk.np + lines * nfh;
  wk.z = reinterpret_cast<float2*>(wk.f + lines * nfh);
  wk.w = p.bluestein ? wk.z + lines * p.n : nullptr;
  static size_t allowed = 0, counted = 0;
  static int blocks = 0;
  return dm::cooperative_launch(ks_cnab2_dm_kernel, dm::smem_bytes(p),
                                static_cast<cudaStream_t>(stream), allowed, counted, blocks, y, f,
                                ops, out, wk, p, batch, substeps, dt_os);
}

const char* ks_cnab2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
