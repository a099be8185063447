// Fused 2D Navier-Stokes advection term with the 2/3-rule mask (kernel K2)
// for Hopper (sm_90a), with the Runge-Kutta stage arithmetic around it as
// optional operands.
//
// Replaces distributedconvrl_pde_control_tpu/ops/pallas/ns_advection.py::
// PallasAdvection2D._kernel. For a batch of full n x n vorticity spectra
// w (batch, n, n) complex64, indexed [ky][kx]:
//
//   psi = w * inv_k2                       (inv_k2[0][0] = 0)
//   u    = Re IFFT2( i ky psi)             v    = Re IFFT2(-i kx psi)
//   dwdx = Re IFFT2( i kx w)               dwdy = Re IFFT2( i ky w)
//   adv  = FFT2(-u dwdx - v dwdy) * mask23
//
// kx varies along the last axis, ky along rows; both are given as vectors
// (the signed Nyquist entry is the caller's), inv_k2 and mask23 as (n, n)
// arrays. The inverse carries 1/n per axis. Everything is float32. With all
// optional operands null, out = adv. Otherwise, with ws = w + alpha * k_prev
// taking the place of w above (k_prev null: ws = w):
//
//   rhs = lin * ws + adv + f               (lin, f each optional)
//   out = rhs                              (k1 null)
//   out = w + dt6 * (k1 + 2 (k2 + k_prev) + rhs)    (k1, k2 given: the RK4
//                                                    combination, k_prev = k3)
//
// Design. The four inverses keep only real parts, so they are packed in
// pairs: Re IFFT2(a) = IFFT2(H a) with (H a)[k] = (a[k] + conj a[-k]) / 2, and
//
//   IFFT2(H u^ + i H v^) = u + i v,   IFFT2(H dwdx^ + i H dwdy^) = dwdx + i dwdy.
//
// H is formed explicitly from ws at k and at -k with the wavenumbers and
// inv_k2 read at both places: a positive Nyquist wavenumber makes i k ws
// non-Hermitian on the Nyquist row and column and RK stages are Hermitian
// only to rounding; the reference drops those parts by taking real parts,
// and packing without H would leak them into the partner field. The forward
// transform takes a real field: two real lines ride one complex line
// transform and are split by symmetry, and only rows ky <= n/2 are
// transformed along the second axis; row -ky is the conjugate mirror. That
// is 2.5 complex 2D transforms where the first version ran five. For odd n
// there is no Nyquist row or column: the rows ky <= (n-1)/2 and their
// mirrors cover the grid, and the last column of a grid with an odd number
// of columns rides its line with a zero partner.
//
// A field (512 KB at n = 256) does not fit one block's shared memory, so the
// transforms run by lines, in three passes over a (batch, 2, n, n) scratch:
//
//   1. rows, inverse: a block takes row pairs (r, -r) of ws (each needs the
//      other for H), forms the two packed spectra of both rows, inverse-
//      transforms the lines along the row and writes the scratch. n/2 + 1
//      pairs per field.
//   2. columns: a block takes `tc` neighbouring columns of both scratch
//      fields (the last tile of the grid may hold fewer: its missing columns
//      are zeros and are not written), inverse-transforms them along axis -2,
//      forms the product -u dwdx - v dwdy, packs column pairs (2j, 2j+1) as
//      re/im of one line, forward-transforms tc/2 lines, splits them by
//      symmetry and writes rows ky <= n/2 of scratch field 0.
//   3. rows, forward: a block takes row ky <= n/2 of scratch field 0,
//      forward-transforms it along the row, and writes rows ky and -ky of
//      out with the mask and the optional stage arithmetic (all row reads).
//
// Line transforms. For n a power of two a thread holds 2^K points (K <= 4)
// and runs K radix-2 stages in registers with constant twiddles, then one
// table twiddle per point; a 256-point line is two such groups with one
// barrier between them, where the radix-2 version had eight. Any other n
// runs the mixed-radix passes of kernel K1 (csrc/ks_cnab2.cu; the butterflies
// and a pass's stages are csrc/radix.cuh, shared by both): the factors
// of n as butterflies of 4, 2, 3 and 5 in registers, two neighbouring
// factors in one pass where a thread holds both stages' points (96 =
// (4*4)(2*3)), and any other prime as a generic stage that computes each
// output point as a sum, out of place into a second line. Shared-memory
// lines are padded by one point in 16, so that the strided accesses of the
// short-span groups fall on distinct banks. The inverse passes are
// decimation in frequency (natural order in, digit-reversed out) and the
// forward passes decimation in time (digit-reversed in, natural out). The
// real-space product is pointwise, so it does not care that both of its
// axes are in digit-reversed order, and no pass ever permutes data.
// Twiddles cos/sin(2 pi k / n) are computed in float64 on the host and read
// from shared memory: k < n/2 for even n (the rest by symmetry), k < n for
// odd n. The two kinds of line transform are two instantiations of every
// kernel (kPow2), so that the power-of-two kernels keep their registers.
//
// Limits and routes. A block holds whole lines: at one row pair per block,
// pass 1 needs (tlen + 2 n + 4 pad(n)) float2, twice the 4 pad(n) with a
// generic stage. Within the 232,448 B a block may take that is every n up to
// 4,304 whose factors are 2, 3 and 5 (4,008 for odd n) and every n up to
// 2,527 with another prime factor (2,641 for even n): the block route. Above
// them the Python wrapper launches the device route (ns_adv_dm_kernel,
// below): the same function with the line transforms as dm_fft.cuh's levels
// through device memory (a split of n or Bluestein). It refuses only buffers
// that do not fit the device's memory, and names the bytes.
//
// The passes are __device__ functions of a virtual block index. On the card
// one cooperative kernel runs all three: persistent blocks walk each pass's
// virtual blocks, with a grid-wide barrier between passes, so a stage is one
// launch (at batch 1 the field and the scratch sit in L2 and launches are the
// cost). Three __global__ wrappers launch the same passes as a chain; that
// form is what runs on the CPU, one block after another, in the tests, and it
// is timed beside the cooperative one by chip_smoke.py.
//
// The cluster route (ns_adv_cluster, below) runs the same three passes with
// no scratch in device memory: one thread-block cluster of c blocks per
// field, each block holding a share of the field's intermediates in its
// shared memory, where the others store into it (distributed shared memory),
// and cluster barriers in place of the grid's. The Python wrapper takes it
// where one field fits a cluster of at most 16 blocks and the batch's
// clusters fill the card (ops/kernels/ns_advection.py::cluster_size: at
// 256^2 from batch 16, six blocks a field on an H100); every other shape runs
// the cooperative kernel. The library has two
// entry points. ns_advection_launch is the function with lin and f alone.
// ns_advection_rk4_launch makes the 4 * substeps stage launches of a run of
// RK4 substeps from one call, with k1, k2, k3 and the intermediate states in
// a work buffer, so the host pays one call per env step instead of one per
// stage; it alone gives a stage k_prev, alpha and the combination. Both add
// the kernel launches they issued to *launched, counted where they are made.
//
// What bounds it. The function reads w and writes out, 16 n^2 bytes per
// field (1 MB at n = 256: 0.31 us at 3.35 TB/s); 2.5 complex 2D FFTs are
// 2.5 * 5 n^2 log2(n^2) flops plus ~30 per point (15 MFLOP at n = 256:
// 0.22 us at 67 TFLOP/s). So the bound is the bytes, and at batch 1 it is
// below the cost of one launch: there a stage is a chain of three dependent
// passes and two grid barriers over an L2-resident field, and its time is
// their latency. At batch 16 what the passes really move (the scratch: two
// fields written and read, half a field written and read; with the stage
// operands also k_prev, f, k1, k2 and w twice) is several times the
// function's bytes and no longer fits L2. A generic stage of a large prime
// does r operations per point where a butterfly does a few: there the
// operations bound it.
//
// Plain C interface (built by nvcc, loaded with ctypes): the launch returns
// a cudaError_t code, 0 on success, checked by the Python wrapper.

#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>
#ifdef __CUDACC__
#include <cooperative_groups.h>
#endif

namespace {

#include "radix.cuh"
#include "dm_fft.cuh"

constexpr int kPacked = 2;  // u + i v and dw/dx + i dw/dy
constexpr int kMaxThreads = 256;
constexpr int kMaxStages = 4;  // radix-2 stages a thread runs in registers between barriers
constexpr int kMaxPasses = 16;

// The line transform of one grid size n. A power of two (logn >= 0) runs
// ceil(logn / kMaxStages) groups of radix-2 stages; any other n runs
// `passes` passes of radix r1[s] (and, with r2[s] > 1, a second stage of
// radix r2[s] on the same registers), in the order of the inverse
// (decimation in frequency) transform. tlen twiddles are read; `generic`:
// some pass is a generic stage (r1 > 5), which needs a second line buffer;
// per_line: tasks per line of the pass with the most (the chain form's
// thread counts).
struct Plan {
  int n, logn, tlen, passes, generic, per_line;
  int r1[kMaxPasses], r2[kMaxPasses];
};

// What the power-of-two kernels read of it: a parameter as small as the
// radix-2 kernels' own (n, logn), so that they compile as before.
struct Pow2Plan {
  int n, logn, tlen;
};
template <bool kPow2>
using PlanOf = typename std::conditional<kPow2, Pow2Plan, Plan>::type;

// The optional operands of a launch (null pointers: not given).
struct Stage {
  const float2* k_prev;  // ws = w + alpha * k_prev
  float alpha;
  const float* lin;   // (n, n): + lin * ws
  const float2* f;    // (batch, n, n): + f
  const float2* k1;   // with k2: out = w + dt6 * (k1 + 2 (k2 + k_prev) + rhs)
  const float2* k2;
  float dt6;
};

__device__ inline float2 scal(float s, float2 a) { return make_float2(s * a.x, s * a.y); }
__device__ inline float2 cconj(float2 a) { return make_float2(a.x, -a.y); }

// Point i of a shared-memory line sits at pad(i): one spare point in 16.
__host__ __device__ inline int pad(int i) { return i + (i >> 4); }

// -i mod n
template <bool kPow2>
__device__ __forceinline__ int neg(int i, int n) {
  return kPow2 ? (n - i) & (n - 1) : (i ? n - i : 0);
}

// exp(+-2 pi i idx / n) for idx < n from the table of tlen entries (n/2 for
// even n: the second half by symmetry); + for the inverse.
template <bool kInverse>
__device__ __forceinline__ float2 twiddle_at(const float2* tw, int idx, int tlen) {
  float2 t = idx < tlen ? tw[idx] : tw[idx - tlen];
  if (idx >= tlen) t = make_float2(-t.x, -t.y);
  if (!kInverse) t.y = -t.y;
  return t;
}
template <bool kInverse>
struct Table {  // pass_stages' twiddle lookup
  const float2* tw;
  int tlen;
  __device__ float2 operator()(int idx) const { return twiddle_at<kInverse>(tw, idx, tlen); }
};

// ------------------------------------------------- power-of-two line transforms
// v * exp(+-2 pi i k / 16), k = 0..7 known at compile time after unrolling.
template <bool kInverse>
__device__ __forceinline__ float2 mul_root16(float2 v, int k) {
  const float c1 = 0.92387953251128674f, s1 = 0.38268343236508977f, h = 0.70710678118654752f;
  float c, s;
  switch (k) {
    case 0: return v;
    case 4: return kInverse ? make_float2(-v.y, v.x) : make_float2(v.y, -v.x);
    case 1: c = c1; s = s1; break;
    case 2: c = h; s = h; break;
    case 3: c = s1; s = c1; break;
    case 5: c = -s1; s = c1; break;
    case 6: c = -h; s = h; break;
    default: c = -c1; s = s1; break;
  }
  if (!kInverse) s = -s;
  return make_float2(v.x * c - v.y * s, v.x * s + v.y * c);
}

template <int K>
__device__ __forceinline__ int bitrev(int m) {
  int r = 0;
#pragma unroll
  for (int b = 0; b < K; ++b) r |= ((m >> b) & 1) << (K - 1 - b);
  return r;
}

// 2^K-point transform in registers, K radix-2 stages. Decimation in
// frequency: natural order in, bit-reversed out.
template <int K, bool kInverse>
__device__ __forceinline__ void radix_dif(float2 (&v)[1 << K]) {
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const int hm = 1 << (K - 1 - t);
#pragma unroll
    for (int m = 0; m < (1 << K); ++m) {
      if (m & hm) continue;
      const float2 a = v[m], b = v[m + hm];
      v[m] = cadd(a, b);
      v[m + hm] = mul_root16<kInverse>(csub(a, b), (m & (hm - 1)) * (8 / hm));
    }
  }
}

// Decimation in time: bit-reversed order in, natural out.
template <int K, bool kInverse>
__device__ __forceinline__ void radix_dit(float2 (&v)[1 << K]) {
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const int hm = 1 << t;
#pragma unroll
    for (int m = 0; m < (1 << K); ++m) {
      if (m & hm) continue;
      const float2 a = v[m], b = mul_root16<kInverse>(v[m + hm], (m & (hm - 1)) * (8 / hm));
      v[m] = cadd(a, b);
      v[m + hm] = csub(a, b);
    }
  }
}

// One group of K radix-2 stages of `lines` in-place line transforms of
// length n in shared memory, on blocks of 2^lg points: a thread takes the
// 2^K points p + m * 2^(lg-K) of one block. Point i of a line sits at
// x[line * line_stride + pad(i) * idx_stride]. With lines_fastest,
// neighbouring threads take the same points of neighbouring lines.
template <int K, bool kInverse, bool kDif>
__device__ __forceinline__ void fft_group(float2* x, const float2* tw, int n, int lg, int lines,
                                 int line_stride, int idx_stride, bool lines_fastest) {
  constexpr int R = 1 << K;
  const int lgs = lg - K, sub = 1 << lgs;
  const int per_line = n >> K, work = lines * per_line, tw_mul = n >> lg;
  for (int t = threadIdx.x; t < work; t += blockDim.x) {
    int line, j;
    if (lines_fastest) {
      j = t / lines;
      line = t - j * lines;
    } else {
      line = t / per_line;
      j = t - line * per_line;
    }
    const int p = j & (sub - 1);
    const int i0 = ((j >> lgs) << lg) + p;
    float2* base = x + (size_t)line * line_stride;
    float2 v[R];
#pragma unroll
    for (int m = 0; m < R; ++m) v[m] = base[(size_t)pad(i0 + (m << lgs)) * idx_stride];
    if (kDif) radix_dif<K, kInverse>(v);
    if (lgs > 0) {  // point m belongs to output (input) residue bitrev(m) of the block
#pragma unroll
      for (int m = 1; m < R; ++m)
        v[m] = cmul(v[m], twiddle_at<kInverse>(tw, p * bitrev<K>(m) * tw_mul, n >> 1));
    }
    if (!kDif) radix_dit<K, kInverse>(v);
#pragma unroll
    for (int m = 0; m < R; ++m) base[(size_t)pad(i0 + (m << lgs)) * idx_stride] = v[m];
  }
  __syncthreads();
}

// ------------------------------------------------- mixed-radix line transforms
// Task t of a line transform: (line, j), with neighbouring threads on
// neighbouring lines where lines_fastest.
__device__ inline void line_task(int t, int lines, int per_line, bool lines_fastest, int& line,
                                 int& j) {
  if (lines_fastest) {
    j = t / lines;
    line = t - j * lines;
  } else {
    line = t / per_line;
    j = t - line * per_line;
  }
}

// One in-place pass of `lines` line transforms on blocks of `len` points: a
// thread takes the R1 * R2 points p + q * sub (sub = len / (R1 R2)) of one
// block of one line. Lines laid out as in fft_group.
template <int R1, int R2, bool kInverse>
__device__ inline void fft_pass(float2* x, const float2* tw, int n, int tlen, int len, int lines,
                                int line_stride, int idx_stride, bool lines_fastest) {
  constexpr int R = R1 * R2;
  const int sub = len / R, per_line = n / R, work = lines * per_line;
  const int tw1 = n / len, tw2 = tw1 * R1;
  for (int t = threadIdx.x; t < work; t += blockDim.x) {
    int line, j;
    line_task(t, lines, per_line, lines_fastest, line, j);
    const int blk = j / sub, p = j - blk * sub;
    const int i0 = blk * len + p;
    float2* base = x + (size_t)line * line_stride;
    float2 v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = base[(size_t)pad(i0 + q * sub) * idx_stride];
    pass_stages<R1, R2, kInverse, kInverse>(v, Table<kInverse>{tw, tlen}, p, sub, tw1, tw2);
#pragma unroll
    for (int q = 0; q < R; ++q) base[(size_t)pad(i0 + q * sub) * idx_stride] = v[q];
  }
  __syncthreads();
}

// The same stage for any radix r, out of place (x -> y, laid out alike): a
// thread computes one output point as an r-term sum.
template <bool kInverse>
__device__ inline void fft_stage_generic(const float2* x, float2* y, const float2* tw, int n,
                                         int tlen, int r, int len, int lines, int line_stride,
                                         int idx_stride, bool lines_fastest) {
  const int sub = len / r, work = lines * n, tw_mul = n / len, root_mul = n / r;
  for (int t = threadIdx.x; t < work; t += blockDim.x) {
    int line, o;
    line_task(t, lines, n, lines_fastest, line, o);
    const int blk = o / len, rem = o - blk * len;
    const int k = rem / sub, p = rem - k * sub;
    const float2* in = x + (size_t)line * line_stride;
    float2 acc = make_float2(0.f, 0.f);
    int mk = 0;  // (m * k) mod r
    for (int m = 0; m < r; ++m) {
      const float2 v = in[(size_t)pad(blk * len + p + m * sub) * idx_stride];
      int idx = mk * root_mul + (kInverse ? 0 : p * m * tw_mul);
      if (idx >= n) idx -= n;
      acc = cadd(acc, cmul(v, twiddle_at<kInverse>(tw, idx, tlen)));
      mk += k;
      if (mk >= r) mk -= r;
    }
    if (kInverse) acc = cmul(acc, twiddle_at<kInverse>(tw, p * k * tw_mul, tlen));
    y[(size_t)line * line_stride + (size_t)pad(o) * idx_stride] = acc;
  }
  __syncthreads();
}

// In-place transforms of `lines` lines of length n, unscaled. kInverse:
// exp(+i theta), decimation in frequency, natural order in, digit-reversed
// out; otherwise exp(-i theta), decimation in time, digit-reversed in,
// natural out. x2 is a second buffer laid out as x, written by generic
// stages (never with kPow2); returns the buffer that holds the result. The
// caller synchronises before; every pass ends in a __syncthreads().
template <bool kPow2, bool kInverse>
__device__ __forceinline__ float2* fft_lines(float2* x, float2* x2, const float2* tw,
                                             const PlanOf<kPow2> plan,
                                    int lines, int line_stride, int idx_stride,
                                    bool lines_fastest) {
  const int n = plan.n;
  if constexpr (kPow2) {
    constexpr bool kDif = kInverse;
    const int logn = plan.logn;
    const int groups = (logn + kMaxStages - 1) / kMaxStages, base = logn / groups;
    const int extra = logn - base * groups;
    int lg = kDif ? logn : 0;
    for (int s = 0; s < groups; ++s) {
      const int gi = kDif ? s : groups - 1 - s;
      const int k = base + (gi < extra ? 1 : 0);
      if (!kDif) lg += k;
      if (k == 2)
        fft_group<2, kInverse, kDif>(x, tw, n, lg, lines, line_stride, idx_stride, lines_fastest);
      else if (k == 3)
        fft_group<3, kInverse, kDif>(x, tw, n, lg, lines, line_stride, idx_stride, lines_fastest);
      else
        fft_group<4, kInverse, kDif>(x, tw, n, lg, lines, line_stride, idx_stride, lines_fastest);
      if (kDif) lg -= k;
    }
  } else {
    int len = kInverse ? n : 1;
    for (int s = 0; s < plan.passes; ++s) {
      const int pass = kInverse ? s : plan.passes - 1 - s;
      const int r1 = plan.r1[pass], r2 = plan.r2[pass];
      if (!kInverse) len *= r1 * r2;
#define K2_PASS(A, B)                                                                        \
  case A * 8 + B:                                                                            \
    fft_pass<A, B, kInverse>(x, tw, n, plan.tlen, len, lines, line_stride, idx_stride,         \
                             lines_fastest);                                                  \
    break;
      switch (r1 * 8 + r2) {
        K2_PASS(4, 4) K2_PASS(4, 3) K2_PASS(4, 2) K2_PASS(2, 3) K2_PASS(2, 5) K2_PASS(3, 3)
        K2_PASS(3, 5) K2_PASS(4, 1) K2_PASS(2, 1) K2_PASS(3, 1) K2_PASS(5, 1)
        default: {  // any other prime: one stage, out of place
          fft_stage_generic<kInverse>(x, x2, tw, n, plan.tlen, r1, len, lines, line_stride,
                                      idx_stride, lines_fastest);
          float2* done = x2;
          x2 = x;
          x = done;
        }
      }
#undef K2_PASS
      if (kInverse) len /= r1 * r2;
    }
  }
  return x;
}

// ---------------------------------------------------------------- the passes
__device__ __forceinline__ float2 stage_state(const float2* __restrict__ w, const Stage& st,
                                              size_t at) {
  float2 z = w[at];
  if (st.k_prev) {
    const float2 k = st.k_prev[at];
    z.x += st.alpha * k.x;
    z.y += st.alpha * k.y;
  }
  return z;
}

__device__ __forceinline__ void load_twiddle(float2* tw, const float2* __restrict__ twiddle,
                                             int tlen) {
  for (int i = threadIdx.x; i < tlen; i += blockDim.x) tw[i] = twiddle[i];
}

// Pass 1, virtual block vb of batch * ceil((n/2 + 1) / ppc): row pairs
// [p0, p0 + ppc) of field b. Lines of pair r: 4*pr + {0: z1 of row r, 1: z2
// of row r, 2: z1 of row -r, 3: z2 of row -r}; the self-paired rows 0 and n/2
// compute (and write) their two lines twice.
template <bool kPow2>
__device__ __forceinline__ void pass_rows_inverse(int vb, const float2* __restrict__ w,
                                                  const Stage& st,
                                         const float* __restrict__ kx,
                                         const float* __restrict__ ky,
                                         const float* __restrict__ inv_k2,
                                         const float2* __restrict__ twiddle,
                                         float2* scratch, const PlanOf<kPow2> plan, int ppc,
                                         float2* smem) {
  const int n = plan.n;
  const int pairs = (n >> 1) + 1, tiles = (pairs + ppc - 1) / ppc;
  const int b = vb / tiles, p0 = (vb - b * tiles) * ppc;
  const int np = pairs - p0 < ppc ? pairs - p0 : ppc;
  const int npad = pad(n);
  float2* tw = smem;
  float2* raw = tw + plan.tlen;            // [2 * ppc][n]: ws rows r and -r
  float2* x = raw + (size_t)2 * ppc * n;   // [4 * ppc][npad]
  float2* x2 = x + (size_t)4 * ppc * npad;  // the same, with a generic stage
  const size_t field = (size_t)b * n * n;

  load_twiddle(tw, twiddle, plan.tlen);
  for (int e = threadIdx.x; e < np * 2 * n; e += blockDim.x) {
    const int h = e / n, c = e - h * n;
    const int r = p0 + (h >> 1), row = (h & 1) ? neg<kPow2>(r, n) : r;
    raw[e] = stage_state(w, st, field + (size_t)row * n + c);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < np * 2 * n; e += blockDim.x) {
    const int h = e / n, c = e - h * n;
    const int r = p0 + (h >> 1), row = (h & 1) ? neg<kPow2>(r, n) : r;
    const int rowm = neg<kPow2>(row, n), cm = neg<kPow2>(c, n);
    const float2 a = raw[e], bm = cconj(raw[(size_t)(h ^ 1) * n + cm]);  // ws[k], conj ws[-k]
    const float kyr = ky[row], kym = ky[rowm], kxc = kx[c], kxm = kx[cm];
    const float2 pa = scal(inv_k2[(size_t)row * n + c], a);
    const float2 pb = scal(inv_k2[(size_t)rowm * n + cm], bm);
    // H u^ = (i/2) uq, H v^ = (-i/2) vq, H dwdx^ = (i/2) dx, H dwdy^ = (i/2) dy
    const float2 uq = csub(scal(kyr, pa), scal(kym, pb));
    const float2 vq = csub(scal(kxc, pa), scal(kxm, pb));
    const float2 dx = csub(scal(kxc, a), scal(kxm, bm));
    const float2 dy = csub(scal(kyr, a), scal(kym, bm));
    float2* line = x + (size_t)(2 * h) * npad + pad(c);
    line[0] = make_float2(0.5f * (vq.x - uq.y), 0.5f * (vq.y + uq.x));      // H u^ + i H v^
    line[npad] = make_float2(0.5f * (-dx.y - dy.x), 0.5f * (dx.x - dy.y));  // H dwdx^ + i H dwdy^
  }
  __syncthreads();
  const float2* y = fft_lines<kPow2, true>(x, x2, tw, plan, 4 * np, npad, 1, false);
  for (int e = threadIdx.x; e < np * 4 * n; e += blockDim.x) {
    const int line = e / n, c = e - line * n;
    const int h = line >> 1, q = line & 1;
    const int r = p0 + (h >> 1), row = (h & 1) ? neg<kPow2>(r, n) : r;
    scratch[(((size_t)b * kPacked + q) * n + row) * n + c] = y[(size_t)line * npad + pad(c)];
  }
  __syncthreads();
}

// Pass 2, virtual block vb of batch * ceil(n / tc): columns [x0, x0 + tc) of
// both scratch fields of field b, of which the grid holds nc (fewer in the
// last tile where tc does not divide n); `scale` is 1 / n^4 (both inverses,
// both axes).
template <bool kPow2>
__device__ __forceinline__ void pass_columns(int vb, float2* scratch,
                                             const float2* __restrict__ twiddle,
                                    const PlanOf<kPow2> plan, int tc, float scale, float2* smem) {
  const int n = plan.n, tiles = (n + tc - 1) / tc;
  const int b = vb / tiles, x0 = (vb - b * tiles) * tc;
  const int nc = kPow2 || n - x0 >= tc ? tc : n - x0;
  const int npad = pad(n), wide = 2 * tc, half_tc = tc >> 1;
  float2* tw = smem;
  float2* x = tw + plan.tlen;              // [npad][2 * tc]: z1 columns, then z2 columns
  float2* z = x + (size_t)npad * wide;     // [npad][tc / 2]: packed products
  float2* x2 = z + (size_t)npad * half_tc;  // as x, with a generic stage
  float2* sb = scratch + (size_t)b * kPacked * n * n;

  load_twiddle(tw, twiddle, plan.tlen);
  for (int e = threadIdx.x; e < kPacked * n * tc; e += blockDim.x) {
    const int q = e / (n * tc), rem = e - q * n * tc;
    const int y = rem / tc, c = rem - y * tc;
    x[(size_t)pad(y) * wide + q * tc + c] =
        kPow2 || c < nc ? sb[((size_t)q * n + y) * n + x0 + c] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  const float2* u = fft_lines<kPow2, true>(x, x2, tw, plan, wide, 1, wide, true);
  for (int e = threadIdx.x; e < n * half_tc; e += blockDim.x) {
    const int y = e / half_tc, j = e - y * half_tc;
    const float2* row = u + (size_t)pad(y) * wide + 2 * j;
    const float2 uva = row[0], uvb = row[1], da = row[tc], db = row[tc + 1];
    z[(size_t)pad(y) * half_tc + j] = make_float2(-(uva.x * da.x + uva.y * da.y) * scale,
                                                  -(uvb.x * db.x + uvb.y * db.y) * scale);
  }
  __syncthreads();
  // x is free again: the packed lines' second buffer
  const float2* zf = fft_lines<kPow2, false>(z, x, tw, plan, half_tc, 1, half_tc, true);
  for (int e = threadIdx.x; e < ((n >> 1) + 1) * half_tc; e += blockDim.x) {
    const int kyi = e / half_tc, j = e - kyi * half_tc;
    const float2 za = zf[(size_t)pad(kyi) * half_tc + j];
    const float2 zb = cconj(zf[(size_t)pad(neg<kPow2>(kyi, n)) * half_tc + j]);
    const float2 d = csub(za, zb);
    float2* o = sb + (size_t)kyi * n + x0 + 2 * j;
    // the spectra of columns 2j and 2j + 1: (za + zb) / 2 and (za - zb) / (2i)
    if (kPow2 || 2 * j < nc) o[0] = scal(0.5f, cadd(za, zb));
    if (kPow2 || 2 * j + 1 < nc) o[1] = make_float2(0.5f * d.y, -0.5f * d.x);
  }
  __syncthreads();
}

// Pass 3, virtual block vb as in pass 1: rows ky in [p0, p0 + ppc) of scratch
// field 0, written as rows ky and -ky of out.
template <bool kPow2>
__device__ __forceinline__ void pass_rows_forward(int vb, const float2* scratch,
                                         const float2* __restrict__ w, const Stage& st,
                                         const float* __restrict__ mask,
                                         const float2* __restrict__ twiddle,
                                         float2* __restrict__ out, const PlanOf<kPow2> plan,
                                         int ppc,
                                         float2* smem) {
  const int n = plan.n;
  const int pairs = (n >> 1) + 1, tiles = (pairs + ppc - 1) / ppc;
  const int b = vb / tiles, p0 = (vb - b * tiles) * ppc;
  const int np = pairs - p0 < ppc ? pairs - p0 : ppc;
  const int npad = pad(n);
  float2* tw = smem;
  float2* x = tw + plan.tlen;             // [ppc][npad]
  float2* x2 = x + (size_t)ppc * npad;   // the same, with a generic stage
  const float2* sb = scratch + (size_t)b * kPacked * n * n;
  const size_t field = (size_t)b * n * n;

  load_twiddle(tw, twiddle, plan.tlen);
  for (int e = threadIdx.x; e < np * n; e += blockDim.x) {
    const int pr = e / n, c = e - pr * n;
    x[(size_t)pr * npad + pad(c)] = sb[(size_t)(p0 + pr) * n + c];
  }
  __syncthreads();
  const float2* y = fft_lines<kPow2, false>(x, x2, tw, plan, np, npad, 1, false);
  for (int e = threadIdx.x; e < np * 2 * n; e += blockDim.x) {
    const int h = e / n, c = e - h * n;
    const int pr = h >> 1, kyi = p0 + pr;
    const int row = (h & 1) ? neg<kPow2>(kyi, n) : kyi;
    if ((h & 1) && row == kyi) continue;  // rows 0 and n/2 mirror onto themselves
    const float2* line = y + (size_t)pr * npad;
    const float2 t = (h & 1) ? cconj(line[pad(neg<kPow2>(c, n))]) : line[pad(c)];
    const size_t plane = (size_t)row * n + c, at = field + plane;
    const float m = mask[plane];
    float2 r = make_float2(m * t.x, m * t.y);
    if (st.lin) {
      const float2 ws = stage_state(w, st, at);
      const float l = st.lin[plane];
      r.x += l * ws.x;
      r.y += l * ws.y;
    }
    if (st.f) r = cadd(r, st.f[at]);
    if (st.k1) {
      float2 acc = scal(2.0f, cadd(st.k2[at], st.k_prev[at]));
      acc = cadd(cadd(st.k1[at], acc), r);
      const float2 w0 = w[at];
      r = make_float2(w0.x + st.dt6 * acc.x, w0.y + st.dt6 * acc.y);
    }
    out[at] = r;
  }
  __syncthreads();
}

template <bool kPow2>
__global__ void __launch_bounds__(kMaxThreads)
ns_adv_rows_inverse(const float2* w, Stage st, const float* kx, const float* ky,
                    const float* inv_k2, const float2* twiddle, float2* scratch, PlanOf<kPow2> plan,
                    int ppc) {
  extern __shared__ float2 smem[];
  pass_rows_inverse<kPow2>(blockIdx.x, w, st, kx, ky, inv_k2, twiddle, scratch, plan, ppc, smem);
}

template <bool kPow2>
__global__ void __launch_bounds__(kMaxThreads)
ns_adv_columns(float2* scratch, const float2* twiddle, PlanOf<kPow2> plan, int tc,
               float scale) {
  extern __shared__ float2 smem[];
  pass_columns<kPow2>(blockIdx.x, scratch, twiddle, plan, tc, scale, smem);
}

template <bool kPow2>
__global__ void __launch_bounds__(kMaxThreads)
ns_adv_rows_forward(const float2* scratch, const float2* w, Stage st, const float* mask,
                    const float2* twiddle, float2* out, PlanOf<kPow2> plan, int ppc) {
  extern __shared__ float2 smem[];
  pass_rows_forward<kPow2>(blockIdx.x, scratch, w, st, mask, twiddle, out, plan, ppc, smem);
}

#ifdef __CUDACC__
// The three passes in one cooperative launch: persistent blocks walk the
// virtual blocks of each pass, with a grid-wide barrier between passes.
template <bool kPow2>
__global__ void __launch_bounds__(kMaxThreads)
ns_adv_cooperative(const float2* w, Stage st, const float* kx, const float* ky,
                   const float* inv_k2, const float* mask, const float2* twiddle,
                   float2* scratch, float2* out, PlanOf<kPow2> plan, int tc, int ppc,
                   float scale,
                   int grid_rows, int grid_cols) {
  extern __shared__ float2 smem[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int vb = blockIdx.x; vb < grid_rows; vb += gridDim.x)
    pass_rows_inverse<kPow2>(vb, w, st, kx, ky, inv_k2, twiddle, scratch, plan, ppc, smem);
  grid.sync();
  for (int vb = blockIdx.x; vb < grid_cols; vb += gridDim.x)
    pass_columns<kPow2>(vb, scratch, twiddle, plan, tc, scale, smem);
  grid.sync();
  for (int vb = blockIdx.x; vb < grid_rows; vb += gridDim.x)
    pass_rows_forward<kPow2>(vb, scratch, w, st, mask, twiddle, out, plan, ppc, smem);
}
#endif

// ----------------------------------------------------------- the cluster route
// One cluster of c blocks per field b (blocks b * c .. b * c + c - 1). Block
// `rank` owns columns [x0, x0 + tc), x0 = rank * tc, of the real-space fields
// (the last blocks may own fewer, or none) and row pairs [p0, p0 + ppb), p0 =
// rank * ppb, of passes 1 and 3. Its shared memory is the twiddles and X, n +
// n/16 padded rows of ld points (with a generic stage a second buffer like
// it), which holds in turn:
//
//   pass 1   the block's packed rows as lines of n + n/16 points: z1 and z2
//            of row r of pair p at lines 2p and 2p + 1, those of row -r at
//            lines lb + 2p and lb + 2p + 1, where lb puts them past every row
//            y <= n/2 of the layout below; inverse-transformed along the rows
//            in one batch;
//   exchange the cluster's z1 and z2 at X[pad(y) * ld + x - x0] and
//            X[pad(y) * ld + tc + x - x0] for the block's columns x, stored
//            there by the blocks that transformed row y, in two rounds: the
//            rows y <= n/2, then the rest. In each a block holds what it
//            sends in registers across a cluster barrier before it stores, so
//            that no store lands on what its owner has yet to send: the
//            second round's lines lie where only it stores;
//   pass 2   the columns inverse-transformed, the product written over z1's
//            even columns (each thread overwrites only what it read), a
//            cluster barrier (no block reads z2 any more), those column pairs
//            forward-transformed in place (a generic stage's second line: z1's
//            odd columns), and the split spectra of rows ky <= n/2 stored in
//            place of z2 in the block that owns the row, row ky at
//            X[pad(x) * ld + tc + ky - p0], two neighbouring rows to a
//            16-byte store;
//   pass 3   after a cluster barrier, those rows forward-transformed (lines
//            across ld) and written out as pass_rows_forward does.
//
// The arithmetic is that of the passes above, point for point; only where the
// intermediates live differs. No block touches another's shared memory after
// the last barrier, so blocks may end freely; the first store into another
// block follows a cluster barrier, so every block of the cluster runs.
#ifndef CLUSTER_THREADS
#define CLUSTER_THREADS 512
#endif
constexpr int kClusterThreads = CLUSTER_THREADS;
constexpr int kClusterMax = 16;  // above 8 blocks the card's non-portable cluster sizes
constexpr size_t kSmemLimit = 232448;  // bytes of shared memory a block may take
constexpr int kStage = 12;  // column pairs a thread holds in registers in a round of the exchange
constexpr int kStageThreads = 512;  // the card's threads a block, which the shape is held to

#ifdef __CUDACC__
__device__ __forceinline__ int cluster_rank() {
  return (int)cooperative_groups::this_cluster().block_rank();
}
__device__ __forceinline__ void cluster_sync() { cooperative_groups::this_cluster().sync(); }
__device__ __forceinline__ float2* cluster_map(float2* p, int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}
// two neighbouring points as one 16-byte store (dst 16-byte aligned)
__device__ __forceinline__ void store_pair(float2* dst, float2 a, float2 b) {
  *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
}
#endif

// X starts 16-byte aligned: after the twiddles, rounded up to an even count
__host__ __device__ inline int cluster_twiddles(int tlen) { return (tlen + 1) & ~1; }

struct ClusterShape {
  int c, tc, ppb, ld, lb;  // blocks; columns, row pairs (both even) a block; X's row; pass 1's -r lines
};

// The packed spectra H u^ + i H v^ (z1) and H dwdx^ + i H dwdy^ (z2) at
// k = (row, c) from a = ws[k] and bm = conj ws[-k], as pass_rows_inverse.
__device__ __forceinline__ void packed_spectra(float2 a, float2 bm, float kyr, float kym, float kxc,
                                               float kxm, float ik, float ikm, float2& z1,
                                               float2& z2) {
  const float2 pa = scal(ik, a), pb = scal(ikm, bm);
  const float2 uq = csub(scal(kyr, pa), scal(kym, pb));
  const float2 vq = csub(scal(kxc, pa), scal(kxm, pb));
  const float2 dx = csub(scal(kxc, a), scal(kxm, bm));
  const float2 dy = csub(scal(kyr, a), scal(kym, bm));
  z1 = make_float2(0.5f * (vq.x - uq.y), 0.5f * (vq.y + uq.x));
  z2 = make_float2(0.5f * (-dx.y - dy.x), 0.5f * (dx.x - dy.y));
}

// Pass 1 up to the exchange: the np row pairs from p0 packed into lines and
// inverse-transformed along the rows (the lines between are transformed too
// and never read).
template <bool kPow2>
__device__ __forceinline__ void cluster_rows_inverse(
    const float2* __restrict__ w, const Stage& st, const float* __restrict__ kx,
    const float* __restrict__ ky, const float* __restrict__ inv_k2, const float2* tw,
    const PlanOf<kPow2> plan, const ClusterShape& cs, int b, int p0, int np, float2* X,
    float2* X2) {
  const int n = plan.n, npad = pad(n);
  const size_t field = (size_t)b * n * n;
  // point (r, c) and its mirror (-r, -c), each from ws at both; a row that is its own
  // mirror (0, n/2) is written once, from (r, c)
  for (int e = threadIdx.x; e < np * n; e += blockDim.x) {
    const int pr = e / n, c = e - pr * n;
    const int r = p0 + pr, rm = neg<kPow2>(r, n), cm = neg<kPow2>(c, n);
    const float2 a = stage_state(w, st, field + (size_t)r * n + c);
    const float2 bq = stage_state(w, st, field + (size_t)rm * n + cm);
    const float ik = inv_k2[(size_t)r * n + c], ikm = inv_k2[(size_t)rm * n + cm];
    const float kyr = ky[r], kym = ky[rm], kxc = kx[c], kxm = kx[cm];
    float2* l0 = X + (size_t)(2 * pr) * npad;
    packed_spectra(a, cconj(bq), kyr, kym, kxc, kxm, ik, ikm, l0[pad(c)], l0[npad + pad(c)]);
    if (rm != r) {
      float2* l1 = l0 + (size_t)cs.lb * npad;
      packed_spectra(bq, cconj(a), kym, kyr, kxm, kxc, ikm, ik, l1[pad(cm)], l1[npad + pad(cm)]);
    }
  }
  __syncthreads();
  const int lines = cs.lb + 2 * np;
  const float2* y = fft_lines<kPow2, true>(X, X2, tw, plan, lines, npad, 1, false);
  if (y != X) {  // a generic stage left the lines in the second buffer
    for (int i = threadIdx.x; i < lines * npad; i += blockDim.x) X[i] = y[i];
    __syncthreads();
  }
}

// The exchange: round 0 the lines of rows r, round 1 those of rows -r (r not
// its own mirror), each point pair (c, c + 1), c even, of z1 and z2 stored
// into X of the block that owns column c. Ends in a cluster barrier.
template <bool kPow2>
__device__ __forceinline__ void cluster_exchange(int n, const ClusterShape& cs, int p0, int np,
                                                 float2* X) {
  const int npad = pad(n), halves = (n + 1) >> 1, items = 2 * np * halves;
  for (int m = 0; m < 2; ++m) {
    float4 v[kStage];
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int e = threadIdx.x + k * blockDim.x;
      if (e >= items) break;
      const int line = e / halves, c = 2 * (e - line * halves);
      const float2* at = X + (size_t)(m * cs.lb + line) * npad + pad(c);
      const float2 a = at[0], b = c + 1 < n ? at[1] : a;  // pad(c + 1) = pad(c) + 1
      v[k] = make_float4(a.x, a.y, b.x, b.y);
    }
    cluster_sync();  // every block holds what it sends in this round
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int e = threadIdx.x + k * blockDim.x;
      if (e >= items) break;
      const int line = e / halves, c = 2 * (e - line * halves);
      const int r = p0 + (line >> 1), row = m ? neg<kPow2>(r, n) : r;
      if (m && row == r) continue;  // rows 0 and n/2 went in round 0
      const int owner = c / cs.tc;
      float2* dst = cluster_map(X, owner) + (size_t)pad(row) * cs.ld + (line & 1) * cs.tc + c -
                    owner * cs.tc;
      if (c + 1 < n)
        store_pair(dst, make_float2(v[k].x, v[k].y), make_float2(v[k].z, v[k].w));
      else
        dst[0] = make_float2(v[k].x, v[k].y);  // the last column of odd n
    }
  }
  cluster_sync();
}

// Pass 2 up to its barrier: the block's nc columns of both fields inverse-
// transformed, and the product written over z1's even columns. Returns where
// the product lies (X, or X2 after a generic stage).
template <bool kPow2>
__device__ __forceinline__ float2* cluster_columns_inverse(const float2* tw,
                                                           const PlanOf<kPow2> plan,
                                                           const ClusterShape& cs, int nc,
                                                           float scale, float2* X, float2* X2) {
  const int n = plan.n, tc = cs.tc, ld = cs.ld, half_tc = tc >> 1;
  for (int e = threadIdx.x; e < n * (tc - nc); e += blockDim.x) {  // a partial tile's zeros
    const int y = e / (tc - nc), c = nc + e - y * (tc - nc);
    X[(size_t)pad(y) * ld + c] = X[(size_t)pad(y) * ld + tc + c] = make_float2(0.f, 0.f);
  }
  __syncthreads();
  float2* u = fft_lines<kPow2, true>(X, X2, tw, plan, 2 * tc, 1, ld, true);
  for (int e = threadIdx.x; e < n * half_tc; e += blockDim.x) {
    const int y = e / half_tc, j = e - y * half_tc;
    float2* row = u + (size_t)pad(y) * ld + 2 * j;
    const float2 uva = row[0], uvb = row[1], da = row[tc], db = row[tc + 1];
    row[0] = make_float2(-(uva.x * da.x + uva.y * da.y) * scale,
                         -(uvb.x * db.x + uvb.y * db.y) * scale);
  }
  __syncthreads();
  return u;
}

// Pass 2 after its barrier: the product's column pairs forward-transformed and
// split; rows (ky, ky + 1), ky even, stored together in place of z2 of their
// owner.
template <bool kPow2>
__device__ __forceinline__ void cluster_columns_forward(const float2* tw, const PlanOf<kPow2> plan,
                                                        const ClusterShape& cs, int x0, int nc,
                                                        float2* u, float2* X) {
  const int n = plan.n, ld = cs.ld, half_tc = cs.tc >> 1;
  const float2* zf = fft_lines<kPow2, false>(u, u + 1, tw, plan, half_tc, 2, ld, true);
  const int pairs = (n >> 1) + 1, rows2 = (pairs + 1) >> 1;
  for (int e = threadIdx.x; e < rows2 * half_tc; e += blockDim.x) {
    const int k2 = e / half_tc, j = e - k2 * half_tc;
    if (2 * j >= nc) continue;
    float2 s0[2], s1[2];  // the spectra of columns 2j and 2j + 1 at rows 2 k2 and 2 k2 + 1
    const int rows = 2 * k2 + 1 < pairs ? 2 : 1;
    for (int i = 0; i < rows; ++i) {
      const int kyi = 2 * k2 + i;
      const float2 za = zf[(size_t)pad(kyi) * ld + 2 * j];
      const float2 zb = cconj(zf[(size_t)pad(neg<kPow2>(kyi, n)) * ld + 2 * j]);
      const float2 d = csub(za, zb);
      s0[i] = scal(0.5f, cadd(za, zb));
      s1[i] = make_float2(0.5f * d.y, -0.5f * d.x);
    }
    const int owner = 2 * k2 / cs.ppb;
    float2* R = cluster_map(X, owner) + cs.tc + 2 * k2 - owner * cs.ppb;
    float2* o0 = R + (size_t)pad(x0 + 2 * j) * ld;
    float2* o1 = R + (size_t)pad(x0 + 2 * j + 1) * ld;
    if (rows == 2) {
      store_pair(o0, s0[0], s0[1]);
      if (2 * j + 1 < nc) store_pair(o1, s1[0], s1[1]);
    } else {
      o0[0] = s0[0];
      if (2 * j + 1 < nc) o1[0] = s1[0];
    }
  }
}

template <bool kPow2>
__device__ __forceinline__ void cluster_rows_forward(
    const float2* __restrict__ w, const Stage& st, const float* __restrict__ mask, const float2* tw,
    float2* __restrict__ out, const PlanOf<kPow2> plan, const ClusterShape& cs, int b, int p0,
    int np, float2* X) {
  const int n = plan.n, ld = cs.ld;
  const size_t field = (size_t)b * n * n;
  const float2* y = fft_lines<kPow2, false>(X + cs.tc, X, tw, plan, np, 1, ld, true);
  // the arithmetic of pass_rows_forward (rows 0 and n/2 mirror onto themselves)
  for (int e = threadIdx.x; e < np * 2 * n; e += blockDim.x) {
    const int h = e / n, c = e - h * n;
    const int pr = h >> 1, kyi = p0 + pr;
    const int row = (h & 1) ? neg<kPow2>(kyi, n) : kyi;
    if ((h & 1) && row == kyi) continue;
    const float2 t = (h & 1) ? cconj(y[(size_t)pad(neg<kPow2>(c, n)) * ld + pr])
                             : y[(size_t)pad(c) * ld + pr];
    const size_t plane = (size_t)row * n + c, at = field + plane;
    const float m = mask[plane];
    float2 r = make_float2(m * t.x, m * t.y);
    if (st.lin) {
      const float2 ws = stage_state(w, st, at);
      const float l = st.lin[plane];
      r.x += l * ws.x;
      r.y += l * ws.y;
    }
    if (st.f) r = cadd(r, st.f[at]);
    if (st.k1) {
      float2 acc = scal(2.0f, cadd(st.k2[at], st.k_prev[at]));
      acc = cadd(cadd(st.k1[at], acc), r);
      const float2 w0 = w[at];
      r = make_float2(w0.x + st.dt6 * acc.x, w0.y + st.dt6 * acc.y);
    }
    out[at] = r;
  }
}

// One stage of `gridDim.x / cs.c` fields, one cluster each.
template <bool kPow2>
__global__ void __launch_bounds__(kClusterThreads, 1)
ns_adv_cluster(const float2* w, Stage st, const float* kx, const float* ky, const float* inv_k2,
               const float* mask, const float2* twiddle, float2* out, PlanOf<kPow2> plan,
               ClusterShape cs, float scale) {
  extern __shared__ __align__(16) float2 smem[];
  const int n = plan.n, b = blockIdx.x / cs.c, rank = cluster_rank();
  const int pairs = (n >> 1) + 1, p0 = rank * cs.ppb;
  const int np = pairs - p0 < cs.ppb ? (pairs > p0 ? pairs - p0 : 0) : cs.ppb;
  const int x0 = rank * cs.tc, nc = n - x0 < cs.tc ? (n > x0 ? n - x0 : 0) : cs.tc;
  float2* tw = smem;
  float2* X = tw + cluster_twiddles(plan.tlen);
  float2* X2 = X + (size_t)pad(n) * cs.ld;  // with a generic stage: X's second buffer
  load_twiddle(tw, twiddle, plan.tlen);
  if (np > 0) cluster_rows_inverse<kPow2>(w, st, kx, ky, inv_k2, tw, plan, cs, b, p0, np, X, X2);
  cluster_exchange<kPow2>(n, cs, p0, np, X);
  float2* u = nc > 0 ? cluster_columns_inverse<kPow2>(tw, plan, cs, nc, scale, X, X2) : X;
  cluster_sync();  // no block reads its z2 any more
  if (nc > 0) cluster_columns_forward<kPow2>(tw, plan, cs, x0, nc, u, X);
  cluster_sync();
  if (np > 0) cluster_rows_forward<kPow2>(w, st, mask, tw, out, plan, cs, b, p0, np, X);
}

// ------------------------------------------------------------ the device route
// The same function for n whose lines do not fit one block: the line
// transforms run as dm_fft.cuh's levels (a split of n, or Bluestein) through
// device memory, the passes above become phases of one cooperative kernel
// with a grid barrier after each, and the work between the transforms is
// pointwise over the field:
//
//   E1  the packed spectra H u^ + i H v^ and H dwdx^ + i H dwdy^ of ws into
//       the two scratch fields (ws read at k and at -k), natural order;
//       then every scratch row and every scratch column inverse-transformed;
//   E2  the product -u dwdx - v dwdy, column pairs (2j, 2j+1) packed as one
//       complex column of `packed` (batch, n, nh), nh = ceil(n / 2), the
//       last one of odd n with a zero partner; its columns forward-transformed;
//   E3  split by symmetry into rows ky <= n/2 of scratch field 0; those rows
//       forward-transformed;
//   E4  rows ky and -ky of out, with the mask and the stage arithmetic.
//
// The real-space axes stay in the levels' order (dm::real_pos): the product
// is pointwise and the packed column pairs are pairs of places, so nothing
// is permuted. A block takes a tile of neighbouring columns of a level of
// the column transforms, so that their reads run along rows.
__device__ __forceinline__ int dm_neg(int i, int n) { return i ? n - i : 0; }

__global__ void __launch_bounds__(dm::kThreads)
ns_adv_dm_kernel(const float2* __restrict__ w, Stage st, const float* __restrict__ kx,
                 const float* __restrict__ ky, const float* __restrict__ inv_k2,
                 const float* __restrict__ mask, float2* scratch, float2* packed, float2* wbuf,
                 float2* __restrict__ out, dm::Plan p, int batch, float scale) {
  extern __shared__ float2 smem[];
  const int n = p.n, nh = (n + 1) / 2, half = n / 2;
  const long long nn = (long long)n * n;
  const long long stride = dm::thread_count();

  // E1: packed spectra, then the inverse along rows and along columns
  for (long long e = dm::thread_index(); e < batch * nn; e += stride) {
    const long long b = e / nn;
    const int rem = (int)(e - b * nn), row = rem / n, c = rem - row * n;
    const int rowm = dm_neg(row, n), cm = dm_neg(c, n);
    const size_t field = b * nn;
    const float2 a = stage_state(w, st, field + rem);
    const float2 bm = cconj(stage_state(w, st, field + (size_t)rowm * n + cm));
    const float kyr = ky[row], kym = ky[rowm], kxc = kx[c], kxm = kx[cm];
    const float2 pa = scal(inv_k2[rem], a);
    const float2 pb = scal(inv_k2[(size_t)rowm * n + cm], bm);
    const float2 uq = csub(scal(kyr, pa), scal(kym, pb));
    const float2 vq = csub(scal(kxc, pa), scal(kxm, pb));
    const float2 dx = csub(scal(kxc, a), scal(kxm, bm));
    const float2 dy = csub(scal(kyr, a), scal(kym, bm));
    float2* s0 = scratch + b * kPacked * nn + rem;
    s0[0] = make_float2(0.5f * (vq.x - uq.y), 0.5f * (vq.y + uq.x));   // H u^ + i H v^
    s0[nn] = make_float2(0.5f * (-dx.y - dy.x), 0.5f * (dx.x - dy.y));  // H dwdx^ + i H dwdy^
  }
  grid_sync();
  const long long fields = (long long)kPacked * batch;
  const dm::Lines rows = dm::contiguous(scratch, fields * n, n);
  const dm::Lines wrows = dm::contiguous(wbuf, fields * n, p.m);
  dm::inverse(p, rows, wrows, smem);
  const dm::Lines cols = {scratch, nn, 1, fields * n, n, n};
  dm::inverse(p, cols, wrows, smem);

  // E2: the product, column pairs packed; the forward along columns
  const long long pfield = (long long)n * nh;
  for (long long e = dm::thread_index(); e < batch * pfield; e += stride) {
    const long long b = e / pfield;
    const int rem = (int)(e - b * pfield), y = rem / nh, j = rem - y * nh;
    const float2* uv = scratch + b * kPacked * nn + (size_t)y * n + 2 * j;
    const float2 uva = uv[0], da = uv[nn];
    float pb = 0.f;
    if (2 * j + 1 < n) {
      const float2 uvb = uv[1], db = uv[nn + 1];
      pb = -(uvb.x * db.x + uvb.y * db.y) * scale;
    }
    packed[e] = make_float2(-(uva.x * da.x + uva.y * da.y) * scale, pb);
  }
  grid_sync();
  const dm::Lines pcols = {packed, pfield, 1, batch * (long long)nh, nh, nh};
  dm::forward(p, pcols, wrows, smem);

  // E3: split into rows ky <= n/2 of scratch field 0; the forward along those rows
  const long long srows = (long long)(half + 1) * nh;
  for (long long e = dm::thread_index(); e < batch * srows; e += stride) {
    const long long b = e / srows;
    const int rem = (int)(e - b * srows), kyi = rem / nh, j = rem - kyi * nh;
    const float2* pf = packed + b * pfield;
    const float2 za = pf[(size_t)kyi * nh + j], zb = cconj(pf[(size_t)dm_neg(kyi, n) * nh + j]);
    const float2 d = csub(za, zb);
    float2* o = scratch + b * kPacked * nn + (size_t)kyi * n + 2 * j;
    o[0] = scal(0.5f, cadd(za, zb));
    if (2 * j + 1 < n) o[1] = make_float2(0.5f * d.y, -0.5f * d.x);
  }
  grid_sync();
  const dm::Lines frows = {scratch, kPacked * nn, n, batch * (long long)(half + 1), half + 1, 1};
  dm::forward(p, frows, wrows, smem);

  // E4: rows ky and -ky of out, with the mask and the stage arithmetic
  for (long long e = dm::thread_index(); e < batch * nn; e += stride) {
    const long long b = e / nn;
    const int rem = (int)(e - b * nn), row = rem / n, c = rem - row * n;
    const float2* s0 = scratch + b * kPacked * nn;
    const float2 t = row <= half ? s0[rem] : cconj(s0[(size_t)(n - row) * n + dm_neg(c, n)]);
    const float m = mask[rem];
    float2 r = make_float2(m * t.x, m * t.y);
    if (st.lin) {
      const float2 ws = stage_state(w, st, e);
      const float l = st.lin[rem];
      r.x += l * ws.x;
      r.y += l * ws.y;
    }
    if (st.f) r = cadd(r, st.f[e]);
    if (st.k1) {
      float2 acc = scal(2.0f, cadd(st.k2[e], st.k_prev[e]));
      acc = cadd(cadd(st.k1[e], acc), r);
      const float2 w0 = w[e];
      r = make_float2(w0.x + st.dt6 * acc.x, w0.y + st.dt6 * acc.y);
    }
    out[e] = r;
  }
}

// ------------------------------------------------------------------ the host
// Whether n has a prime factor other than 2, 3 and 5.
bool has_generic_factor(int n) {
  if (n < 1) return false;
  const int small[] = {2, 3, 5};
  for (int r : small)
    while (n % r == 0) n /= r;
  return n > 1;
}

// The plan of grid size n: its factors as K1's factor_radices gives them
// (4s, then a 2, 3s, 5s, then other primes ascending), neighbouring factors
// paired by shares_pass. Returns 0, or -1 for n < 2 or too many passes.
int make_plan(int n, Plan* plan) {
  if (n < 2) return -1;
  Plan p = {};
  p.n = n;
  p.tlen = (n & 1) ? n : n / 2;
  p.logn = -1;
  if ((n & (n - 1)) == 0) {
    p.logn = 0;
    while ((1 << p.logn) < n) ++p.logn;
    const int groups = (p.logn + kMaxStages - 1) / kMaxStages;
    p.per_line = n >> (p.logn / groups);  // tasks of a line's widest group
    *plan = p;
    return 0;
  }
  int radix[32], count = 0, rest = n;
  const int butterflies[] = {4, 2, 3, 5};
  for (int r : butterflies)
    while (rest % r == 0) {
      radix[count++] = r;
      rest /= r;
    }
  for (int q = 7; rest > 1; q += 2)
    while (rest % q == 0) {
      radix[count++] = q;
      rest /= q;
    }
  for (int s = 0; s < count; ++s) {
    const int r1 = radix[s];
    int r2 = 1;
    if (s + 1 < count && shares_pass(r1, radix[s + 1])) r2 = radix[++s];
    if (p.passes == kMaxPasses) return -1;
    p.r1[p.passes] = r1;
    p.r2[p.passes] = r2;
    ++p.passes;
    if (r1 > 5) p.generic = 1;
    const int tasks = r1 > 5 ? n : n / (r1 * r2);
    if (tasks > p.per_line) p.per_line = tasks;
  }
  *plan = p;
  return 0;
}

inline int block_threads(int work) {
  const int t = (work + 31) / 32 * 32;
  return t < 32 ? 32 : (t < kMaxThreads ? t : kMaxThreads);
}

// What every stage of one call shares. dm: the device route's plan (null:
// the block route) with its buffers.
struct Launch {
  const float* kx;
  const float* ky;
  const float* inv_k2;
  const float* mask;
  const float2* twiddle;
  float2* scratch;
  Plan plan;
  int batch, tc, ppc, cooperative;
  cudaStream_t stream;
  const dm::Plan* dm;
  float2* packed;
  float2* wbuf;
  int cluster;  // > 0: the cluster route, on clusters of that many blocks
};

size_t smem_bytes(int pass, int n, int tc, int ppc) {
  const size_t npad = pad(n), tlen = (n & 1) ? n : n / 2;
  const size_t lines = has_generic_factor(n) ? 2 : 1;  // a generic stage's second buffer
  if (pass == 0)
    return (tlen + (size_t)2 * ppc * n + (size_t)4 * ppc * npad * lines) * sizeof(float2);
  if (pass == 1) return (tlen + npad * (size_t)(2 * tc * lines + tc / 2)) * sizeof(float2);
  return (tlen + (size_t)ppc * npad * lines) * sizeof(float2);
}

template <bool kPow2>
PlanOf<kPow2> plan_of(const Plan& p) {
  if constexpr (kPow2)
    return Pow2Plan{p.n, p.logn, p.tlen};
  else
    return p;
}

// One stage: out from w and the optional operands `stage`, as one cooperative
// launch or as the chain of three; *launched grows by the launches issued.
template <bool kPow2>
int launch_stage(const Launch& l, const float2* w, Stage stage, float2* out, int* launched) {
  const int n = l.plan.n, tc = l.tc, ppc = l.ppc;
  cudaStream_t st = l.stream;
  const int per_line = l.plan.per_line;
  const int row_tiles = (n / 2 + 1 + ppc - 1) / ppc;
  const int grid_a = l.batch * row_tiles, grid_b = l.batch * ((n + tc - 1) / tc), grid_c = grid_a;
  const size_t smem_a = smem_bytes(0, n, tc, ppc), smem_b = smem_bytes(1, n, tc, ppc);
  const size_t smem_c = smem_bytes(2, n, tc, ppc);
  const float scale = 1.0f / ((float)n * (float)n * (float)n * (float)n);

  if (l.cooperative) {
#ifdef __CUDACC__
    // more than the default 48 KB of dynamic shared memory must be allowed first
    static size_t allowed = 0, counted = 0;
    static int resident = 0;  // blocks the card holds at once at `counted` bytes each
    const size_t smem = smem_a > smem_b ? smem_a : smem_b;
    if (smem > allowed) {
      const cudaError_t err = cudaFuncSetAttribute(
          ns_adv_cooperative<kPow2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      allowed = smem;
    }
    if (smem != counted) {
      int device = 0, sms = 0, per_sm = 0;
      cudaGetDevice(&device);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ns_adv_cooperative<kPow2>, kMaxThreads, smem);
      if (err != cudaSuccess) return (int)err;
      resident = sms * per_sm;
      counted = smem;
    }
    int grid = grid_a > grid_b ? grid_a : grid_b;
    if (grid > resident) grid = resident;
    Launch a = l;
    PlanOf<kPow2> plan = plan_of<kPow2>(l.plan);
    int ga = grid_a, gb = grid_b;
    float sc = scale;
    void* args[] = {&w, &stage, &a.kx, &a.ky, &a.inv_k2, &a.mask, &a.twiddle, &a.scratch, &out,
                    &plan, &a.tc, &a.ppc, &sc, &ga, &gb};
    const cudaError_t err = cudaLaunchCooperativeKernel((void*)ns_adv_cooperative<kPow2>,
                                                        dim3(grid), dim3(kMaxThreads), args, smem,
                                                        st);
    if (err == cudaSuccess) *launched += 1;
    return (int)err;
#else
    return -1;  // a grid-wide barrier needs the card
#endif
  }
  static size_t allowed_a = 0, allowed_b = 0;
  if (smem_a > allowed_a) {
    cudaError_t err = cudaFuncSetAttribute(ns_adv_rows_inverse<kPow2>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
    if (err != cudaSuccess) return (int)err;
    allowed_a = smem_a;
  }
  if (smem_b > allowed_b) {
    cudaError_t err = cudaFuncSetAttribute(ns_adv_columns<kPow2>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
    if (err != cudaSuccess) return (int)err;
    allowed_b = smem_b;
  }
  const int threads_a = block_threads(ppc * n > 4 * ppc * per_line ? ppc * n : 4 * ppc * per_line);
  const int threads_b = block_threads(2 * tc * per_line);
  const int threads_c = block_threads(ppc * n / 2 > ppc * per_line ? ppc * n / 2 : ppc * per_line);
  float2* s2 = l.scratch;
  const float2* tw2 = l.twiddle;
  const PlanOf<kPow2> plan = plan_of<kPow2>(l.plan);
  ns_adv_rows_inverse<kPow2><<<grid_a, threads_a, smem_a, st>>>(w, stage, l.kx, l.ky, l.inv_k2, tw2, s2, plan, ppc);
  ns_adv_columns<kPow2><<<grid_b, threads_b, smem_b, st>>>(s2, tw2, plan, tc, scale);
  ns_adv_rows_forward<kPow2><<<grid_c, threads_c, smem_c, st>>>(s2, w, stage, l.mask, tw2, out, plan, ppc);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) *launched += 3;
  return (int)err;
}

// The cluster route's shape of grid size n on clusters of c blocks, and its
// bytes of shared memory a block. Returns 0, or -1 where the field does not
// fit c blocks: their shared memory, or the registers that the exchange
// stages a field's rows in (kStage column pairs a thread at kStageThreads).
int cluster_shape(int n, int c, ClusterShape* cs, size_t* smem) {
  if (n < 2 || c < 1 || c > kClusterMax) return -1;
  const int npad = pad(n), tw = cluster_twiddles((n & 1) ? n : n / 2);
  const int g = has_generic_factor(n) ? 2 : 1;  // a generic stage's second buffer
  const int tc = 2 * ((n + 2 * c - 1) / (2 * c)), pairs = n / 2 + 1;
  const int ppb = 2 * ((pairs + 2 * c - 1) / (2 * c)), top = pad(pairs);
  // the narrowest even row that holds both fields' columns, pass 1's lines of rows r
  // within the rows y <= n/2, and its lines of rows -r past them
  int ld = 2 * tc, lb = 0;
  for (;; ld += 2) {
    lb = (top * ld + npad - 1) / npad;
    if (2 * ppb <= lb && lb + 2 * ppb <= ld) break;
  }
  const size_t bytes = (tw + (size_t)g * npad * ld) * sizeof(float2);
  if (bytes > kSmemLimit || 2 * ppb * ((n + 1) / 2) > kStage * kStageThreads) return -1;
  *cs = ClusterShape{c, tc, ppb, ld, lb};
  *smem = bytes;
  return 0;
}

#ifdef __CUDACC__
// The launch configuration of `batch` clusters of c blocks with smem bytes
// each, the kernel first allowed that much shared memory (and, above 8
// blocks, the non-portable cluster sizes); *err says whether that went well.
template <bool kPow2>
cudaLaunchConfig_t cluster_config(int batch, int c, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr, cudaError_t* err) {
  static size_t allowed = 0;
  static bool nonportable = false;
  *err = cudaSuccess;
  if (smem > allowed) {
    *err = cudaFuncSetAttribute(ns_adv_cluster<kPow2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
    if (*err == cudaSuccess) allowed = smem;
  }
  if (*err == cudaSuccess && c > 8 && !nonportable) {
    *err = cudaFuncSetAttribute(ns_adv_cluster<kPow2>,
                                cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    nonportable = *err == cudaSuccess;
  }
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(batch * c);
  config.blockDim = dim3(kClusterThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

template <bool kPow2>
int cluster_capacity(int c, size_t smem) {
  cudaLaunchAttribute attr[1];
  cudaError_t err = cudaSuccess;
  const cudaLaunchConfig_t config = cluster_config<kPow2>(1, c, smem, nullptr, attr, &err);
  int clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, ns_adv_cluster<kPow2>, &config);
  return err == cudaSuccess ? clusters : -(int)err;
}
#endif

// One stage by the cluster route: one launch of batch clusters.
template <bool kPow2>
int launch_cluster(const Launch& l, const float2* w, Stage stage, float2* out, int* launched) {
  ClusterShape cs;
  size_t smem = 0;
  const int n = l.plan.n;
  if (cluster_shape(n, l.cluster, &cs, &smem) ||
      2 * cs.ppb * ((n + 1) / 2) > kStage * kClusterThreads)
    return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / ((float)n * (float)n * (float)n * (float)n);
  const PlanOf<kPow2> plan = plan_of<kPow2>(l.plan);
  cudaError_t err = cudaSuccess;
#ifdef __CUDACC__
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t config = cluster_config<kPow2>(l.batch, cs.c, smem, l.stream, attr, &err);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&config, ns_adv_cluster<kPow2>, w, stage, l.kx, l.ky, l.inv_k2, l.mask,
                           l.twiddle, out, plan, cs, scale);
#else
  err = host_cluster_launch(ns_adv_cluster<kPow2>, l.batch * cs.c, cs.c, kClusterThreads, smem, w,
                            stage, l.kx, l.ky, l.inv_k2, l.mask, l.twiddle, out, plan, cs, scale);
#endif
  if (err == cudaSuccess) *launched += 1;
  return (int)err;
}

// One stage by the device route: one cooperative launch.
int launch_dm(const Launch& l, const float2* w, Stage stage, float2* out, int* launched) {
  const float n = (float)l.dm->n;
  static size_t allowed = 0, counted = 0;
  static int blocks = 0;
  const int err = dm::cooperative_launch(ns_adv_dm_kernel, dm::smem_bytes(*l.dm), l.stream,
                                         allowed, counted, blocks, w, stage, l.kx, l.ky,
                                         l.inv_k2, l.mask, l.scratch, l.packed, l.wbuf, out,
                                         *l.dm, l.batch, 1.0f / (n * n * n * n));
  if (err == 0) *launched += 1;
  return err;
}

int launch_any(const Launch& l, const float2* w, Stage stage, float2* out, int* launched) {
  if (l.dm) return launch_dm(l, w, stage, out, launched);
  if (l.cluster)
    return l.plan.logn >= 0 ? launch_cluster<true>(l, w, stage, out, launched)
                            : launch_cluster<false>(l, w, stage, out, launched);
  return l.plan.logn >= 0 ? launch_stage<true>(l, w, stage, out, launched)
                          : launch_stage<false>(l, w, stage, out, launched);
}

inline const float2* c2(const float* p) { return reinterpret_cast<const float2*>(p); }

// `substeps` classical RK4 substeps, four stages each (see ns_advection_rk4_launch).
int rk4_substeps(const Launch& l, const float* w, float* work, float* out, const float* lin,
                 const float* f, double dt, int substeps, int* launched) {
  const size_t field = (size_t)l.batch * l.plan.n * l.plan.n;
  float2* k = reinterpret_cast<float2*>(work);
  float2* k1 = k, *k2 = k + field, *k3 = k + 2 * field;
  const float2* src = c2(w);
  const float half_dt = (float)(0.5 * dt);
  for (int s = 0; s < substeps; ++s) {
    float2* dst = s == substeps - 1 ? reinterpret_cast<float2*>(out) : k + (3 + (s & 1)) * field;
    const Stage stages[4] = {{nullptr, 0.f, lin, c2(f), nullptr, nullptr, 0.f},
                             {k1, half_dt, lin, c2(f), nullptr, nullptr, 0.f},
                             {k2, half_dt, lin, c2(f), nullptr, nullptr, 0.f},
                             {k3, (float)dt, lin, c2(f), k1, k2, (float)(dt / 6.0)}};
    float2* outs[4] = {k1, k2, k3, dst};
    for (int i = 0; i < 4; ++i) {
      const int err = launch_any(l, src, stages[i], outs[i], launched);
      if (err) return err;
    }
    src = dst;
  }
  return 0;
}

// The device route's buffers in `dm_work` (ns_advection_dm_work_floats): the
// packed products, then Bluestein's work lines. Returns 0, or -1.
int dm_launch_setup(Launch& l, dm::Plan& p, const int* desc, int ndesc, const float* tw,
                    const int* pos, const float* chirp, const float* bh, float* dm_work) {
  if (dm::make_plan(desc, ndesc, tw, pos, chirp, bh, &p) || p.n != l.plan.n) return -1;
  l.dm = &p;
  l.packed = reinterpret_cast<float2*>(dm_work);
  l.wbuf = p.bluestein ? l.packed + (size_t)l.batch * p.n * ((p.n + 1) / 2) : nullptr;
  return 0;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of the three passes (the Python wrapper
// picks tc and ppc so that two blocks fit an SM where they can).
size_t ns_advection_smem_bytes(int pass, int n, int tc, int ppc) {
  return smem_bytes(pass, n, tc, ppc);
}

// The function, with lin and f optional (null or given). w, out, f: (batch,
// n, n) complex64 as interleaved floats; scratch: (batch, 2, n, n) complex64;
// kx, ky: (n); inv_k2, mask, lin: (n, n); twiddle: (n/2, 2) for even n, (n,
// 2) for odd n. tc is even; ppc >= 1 row pairs per block (the Python
// wrapper checks n against the shared-memory limit and picks tc and ppc).
// cooperative: one cooperative launch in place of the chain of three.
// *launched grows by the launches issued.
int ns_advection_launch(const float* w, const float* kx, const float* ky, const float* inv_k2,
                        const float* mask, const float* twiddle, float* scratch, float* out,
                        const float* lin, const float* f, int batch, int n, int tc, int ppc,
                        int cooperative, void* stream, int* launched) {
  Launch l = {kx, ky, inv_k2, mask, c2(twiddle), reinterpret_cast<float2*>(scratch), {},
              batch, tc, ppc, cooperative, static_cast<cudaStream_t>(stream), nullptr, nullptr,
              nullptr};
  if (make_plan(n, &l.plan) || tc < 2 || tc % 2 || ppc < 1) return (int)cudaErrorInvalidValue;
  const Stage stage = {nullptr, 0.f, lin, c2(f), nullptr, nullptr, 0.f};
  return launch_any(l, c2(w), stage, reinterpret_cast<float2*>(out), launched);
}

// `substeps` classical RK4 substeps of length dt of w' = lin w + adv(w) + f:
// four stages each, the fourth writing the combined substep. work:
// (5, batch, n, n) complex64 for k1, k2, k3 and the states between substeps;
// out receives the last state. Other arguments as in ns_advection_launch.
int ns_advection_rk4_launch(const float* w, const float* kx, const float* ky,
                            const float* inv_k2, const float* mask, const float* twiddle,
                            float* scratch, float* work, float* out, const float* lin,
                            const float* f, double dt, int substeps, int batch, int n, int tc,
                            int ppc, int cooperative, void* stream, int* launched) {
  Launch l = {kx, ky, inv_k2, mask, c2(twiddle), reinterpret_cast<float2*>(scratch), {},
              batch, tc, ppc, cooperative, static_cast<cudaStream_t>(stream), nullptr, nullptr,
              nullptr};
  if (make_plan(n, &l.plan) || tc < 2 || tc % 2 || ppc < 1) return (int)cudaErrorInvalidValue;
  return rk4_substeps(l, w, work, out, lin, f, dt, substeps, launched);
}

// Bytes of shared memory a block of the cluster route takes at grid size n on
// clusters of c blocks; 0 where the field does not fit them.
size_t ns_advection_cluster_smem_bytes(int n, int c) {
  ClusterShape cs;
  size_t smem = 0;
  return cluster_shape(n, c, &cs, &smem) ? 0 : smem;
}

// Clusters of c blocks at grid size n that the card holds at once (0: none
// fits, and a launch would be refused), or minus a cudaError_t code.
int ns_advection_cluster_capacity(int n, int c) {
  ClusterShape cs;
  size_t smem = 0;
  Plan plan;
  if (make_plan(n, &plan) || cluster_shape(n, c, &cs, &smem)) return -(int)cudaErrorInvalidValue;
#ifdef __CUDACC__
  return plan.logn >= 0 ? cluster_capacity<true>(c, smem) : cluster_capacity<false>(c, smem);
#else
  return 1;
#endif
}

// ns_advection_launch on the cluster route: one launch of batch clusters of
// `cluster` blocks (no scratch). Other arguments as there.
int ns_advection_cluster_launch(const float* w, const float* kx, const float* ky,
                                const float* inv_k2, const float* mask, const float* twiddle,
                                float* out, const float* lin, const float* f, int batch, int n,
                                int cluster, void* stream, int* launched) {
  Launch l = {kx, ky, inv_k2, mask, c2(twiddle), nullptr, {}, batch, 0, 0, 0,
              static_cast<cudaStream_t>(stream), nullptr, nullptr, nullptr, cluster};
  if (make_plan(n, &l.plan) || batch < 1 || cluster < 1) return (int)cudaErrorInvalidValue;
  const Stage stage = {nullptr, 0.f, lin, c2(f), nullptr, nullptr, 0.f};
  return launch_any(l, c2(w), stage, reinterpret_cast<float2*>(out), launched);
}

// ns_advection_rk4_launch on the cluster route: 4 * substeps launches.
int ns_advection_cluster_rk4_launch(const float* w, const float* kx, const float* ky,
                                    const float* inv_k2, const float* mask, const float* twiddle,
                                    float* work, float* out, const float* lin, const float* f,
                                    double dt, int substeps, int batch, int n, int cluster,
                                    void* stream, int* launched) {
  Launch l = {kx, ky, inv_k2, mask, c2(twiddle), nullptr, {}, batch, 0, 0, 0,
              static_cast<cudaStream_t>(stream), nullptr, nullptr, nullptr, cluster};
  if (make_plan(n, &l.plan) || batch < 1 || cluster < 1) return (int)cudaErrorInvalidValue;
  return rk4_substeps(l, w, work, out, lin, f, dt, substeps, launched);
}

// Floats of the device route's workspace, which the Python wrapper
// allocates: the packed products (batch, n, ceil(n / 2)) complex, and for
// Bluestein the work lines, one of m points per scratch row.
size_t ns_advection_dm_work_floats(int batch, int n, int m, int bluestein) {
  const size_t b = batch;
  return 2 * b * n * ((n + 1) / 2) + (bluestein ? 2 * (size_t)kPacked * b * n * m : 0);
}

// The device route of ns_advection_launch: one cooperative launch. desc, tw,
// pos, chirp, bh: the plan and its tables (ops/kernels/device_route.py;
// chirp and bh null for a split); dm_work: ns_advection_dm_work_floats
// floats. Other arguments as there (no tiles, no chain).
int ns_advection_dm_launch(const float* w, const float* kx, const float* ky, const float* inv_k2,
                           const float* mask, float* scratch, float* out, const float* lin,
                           const float* f, int batch, int n, const int* desc, int ndesc,
                           const float* tw, const int* pos, const float* chirp, const float* bh,
                           float* dm_work, void* stream, int* launched) {
  Launch l = {kx, ky, inv_k2, mask, nullptr, reinterpret_cast<float2*>(scratch), {},
              batch, 0, 0, 1, static_cast<cudaStream_t>(stream), nullptr, nullptr, nullptr};
  l.plan.n = n;
  dm::Plan p;
  if (batch < 1 || dm_launch_setup(l, p, desc, ndesc, tw, pos, chirp, bh, dm_work))
    return (int)cudaErrorInvalidValue;
  const Stage stage = {nullptr, 0.f, lin, c2(f), nullptr, nullptr, 0.f};
  return launch_any(l, c2(w), stage, reinterpret_cast<float2*>(out), launched);
}

// The device route of ns_advection_rk4_launch: 4 * substeps cooperative launches.
int ns_advection_dm_rk4_launch(const float* w, const float* kx, const float* ky,
                               const float* inv_k2, const float* mask, float* scratch,
                               float* work, float* out, const float* lin, const float* f,
                               double dt, int substeps, int batch, int n, const int* desc,
                               int ndesc, const float* tw, const int* pos, const float* chirp,
                               const float* bh, float* dm_work, void* stream, int* launched) {
  Launch l = {kx, ky, inv_k2, mask, nullptr, reinterpret_cast<float2*>(scratch), {},
              batch, 0, 0, 1, static_cast<cudaStream_t>(stream), nullptr, nullptr, nullptr};
  l.plan.n = n;
  dm::Plan p;
  if (batch < 1 || dm_launch_setup(l, p, desc, ndesc, tw, pos, chirp, bh, dm_work))
    return (int)cudaErrorInvalidValue;
  return rk4_substeps(l, w, work, out, lin, f, dt, substeps, launched);
}

const char* ns_advection_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
