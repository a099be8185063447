// Fused 2D Navier-Stokes advection term with the 2/3-rule mask (kernel K2)
// for Hopper (sm_90a).
//
// Replaces distributedconvrl_pde_control_tpu/ops/pallas/ns_advection.py::
// PallasAdvection2D._kernel. For a batch of full n x n vorticity spectra
// w (batch, n, n) complex64, indexed [ky][kx]:
//
//   psi = w * inv_k2                       (inv_k2[0][0] = 0)
//   u    = Re IFFT2( i ky psi)             v    = Re IFFT2(-i kx psi)
//   dwdx = Re IFFT2( i kx w)               dwdy = Re IFFT2( i ky w)
//   out  = FFT2(-u dwdx - v dwdy) * mask23
//
// kx varies along the last axis, ky along rows; both are given as vectors
// (the signed Nyquist entry is the caller's), inv_k2 and mask23 as (n, n)
// arrays. The inverse carries 1/n per axis. Everything is float32.
//
// Design. The TPU kernel keeps two dense n x n cos/sin matrices and a whole
// batch tile in its fast memory and runs ~38 matrix products. Here a field
// (512 KB at n = 256) does not fit one block's shared memory and one block
// per field would leave most of the card idle at batch 1, so the 2D
// transforms are split by axis into three launches of line transforms, each
// a radix-2 FFT of length n in shared memory (a line is 8n bytes):
//
//   1. ns_adv_inverse_cols: a block takes `tc` neighbouring columns of one
//      of the four spectra, forms the spectrum from w on the fly, inverse-
//      transforms along rows (axis -2) and writes a (batch, 4, n, n) complex
//      scratch. Neighbouring columns keep the global accesses in 8*tc-byte
//      runs.
//   2. ns_adv_rows: a block takes one row of the four scratch fields,
//      inverse-transforms along the row, keeps the real parts, forms
//      -u dwdx - v dwdy and forward-transforms that line back into field 0
//      of the scratch.
//   3. ns_adv_forward_cols: forward transform along axis -2 of field 0,
//      times the mask, into out.
//
// The inverse passes are decimation in frequency (natural order in,
// bit-reversed out) and the forward passes decimation in time (bit-reversed
// in, natural out). The real-space product is pointwise, so it does not
// care that both of its axes are in bit-reversed order, and no pass ever
// permutes data. Twiddles cos/sin(2 pi k / n), k < n/2, are computed in
// float64 on the host and read from shared memory.
//
// What bounds it. The function reads w and writes out, 16 n^2 bytes per
// field (1 MB at n = 256: 0.31 us at 3.35 TB/s). Its four inverses keep only
// real parts and its forward takes a real field, so two complex inverses of
// packed pairs and one real-to-complex forward would do: 2.5 complex 2D
// FFTs, 2.5 * 5 n^2 log2(n^2) flops plus ~30 per point (15 MFLOP at n = 256:
// 0.22 us at 67 TFLOP/s). So the bound is the bytes, and at batch 1 it is
// below the cost of one launch. This first version runs five full complex
// transforms, as the reference does (twice the flops of that count), and
// spends its time on the scratch round trips (each field crosses L2 twice
// more) and on 3 launches. n must be a power of two, 8..1024.
//
// Plain C interface (built by nvcc, loaded with ctypes): the launch returns
// a cudaError_t code, 0 on success, checked by the Python wrapper.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kFields = 4;  // u, v, dw/dx, dw/dy

__device__ inline float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ inline float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ inline float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// In-place radix-2 FFTs of `lines` lines of length n = 2^logn in shared
// memory; element i of a line sits at x[line * line_stride + i * idx_stride].
// kInverse picks exp(+i theta) (unscaled). kDif: decimation in frequency,
// natural order in, bit-reversed order out; otherwise decimation in time,
// bit-reversed in, natural out. tw[k] = (cos, sin)(2 pi k / n), k < n/2.
// With lines_fastest, neighbouring threads take the same butterfly of
// neighbouring lines. The caller synchronises before; every stage ends in
// a __syncthreads().
template <bool kInverse, bool kDif>
__device__ inline void fft_lines(float2* x, const float2* tw, int n, int logn, int lines,
                                 int line_stride, int idx_stride, bool lines_fastest) {
  const int half_n = n >> 1;
  const int work = lines * half_n;
  for (int s = 0; s < logn; ++s) {
    const int lg = kDif ? (logn - 1 - s) : s;  // log2 of the butterfly span
    const int half = 1 << lg;
    const int tw_step = half_n >> lg;
    for (int t = threadIdx.x; t < work; t += blockDim.x) {
      int line, j;
      if (lines_fastest) {
        j = t / lines;
        line = t - j * lines;
      } else {
        line = t / half_n;
        j = t - line * half_n;
      }
      const int pos = j & (half - 1);
      const int i0 = ((j >> lg) << (lg + 1)) + pos;
      float2* p0 = x + (size_t)line * line_stride + (size_t)i0 * idx_stride;
      float2* p1 = p0 + (size_t)half * idx_stride;
      float2 w = tw[pos * tw_step];
      if (!kInverse) w.y = -w.y;
      const float2 a = *p0, b = *p1;
      if (kDif) {
        *p0 = cadd(a, b);
        *p1 = cmul(csub(a, b), w);
      } else {
        const float2 bw = cmul(b, w);
        *p0 = cadd(a, bw);
        *p1 = csub(a, bw);
      }
    }
    __syncthreads();
  }
}

// Launch 1. grid = batch * 4 * (n / tc); block (b, q, tile) inverse-
// transforms columns [tile*tc, tile*tc + tc) of spectrum q along axis -2.
__global__ void __launch_bounds__(256)
ns_adv_inverse_cols(const float2* __restrict__ w, const float* __restrict__ kx,
                    const float* __restrict__ ky, const float* __restrict__ inv_k2,
                    const float2* __restrict__ twiddle, float2* __restrict__ scratch,
                    int n, int logn, int tc) {
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* x = smem + (n >> 1);  // [n][tc]
  const int tiles = n / tc;
  int bid = blockIdx.x;
  const int tile = bid % tiles;
  bid /= tiles;
  const int q = bid % kFields;
  const int b = bid / kFields;
  const int c0 = tile * tc;

  for (int i = threadIdx.x; i < (n >> 1); i += blockDim.x) tw[i] = twiddle[i];
  const float2* wb = w + (size_t)b * n * n;
  for (int e = threadIdx.x; e < n * tc; e += blockDim.x) {
    const int r = e / tc, c = c0 + (e - r * tc);
    const float2 z = wb[(size_t)r * n + c];
    const float kxc = kx[c], kyr = ky[r];
    float2 v;
    if (q < 2) {
      const float ik = inv_k2[(size_t)r * n + c];
      const float pr = ik * z.x, pi = ik * z.y;
      v = q == 0 ? make_float2(-kyr * pi, kyr * pr)   // u_hat =  i ky psi
                 : make_float2(kxc * pi, -kxc * pr);  // v_hat = -i kx psi
    } else {
      v = q == 2 ? make_float2(-kxc * z.y, kxc * z.x)   // i kx w
                 : make_float2(-kyr * z.y, kyr * z.x);  // i ky w
    }
    x[e] = v;
  }
  __syncthreads();
  fft_lines<true, true>(x, tw, n, logn, tc, 1, tc, true);
  float2* sb = scratch + ((size_t)b * kFields + q) * n * n;
  for (int e = threadIdx.x; e < n * tc; e += blockDim.x) {
    const int p = e / tc;
    sb[(size_t)p * n + c0 + (e - p * tc)] = x[e];
  }
}

// Launch 2. grid = batch * n; block (b, p) takes row p of the four scratch
// fields: inverse along the row, real parts scaled by 1/n^2, the product,
// forward along the row, written over row p of field 0.
__global__ void __launch_bounds__(256)
ns_adv_rows(float2* __restrict__ scratch, const float2* __restrict__ twiddle, int n, int logn,
            float scale) {
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* x = smem + (n >> 1);  // [4][n]
  const int b = blockIdx.x / n, p = blockIdx.x - b * n;

  for (int i = threadIdx.x; i < (n >> 1); i += blockDim.x) tw[i] = twiddle[i];
  float2* sb = scratch + (size_t)b * kFields * n * n + (size_t)p * n;
  for (int e = threadIdx.x; e < kFields * n; e += blockDim.x) {
    const int q = e / n;
    x[e] = sb[(size_t)q * n * n + (e - q * n)];
  }
  __syncthreads();
  fft_lines<true, true>(x, tw, n, logn, kFields, n, 1, false);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float u = x[i].x * scale, v = x[n + i].x * scale;
    const float dwdx = x[2 * n + i].x * scale, dwdy = x[3 * n + i].x * scale;
    x[i] = make_float2(-u * dwdx - v * dwdy, 0.f);
  }
  __syncthreads();
  fft_lines<false, false>(x, tw, n, logn, 1, n, 1, false);
  for (int i = threadIdx.x; i < n; i += blockDim.x) sb[i] = x[i];
}

// Launch 3. grid = batch * (n / tc); block (b, tile) forward-transforms
// columns [tile*tc, tile*tc + tc) of scratch field 0 along axis -2 and
// writes them, times the mask, to out.
__global__ void __launch_bounds__(256)
ns_adv_forward_cols(const float2* __restrict__ scratch, const float* __restrict__ mask,
                    const float2* __restrict__ twiddle, float2* __restrict__ out, int n,
                    int logn, int tc) {
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* x = smem + (n >> 1);  // [n][tc]
  const int tiles = n / tc;
  const int b = blockIdx.x / tiles, c0 = (blockIdx.x - b * tiles) * tc;

  for (int i = threadIdx.x; i < (n >> 1); i += blockDim.x) tw[i] = twiddle[i];
  const float2* sb = scratch + (size_t)b * kFields * n * n;
  for (int e = threadIdx.x; e < n * tc; e += blockDim.x) {
    const int p = e / tc;
    x[e] = sb[(size_t)p * n + c0 + (e - p * tc)];
  }
  __syncthreads();
  fft_lines<false, false>(x, tw, n, logn, tc, 1, tc, true);
  float2* ob = out + (size_t)b * n * n;
  for (int e = threadIdx.x; e < n * tc; e += blockDim.x) {
    const int r = e / tc;
    const size_t at = (size_t)r * n + c0 + (e - r * tc);
    const float m = mask[at];
    ob[at] = make_float2(x[e].x * m, x[e].y * m);
  }
}

inline int block_threads(int work) {
  const int t = (work + 31) / 32 * 32;
  return t < 256 ? t : 256;
}

}  // namespace

extern "C" {

// w, out: (batch, n, n) complex64 as interleaved floats; scratch:
// (batch, 4, n, n) complex64; kx, ky: (n); inv_k2, mask: (n, n); twiddle:
// (n/2, 2). n = 2^logn, tc divides n and (n/2 + 4n) and (n/2 + n*tc) float2
// fit in 48 KB of shared memory (the Python wrapper checks).
int ns_advection_launch(const float* w, const float* kx, const float* ky, const float* inv_k2,
                        const float* mask, const float* twiddle, float* scratch, float* out,
                        int batch, int n, int logn, int tc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* w2 = reinterpret_cast<const float2*>(w);
  const float2* tw2 = reinterpret_cast<const float2*>(twiddle);
  float2* s2 = reinterpret_cast<float2*>(scratch);
  float2* o2 = reinterpret_cast<float2*>(out);
  const int tiles = n / tc;
  const int col_threads = block_threads(tc * (n / 2));
  const int row_threads = block_threads(kFields * (n / 2));
  const size_t col_smem = ((size_t)(n / 2) + (size_t)n * tc) * sizeof(float2);
  const size_t row_smem = ((size_t)(n / 2) + (size_t)kFields * n) * sizeof(float2);
  const int grid_a = batch * kFields * tiles, grid_b = batch * n, grid_c = batch * tiles;
  const float scale = 1.0f / ((float)n * (float)n);

  ns_adv_inverse_cols<<<grid_a, col_threads, col_smem, st>>>(w2, kx, ky, inv_k2, tw2, s2, n, logn, tc);
  ns_adv_rows<<<grid_b, row_threads, row_smem, st>>>(s2, tw2, n, logn, scale);
  ns_adv_forward_cols<<<grid_c, col_threads, col_smem, st>>>(s2, mask, tw2, o2, n, logn, tc);
  return (int)cudaGetLastError();
}

const char* ns_advection_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
