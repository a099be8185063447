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
// Design. One CTA owns `rows` env rows (a multiple of 4). Their half
// spectrum (u_hat, N_prev, f_hat as re/im, `nfp` bins each) and one real
// work row (nx) stay in shared memory for every substep; only y and f are
// read and out written in device memory. The transforms are direct DFTs
// with the twiddle factors cos/sin(2*pi*i/nx) read from a shared table of
// nx entries at index (j*k) mod nx, instead of the dense (nx, nf) cos/sin
// matrices of the TPU kernel (four of them, ~300 KB at nx=192, more than a
// CTA's 227 KB of shared memory). Each transform splits the grid index as
// j = j0 + m*nx/4 (m = 0..3): the four points share one twiddle up to a
// power of i, so a length-4 DFT combines them and the inner loop runs over
// j0 < nx/4 only (a radix-4 first stage, about 2.7x fewer multiply-adds
// than the dense DFT). A thread task covers 4 rows (one float4 of the
// [bin][row] shared layout), so every twiddle read serves 4 rows.
//
// What bounds it. The kernel reads 2 and writes 1 float per grid point and
// env step (37.7 MB at batch 16384, nx 192: ~11 us at 3.35 TB/s). The step
// itself needs ~0.27 MFLOP per row at nx=192 and 30 substeps, counting 62
// real FFTs at 2.5*nx*log2(nx) flops plus the per-bin update
// (`ks_kernel.flops_per_row`; ~0.067 ms at 16384 rows on 67 TFLOP/s), so
// the function is bound by arithmetic, not by memory. The design keeps all
// substep state on chip so that only the arithmetic remains; its direct
// DFTs spend ~1.8 MFLOP per row, ~7x the FFT count, which an in-kernel FFT
// would remove. Everything is float32. Requires nx % 4 == 0.
//
// Plain C interface (built by nvcc, loaded with ctypes): every call returns
// a cudaError_t code, 0 on success, checked by the Python wrapper.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kOps = 6;  // a_inv, b, g_alpha, dist_re, dist_im, irdft weight

struct Smem {
  float2* tw;   // nx twiddles (cos, sin)(2*pi*i/nx)
  float* a_inv; // nfp each, zero in the padded bins
  float* b;
  float* ga;
  float* dre;
  float* dim;
  float* w;     // irdft weights 1/nx (DC, Nyquist), 2/nx otherwise
  float* ur;    // [nfp][rows] half spectrum u_hat
  float* ui;
  float* npr;   // [nfp][rows] previous nonlinear term
  float* npi;
  float* fr;    // [nfp][rows] forcing spectrum * dt
  float* fi;
  float* buf;   // [nx][rows] real work row (y, y^2, f or u^2)
};

__host__ __device__ inline size_t smem_floats(int nx, int nfp, int rows) {
  return 2 * (size_t)nx + (size_t)kOps * nfp + 6 * (size_t)nfp * rows + (size_t)nx * rows;
}

__device__ inline Smem carve(float* base, int nx, int nfp, int rows) {
  Smem s;
  s.tw = reinterpret_cast<float2*>(base);
  float* p = base + 2 * nx;
  s.a_inv = p; p += nfp;
  s.b = p; p += nfp;
  s.ga = p; p += nfp;
  s.dre = p; p += nfp;
  s.dim = p; p += nfp;
  s.w = p; p += nfp;
  const size_t spec = (size_t)nfp * rows;
  s.ur = p; p += spec;
  s.ui = p; p += spec;
  s.npr = p; p += spec;
  s.npi = p; p += spec;
  s.fr = p; p += spec;
  s.fi = p; p += spec;
  s.buf = p;
  return s;
}

__device__ inline void to4(const float4 v, float a[4]) {
  a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
}

// Forward real DFT X_k = sum_j buf_j exp(-2 pi i j k / nx) at the four bins
// k = 4*kq + c (c = 0..3) for the rows 4g..4g+3 of buf.
__device__ inline void rdft_quad(const Smem& s, int nx, int rows, int kq, int g,
                                 float xr[4][4], float xi[4][4]) {
  const int q = nx >> 2;
  int idx[4], stride[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    idx[c] = 0;
    stride[c] = (4 * kq + c) % nx;
#pragma unroll
    for (int r = 0; r < 4; ++r) { xr[c][r] = 0.f; xi[c][r] = 0.f; }
  }
  const float* col = s.buf + 4 * g;
  for (int j0 = 0; j0 < q; ++j0) {
    float a0[4], a1[4], a2[4], a3[4];
    to4(*reinterpret_cast<const float4*>(col + (size_t)j0 * rows), a0);
    to4(*reinterpret_cast<const float4*>(col + (size_t)(j0 + q) * rows), a1);
    to4(*reinterpret_cast<const float4*>(col + (size_t)(j0 + 2 * q) * rows), a2);
    to4(*reinterpret_cast<const float4*>(col + (size_t)(j0 + 3 * q) * rows), a3);
    const float2 t0 = s.tw[idx[0]], t1 = s.tw[idx[1]];
    const float2 t2 = s.tw[idx[2]], t3 = s.tw[idx[3]];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // length-4 DFT of (a0, a1, a2, a3) at the four residues of k mod 4
      const float sp = a0[r] + a2[r], pp = a1[r] + a3[r];
      const float e0 = sp + pp, e2 = sp - pp;
      const float d = a0[r] - a2[r], qd = a1[r] - a3[r];
      // k = 0 mod 4: e0 * e^{-i th};  k = 2 mod 4: e2 * e^{-i th}
      xr[0][r] += e0 * t0.x;  xi[0][r] -= e0 * t0.y;
      xr[2][r] += e2 * t2.x;  xi[2][r] -= e2 * t2.y;
      // k = 1 mod 4: (d - i qd) e^{-i th};  k = 3 mod 4: (d + i qd) e^{-i th}
      xr[1][r] += d * t1.x - qd * t1.y;  xi[1][r] -= d * t1.y + qd * t1.x;
      xr[3][r] += d * t3.x + qd * t3.y;  xi[3][r] -= d * t3.y - qd * t3.x;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      idx[c] += stride[c];
      if (idx[c] >= nx) idx[c] -= nx;
    }
  }
}

// Inverse real DFT u_j = sum_k w_k (ur_k cos - ui_k sin)(2 pi j k / nx) at
// the four points j = j0 + m*nx/4 (m = 0..3) for the rows 4g..4g+3.
__device__ inline void irdft_quad(const Smem& s, int nx, int nfp, int rows, int j0, int g,
                                  float u[4][4]) {
  // A_c = sum over k = c mod 4 of W_k e^{i th_k}, th_k = 2 pi j0 k / nx;
  // classes 0 and 2 only ever need their real part
  float a0r[4], a2r[4], a1r[4], a1i[4], a3r[4], a3i[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    a0r[r] = a2r[r] = a1r[r] = a1i[r] = a3r[r] = a3i[r] = 0.f;
  }
  int idx = 0;  // (j0 * k) mod nx
  for (int k0 = 0; k0 < nfp; k0 += 4) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = k0 + c;
      const float2 t = s.tw[idx];
      const float wk = s.w[k];
      const float cw = t.x * wk, sw = t.y * wk;
      float zr[4], zi[4];
      to4(*reinterpret_cast<const float4*>(s.ur + (size_t)k * rows + 4 * g), zr);
      to4(*reinterpret_cast<const float4*>(s.ui + (size_t)k * rows + 4 * g), zi);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float re = zr[r] * cw - zi[r] * sw;
        if (c == 0) a0r[r] += re;
        if (c == 2) a2r[r] += re;
        if (c == 1) { a1r[r] += re; a1i[r] += zr[r] * sw + zi[r] * cw; }
        if (c == 3) { a3r[r] += re; a3i[r] += zr[r] * sw + zi[r] * cw; }
      }
      idx += j0;
      if (idx >= nx) idx -= nx;
    }
  }
  // u(j0 + m nx/4) = Re(A0 + i^m A1 + (-1)^m A2 + (-i)^m A3)
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    u[0][r] = a0r[r] + a1r[r] + a2r[r] + a3r[r];
    u[1][r] = a0r[r] - a1i[r] - a2r[r] + a3i[r];
    u[2][r] = a0r[r] - a1r[r] + a2r[r] - a3r[r];
    u[3][r] = a0r[r] + a1i[r] - a2r[r] - a3i[r];
  }
}

enum RdftMode { kInitU = 0, kInitN = 1, kInitF = 2, kSubstep = 3 };

// One pass over all (bin quad, row group) tasks: X = rdft(buf), then the
// mode's use of X for every bin k < nf (padded bins are kept at zero).
__device__ inline void rdft_pass(const Smem& s, int mode, int nx, int nfp, int rows,
                                 float dt_os) {
  const int nf = nx / 2 + 1;
  const int nq = nfp / 4, groups = rows / 4;
  const float dt2 = 0.5f * dt_os, dt32 = 1.5f * dt_os;
  for (int t = threadIdx.x; t < nq * groups; t += blockDim.x) {
    const int kq = t % nq, g = t / nq;
    float xr[4][4], xi[4][4];
    rdft_quad(s, nx, rows, kq, g, xr, xi);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = 4 * kq + c;
      const bool live = k < nf;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const size_t i = (size_t)k * rows + 4 * g + r;
        const float sr = live ? xr[c][r] : 0.f, si = live ? xi[c][r] : 0.f;
        if (mode == kInitU) {
          s.ur[i] = sr;
          s.ui[i] = si;
        } else if (mode == kInitN) {
          s.npr[i] = s.ga[k] * si;
          s.npi[i] = -s.ga[k] * sr;
        } else if (mode == kInitF) {
          s.fr[i] = sr * dt_os;
          s.fi[i] = si * dt_os;
        } else {
          const float nr = s.ga[k] * si, ni = -s.ga[k] * sr;
          const float ur = s.a_inv[k] * (s.b[k] * s.ur[i] + dt32 * nr - dt2 * s.npr[i] + s.fr[i]) + s.dre[k];
          const float ui = s.a_inv[k] * (s.b[k] * s.ui[i] + dt32 * ni - dt2 * s.npi[i] + s.fi[i]) + s.dim[k];
          s.ur[i] = live ? ur : 0.f;
          s.ui[i] = live ? ui : 0.f;
          s.npr[i] = nr;
          s.npi[i] = ni;
        }
      }
    }
  }
}

// Copy rows [row0, row0 + rows) of src (batch, nx) into buf as [j][row];
// rows past the batch are zero.
__device__ inline void load_rows(const Smem& s, const float* __restrict__ src, int batch,
                                 int nx, int rows, int row0) {
  for (int e = threadIdx.x; e < rows * nx; e += blockDim.x) {
    const int r = e / nx, j = e - r * nx;
    const int row = row0 + r;
    s.buf[(size_t)j * rows + r] = row < batch ? src[(size_t)row * nx + j] : 0.f;
  }
}

__global__ void __launch_bounds__(512)
ks_cnab2_kernel(const float* __restrict__ y, const float* __restrict__ f,
                const float* __restrict__ ops, const float2* __restrict__ twiddle,
                float* __restrict__ out, int batch, int nx, int nfp, int rows,
                int substeps, float dt_os) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), nx, nfp, rows);
  const int row0 = blockIdx.x * rows;
  const int q = nx >> 2, groups = rows / 4;

  for (int i = threadIdx.x; i < nx; i += blockDim.x) s.tw[i] = twiddle[i];
  for (int i = threadIdx.x; i < kOps * nfp; i += blockDim.x) s.a_inv[i] = ops[i];
  load_rows(s, y, batch, nx, rows, row0);
  __syncthreads();
  rdft_pass(s, kInitU, nx, nfp, rows, dt_os);  // u_hat = rdft(y)
  __syncthreads();
  for (int e = threadIdx.x; e < rows * nx; e += blockDim.x) s.buf[e] *= s.buf[e];
  __syncthreads();
  rdft_pass(s, kInitN, nx, nfp, rows, dt_os);  // N_prev = G rdft(y^2)
  __syncthreads();
  load_rows(s, f, batch, nx, rows, row0);
  __syncthreads();
  rdft_pass(s, kInitF, nx, nfp, rows, dt_os);  // f_hat = dt rdft(f)
  __syncthreads();

  for (int step = 0; step <= substeps; ++step) {
    const bool last = step == substeps;
    for (int t = threadIdx.x; t < q * groups; t += blockDim.x) {
      const int j0 = t % q, g = t / q;
      float u[4][4];
      irdft_quad(s, nx, nfp, rows, j0, g, u);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = j0 + m * q;
        if (last) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = row0 + 4 * g + r;
            if (row < batch) out[(size_t)row * nx + j] = u[m][r];
          }
        } else {
          *reinterpret_cast<float4*>(s.buf + (size_t)j * rows + 4 * g) =
              make_float4(u[m][0] * u[m][0], u[m][1] * u[m][1],
                          u[m][2] * u[m][2], u[m][3] * u[m][3]);
        }
      }
    }
    if (last) break;
    __syncthreads();
    rdft_pass(s, kSubstep, nx, nfp, rows, dt_os);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

size_t ks_cnab2_smem_bytes(int nx, int nfp, int rows) {
  return smem_floats(nx, nfp, rows) * sizeof(float);
}

int ks_cnab2_launch(const float* y, const float* f, const float* ops, const float* twiddle,
                    float* out, int batch, int nx, int nfp, int rows, int threads,
                    int substeps, float dt_os, void* stream) {
  const size_t smem = ks_cnab2_smem_bytes(nx, nfp, rows);
  cudaError_t err = cudaFuncSetAttribute(ks_cnab2_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (batch + rows - 1) / rows;
  ks_cnab2_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      y, f, ops, reinterpret_cast<const float2*>(twiddle), out, batch, nx, nfp, rows,
      substeps, dt_os);
  return (int)cudaGetLastError();
}

const char* ks_cnab2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
