// Mixed-radix FFT pieces shared by kernels K1 (ks_cnab2.cu) and K2
// (ns_advection.cu): complex arithmetic on float2, the radix-2, 3, 4 and 5
// butterflies in registers, the stages of one pass of an in-place
// mixed-radix transform (one or two radices on the points a thread holds),
// and which neighbouring radices share a pass. Included inside each
// source's anonymous namespace, after <cuda_runtime.h>.

__device__ inline float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ inline float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ inline float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * (+i) for the inverse, a * (-i) for the forward transform
template <bool kInverse>
__device__ inline float2 mul_i(float2 a) {
  return kInverse ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}
// R-point DFT in registers, natural order in and out.
template <int R, bool kInverse>
__device__ __forceinline__ void butterfly(float2 (&x)[R]) {
  if constexpr (R == 2) {
    const float2 a = x[0], b = x[1];
    x[0] = cadd(a, b);
    x[1] = csub(a, b);
  } else if constexpr (R == 3) {
    const float h = 0.86602540378443865f;  // sin(2 pi / 3)
    const float2 s = cadd(x[1], x[2]), d = csub(x[1], x[2]);
    const float2 t = make_float2(x[0].x - 0.5f * s.x, x[0].y - 0.5f * s.y);
    const float2 e = mul_i<kInverse>(make_float2(h * d.x, h * d.y));
    x[0] = cadd(x[0], s);
    x[1] = cadd(t, e);
    x[2] = csub(t, e);
  } else if constexpr (R == 4) {
    const float2 t0 = cadd(x[0], x[2]), t1 = csub(x[0], x[2]);
    const float2 t2 = cadd(x[1], x[3]), t3 = mul_i<kInverse>(csub(x[1], x[3]));
    x[0] = cadd(t0, t2);
    x[1] = cadd(t1, t3);
    x[2] = csub(t0, t2);
    x[3] = csub(t1, t3);
  } else if constexpr (R == 5) {
    const float c1 = 0.30901699437494742f, c2 = -0.80901699437494742f;  // cos(2 pi / 5), cos(4 pi / 5)
    const float s1 = 0.95105651629515357f, s2 = 0.58778525229247313f;   // sin(2 pi / 5), sin(4 pi / 5)
    const float2 a1 = cadd(x[1], x[4]), a2 = cadd(x[2], x[3]);
    const float2 b1 = csub(x[1], x[4]), b2 = csub(x[2], x[3]);
    const float2 t1 = make_float2(x[0].x + c1 * a1.x + c2 * a2.x, x[0].y + c1 * a1.y + c2 * a2.y);
    const float2 t2 = make_float2(x[0].x + c2 * a1.x + c1 * a2.x, x[0].y + c2 * a1.y + c1 * a2.y);
    const float2 u1 = mul_i<kInverse>(make_float2(s1 * b1.x + s2 * b2.x, s1 * b1.y + s2 * b2.y));
    const float2 u2 = mul_i<kInverse>(make_float2(s2 * b1.x - s1 * b2.x, s2 * b1.y - s1 * b2.y));
    x[0] = cadd(x[0], cadd(a1, a2));
    x[1] = cadd(t1, u1);
    x[2] = cadd(t2, u2);
    x[3] = csub(t2, u2);
    x[4] = csub(t1, u1);
  }  // R == 1: nothing to do
}

// The stages of one pass on the R1 * R2 points a thread holds: point
// q = m1 * R2 + m2 of x sits at p + q * sub of a block of R1 * R2 * sub
// points. Decimation in frequency (kDif): the radix-R1 stage on the whole
// block (butterflies over m1, then twiddles), then the radix-R2 stage on each
// of its R1 sub-blocks; decimation in time runs the mirror image, the R2
// stage first and twiddles before butterflies. tw1 = n / (block length),
// tw2 = n / (sub-block length) scale the twiddle indices; twiddle(idx) is
// exp(+-2 pi i idx / n), + for the inverse.
template <int R1, int R2, bool kInverse, bool kDif, class Twiddle>
__device__ __forceinline__ void pass_stages(float2 (&x)[R1 * R2], const Twiddle& twiddle, int p,
                                            int sub, int tw1, int tw2) {
  float2 w2[R2];  // the R2 stage's twiddles do not depend on the sub-block
  if (R2 > 1 && sub > 1) {
#pragma unroll
    for (int k = 1; k < R2; ++k) w2[k] = twiddle(p * k * tw2);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if ((half == 0) == kDif) {  // the radix-R1 stage
#pragma unroll
      for (int m2 = 0; m2 < R2; ++m2) {
        float2 t[R1];
#pragma unroll
        for (int m1 = 0; m1 < R1; ++m1) t[m1] = x[m1 * R2 + m2];
        const int at = (p + m2 * sub) * tw1;
        if (!kDif && (R2 > 1 || sub > 1)) {
#pragma unroll
          for (int m1 = 1; m1 < R1; ++m1) t[m1] = cmul(t[m1], twiddle(at * m1));
        }
        butterfly<R1, kInverse>(t);
        if (kDif && (R2 > 1 || sub > 1)) {
#pragma unroll
          for (int m1 = 1; m1 < R1; ++m1) t[m1] = cmul(t[m1], twiddle(at * m1));
        }
#pragma unroll
        for (int m1 = 0; m1 < R1; ++m1) x[m1 * R2 + m2] = t[m1];
      }
    } else if (R2 > 1) {  // the radix-R2 stage
#pragma unroll
      for (int m1 = 0; m1 < R1; ++m1) {
        float2 t[R2];
#pragma unroll
        for (int m2 = 0; m2 < R2; ++m2) t[m2] = x[m1 * R2 + m2];
        if (!kDif && sub > 1) {
#pragma unroll
          for (int m2 = 1; m2 < R2; ++m2) t[m2] = cmul(t[m2], w2[m2]);
        }
        butterfly<R2, kInverse>(t);
        if (kDif && sub > 1) {
#pragma unroll
          for (int m2 = 1; m2 < R2; ++m2) t[m2] = cmul(t[m2], w2[m2]);
        }
#pragma unroll
        for (int m2 = 0; m2 < R2; ++m2) x[m1 * R2 + m2] = t[m2];
      }
    }
  }
}

// The pairs of neighbouring factors (r1, r2) that run as one pass: those that
// `factor_radices`'s order (4s, a 2, 3s, 5s) can produce with at most 16
// points per thread. Each kernel's pass dispatch has a case for each.
inline bool shares_pass(int r1, int r2) {
  const int pairs[][2] = {{4, 4}, {4, 3}, {4, 2}, {2, 3}, {2, 5}, {3, 3}, {3, 5}};
  for (const auto& pr : pairs)
    if (pr[0] == r1 && pr[1] == r2) return true;
  return false;
}
