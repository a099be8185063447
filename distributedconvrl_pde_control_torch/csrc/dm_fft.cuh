// Line transforms through device memory: the device route of kernels K1
// (ks_cnab2.cu) and K2 (ns_advection.cu), for lines that do not fit one
// block's shared memory. Included inside each source's anonymous namespace,
// after radix.cuh; everything is in namespace dm.
//
// A line of n points is transformed as levels that fit a block (the plan is
// made on the host: ops/kernels/device_route.py). A split reads the line of
// m = n points as a row-major array [L_0][L_1]...; the inverse runs, for
// a = 0, 1, ..., the L_a-point transforms along axis a (a "level"), each
// followed by the twiddles exp(+2 pi i k_a r / N_a), where k_a is the
// level's output index, r the position along the axes after a and N_a =
// L_a * L_(a+1) * ...; the forward runs the mirror image (levels from the
// innermost out, twiddles exp(-...) before each). Point j = j_0 + L_0 j_1 +
// ... of the inverse's output sits at sum_a j_a S_a (S_a = L_(a+1) * ...,
// `real_pos`), where the forward takes it back from; between them the
// kernels only work pointwise, so no pass permutes data. Bluestein (a
// length with no split) runs the same levels on a work line of a 5-smooth
// m >= 2n - 1: chirp, inverse over m, the product with the kernel's
// spectrum, forward over m, chirp. Its real-space order is the natural one.
//
// A level is one pass over device memory: a block loads a tile of 1 << lgt
// sub-lines of L points into shared memory, laid out [point][sub-line],
// transforms them with radix.cuh's butterflies (two stages a pass where a
// thread holds both, a generic stage for other primes, out of place), and
// stores them. Decimation in frequency for the inverse (natural in, digit
// reversed in shared memory, stored back in natural order through the
// level's position table), decimation in time for the forward (loaded into
// digit-reversed places). The tile's sub-lines are neighbours in memory
// where that exists: neighbouring lines of a set of strided lines (a field's
// columns), else neighbouring positions r of a strided level, else the
// contiguous sub-lines of the innermost level, so that reads run along
// memory. The innermost level of a transform that turns round (K1's square,
// Bluestein's product) runs its inverse stages, the pointwise operation and
// its forward stages on the same tile (a "turn").
//
// Every phase is a loop of the whole grid over its virtual blocks or points,
// followed by a grid-wide barrier: the kernels that use this header are
// launched cooperatively (`cooperative_launch`), one launch for all phases.

#ifndef DM_THREADS
#define DM_THREADS 256
#endif

#ifdef __CUDACC__
__device__ __forceinline__ void grid_sync() { cooperative_groups::this_grid().sync(); }
#endif

namespace dm {

constexpr int kThreads = DM_THREADS;
constexpr int kMaxLevels = 3;
constexpr int kMaxPasses = 16;

// One level: `len` points per sub-line, `stride` (S) between them in the
// line, 1 << lgt sub-lines per tile; `passes` passes of radix r1 (and r2 on
// the same registers where r2 > 1) in the order of the inverse stages;
// `generic`: some pass is a generic stage (a second tile buffer); its
// position table starts at pos + pos_off.
struct Level {
  int len, stride, lgt, passes, generic, pos_off;
  int r1[kMaxPasses], r2[kMaxPasses];
};

// The transform of a line of n points: a split (m == n) or Bluestein of
// length m; tw: m entries (cos, sin)(2 pi r / m); chirp: n entries
// exp(+i pi j^2 / n); bh: 2 m entries, the spectrum of the convolution
// kernel for the inverse and then for the forward direction, in the slot
// order of the innermost level.
struct Plan {
  int n, m, bluestein, levels;
  Level lv[kMaxLevels];
  const float2* tw;
  const int* pos;
  const float2* chirp;
  const float2* bh;
};

// A set of `count` lines: line l starts at base + (l / per) * outer +
// (l % per) * inner, its points `es` apart.
struct Lines {
  float2* base;
  long long outer, inner;
  long long count;
  int per, es;
  __device__ float2* line(long long l) const {
    return base + (l / per) * outer + (l % per) * inner;
  }
};

__host__ __device__ inline Lines contiguous(float2* base, long long count, int len) {
  return Lines{base, (long long)len, 0, count, 1, 1};
}

__device__ __forceinline__ float2 conj2(float2 a) { return make_float2(a.x, -a.y); }

__device__ __forceinline__ long long thread_index() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ long long thread_count() { return (long long)gridDim.x * blockDim.x; }

// Where the inverse leaves point j of a line and the forward takes it from.
__device__ __forceinline__ long long real_pos(const Plan& p, long long j) {
  if (p.bluestein) return j;
  long long at = 0;
  for (int a = 0; a < p.levels; ++a) {
    const long long ja = j % p.lv[a].len;
    j /= p.lv[a].len;
    at += ja * p.lv[a].stride;
  }
  return at;
}

template <bool kInverse>
struct Tw {  // pass_stages' twiddle lookup in a level's table exp(2 pi i idx / L)
  const float2* t;
  __device__ float2 operator()(int idx) const {
    float2 v = t[idx];
    if (!kInverse) v.y = -v.y;
    return v;
  }
};

// One pass of the tile's in-place transforms on blocks of `len` points: a
// thread takes the R1 * R2 points p + q * sub of one block of one sub-line.
template <int R1, int R2, bool kInverse>
__device__ void tile_pass(float2* x, const float2* tw, int L, int len, int lgt) {
  constexpr int R = R1 * R2;
  const int sub = len / R, tasks = (L / R) << lgt, step = sub << lgt, lanes = (1 << lgt) - 1;
  const int tw1 = L / len, tw2 = tw1 * R1;
  for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
    const int lane = t & lanes, j = t >> lgt;
    const int blk = j / sub, p = j - blk * sub;
    float2* b = x + ((size_t)(blk * len + p) << lgt) + lane;
    float2 v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = b[(size_t)q * step];
    pass_stages<R1, R2, kInverse, kInverse>(v, Tw<kInverse>{tw}, p, sub, tw1, tw2);
#pragma unroll
    for (int q = 0; q < R; ++q) b[(size_t)q * step] = v[q];
  }
  __syncthreads();
}

// The same stage for any radix r, out of place (x -> y): a thread computes
// one output point as an r-term sum.
template <bool kInverse>
__device__ void tile_generic(const float2* x, float2* y, const float2* tw, int L, int r, int len,
                             int lgt) {
  const int sub = len / r, tasks = L << lgt, tw_mul = L / len, root_mul = L / r;
  const int lanes = (1 << lgt) - 1;
  const Tw<kInverse> twd{tw};
  for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
    const int lane = t & lanes, o = t >> lgt;
    const int blk = o / len, rem = o - blk * len;
    const int k = rem / sub, p = rem - k * sub;
    float2 acc = make_float2(0.f, 0.f);
    int mk = 0;  // (m * k) mod r
    for (int m = 0; m < r; ++m) {
      const float2 v = x[((size_t)(blk * len + p + m * sub) << lgt) + lane];
      int idx = mk * root_mul + (kInverse ? 0 : p * m * tw_mul);
      if (idx >= L) idx -= L;
      acc = cadd(acc, cmul(v, twd(idx)));
      mk += k;
      if (mk >= r) mk -= r;
    }
    if (kInverse) acc = cmul(acc, twd(p * k * tw_mul));
    y[((size_t)o << lgt) + lane] = acc;
  }
  __syncthreads();
}

// The tile's transforms: kInverse, decimation in frequency with exp(+i)
// (natural in, slot order out); else decimation in time with exp(-i) (slot
// order in, natural out). Returns the buffer that holds the result. Kept out
// of line: one copy per direction, where inlining made one per caller.
template <bool kInverse>
__device__ __noinline__ float2* tile_fft(float2* x, float2* x2, const float2* tw, const Level& lv) {
  const int L = lv.len, lgt = lv.lgt;
  int len = kInverse ? L : 1;
  for (int s = 0; s < lv.passes; ++s) {
    const int pass = kInverse ? s : lv.passes - 1 - s;
    const int r1 = lv.r1[pass], r2 = lv.r2[pass];
    if (!kInverse) len *= r1 * r2;
#define DM_PASS(A, B)                                  \
  case A * 8 + B:                                      \
    tile_pass<A, B, kInverse>(x, tw, L, len, lgt);     \
    break;
    switch (r1 * 8 + r2) {
      DM_PASS(4, 4) DM_PASS(4, 3) DM_PASS(4, 2) DM_PASS(2, 3) DM_PASS(2, 5) DM_PASS(3, 3)
      DM_PASS(3, 5) DM_PASS(4, 1) DM_PASS(2, 1) DM_PASS(3, 1) DM_PASS(5, 1)
      default: {
        tile_generic<kInverse>(x, x2, tw, L, r1, len, lgt);
        float2* done = x2;
        x2 = x;
        x = done;
      }
    }
#undef DM_PASS
    if (kInverse) len /= r1 * r2;
  }
  return x;
}

// Dynamic shared memory of a block at one level: the level's twiddles and
// positions, the tile (twice with a generic stage). device_route.level_smem.
__host__ __device__ inline size_t level_smem(const Level& lv) {
  const size_t L = lv.len;
  return 8 * L + 4 * (L + (L & 1)) + 8 * (L << lv.lgt) * (lv.generic ? 2 : 1);
}

inline size_t smem_bytes(const Plan& p) {
  size_t most = 0;
  for (int a = 0; a < p.levels; ++a) {
    const size_t s = level_smem(p.lv[a]);
    if (s > most) most = s;
  }
  return most;
}

enum Kind { kInv = 0, kFwd = 1, kTurn = 2 };

struct NoOp {
  __device__ float2 operator()(float2 v, long long) const { return v; }
};
struct SquareOp {  // the square of both components (K1's two real rows)
  __device__ float2 operator()(float2 v, long long) const {
    return make_float2(v.x * v.x, v.y * v.y);
  }
};
struct KernelOp {  // Bluestein: the product with the kernel's spectrum, by slot
  const float2* bh;
  __device__ float2 operator()(float2 v, long long at) const { return cmul(v, bh[at]); }
};

// Level a on every line of ls, as a loop of the grid over the level's tiles.
// kInv: inverse stages, twiddles after; kFwd: twiddles before, forward
// stages; kTurn (the innermost level, S = 1): inverse stages, op on every
// point (its index in the line's slot order), forward stages.
template <int kKind, class Op>
__device__ void level_phase(const Plan& p, int a, const Lines& ls, float2* smem, const Op& op) {
  const Level& lv = p.lv[a];
  const int L = lv.len, S = lv.stride, lgt = lv.lgt, T = 1 << lgt;
  const long long NS = (long long)L * S, Q = p.m / NS, tw_scale = p.m / NS;
  // the tile's sub-lines: neighbouring lines, else neighbouring r, else neighbouring q
  const int by_line = ls.es != 1 && ls.inner == 1 && ls.per > 1;
  const int by_r = !by_line && S > 1;
  const long long tl = by_line ? (ls.count + T - 1) / T : ls.count;
  const long long tr = by_r ? (S + T - 1) / T : S;
  const long long tq = (!by_line && !by_r) ? (Q + T - 1) / T : Q;
  float2* tw = smem;
  int* pos = reinterpret_cast<int*>(tw + L);
  float2* x = reinterpret_cast<float2*>(pos + L + (L & 1));
  float2* x2 = x + ((size_t)L << lgt);
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    tw[i] = p.tw[(size_t)i * (p.m / L)];
    pos[i] = p.pos[lv.pos_off + i];
  }
  __syncthreads();
  const int points = L << lgt;
  for (long long vb = blockIdx.x; vb < tl * tq * tr; vb += gridDim.x) {
    long long r0 = vb % tr, rest = vb / tr;
    long long q0 = rest % tq, l0 = rest / tq;
    if (by_line) l0 *= T; else if (by_r) r0 *= T; else q0 *= T;
    for (int e = threadIdx.x; e < points; e += blockDim.x) {
      int t, i;
      if (by_line || by_r) {
        i = e >> lgt;
        t = e & (T - 1);
      } else {
        t = e / L;
        i = e - t * L;
      }
      const long long l = l0 + (by_line ? t : 0), r = r0 + (by_r ? t : 0);
      const long long q = q0 + (!by_line && !by_r ? t : 0);
      float2 v = make_float2(0.f, 0.f);
      if (l < ls.count && q < Q && r < S) {
        v = ls.line(l)[(q * NS + (long long)i * S + r) * ls.es];
        if (kKind == kFwd && S > 1) v = cmul(v, conj2(p.tw[(long long)i * r * tw_scale]));
      }
      x[((size_t)(kKind == kFwd ? pos[i] : i) << lgt) + t] = v;
    }
    __syncthreads();
    float2* y;
    if (kKind == kFwd) {
      y = tile_fft<false>(x, x2, tw, lv);
    } else {
      y = tile_fft<true>(x, x2, tw, lv);
      if (kKind == kTurn) {
        for (int e = threadIdx.x; e < points; e += blockDim.x) {
          // slot e >> lgt of sub-line e & (T - 1)
          const long long q = q0 + (by_line ? 0 : (e & (T - 1)));
          y[e] = op(y[e], q * L + (e >> lgt));
        }
        __syncthreads();
        y = tile_fft<false>(y, y == x ? x2 : x, tw, lv);
      }
    }
    for (int e = threadIdx.x; e < points; e += blockDim.x) {
      int t, i;
      if (by_line || by_r) {
        i = e >> lgt;
        t = e & (T - 1);
      } else {
        t = e / L;
        i = e - t * L;
      }
      const long long l = l0 + (by_line ? t : 0), r = r0 + (by_r ? t : 0);
      const long long q = q0 + (!by_line && !by_r ? t : 0);
      if (l < ls.count && q < Q && r < S) {
        float2 v = y[((size_t)(kKind == kInv ? pos[i] : i) << lgt) + t];
        if (kKind == kInv && S > 1) v = cmul(v, p.tw[(long long)i * r * tw_scale]);
        ls.line(l)[(q * NS + (long long)i * S + r) * ls.es] = v;
      }
    }
    __syncthreads();
  }
}

// The levels of a transform that turns round: inverse levels, the innermost
// as a turn with op, forward levels.
template <class Op>
__device__ void levels_turn(const Plan& p, const Lines& ls, float2* smem, const Op& op) {
  for (int a = 0; a + 1 < p.levels; ++a) {
    level_phase<kInv>(p, a, ls, smem, NoOp{});
    grid_sync();
  }
  level_phase<kTurn>(p, p.levels - 1, ls, smem, op);
  grid_sync();
  for (int a = p.levels - 2; a >= 0; --a) {
    level_phase<kFwd>(p, a, ls, smem, NoOp{});
    grid_sync();
  }
}

// Bluestein: the lines of ls times the chirp (conjugate for the forward
// direction) into the work lines of m points, zero past n.
__device__ void chirp_in(const Plan& p, const Lines& ls, const Lines& wl, bool inverse) {
  const long long total = ls.count * p.m;
  for (long long e = thread_index(); e < total; e += thread_count()) {
    const long long l = e / p.m, j = e - l * p.m;
    float2 v = make_float2(0.f, 0.f);
    if (j < p.n) {
      const float2 c = p.chirp[j];
      v = cmul(ls.line(l)[j * ls.es], inverse ? c : conj2(c));
    }
    wl.line(l)[j] = v;
  }
  grid_sync();
}

__device__ void chirp_out(const Plan& p, const Lines& ls, const Lines& wl, bool inverse) {
  const long long total = ls.count * p.n;
  for (long long e = thread_index(); e < total; e += thread_count()) {
    const long long l = e / p.n, k = e - l * p.n;
    const float2 c = p.chirp[k];
    ls.line(l)[k * ls.es] = cmul(wl.line(l)[k], inverse ? c : conj2(c));
  }
  grid_sync();
}

// Unscaled inverse transforms of every line of ls, in place: natural order
// in, real-space order out. wl: Bluestein's work lines (m points per line
// of ls). Every phase ends in a grid barrier.
__device__ void inverse(const Plan& p, const Lines& ls, const Lines& wl, float2* smem) {
  if (p.bluestein) {
    chirp_in(p, ls, wl, true);
    levels_turn(p, wl, smem, KernelOp{p.bh});
    chirp_out(p, ls, wl, true);
    return;
  }
  for (int a = 0; a < p.levels; ++a) {
    level_phase<kInv>(p, a, ls, smem, NoOp{});
    grid_sync();
  }
}

// Unscaled forward transforms: real-space order in, natural out.
__device__ void forward(const Plan& p, const Lines& ls, const Lines& wl, float2* smem) {
  if (p.bluestein) {
    chirp_in(p, ls, wl, false);
    levels_turn(p, wl, smem, KernelOp{p.bh + p.m});
    chirp_out(p, ls, wl, false);
    return;
  }
  for (int a = p.levels - 1; a >= 0; --a) {
    level_phase<kFwd>(p, a, ls, smem, NoOp{});
    grid_sync();
  }
}

// The inverse, the square of both components of every point, the forward.
__device__ void inverse_square_forward(const Plan& p, const Lines& ls, const Lines& wl,
                                       float2* smem) {
  if (!p.bluestein) {
    levels_turn(p, ls, smem, SquareOp{});
    return;
  }
  inverse(p, ls, wl, smem);
  const long long total = ls.count * p.n;
  for (long long e = thread_index(); e < total; e += thread_count()) {
    const long long l = e / p.n, j = e - l * p.n;
    float2* v = ls.line(l) + j * ls.es;
    *v = SquareOp{}(*v, 0);
  }
  grid_sync();
  forward(p, ls, wl, smem);
}

// The plan from its descriptor (device_route.descriptor: n, m, bluestein,
// levels, then per level its length, log2 tile, stage count and stages);
// neighbouring stages that shares_pass lists share a pass. Returns 0, or -1
// for a malformed descriptor.
inline int make_plan(const int* desc, int ndesc, const float* tw, const int* pos,
                     const float* chirp, const float* bh, Plan* out) {
  if (ndesc < 4) return -1;
  Plan p = {};
  p.n = desc[0];
  p.m = desc[1];
  p.bluestein = desc[2];
  p.levels = desc[3];
  if (p.n < 2 || p.m < p.n || p.levels < 1 || p.levels > kMaxLevels) return -1;
  if (p.bluestein && (!chirp || !bh)) return -1;
  int at = 4, pos_off = 0;
  long long prod = 1;
  for (int a = 0; a < p.levels; ++a) {
    if (at + 3 > ndesc) return -1;
    Level& lv = p.lv[a];
    lv.len = desc[at];
    lv.lgt = desc[at + 1];
    const int stages = desc[at + 2];
    at += 3;
    if (lv.len < 2 || lv.lgt < 0 || lv.lgt > 8 || stages < 1 || at + stages > ndesc) return -1;
    lv.pos_off = pos_off;
    pos_off += lv.len;
    long long len = 1;
    for (int s = 0; s < stages; ++s) {
      const int r1 = desc[at + s];
      int r2 = 1;
      if (r1 < 2) return -1;
      if (r1 > 5) lv.generic = 1;
      if (s + 1 < stages && shares_pass(r1, desc[at + s + 1])) r2 = desc[at + ++s];
      if (lv.passes == kMaxPasses) return -1;
      lv.r1[lv.passes] = r1;
      lv.r2[lv.passes] = r2;
      ++lv.passes;
      len *= (long long)r1 * r2;
    }
    at += stages;
    if (len != lv.len) return -1;
    prod *= lv.len;
  }
  if (at != ndesc || prod != p.m || (!p.bluestein && p.m != p.n)) return -1;
  int stride = 1;
  for (int a = p.levels - 1; a >= 0; --a) {
    p.lv[a].stride = stride;
    stride *= p.lv[a].len;
  }
  p.tw = reinterpret_cast<const float2*>(tw);
  p.pos = pos;
  p.chirp = reinterpret_cast<const float2*>(chirp);
  p.bh = reinterpret_cast<const float2*>(bh);
  *out = p;
  return 0;
}

// One argument as the kernel takes it, so that a launch converts what it is given.
template <class T>
struct Ident {
  using type = T;
};

// The device route's launch: cooperative (every block resident, for the
// grid barriers), as many blocks as the card holds at once. `allowed` and
// `counted` keep, per kernel, the shared memory already allowed and the
// block count found for it. Without nvcc (a host build that runs CUDA
// threads as host threads) the launch goes through host_cooperative_launch,
// which that build provides.
template <class... P>
int cooperative_launch(void (*kernel)(P...), size_t smem, cudaStream_t stream, size_t& allowed,
                       size_t& counted, int& blocks, typename Ident<P>::type... args) {
  if (smem > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  if (smem != counted) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    blocks = sms * per_sm;
    counted = smem;
  }
#ifdef __CUDACC__
  void* ptrs[] = {static_cast<void*>(&args)...};
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                          dim3(kThreads), ptrs, smem, stream);
#else
  return host_cooperative_launch(kernel, blocks, kThreads, smem, args...);
#endif
}

}  // namespace dm
