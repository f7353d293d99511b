// RGB batch 2-D LP solver for Hopper (sm_90a): Seidel's randomised
// incremental algorithm, one warp per problem, each problem staged in shared
// memory by the Tensor Memory Accelerator.
//
// Replaces the TPU kernel src/repro/kernels/batch_lp.py::_rgb_kernel
// (launched by rgb_pallas).  Same function: packed constraints
// L (B, 4, m_pad) with rows (a_x, a_y, b, 0), objectives c (B, 2), valid
// counts m_valid (B, 1) int32  ->  x (B, 2), feas (B, 1) int32.
//
// What bounds it on this card: bytes, nominally — every constraint is read
// once (3 * m_pad * itemsize per problem at most) and the arithmetic per
// constraint is a handful of multiplies.  In practice the incremental loop
// is a dependency chain (the test of constraint i needs the optimum after
// constraint i-1), so what sets the time is the latency of each step of the
// chain and how many chains the card holds at once.  What the design does:
//
//  * One warp per problem.  The membership test runs 32 constraints at a
//    time: lane l reads column i0+l of rows 0-2 (row 3 of L is never read)
//    and tests it against the current optimum.  The optimum only changes at
//    a violation, so the first violated lane of the ballot is exactly the
//    constraint the sequential algorithm stops at; after its re-solve the
//    lanes above it are re-tested against the new optimum.  The test is
//    warp-uniform, so skipping the re-solve is a plain branch per problem.
//  * The O(i) re-solve at column ii strides the lanes over the columns
//    h < ceil(ii / 32) * 32 only — the constraints before the violated one,
//    rounded up to the warp — under the mask h < ii; in the unstaged
//    regime a lane loads SCAN_BATCH columns (4 in float32, 2 in float64)
//    before it uses any, so their loads overlap.  The four box faces, in
//    closed form, are computed by lanes 0-3 (one face a lane: one division
//    each instead of four on every lane).  t_lo / t_hi are folded with
//    redux.sync min/max on the values' order-preserving integer image (one
//    each in float32, two in float64), the parallel-infeasible flag with
//    __any_sync.  The reductions are exact, so the result is the same in
//    every bit as a scan of the whole padded row: the reference's `chunk`
//    (dense, or ceil(ii / chunk) * chunk columns) changes neither the
//    kernel's result nor its work, and the kernel does not take it.  (Against
//    the plain version's compare-and-select the sign of a zero can differ
//    where +0 and -0 tie; -0 == +0.)
//  * Staged regime (3 * m_pad * itemsize + 64 bytes fits the 232,448 bytes
//    of dynamic shared memory a block may have): each warp owns one region
//    of 3 x m_pad elements.  When a warp takes a problem, lane 0 issues 1-D
//    bulk copies (cp.async.bulk, the TMA's copy of contiguous bytes) of rows
//    0-2, columns [0, ceil(m_valid / 32) * 32) only — the padding past
//    m_valid is never copied — split into at most CHUNKS column chunks of at
//    least MIN_CHUNK columns, each completing on an mbarrier of its own.  A
//    ballot step waits only for the chunk it is about to test, so the chain
//    starts when chunk 0 has landed and the problem costs about one memory
//    latency instead of one per step; the ballot steps and re-solves then
//    read shared memory (lane l reads column h+l: no bank conflicts for 4- or
//    8-byte words).  Bulk copies rather than per-lane 16-byte cp.async
//    because one lane moves a whole row chunk with one instruction and no
//    registers, and an mbarrier per chunk gives the per-chunk completion
//    point that cp.async's per-thread groups would need a constant wait
//    depth for.
//  * Unstaged regime (a problem too wide for shared memory): the same loop
//    reads rows 0-2 from global memory (L1/L2), with the same scan limit.
//  * One CTA per tile; warp w solves problems w, w + warps, ... of its tile,
//    re-using its one region.  A second region that prefetched the next
//    problem, and a persistent grid, were measured and were slower at the
//    figure-3 shape and within 5% elsewhere: with one problem per warp and
//    ~32 warps an SM, the other warps hide a problem's copy latency
//    (PERF.md).  Which problem a warp solves never changes its result.
//
// Copy hazards handled: m_valid is clamped to [0, m_pad] before the copy
// size is computed; a problem with m_valid == 0 issues no copy and waits on
// no barrier; every chunk a problem armed is waited for before the warp
// leaves the problem (an infeasible problem stops testing early), so no copy
// is in flight when the region or a barrier is reused or the CTA exits; the
// phase parity of each barrier is tracked per barrier in a bit mask, flipped
// when the barrier is armed.  Source rows start m_pad * itemsize apart with
// m_pad % 128 == 0 and copy sizes are multiples of 32 * itemsize, so the
// bulk copies' 16-byte alignment holds given a 16-byte aligned L (the
// wrapper checks it).
//
// Numerics: every epsilon and M are cast to T once (a double literal would
// promote float comparisons and move ties); `big` is the type's finite max,
// not infinity; division is IEEE.  The library is built without fast-math
// and with --fmad=false, so each product and sum rounds on its own exactly
// as the plain PyTorch version's separate ops do.  Staging changes where
// values are read from, never the order of the arithmetic.
//
// m_valid is clamped here: checking it on the host would cost a device
// synchronisation per launch.  (The reference clamps the column index of its
// dynamic slice instead; for valid inputs both are no-ops.)
//
// wgmma is not used: the kernel does no matrix product.
//
// The same library holds the solver front end's two passes around this
// kernel, prep_kernel and finish_kernel: see their own note further down.

#include <cuda_runtime.h>

#include <atomic>
#include <cfloat>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 8;    // block size bound (launch bounds)
constexpr int CHUNKS = 8;       // completion points per staged problem
constexpr int MIN_CHUNK = 128;  // columns per chunk, at least

template <typename T> struct Lim;
template <> struct Lim<float> {
  static __device__ __forceinline__ float big() { return FLT_MAX; }
};
template <> struct Lim<double> {
  static __device__ __forceinline__ double big() { return DBL_MAX; }
};

template <typename T>
__device__ __forceinline__ T absT(T v) { return v < T(0) ? -v : v; }

template <typename T>
__device__ __forceinline__ T minT(T a, T b) { return b < a ? b : a; }

template <typename T>
__device__ __forceinline__ T maxT(T a, T b) { return b > a ? b : a; }

// sign(v) with tie-break: |v| <= eps -> sign(tb); |tb| <= eps -> +1.
template <typename T>
__device__ __forceinline__ T sign_tb(T v, T tb, T eps_tie) {
  if (absT(v) > eps_tie) return v > T(0) ? T(1) : T(-1);
  if (absT(tb) > eps_tie) return tb > T(0) ? T(1) : T(-1);
  return T(1);
}

// Warp-wide min of `by_min` and max of `by_max`, in place on every lane,
// by redux.sync on the values' order-preserving integer image: flipping the
// magnitude bits of a negative value (b ^ ((b >> 31) & 0x7fffffff), and the
// 64-bit analogue) orders every non-NaN float or double as a signed
// integer; no NaN reaches here.  A double's image is reduced in two 32-bit
// passes: the signed high words, then the unsigned low words of the lanes
// that hold the winning high word.  Exact, like a compare-and-select
// butterfly; the two can differ only in the sign of a zero where +0 and -0
// tie (-0 ranks below +0 here), and -0 == +0.
__device__ __forceinline__ int f2key(float f) {
  const int b = __float_as_int(f);
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float key2f(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}
__device__ __forceinline__ void warp_min_max(float& by_min, float& by_max) {
  by_min = key2f(__reduce_min_sync(FULL, f2key(by_min)));
  by_max = key2f(__reduce_max_sync(FULL, f2key(by_max)));
}
__device__ __forceinline__ long long d2key(double d) {
  const long long b = __double_as_longlong(d);
  return b ^ ((b >> 63) & 0x7fffffffffffffffLL);
}
__device__ __forceinline__ double key2d(int hi, unsigned lo) {
  const long long k =
      (long long)(((unsigned long long)(unsigned)hi << 32) | lo);
  return __longlong_as_double(k ^ ((k >> 63) & 0x7fffffffffffffffLL));
}
__device__ __forceinline__ void warp_min_max(double& by_min, double& by_max) {
  const long long kmin = d2key(by_min), kmax = d2key(by_max);
  const int hmin = __reduce_min_sync(FULL, (int)(kmin >> 32));
  const int hmax = __reduce_max_sync(FULL, (int)(kmax >> 32));
  const unsigned lmin = __reduce_min_sync(
      FULL, (int)(kmin >> 32) == hmin ? (unsigned)kmin : 0xffffffffu);
  const unsigned lmax = __reduce_max_sync(
      FULL, (int)(kmax >> 32) == hmax ? (unsigned)kmax : 0u);
  by_min = key2d(hmin, lmin);
  by_max = key2d(hmax, lmax);
}

// --- mbarrier and bulk-copy primitives (PTX) -------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The barriers are named by their shared-memory address (32 bits).
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of `bar` with this parity has completed.  A copy of
// at most 227 KB lands in microseconds; a wait that is still polling after
// 2^26 polls (seconds) can only be a fault, and traps — the launch then
// fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls > (1u << 26)) __trap();
    asm volatile(
        "{\n"
        " .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy `bytes` (a multiple of 16) from global to shared memory; completion
// is counted on `bar` as transaction bytes.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Column chunks of a staged problem with m valid constraints: groups of 32
// columns, cc32 groups a chunk, n chunks (0 when m == 0).
struct Chunks {
  int m32, cc32, n;
  __device__ __forceinline__ explicit Chunks(int m) {
    m32 = (m + 31) >> 5;
    const int want = (m32 + CHUNKS - 1) / CHUNKS;
    cc32 = want > MIN_CHUNK / 32 ? want : MIN_CHUNK / 32;
    n = (m32 + cc32 - 1) / cc32;
  }
};

__device__ __forceinline__ int clamp_m(int m, int m_pad) {
  return m < 0 ? 0 : (m > m_pad ? m_pad : m);
}

// One warp's staging: a region of rows 0-2 (3 x m_pad elements) and CHUNKS
// barriers, in dynamic shared memory.  Every lane holds the same copy of
// this state and calls every method (warp-uniformly).
template <typename T>
struct Stager {
  T* rows;        // the region: row r at rows + r * m_pad
  uint32_t bars;  // shared address of barrier 0; barrier k 8 * k above
  uint32_t phase; // bit k: parity of barrier k's phase

  __device__ __forceinline__ void init(unsigned char* smem, int warp,
                                       int nwarps, int m_pad, int lane) {
    phase = 0u;
    const int region = 3 * m_pad;
    rows = reinterpret_cast<T*>(smem) + warp * region;
    bars = smem_u32(smem + nwarps * region * (int)sizeof(T)) +
           warp * CHUNKS * 8;
    if (lane == 0) {
      for (int k = 0; k < CHUNKS; ++k) mbar_init(bars + 8 * k);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
  }

  // Start the copies of rows 0-2, columns [0, ceil(m / 32) * 32), of the
  // problem at `src` into the region (lane 0), and flip the parity bits of
  // the barriers this arms (every lane).  m == 0 arms nothing.
  __device__ __forceinline__ void issue(const T* src, int m, int m_pad,
                                        int lane) {
    const Chunks ch(m);
    if (ch.n == 0) return;
    if (lane == 0) {
      // The region was last read through the generic proxy (the previous
      // problem's loads, ordered by __syncwarp): order those before the
      // async proxy's writes.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      for (int k = 0; k < ch.n; ++k) {
        const int g0 = k * ch.cc32;
        const int g1 = min(ch.m32, g0 + ch.cc32);
        const uint32_t bytes = (uint32_t)((g1 - g0) * 32 * sizeof(T));
        mbar_expect_tx(bars + 8 * k, 3u * bytes);
#pragma unroll
        for (int r = 0; r < 3; ++r)
          bulk_g2s(rows + r * m_pad + g0 * 32, src + r * m_pad + g0 * 32,
                   bytes, bars + 8 * k);
      }
    }
    phase ^= (1u << ch.n) - 1u;
  }

  // Wait for chunk k: the phase armed last.
  __device__ __forceinline__ void wait(int k) const {
    mbar_wait(bars + 8 * k, ((phase >> k) & 1u) ^ 1u);
  }
};

// Solve one problem with the warp: rows ax/ay/bb (shared memory when
// STAGED, else global), m valid constraints, objective (cx, cy).  When
// STAGED, waits for each chunk of `st` before testing it and for every
// chunk it armed before returning.
template <typename T, bool STAGED>
__device__ __forceinline__ void solve_problem(const T* __restrict__ ax, int m,
                                              int m_pad, T cx, T cy, T M,
                                              const Stager<T>& st, int lane,
                                              T& x0_out, T& x1_out,
                                              bool& feas_out) {
  const T EPS_DENOM = T(1e-7);
  const T EPS_FEAS = T(1e-5);
  const T EPS_TIE = T(1e-9);
  const T big = Lim<T>::big();
  const T* __restrict__ ay = ax + m_pad;
  const T* __restrict__ bb = ay + m_pad;
  // Columns a lane loads before using any in the re-solve's scan: in the
  // unstaged regime each waits on L2, so several in flight pay off; shared
  // memory answers in tens of cycles, and the extra registers cost the
  // staged regime more than the overlap gains (PERF.md).
  constexpr int SCAN_BATCH = STAGED ? 1 : (sizeof(T) == 4 ? 4 : 2);

  const T cpx = -cy, cpy = cx;  // perpendicular (tie-break) objective
  T x0 = sign_tb(cx, cpx, EPS_TIE) * M;
  T x1 = sign_tb(cy, cpy, EPS_TIE) * M;
  bool feas = true;

  const Chunks ch(m);
  int k_ready = 0;  // chunks waited for: columns [0, k_ready * cc32 * 32)
  for (int i0 = 0; i0 < m && feas; i0 += 32) {
    if (STAGED && i0 >= k_ready * ch.cc32 * 32) {
      st.wait(k_ready);
      ++k_ready;
    }
    const int i = i0 + lane;
    // Lanes past the problem's end hold the neutral constraint.
    T a_x = T(0), a_y = T(0), b_ = T(1);
    if (i < m) { a_x = ax[i]; a_y = ay[i]; b_ = bb[i]; }
    unsigned handled = 0u;  // lanes whose constraint is already settled
    while (true) {
      const bool viol = (i < m) && (a_x * x0 + a_y * x1 > b_ + EPS_FEAS);
      const unsigned ballot = __ballot_sync(FULL, viol) & ~handled;
      if (ballot == 0u) break;            // warp-uniform skip
      const int j = __ffs(ballot) - 1;    // first violated constraint
      const int ii = i0 + j;              // its column
      const T a_ix = __shfl_sync(FULL, a_x, j);
      const T a_iy = __shfl_sync(FULL, a_y, j);
      const T b_i = __shfl_sync(FULL, b_, j);

      // Line frame: p0 = a_i * b_i (unit normals), u = perp(a_i).
      const T p0x = a_ix * b_i, p0y = a_iy * b_i;
      const T ux = -a_iy, uy = a_ix;

      T t_lo = -big, t_hi = big;
      bool bad = false;
      // The four box faces, one a lane (lanes 0-3), in closed form:
      // direction (ux, -ux, uy, -uy), slack (M - p0x, M + p0x, M - p0y,
      // M + p0y).  They join the warp's min/max below like any prior
      // constraint; min, max and OR are exact, so the order is free.
      if (lane < 4) {
        const T bd = lane == 0 ? ux : lane == 1 ? -ux : lane == 2 ? uy : -uy;
        const T bn = lane == 0   ? M - p0x
                     : lane == 1 ? M + p0x
                     : lane == 2 ? M - p0y
                                 : M + p0y;
        const T q = bn / bd;  // used only where |bd| > EPS_DENOM
        if (bd > EPS_DENOM) t_hi = q;
        if (bd < -EPS_DENOM) t_lo = q;
        bad = absT(bd) <= EPS_DENOM && bn < -EPS_FEAS;
      }
      // sigma bounds over prior constraints h < ii (paper eqs. 3-4),
      // scanning only the warp-rounded prefix h < ceil(ii / 32) * 32.
      // The guarded divide's slow-path branch keeps the compiler from
      // hoisting a column's loads above the previous column's divide, hence
      // the explicit batch.  `hb < limit` is warp-uniform: limit and h - lane
      // are multiples of 32.
      const int limit = (ii + 31) & ~31;
      for (int h = lane; h < limit; h += 32 * SCAN_BATCH) {
        T axh[SCAN_BATCH], ayh[SCAN_BATCH], bh[SCAN_BATCH];
#pragma unroll
        for (int u = 0; u < SCAN_BATCH; ++u) {
          const int hb = h + 32 * u;
          if (hb < limit) { axh[u] = ax[hb]; ayh[u] = ay[hb]; bh[u] = bb[hb]; }
        }
#pragma unroll
        for (int u = 0; u < SCAN_BATCH; ++u) {
          const int hb = h + 32 * u;
          if (hb >= limit) break;
          const T denom = axh[u] * ux + ayh[u] * uy;
          const T num = bh[u] - (axh[u] * p0x + ayh[u] * p0y);
          const bool is_par = absT(denom) <= EPS_DENOM;
          const T t = num / (is_par ? T(1) : denom);  // guarded divide
          const bool mask = hb < ii;
          if (mask && denom > EPS_DENOM) t_hi = minT(t_hi, t);
          if (mask && denom < -EPS_DENOM) t_lo = maxT(t_lo, t);
          bad = bad || (mask && is_par && num < -EPS_FEAS);
        }
      }
      warp_min_max(t_hi, t_lo);
      bad = __any_sync(FULL, bad);
      const bool feas_new = (t_lo <= t_hi + EPS_FEAS) && !bad;

      // Objective endpoint selection (tie -> perpendicular objective).
      const T cu = cx * ux + cy * uy;
      const T cpu = cpx * ux + cpy * uy;
      const bool pick_hi = absT(cu) > EPS_TIE ? cu > T(0) : cpu > T(0);
      const T tt = pick_hi ? t_hi : t_lo;
      x0 = p0x + tt * ux;
      x1 = p0y + tt * uy;
      feas = feas && feas_new;
      if (!feas) break;  // an infeasible problem is never violated again
      handled = (j == 31) ? FULL : ((2u << j) - 1u);  // lanes <= j
    }
  }
  if constexpr (STAGED) {
    // An infeasible problem stops early: let its remaining copies land
    // before the region and its barriers are reused.
    for (; k_ready < ch.n; ++k_ready) st.wait(k_ready);
    __syncwarp();
  }
  x0_out = x0;
  x1_out = x1;
  feas_out = feas;
}

template <typename T, bool STAGED>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    rgb_kernel(const T* __restrict__ L, const T* __restrict__ c,
               const int* __restrict__ mv, T* __restrict__ x_out,
               int* __restrict__ feas_out, int tile, int m_pad, T M) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  Stager<T> st;  // used (and its barriers initialised) when STAGED only
  if constexpr (STAGED) st.init(smem, warp, nwarps, m_pad, lane);
  for (int p = warp; p < tile; p += nwarps) {
    const int bi = blockIdx.x * tile + p;  // batch < 2^31
    const T* Lb = L + (long long)bi * 4 * m_pad;
    const int m = clamp_m(mv[bi], m_pad);
    const T* ax;
    if constexpr (STAGED) {
      st.issue(Lb, m, m_pad, lane);
      ax = st.rows;
    } else {
      ax = Lb;
    }
    T x0, x1;
    bool feas;
    solve_problem<T, STAGED>(ax, m, m_pad, c[2LL * bi], c[2LL * bi + 1], M,
                             st, lane, x0, x1, feas);
    if (lane == 0) {
      x_out[2LL * bi] = x0;
      x_out[2LL * bi + 1] = x1;
      feas_out[bi] = feas ? 1 : 0;
    }
  }
}

// Dynamic shared memory a staged launch needs.
template <typename T>
long long staged_bytes(int warps, int m_pad) {
  return (long long)warps * (3LL * m_pad * (long long)sizeof(T) +
                             CHUNKS * (long long)sizeof(uint64_t));
}

constexpr int MAX_DEVICES = 64;

template <typename T, bool STAGED>
int launch_t(const void* L, const void* c, const void* mv, void* x,
             void* feas, int batch, int m_pad, int tile, double M, int warps,
             int smem_bytes, void* stream) {
  // Whether this instance has opted in to the block's whole dynamic shared
  // memory on each device.  The value set is the card's own, the same for
  // every launch, so host threads racing to set it agree.
  static std::atomic<bool> opted_in[MAX_DEVICES];
  auto kern = rgb_kernel<T, STAGED>;
  cudaError_t err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if (smem_bytes > 48 * 1024 &&
      (dev >= MAX_DEVICES || !opted_in[dev].load(std::memory_order_acquire))) {
    int optin = 0;
    if ((err = cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
        cudaSuccess)
      return (int)err;
    if ((err = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) !=
        cudaSuccess)
      return (int)err;
    if (dev < MAX_DEVICES)
      opted_in[dev].store(true, std::memory_order_release);
  }
  kern<<<dim3((unsigned)(batch / tile)), dim3((unsigned)(warps * 32)),
         (size_t)smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(L), static_cast<const T*>(c),
      static_cast<const int*>(mv), static_cast<T*>(x),
      static_cast<int*>(feas), tile, m_pad, static_cast<T>(M));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* L, const void* c, const void* mv, void* x, void* feas,
           int batch, int m_pad, int tile, double M, int warps, int staged,
           int smem_bytes, void* stream) {
  if (batch <= 0 || tile <= 0 || batch % tile || warps < 1 ||
      warps > MAX_WARPS || smem_bytes < 0)
    return (int)cudaErrorInvalidValue;
  if (!staged)
    return launch_t<T, false>(L, c, mv, x, feas, batch, m_pad, tile, M, warps,
                              smem_bytes, stream);
  if (smem_bytes < staged_bytes<T>(warps, m_pad) ||
      reinterpret_cast<uintptr_t>(L) % 16)
    return (int)cudaErrorInvalidValue;
  return launch_t<T, true>(L, c, mv, x, feas, batch, m_pad, tile, M, warps,
                           smem_bytes, stream);
}

// --- The front end's passes: prep and finish --------------------------------
//
// These two replace no Pallas kernel.  They are the fusion XLA gives the
// reference's jitted front end (src/repro/solver/solver.py: normalise, pack
// and pad before rgb_pallas, the objective after it), which the port
// otherwise runs as ~20 eager PyTorch ops, each a launch and a pass over the
// batch.  Both are bound by bytes: prep reads 12 bytes a constraint (the AoS
// a_x, a_y, b) and writes 16 (a column of L), with a handful of flops;
// finish touches ~30 bytes a problem.
//
// prep_kernel, in one pass, from either layout as the caller gave it (the
// AoS A (B, m, 2) and b (B, m), or the packed L_in (B, 4, m)), with c (B, 2)
// and m_valid (B,) int32: L (b_pad, 4, m_pad) with rows (a_x, a_y, b, 0),
// normalised; columns m..m_pad-1 and problems B..b_pad-1 neutral
// (a = 0, b = 1; c = (1, 0), m_valid = 0), as pad_packed and
// pad_packed_batch_dim write them; c (b_pad, 2) and m_valid (b_pad, 1).
// The arithmetic is the eager chain's on the card, in its order, so L equals
// its result in every bit: n = ||a|| is torch's vector_norm over the pair
// (two rounded squares, one rounded sum, a rounded square root: the build's
// --fmad=false keeps the sum from contracting, as torch's reduction, which
// folds each square into its own accumulator, does not contract it either);
// s = n < eps ? 1 : 1 / max(n, eps), the divide IEEE (where s is used,
// max(n, eps) is n, NaN included); then a_x * s, a_y * s, b * s, and for a
// packed input the fourth row * s too, as normalize_packed multiplies it.
// Padding columns the input already had are normalised like any column
// (zero norm: s = 1), as in the eager chain.
//
// Access: a thread takes four consecutive columns of one problem, and
// consecutive threads consecutive column groups, so every access is
// coalesced.  In float32 a thread loads two float4 of A and one of b (AoS)
// or one float4 of each row (packed), and stores one float4 to each row of
// L: 16 bytes a thread an access.  That needs the inputs 16-byte aligned
// and a problem's stride (m * itemsize) a multiple of 16 bytes; otherwise,
// and for the group holding the input's last columns, the thread reads
// column by column (the scalar path) and still stores 16-byte words.  L's
// columns are a multiple of 128, so a group never straddles two rows.
//
// finish_kernel: objective = (0 + c_x * x_0) + c_y * x_1, which is how
// (c * x).sum(-1) rounds on the card (a product kernel, then a sum from
// +0: the sign of a zero included), and feasible = feas != 0 as a bool, for
// the first B problems.

template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ p, T v[4]);
template <>
__device__ __forceinline__ void load4<float>(const float* __restrict__ p,
                                             float v[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
template <>
__device__ __forceinline__ void load4<double>(const double* __restrict__ p,
                                              double v[4]) {
  const double2 q0 = __ldg(reinterpret_cast<const double2*>(p));
  const double2 q1 = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
}

template <typename T>
__device__ __forceinline__ void store4(T* __restrict__ p, const T v[4]);
template <>
__device__ __forceinline__ void store4<float>(float* __restrict__ p,
                                              const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store4<double>(double* __restrict__ p,
                                               const double v[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

__device__ __forceinline__ float sqrt_rn(float v) { return __fsqrt_rn(v); }
__device__ __forceinline__ double sqrt_rn(double v) { return __dsqrt_rn(v); }

// 1 / ||a|| where the norm is real, 1 where it is below eps (padding).
template <typename T>
__device__ __forceinline__ T norm_scale(T ax, T ay, T eps) {
  const T n = sqrt_rn(ax * ax + ay * ay);
  return n < eps ? T(1) : T(1) / n;
}

constexpr int PREP_THREADS = 256;
constexpr int FINISH_THREADS = 256;

template <typename T, bool PACKED>
__global__ void __launch_bounds__(PREP_THREADS)
    prep_kernel(const T* __restrict__ src, const T* __restrict__ b_src,
                const T* __restrict__ c_in, const int* __restrict__ mv_in,
                T* __restrict__ L, T* __restrict__ c_out,
                int* __restrict__ mv_out, int batch, int m, int b_pad,
                int m_pad, bool normalize, bool vec, T eps) {
  const long long groups = m_pad / 4;
  const long long g = (long long)blockIdx.x * PREP_THREADS + threadIdx.x;
  if (g >= (long long)b_pad * groups) return;
  const int p = (int)(g / groups);
  const int j = (int)(g - p * groups) * 4;
  T r0[4], r1[4], r2[4], r3[4];
  if (p < batch && vec && j + 4 <= m) {
    if constexpr (PACKED) {
      const T* s = src + (long long)p * 4 * m + j;
      load4(s, r0);
      load4(s + m, r1);
      load4(s + 2LL * m, r2);
      load4(s + 3LL * m, r3);
    } else {
      const long long k = (long long)p * m + j;
      T a[8];
      load4(src + 2 * k, a);
      load4(src + 2 * k + 4, a + 4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        r0[u] = a[2 * u];
        r1[u] = a[2 * u + 1];
        r3[u] = T(0);
      }
      load4(b_src + k, r2);
    }
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int h = j + u;
      r0[u] = T(0); r1[u] = T(0); r2[u] = T(1); r3[u] = T(0);
      if (p < batch && h < m) {
        if constexpr (PACKED) {
          const T* s = src + (long long)p * 4 * m + h;
          r0[u] = s[0];
          r1[u] = s[m];
          r2[u] = s[2LL * m];
          r3[u] = s[3LL * m];
        } else {
          const long long k = (long long)p * m + h;
          r0[u] = src[2 * k];
          r1[u] = src[2 * k + 1];
          r2[u] = b_src[k];
        }
      }
    }
  }
  if (normalize) {
    // A neutral column has zero norm: s = 1 leaves it as it is.
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const T s = norm_scale(r0[u], r1[u], eps);
      r0[u] *= s;
      r1[u] *= s;
      r2[u] *= s;
      if constexpr (PACKED) r3[u] *= s;
    }
  }
  T* out = L + (long long)p * 4 * m_pad + j;
  store4(out, r0);
  store4(out + m_pad, r1);
  store4(out + 2LL * m_pad, r2);
  store4(out + 3LL * m_pad, r3);
  if (j == 0) {
    const bool real = p < batch;
    c_out[2LL * p] = real ? c_in[2LL * p] : T(1);
    c_out[2LL * p + 1] = real ? c_in[2LL * p + 1] : T(0);
    mv_out[p] = real ? mv_in[p] : 0;
  }
}

template <typename T>
__global__ void __launch_bounds__(FINISH_THREADS)
    finish_kernel(const T* __restrict__ x, const int* __restrict__ feas,
                  const T* __restrict__ c, T* __restrict__ obj,
                  unsigned char* __restrict__ feasible, int batch) {
  const int i = blockIdx.x * FINISH_THREADS + threadIdx.x;
  if (i >= batch) return;
  const T p0 = c[2LL * i] * x[2LL * i];
  const T p1 = c[2LL * i + 1] * x[2LL * i + 1];
  obj[i] = (T(0) + p0) + p1;
  feasible[i] = feas[i] != 0 ? 1 : 0;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int prep(const void* src, const void* b, const void* c, const void* mv,
         void* L, void* c_out, void* mv_out, int batch, int m, int b_pad,
         int m_pad, int packed, int normalize, double eps, void* stream) {
  // Every problem's c and m_valid are written by its column group 0, so an
  // output with problems has columns.
  if (batch < 0 || m < 0 || b_pad < batch || m_pad < m || m_pad % 4 ||
      (b_pad > 0 && m_pad == 0) || (!packed && b == nullptr) ||
      !aligned16(L))
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)b_pad * (m_pad / 4);
  if (threads == 0) return (int)cudaSuccess;
  const long long blocks = (threads + PREP_THREADS - 1) / PREP_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(src) && (packed || aligned16(b)) &&
                   ((long long)m * (long long)sizeof(T)) % 16 == 0;
  auto kern = packed ? prep_kernel<T, true> : prep_kernel<T, false>;
  kern<<<dim3((unsigned)blocks), dim3(PREP_THREADS), 0,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(src), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const int*>(mv),
      static_cast<T*>(L), static_cast<T*>(c_out), static_cast<int*>(mv_out),
      batch, m, b_pad, m_pad, normalize != 0, vec, static_cast<T>(eps));
  return (int)cudaGetLastError();
}

template <typename T>
int finish(const void* x, const void* feas, const void* c, void* obj,
           void* feasible, int batch, void* stream) {
  if (batch < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  finish_kernel<T><<<dim3((unsigned)((batch + FINISH_THREADS - 1) /
                                     FINISH_THREADS)),
                     dim3(FINISH_THREADS), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int*>(feas),
      static_cast<const T*>(c), static_cast<T*>(obj),
      static_cast<unsigned char*>(feasible), batch);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each function enqueues one launch
// on `stream`, does not synchronise, allocates nothing, and returns a CUDA
// error code (0 on success): that of an argument it refuses, of the shared
// memory opt-in, or cudaGetLastError() after the launch.  `batch` must be a
// positive multiple of `tile`; `warps` is the CTA's warp count (1..8);
// `staged` != 0 selects the staged regime, and then `smem_bytes` must hold
// warps * (3 * m_pad * itemsize + 64) and L be 16-byte aligned.
extern "C" int rgb_launch_f32(const void* L, const void* c, const void* mv,
                              void* x, void* feas, int batch, int m_pad,
                              int tile, double M, int warps, int staged,
                              int smem_bytes, void* stream) {
  return launch<float>(L, c, mv, x, feas, batch, m_pad, tile, M, warps,
                       staged, smem_bytes, stream);
}

extern "C" int rgb_launch_f64(const void* L, const void* c, const void* mv,
                              void* x, void* feas, int batch, int m_pad,
                              int tile, double M, int warps, int staged,
                              int smem_bytes, void* stream) {
  return launch<double>(L, c, mv, x, feas, batch, m_pad, tile, M, warps,
                        staged, smem_bytes, stream);
}

extern "C" const char* rgb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The front end's passes, on `stream`, with the same conventions.  prep:
// `src` is A (batch, m, 2) with `b` (batch, m) when `packed` is 0, else
// L_in (batch, 4, m) with `b` unused; `c` (batch, 2), `mv` (batch,) int32;
// writes L (b_pad, 4, m_pad), c_out (b_pad, 2), mv_out (b_pad,) int32, with
// m_pad a multiple of 4 (of 128 on the solver's path) and L 16-byte
// aligned; normalises when `normalize` != 0.  finish: x (>= batch, 2), feas
// (>= batch,) int32 and c (>= batch, 2) in, objective (batch,) and feasible
// (batch,) as 0/1 bytes out.  Nothing is launched for an empty output; prep
// refuses problems without columns (m_pad == 0 < b_pad).
extern "C" int prep_launch_f32(const void* src, const void* b, const void* c,
                               const void* mv, void* L, void* c_out,
                               void* mv_out, int batch, int m, int b_pad,
                               int m_pad, int packed, int normalize,
                               double eps, void* stream) {
  return prep<float>(src, b, c, mv, L, c_out, mv_out, batch, m, b_pad, m_pad,
                     packed, normalize, eps, stream);
}

extern "C" int prep_launch_f64(const void* src, const void* b, const void* c,
                               const void* mv, void* L, void* c_out,
                               void* mv_out, int batch, int m, int b_pad,
                               int m_pad, int packed, int normalize,
                               double eps, void* stream) {
  return prep<double>(src, b, c, mv, L, c_out, mv_out, batch, m, b_pad, m_pad,
                      packed, normalize, eps, stream);
}

extern "C" int finish_launch_f32(const void* x, const void* feas,
                                 const void* c, void* obj, void* feasible,
                                 int batch, void* stream) {
  return finish<float>(x, feas, c, obj, feasible, batch, stream);
}

extern "C" int finish_launch_f64(const void* x, const void* feas,
                                 const void* c, void* obj, void* feasible,
                                 int batch, void* stream) {
  return finish<double>(x, feas, c, obj, feasible, batch, stream);
}
