// RGB batch 2-D LP solver for Hopper (sm_90a): Seidel's randomised
// incremental algorithm, one warp per problem.
//
// Replaces the TPU kernel src/repro/kernels/batch_lp.py::_rgb_kernel
// (launched by rgb_pallas).  Same function: packed constraints
// L (B, 4, m_pad) with rows (a_x, a_y, b, 0), objectives c (B, 2), valid
// counts m_valid (B, 1) int32  ->  x (B, 2), feas (B, 1) int32.
//
// What bounds it on this card: bytes, nominally — every constraint is read
// at least once (3 * m_pad * itemsize per problem) and the arithmetic per
// constraint is a handful of multiplies.  In practice the incremental loop
// is a dependency chain (the test of constraint i needs the optimum after
// constraint i-1), so a naive port is bound by load latency, not by
// bandwidth.  What the design does about that:
//
//  * One CTA owns `tile` problems and its warps walk them, one warp per
//    problem at a time, so thousands of independent chains are in flight
//    and the memory system stays busy.
//  * The membership test runs 32 constraints at a time: lane l loads
//    column i0+l (one coalesced read of each of the three rows — row 3 of
//    L is never touched) and tests it against the current optimum.  The
//    optimum only changes at a violation, so "first violated lane of the
//    ballot" is exactly the constraint the sequential algorithm would stop
//    at; after its re-solve the lanes above it are re-tested against the
//    new optimum.  The test is warp-uniform, so skipping the re-solve is a
//    plain branch per problem (the TPU kernel needed a tile-wide
//    predicate).
//  * The O(i) re-solve strides the lanes over the prior constraints h < i
//    (coalesced along the minor axis, served from L1/L2 after the first
//    pass) and folds t_lo / t_hi with __shfl_xor_sync max/min and the
//    parallel-infeasible flag with __any_sync — the paper's atomicMin /
//    atomicMax, contention-free.  The four box faces are applied in closed
//    form afterwards.
//  * chunk == 0 scans all m_pad columns under the mask h < i (the dense
//    re-solve); chunk > 0 scans only ceil(i / chunk) * chunk columns.  The
//    mask is the same, so both give the same bits.
//
// Numerics: every epsilon and M are cast to T once (a double literal would
// promote float comparisons and move ties); `big` is the type's finite max,
// not infinity; division is IEEE.  The library is built without fast-math
// and with --fmad=false, so each product and sum rounds on its own exactly
// as the plain PyTorch version's separate ops do.
//
// m_valid is clamped to [0, m_pad] here: checking it on the host would cost
// a device synchronisation per launch.  (The reference clamps the column
// index of its dynamic slice instead; for valid inputs both are no-ops.)
//
// wgmma, TMA, shared-memory staging and persistent CTAs are not used: the
// kernel does no matrix product, and staging is left for a later redesign.

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr unsigned FULL = 0xffffffffu;

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

template <typename T>
__global__ void rgb_kernel(const T* __restrict__ L, const T* __restrict__ c,
                           const int* __restrict__ mv, T* __restrict__ x_out,
                           int* __restrict__ feas_out, int tile, int m_pad,
                           int chunk, T M) {
  const T EPS_DENOM = T(1e-7);
  const T EPS_FEAS = T(1e-5);
  const T EPS_TIE = T(1e-9);
  const T big = Lim<T>::big();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long tile0 = (long long)blockIdx.x * tile;

  for (int p = warp; p < tile; p += nwarps) {
    const long long bi = tile0 + p;
    const T* __restrict__ ax = L + bi * 4 * (long long)m_pad;
    const T* __restrict__ ay = ax + m_pad;
    const T* __restrict__ bb = ay + m_pad;

    const T cx = c[2 * bi], cy = c[2 * bi + 1];
    const T cpx = -cy, cpy = cx;  // perpendicular (tie-break) objective
    T x0 = sign_tb(cx, cpx, EPS_TIE) * M;
    T x1 = sign_tb(cy, cpy, EPS_TIE) * M;
    bool feas = true;

    int m = mv[bi];
    m = m < 0 ? 0 : (m > m_pad ? m_pad : m);

    for (int i0 = 0; i0 < m && feas; i0 += 32) {
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

        // sigma bounds over prior constraints h < ii (paper eqs. 3-4).
        T t_lo = -big, t_hi = big;
        bool bad = false;
        const int limit =
            chunk > 0 ? ((ii + chunk - 1) / chunk) * chunk : m_pad;
        for (int h = lane; h < limit; h += 32) {
          const T axh = ax[h], ayh = ay[h], bh = bb[h];
          const T denom = axh * ux + ayh * uy;
          const T num = bh - (axh * p0x + ayh * p0y);
          const bool is_par = absT(denom) <= EPS_DENOM;
          const T t = num / (is_par ? T(1) : denom);  // guarded divide
          const bool mask = h < ii;
          if (mask && denom > EPS_DENOM) t_hi = minT(t_hi, t);
          if (mask && denom < -EPS_DENOM) t_lo = maxT(t_lo, t);
          bad = bad || (mask && is_par && num < -EPS_FEAS);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          t_hi = minT(t_hi, __shfl_xor_sync(FULL, t_hi, off));
          t_lo = maxT(t_lo, __shfl_xor_sync(FULL, t_lo, off));
        }
        bad = __any_sync(FULL, bad);

        // The four box faces, in closed form (every lane, uniformly).
        const T bds[4] = {ux, -ux, uy, -uy};
        const T bns[4] = {M - p0x, M + p0x, M - p0y, M + p0y};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const T bd = bds[k], bn = bns[k];
          if (bd > EPS_DENOM) t_hi = minT(t_hi, bn / bd);
          if (bd < -EPS_DENOM) t_lo = maxT(t_lo, bn / bd);
          bad = bad || (absT(bd) <= EPS_DENOM && bn < -EPS_FEAS);
        }
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

    if (lane == 0) {
      x_out[2 * bi] = x0;
      x_out[2 * bi + 1] = x1;
      feas_out[bi] = feas ? 1 : 0;
    }
  }
}

template <typename T>
int launch(const void* L, const void* c, const void* mv, void* x, void* feas,
           int batch, int m_pad, int tile, int chunk, double M, int warps,
           void* stream) {
  const dim3 grid((unsigned)(batch / tile));
  const dim3 block((unsigned)(warps * 32));
  rgb_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(L), static_cast<const T*>(c),
      static_cast<const int*>(mv), static_cast<T*>(x),
      static_cast<int*>(feas), tile, m_pad, chunk, static_cast<T>(M));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each function enqueues one launch
// on `stream`, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success).  `batch` must be a positive multiple of
// `tile`; `warps` is the CTA's warp count (1..32).
extern "C" int rgb_launch_f32(const void* L, const void* c, const void* mv,
                              void* x, void* feas, int batch, int m_pad,
                              int tile, int chunk, double M, int warps,
                              void* stream) {
  return launch<float>(L, c, mv, x, feas, batch, m_pad, tile, chunk, M, warps,
                       stream);
}

extern "C" int rgb_launch_f64(const void* L, const void* c, const void* mv,
                              void* x, void* feas, int batch, int m_pad,
                              int tile, int chunk, double M, int warps,
                              void* stream) {
  return launch<double>(L, c, mv, x, feas, batch, m_pad, tile, chunk, M,
                        warps, stream);
}

extern "C" const char* rgb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
