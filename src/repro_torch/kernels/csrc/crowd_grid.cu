// The crowd's neighbour query for Hopper (sm_90a): each agent's k nearest
// agents within a radius, scanned from the agents sorted by grid cell, one
// thread an agent, the k best kept in registers.
//
// Replaces no TPU kernel: the crowd (src/repro_torch/crowd/) exists only in
// the port, and the JAX package has no neighbour search.  It replaces the
// torch operations of crowd/grid.py's plain version on the card: the capped
// gather of the first `capacity` agents of each of the nine cells around an
// agent, the (N, 9 capacity) distance, mask and key tensors and their top-k,
// and the exact second pass, a (fallback, N) search and its top-k, which ran
// every step.  The binning, the stable sort by cell, the counts a cell and
// their exclusive cumsum stay torch operations before it.
//
// What bounds it on this card: bytes, nominally and far below anything it
// can reach.  At 16,384 agents it reads the positions, the sort order, the
// cells (8 + 8 + 8 B an agent) and the grid's starts and counts (16 B a
// cell) once, and writes 9 B a slot and 8 B an agent: ~2.2 MB, under 1 us at
// 3.35 TB/s.  The ~150 candidates an agent are 2.4 M distances, a few
// microseconds of arithmetic.  So it is bound by latency and the launch: one
// launch a step where the plain version made ~60, and with one thread an
// agent only ~4 warps an SM, each walking a chain of dependent loads (a
// candidate's index, then its position).  What the design does about that:
//
//  * Thread t takes the t-th agent in cell order, so the lanes of a warp
//    belong to one or two cells and scan the same candidates: their loads
//    are broadcasts from L1, and the ~0.4 MB of positions and order stay in
//    L2.
//  * Cells are numbered y * G + x, so the three cells of one grid row around
//    an agent are one contiguous run of the sorted agents: three ranges a
//    thread, not nine.  Every agent of each range is tested: there is no
//    capacity, so no second pass and no agent left unplaced.
//  * Candidates are loaded four at a time (their indices, then their
//    positions) before any is tested, so the loads of a batch overlap.
//  * The k best keys live in registers: KMAX = 16 slots, the last k used
//    (k <= 16; the crowd keeps RVO2's 10), so that a fully unrolled
//    insertion indexes only constants; a candidate no better than the k-th
//    is rejected with one compare.
//
// Results equal the plain version's in every bit where it places every
// agent: the same key and the same arithmetic.  d = p_j - p_i in float32,
// d2 = dx * dx + dy * dy with each product and the sum rounded on their own
// (__fmul_rn, __fadd_rn: no contraction into an FMA, as torch's separate
// multiply and add round it); a candidate is kept where j != i and
// d2 < dist^2 (dist^2 rounded to float32, as torch rounds the scalar); keys
// order by the bits of d2 (non-negative floats order as their bit patterns),
// then by j; the nearest is written first, slots are filled from the front,
// an empty slot has idx 0 and valid 0.  The order in which candidates are
// scanned cannot change the result: the keys are distinct.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
// Candidates loaded before any of them is tested.
constexpr int BATCH = 4;
// Slots of the register array: the most neighbours a launch keeps.
constexpr int KMAX = 16;
// Sorts after every real key: a slot with no neighbour in it.
constexpr unsigned long long NONE = ~0ull;

__global__ void __launch_bounds__(THREADS)
    neighbours_kernel(const float2* __restrict__ pos,
                      const long long* __restrict__ order,
                      const long long* __restrict__ cell,
                      const long long* __restrict__ start,
                      const long long* __restrict__ counts,
                      long long* __restrict__ idx,
                      unsigned char* __restrict__ valid,
                      long long* __restrict__ count, int n, int g, int k,
                      float lim) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= n) return;
  const long long i = order[t];
  const float2 p = pos[i];
  const long long c = cell[i];
  const int cx = (int)(c % g), cy = (int)(c / g);
  const int x0 = max(cx - 1, 0), x1 = min(cx + 1, g - 1);
  const int y0 = max(cy - 1, 0), y1 = min(cy + 1, g - 1);

  // The k best, ascending, in the last k slots; the KMAX - k slots before
  // them hold 0, which no insertion moves (a key is never below 0).  So the
  // worst kept key is always best[KMAX - 1] and every index is a constant.
  unsigned long long best[KMAX];
#pragma unroll
  for (int s = 0; s < KMAX; ++s) best[s] = s < KMAX - k ? 0ull : NONE;

  for (int y = y0; y <= y1; ++y) {
    const long long row = (long long)y * g;
    const long long lo = start[row + x0];
    const long long hi = start[row + x1] + counts[row + x1];
    for (long long s0 = lo; s0 < hi; s0 += BATCH) {
      long long js[BATCH];
      float2 q[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        js[u] = s0 + u < hi ? order[s0 + u] : -1;
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        q[u] = js[u] >= 0 ? pos[js[u]] : p;
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const long long j = js[u];
        const float dx = __fsub_rn(q[u].x, p.x);
        const float dy = __fsub_rn(q[u].y, p.y);
        const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        if (j < 0 || j == i || !(d2 < lim)) continue;
        const unsigned long long key =
            ((unsigned long long)__float_as_uint(d2) << 32) |
            (unsigned long long)j;
        if (key >= best[KMAX - 1]) continue;
        // Insert, the worst falling out: each slot above the key takes the
        // one below it, or the key.
#pragma unroll
        for (int s = KMAX - 1; s > 0; --s) {
          if (best[s] > key) best[s] = best[s - 1] > key ? best[s - 1] : key;
        }
        if (best[0] > key) best[0] = key;
      }
    }
  }

  long long filled = 0;
  const long long row0 = i * k - (KMAX - k);   // slot KMAX - k is column 0
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    if (s >= KMAX - k) {
      const bool v = best[s] != NONE;
      idx[row0 + s] = v ? (long long)(best[s] & 0xffffffffull) : 0;
      valid[row0 + s] = v ? 1 : 0;
      filled += v ? 1 : 0;
    }
  }
  count[i] = filled;
}

}  // namespace

// Plain C interface (loaded with ctypes).  Enqueues one launch on `stream`,
// does not synchronise, allocates nothing, and returns a CUDA error code (0
// on success): cudaErrorInvalidValue for an argument it refuses, else
// cudaGetLastError() after the launch.  pos (n, 2) float32, 8-byte aligned;
// order (n,) int64, the agents sorted by cell; cell (n,) int64, each agent's
// cell y * g + x in [0, g * g); start and counts (g * g,) int64, the first
// sorted position and the agents of each cell; out idx (n, k) int64, valid
// (n, k) as 0/1 bytes, count (n,) int64.  `lim` is dist^2, rounded to
// float32 here; 1 <= k <= 16.  Nothing is launched for n == 0.
extern "C" int crowd_neighbours_launch_f32(
    const void* pos, const void* order, const void* cell, const void* start,
    const void* counts, void* idx, void* valid, void* count, int n, int g,
    int k, double lim, void* stream) {
  if (n < 0 || g < 1 || k < 1 || k > KMAX ||
      reinterpret_cast<uintptr_t>(pos) % 8)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const long long blocks = ((long long)n + THREADS - 1) / THREADS;
  neighbours_kernel<<<dim3((unsigned)blocks), dim3(THREADS), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(pos), static_cast<const long long*>(order),
      static_cast<const long long*>(cell),
      static_cast<const long long*>(start),
      static_cast<const long long*>(counts), static_cast<long long*>(idx),
      static_cast<unsigned char*>(valid), static_cast<long long*>(count), n,
      g, k, static_cast<float>(lim));
  return (int)cudaGetLastError();
}

extern "C" const char* crowd_grid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
