// K9a: bottom-k sample capture, one launch after the visited-set insert.
//
// Replaces the capture of stateright_tpu/engines/tpu_bfs.py:506-549
// (`below` and `_capture`, under the `lax.cond` at :547). It fuses:
//   1. the threshold test: candidate i is captured iff it was newly
//      inserted (is_new[i]) and its fingerprint is below the host
//      threshold, (h1, h2) < (t1, t2) lexicographically, compared
//      UNSIGNED on the uint32 halves held in int64 lanes;
//   2. an order-preserving compaction of those candidates to
//      step_cap (= DEVICE_STEP_CAP, 512) slots, in candidate order, as
//      `vs._compact_ids(below, DEVICE_STEP_CAP)` orders them;
//   3. the append of (h1, h2, depth, action) at slab row occupied + rank,
//      for ranks below step_cap; a row at or past scap goes to the trash
//      row scap (the slab lanes are scap + 1 long);
//   4. the counter update on the card: occupied += fit and
//      dropped += n_c - fit, with fit = min(n_c, step_cap).
// When nothing is below the threshold it writes no slab row (the JAX
// `lax.cond` skips the capture then).
//
// counts[0] = occupied, counts[1] = dropped (int64, on the card), so the
// host loop reads the occupancy in the counts vector it already reads
// once per step.
//
// Bound on the card: bytes. is_new is read once (1 byte a candidate),
// h1 and h2 once for each new candidate (16 bytes), and each captured row
// moves 4 x 8 bytes. Design: ONE block of 1024 threads walks the batch in
// tiles of 4096 (four consecutive candidates a thread), ranks the
// captured ones with a warp-shuffle scan and a scan of the 32 warp totals,
// and carries the running rank across tiles in shared memory — an exact,
// deterministic order with no atomics, at the price of one SM for a
// batch of a few tens of thousands (a later PR can split it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    capture_kernel(const bool* __restrict__ is_new,
                   const long long* __restrict__ h1,
                   const long long* __restrict__ h2,
                   const long long* __restrict__ depth,
                   const long long* __restrict__ act, long long n,
                   uint32_t t1, uint32_t t2, long long* __restrict__ sfp1,
                   long long* __restrict__ sfp2, long long* __restrict__ sdep,
                   long long* __restrict__ sact, long long scap,
                   long long* __restrict__ counts, long long step_cap) {
  __shared__ int warp_off[kWarps];
  __shared__ int tile_total;
  __shared__ long long running;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long occ = counts[0];
  if (threadIdx.x == 0) running = 0;
  __syncthreads();
  for (long long base = 0; base < n; base += kTile) {
    const long long first = base + (long long)threadIdx.x * kItems;
    bool flag[kItems];
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      long long i = first + k;
      bool f = false;
      if (i < n && is_new[i]) {
        uint32_t a = (uint32_t)h1[i];
        uint32_t b = (uint32_t)h2[i];
        f = (a < t1) || (a == t1 && b < t2);
      }
      flag[k] = f;
      cnt += f;
    }
    int x = cnt;  // inclusive scan of the per-thread counts in the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_off[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int v = warp_off[lane];
      int s = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        int y = __shfl_up_sync(0xffffffffu, s, d);
        if (lane >= d) s += y;
      }
      warp_off[lane] = s - v;  // exclusive
      if (lane == 31) tile_total = s;
    }
    __syncthreads();
    long long rank = running + warp_off[warp] + (x - cnt);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (!flag[k]) continue;
      if (rank < step_cap) {
        long long i = first + k;
        long long pos = occ + rank;
        long long w = pos < scap ? pos : scap;
        sfp1[w] = h1[i];
        sfp2[w] = h2[i];
        sdep[w] = depth[i];
        sact[w] = act[i];
      }
      ++rank;
    }
    __syncthreads();
    if (threadIdx.x == 0) running += tile_total;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long n_c = running;
    long long fit = n_c < step_cap ? n_c : step_cap;
    counts[0] = occ + fit;
    counts[1] += n_c - fit;
  }
}

}  // namespace

// The slab lanes hold scap + 1 int64 rows; counts is int64[2].
extern "C" int srt_sample_capture(const void* is_new, const void* h1,
                                  const void* h2, const void* depth,
                                  const void* act, long long n,
                                  unsigned long long t1, unsigned long long t2,
                                  void* sfp1, void* sfp2, void* sdep,
                                  void* sact, long long scap, void* counts,
                                  long long step_cap, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  capture_kernel<<<1, kThreads, 0, st>>>(
      (const bool*)is_new, (const long long*)h1, (const long long*)h2,
      (const long long*)depth, (const long long*)act, n, (uint32_t)t1,
      (uint32_t)t2, (long long*)sfp1, (long long*)sfp2, (long long*)sdep,
      (long long*)sact, scap, (long long*)counts, step_cap);
  return (int)cudaGetLastError();
}
