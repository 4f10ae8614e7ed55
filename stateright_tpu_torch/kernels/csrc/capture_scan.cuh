// The sample capture shared by K9a (sample_capture.cu, the BFS step) and
// K13c (walk_capture.cu, the walk step): the threshold test and the
// order-preserving append of the captured candidates' lanes to the slab.
//
// Candidate i is captured iff sel[i] and (h1[i], h2[i]) < (t1, t2)
// lexicographically, compared UNSIGNED on the uint32 halves held in
// int64. The threshold comes by value, or, where `thresh` is not null,
// from thresh[0..1] on the card (the BFS era keeps it in its state
// vector, so a captured step reads the current one). The captured candidates take ranks 0, 1, ... in candidate order;
// those below step_cap are written, lane l from src[l][i] to
// dst[l][occupied + rank] (row scap, the trash row, for a row at or past
// scap), and the counters on the card advance by occupied += fit and
// dropped += n_c - fit, fit = min(n_c, step_cap). Nothing is written when
// nothing is captured.
//
// Design: two launches over tiles of kTile candidates, one block a tile,
// so the scan spreads over the SMs. Pass 1 counts each tile's captures
// into tile_cnt[tile] (and copies occupied to tile_cnt[tiles], so pass 2
// never reads a counter it writes). Pass 2 sums the counts of the tiles
// before its own, ranks its tile with a warp-shuffle scan (four
// consecutive candidates a thread) and a scan of the warp totals, and
// writes the rows; its last block advances the counters. The order is
// exact and deterministic, with no atomics.
//
// Bound on the card: bytes. sel once (1 byte a candidate), h1 and h2 of
// each selected candidate once, and each written row's other lanes read
// and every lane written once; the two passes read sel, h1 and h2 twice,
// which costs less than a second launch does at these batch sizes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace capture {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = 40;

// The lanes of a slab row: dst[l][row] = src[l][candidate], l < n.
struct Lanes {
  const long long* src[kMaxLanes];
  long long* dst[kMaxLanes];
  int n;
};

__device__ __forceinline__ bool below(const bool* __restrict__ sel,
                                      const long long* __restrict__ h1,
                                      const long long* __restrict__ h2,
                                      long long i, long long n, uint32_t t1,
                                      uint32_t t2) {
  if (i >= n || !sel[i]) return false;
  const uint32_t a = (uint32_t)h1[i];
  const uint32_t b = (uint32_t)h2[i];
  return a < t1 || (a == t1 && b < t2);
}

__device__ __forceinline__ void load_threshold(const long long* thresh, uint32_t& t1,
                                               uint32_t& t2) {
  if (thresh != nullptr) {
    t1 = (uint32_t)thresh[0];
    t2 = (uint32_t)thresh[1];
  }
}

__global__ void __launch_bounds__(kThreads)
    count_kernel(const bool* __restrict__ sel, const long long* __restrict__ h1,
                 const long long* __restrict__ h2, long long n, uint32_t t1,
                 uint32_t t2, const long long* __restrict__ thresh,
                 const long long* __restrict__ occ,
                 long long* __restrict__ tile_cnt) {
  __shared__ int warp_sum[kWarps];
  load_threshold(thresh, t1, t2);
  const long long first = (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) cnt += below(sel, h1, h2, first + k, n, t1, t2);
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_sum[w];
    tile_cnt[blockIdx.x] = s;
    if (blockIdx.x == 0) tile_cnt[gridDim.x] = *occ;
  }
}

__global__ void __launch_bounds__(kThreads)
    write_kernel(const bool* __restrict__ sel, const long long* __restrict__ h1,
                 const long long* __restrict__ h2, long long n, uint32_t t1,
                 uint32_t t2, const long long* __restrict__ thresh,
                 const __grid_constant__ Lanes lanes, long long scap,
                 const long long* __restrict__ tile_cnt,
                 long long* __restrict__ occ, long long* __restrict__ dropped,
                 long long step_cap) {
  __shared__ long long warp_part[kWarps];
  __shared__ int warp_off[kWarps];
  __shared__ long long tile_base;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  load_threshold(thresh, t1, t2);

  // This tile's first rank: the captures of the tiles before it.
  long long part = 0;
  for (long long j = threadIdx.x; j < blockIdx.x; j += kThreads) part += tile_cnt[j];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) part += __shfl_down_sync(0xffffffffu, part, d);
  if (lane == 0) warp_part[warp] = part;

  const long long first = (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  bool flag[kItems];
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    flag[k] = below(sel, h1, h2, first + k, n, t1, t2);
    cnt += flag[k];
  }
  int x = cnt;  // inclusive scan of the per-thread counts in the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_off[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long base = 0;
    int s = 0;
    for (int w = 0; w < kWarps; ++w) {
      base += warp_part[w];
      const int v = warp_off[w];
      warp_off[w] = s;  // exclusive
      s += v;
    }
    tile_base = base;
  }
  __syncthreads();
  const long long occupied = tile_cnt[gridDim.x];
  long long rank = tile_base + warp_off[warp] + (x - cnt);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (!flag[k]) continue;
    if (rank < step_cap) {
      const long long i = first + k;
      const long long pos = occupied + rank;
      const long long row = pos < scap ? pos : scap;
      for (int l = 0; l < lanes.n; ++l) lanes.dst[l][row] = lanes.src[l][i];
    }
    ++rank;
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    const long long n_c = tile_base + tile_cnt[blockIdx.x];
    const long long fit = n_c < step_cap ? n_c : step_cap;
    *occ = occupied + fit;
    if (dropped != nullptr) *dropped += n_c - fit;
  }
}

// Launches both passes on `st`; scratch holds at least tiles(n) + 1 int64.
inline long long tiles(long long n) { return (n + kTile - 1) / kTile; }

inline int launch(const bool* sel, const long long* h1, const long long* h2,
                  long long n, uint32_t t1, uint32_t t2, const long long* thresh,
                  const Lanes& lanes,
                  long long scap, long long* occ, long long* dropped,
                  long long step_cap, long long* scratch, long long scratch_len,
                  cudaStream_t st) {
  if (n < 0 || scap < 1 || step_cap < 0 || lanes.n < 1 || lanes.n > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const long long grid = tiles(n);
  if (scratch_len < grid + 1 || grid > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  count_kernel<<<(unsigned)grid, kThreads, 0, st>>>(sel, h1, h2, n, t1, t2, thresh, occ,
                                                    scratch);
  write_kernel<<<(unsigned)grid, kThreads, 0, st>>>(sel, h1, h2, n, t1, t2, thresh, lanes, scap,
                                                    scratch, occ, dropped, step_cap);
  return (int)cudaGetLastError();
}

}  // namespace capture
