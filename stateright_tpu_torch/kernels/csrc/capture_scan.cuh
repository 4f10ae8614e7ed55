// The sample capture shared by K9a (sample_capture.cu, the BFS step) and
// K13c (walk_capture.cu, the walk step): the threshold test and the
// order-preserving append of the captured candidates' lanes to the slab.
//
// Candidate i is captured iff sel[i] and (h1[i], h2[i]) < (t1, t2)
// lexicographically, compared UNSIGNED on the uint32 halves held in
// int64. The threshold comes by value, or, where `thresh` is not null,
// from thresh[0..1] on the card (the BFS era keeps it in its state
// vector, so a captured step reads the current one). The captured
// candidates take ranks 0, 1, ... in candidate order; those below
// step_cap are written, lane l from src[l][i] to
// dst[l][occupied + rank] (row scap, the trash row, for a row at or past
// scap), and the counters on the card advance by occupied += fit and
// dropped += n_c - fit, fit = min(n_c, step_cap). Nothing is written when
// nothing is captured.
//
// Two designs:
//
// `launch` (K13c): two launches over tiles of kTile candidates, one
// block a tile. Pass 1 counts each tile's captures into
// tile_cnt[tile] (and copies occupied to tile_cnt[tiles], so pass 2
// never reads a counter it writes). Pass 2 sums the counts of the tiles
// before its own, ranks its tile with a warp-shuffle scan (four
// consecutive candidates a thread) and a scan of the warp totals, and
// writes the rows; its last block advances the counters. The order is
// exact and deterministic, with no atomics deciding a rank.
//
// `launch_one` (K9a, solo and over every shard): ONE launch over (tile,
// lane). Each block tests its tile (sel, h1 and h2 loaded together: the
// pass is latency-bound) and ranks it (a scan of the threads' counts). A
// tile that captured publishes its count, its capture bits and each
// 32-candidate word's first rank in the tile; every block then adds one
// to its lane's ticket and its captures to the ticket's high word, in
// one atomic, so the last block knows the lane's captures at once. The
// common step after the first eras captures nothing: no block writes or
// fences, and the last one only resets the ticket. Otherwise the last
// block scans the lane's tile counts in order (zeroing them) and writes
// the rows of the tiles whose first rank is below step_cap from their
// bits, a thread a word, so nothing is tested twice and the ranks are the
// candidates' order; then it advances the counters and resets the
// ticket. The scratch is left as it was found, so a CUDA-graph replay
// needs no reset node.
//
// Bound on the card: bytes. sel once (1 byte a candidate), h1 and h2 of
// each selected candidate once (the one launch reads them for every
// candidate: a few hundred KB, for one round trip less), and each
// written row's other lanes read and every lane written once.

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

// K9a's one launch over (tile, lane): lane l's candidates i < n at
// sel / h1 / h2 + l * in_stride, its threshold at thresh + l *
// thresh_stride, source k's value at src[k] + l * src_stride[k] + i, its
// slab's lane k row r at dst[k] + l * dst_stride + r, its counters at
// counts + 2 * l.
constexpr int kOneLanes = 4;
constexpr int kWords = kTile / 32;  // a tile's capture bits, 32 candidates a word
constexpr int kUnroll = 4;          // words a thread of the last block loads at once

struct One {
  const bool* sel;
  const long long* h1;
  const long long* h2;
  long long n, in_stride;
  const long long* thresh;
  long long thresh_stride;
  const long long* src[kOneLanes];
  long long src_stride[kOneLanes];
  long long* dst[kOneLanes];
  long long dst_stride;
  long long scap, step_cap;
  long long* counts;              // [lanes, 2]: occupied, dropped
  unsigned long long* ticket;     // [lanes] arrived blocks | captures << 32; zero between launches
  int* tile_cnt;                  // [lanes, tiles]; zero between launches
  unsigned* bits;                 // [lanes, tiles, kWords] a capturing tile's capture bits
  int* word_rank;                 // [lanes, tiles, kWords] its words' first ranks in the tile
  int tiles;
};

// Whether candidate i is captured, with its three loads issued together
// (latency, not bytes, bounds this pass).
__device__ __forceinline__ bool below_eager(const bool* sel, const long long* h1,
                                            const long long* h2, long long i, long long n,
                                            uint32_t t1, uint32_t t2) {
  if (i >= n) return false;
  const bool s = sel[i];
  const uint32_t a = (uint32_t)h1[i];
  const uint32_t b = (uint32_t)h2[i];
  return s && (a < t1 || (a == t1 && b < t2));
}

__global__ void __launch_bounds__(kThreads) one_kernel(const __grid_constant__ One in) {
  __shared__ int warp_sum[kWarps];
  __shared__ bool last;
  __shared__ long long n_c, occ;
  __shared__ int n_work;
  __shared__ int work_tile[kThreads];
  __shared__ long long work_rank[kThreads];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long l = blockIdx.y;
  const bool* sel = in.sel + l * in.in_stride;
  const long long* h1 = in.h1 + l * in.in_stride;
  const long long* h2 = in.h2 + l * in.in_stride;
  const uint32_t t1 = (uint32_t)in.thresh[l * in.thresh_stride];
  const uint32_t t2 = (uint32_t)in.thresh[l * in.thresh_stride + 1];
  long long* cnt2 = in.counts + 2 * l;
  const long long occupied = threadIdx.x == 0 ? cnt2[0] : 0;  // read early; the last block uses it
  const long long first = (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  unsigned nib = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) nib |= (unsigned)below_eager(sel, h1, h2, first + k, in.n, t1, t2) << k;
  // The thread's rank in its tile: a scan of the nibbles' counts.
  const int cnt = __popc(nib);
  int x = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? warp_sum[w] : 0;
    total += warp_sum[w];
  }
  // A tile that captured publishes its count, its bits (eight threads'
  // nibbles a word of 32 candidates) and each word's first rank; one that
  // did not publishes nothing but its arrival.
  const unsigned group = 0xffu << (lane & ~7);
  const unsigned word = __reduce_or_sync(group, nib << ((lane & 7) * 4));
  if (total) {
    const long long slot = (l * in.tiles + blockIdx.x) * kWords + (threadIdx.x >> 3);
    if ((lane & 7) == 0) {
      in.bits[slot] = word;
      in.word_rank[slot] = before + x - cnt;
    }
    if (threadIdx.x == 0) in.tile_cnt[l * in.tiles + blockIdx.x] = total;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    // The ticket counts the arrivals in its low word and the captures in
    // its high one; only a block with something to publish needs the fence.
    if (total) __threadfence();
    const unsigned long long old = atomicAdd(&in.ticket[l], 1ull | (unsigned long long)total << 32);
    last = (old & 0xffffffffull) + 1 == (unsigned long long)in.tiles;
    n_c = (long long)(old >> 32) + total;
    occ = occupied;
  }
  __syncthreads();
  if (!last) return;
  if (n_c == 0) {  // the common step: nothing captured, nothing to advance
    if (threadIdx.x == 0) in.ticket[l] = 0;
    return;
  }
  __threadfence();

  // The lane's last block: the tiles' first ranks in order, kThreads
  // tiles a round (each count read is zeroed for the next launch); then
  // every word of the tiles that capture below step_cap, a thread a word,
  // each captured candidate written at its rank.
  volatile int* counts = in.tile_cnt + l * in.tiles;
  const volatile unsigned* bits = in.bits + l * in.tiles * kWords;
  const volatile int* word_rank = in.word_rank + l * in.tiles * kWords;
  long long carry = 0;
  for (int r0 = 0; r0 < in.tiles; r0 += kThreads) {
    const int j = r0 + threadIdx.x;
    const int v = j < in.tiles ? counts[j] : 0;
    if (v) counts[j] = 0;
    int y = v;  // inclusive scan in the warp, then over the warps
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int z = __shfl_up_sync(0xffffffffu, y, d);
      if (lane >= d) y += z;
    }
    __syncthreads();
    if (lane == 31) warp_sum[warp] = y;
    if (threadIdx.x == 0) n_work = 0;
    __syncthreads();
    long long pre = carry, round = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) pre += warp_sum[w];
      round += warp_sum[w];
    }
    const long long rank0 = pre + y - v;
    if (v > 0 && rank0 < in.step_cap) {
      const int k = atomicAdd(&n_work, 1);
      work_tile[k] = j;
      work_rank[k] = rank0;
    }
    __syncthreads();
    const int pairs = n_work * kWords;
    for (int p0 = threadIdx.x; p0 < pairs; p0 += kUnroll * kThreads) {
      unsigned m[kUnroll];  // a few words' loads in flight at once
      int wr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + u * kThreads;
        const long long at = p < pairs ? (long long)work_tile[p / kWords] * kWords + p % kWords : 0;
        m[u] = p < pairs ? bits[at] : 0u;
        wr[u] = p < pairs ? word_rank[at] : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + u * kThreads;
        const long long base = m[u] ? work_rank[p / kWords] + wr[u] : 0;
        for (unsigned b = m[u]; b; b &= b - 1) {
          const int k = __ffs(b) - 1;
          const long long rank = base + __popc(m[u] & ((1u << k) - 1u));
          if (rank >= in.step_cap) break;
          const long long i = (long long)work_tile[p / kWords] * kTile + (p % kWords) * 32 + k;
          const long long pos = occ + rank;
          const long long row = pos < in.scap ? pos : in.scap;
#pragma unroll
          for (int q = 0; q < kOneLanes; ++q)
            in.dst[q][l * in.dst_stride + row] = in.src[q][l * in.src_stride[q] + i];
        }
      }
    }
    carry += round;
  }
  if (threadIdx.x == 0) {
    const long long fit = carry < in.step_cap ? carry : in.step_cap;
    cnt2[0] = occ + fit;
    cnt2[1] += carry - fit;
    in.ticket[l] = 0;
  }
}

// Int32 words of launch_one's scratch for `lanes` lanes of n candidates:
// the tickets (two words each), the tile counts, the tiles' capture bits
// and word ranks (zeroed once).
inline long long one_scratch(long long lanes, long long n) {
  return lanes * (2 + tiles(n) * (1 + 2 * kWords));
}

inline int launch_one(One in, long long lanes, int* scratch, long long scratch_len,
                      cudaStream_t st) {
  if (in.n < 0 || in.scap < 1 || in.step_cap < 0 || lanes < 1 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  if (in.n == 0) return (int)cudaSuccess;
  const long long grid = tiles(in.n);
  if (scratch == nullptr || (reinterpret_cast<uintptr_t>(scratch) & 7) != 0 ||
      scratch_len < one_scratch(lanes, in.n) || grid > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  in.tiles = (int)grid;
  in.ticket = (unsigned long long*)scratch;
  in.tile_cnt = scratch + 2 * lanes;
  in.bits = (unsigned*)(in.tile_cnt + lanes * grid);
  in.word_rank = (int*)in.bits + lanes * grid * kWords;
  one_kernel<<<dim3((unsigned)grid, (unsigned)lanes), kThreads, 0, st>>>(in);
  return (int)cudaGetLastError();
}

}  // namespace capture
