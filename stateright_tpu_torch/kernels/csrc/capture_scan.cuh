// The sample capture shared by K9a (sample_capture.cu, the BFS step, solo
// and over every shard) and K13c (walk_capture.cu, the walk step): the
// threshold test and the order-preserving append of the captured
// candidates' lanes to the slab, in ONE launch over (tile, lane).
//
// Candidate i of lane l is captured iff sel[i] and (h1[i], h2[i]) < (t1,
// t2) lexicographically, compared UNSIGNED on the uint32 halves held in
// int64, the threshold read on the card from thresh[0..1] (an era's
// state vector holds it, so a captured step reads the current one). The
// captured candidates take ranks 0, 1, ... in candidate order; those
// below step_cap are written, lane k from src[k][i] to dst[k][occupied +
// rank] (row scap, the trash row, for a row at or past scap), and the
// counters on the card advance by occupied += fit and, where a dropped
// counter is given, dropped += n_c - fit, fit = min(n_c, step_cap).
// Nothing is written when nothing is captured.
//
// Each block takes its tile from its lane's tile counter (an atomic: the
// hardware does not promise to start blocks in index order), tests its
// tile of kTile candidates (sel, h1 and h2 loaded together: the pass is
// latency-bound), ranks it (a scan of the threads' counts) and publishes
// its count at once in its status word (a ready bit and the count). A
// tile that captured then sums the status words of the lane's earlier
// tiles (a look-back over every one at once, each thread spinning on its
// own) for its first rank, and writes its own rows: a thread a (lane,
// capture) pair, the pairs' loads issued kUnroll at a time, consecutive
// threads on consecutive captures of one lane. Every wait ends: a block
// that holds tile t took it after the blocks that hold tiles 0..t-1 took
// theirs, so those are running, and each publishes before it waits.
// Every block adds one to its lane's ticket and its captures to the
// ticket's high word, in one atomic after a fence; the lane's last block
// clears the status words and the tile counter, advances the counters
// and resets the ticket. The scratch is left as it was found (zero), so
// a CUDA-graph replay needs no reset node. The common step after the
// first eras captures nothing: no block looks back or writes a row.
//
// Bound on the card: bytes. sel once (1 byte a candidate), h1 and h2 of
// each selected candidate once (the one launch reads them for every
// candidate: a few hundred KB, for one round trip less), and each
// written row's other lanes read and every lane written once. The rows
// of a step that captures many (the first step of a run, threshold MAX)
// are written by every capturing block, each its own.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace capture {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = 40;
constexpr int kUnroll = 8;               // (lane, capture) pairs a thread loads at once
constexpr unsigned kReady = 0x80000000u;  // a status word's ready bit (the count below it)

inline long long tiles(long long n) { return (n + kTile - 1) / kTile; }

// One launch over (tile, lane) of `lanes` lanes: lane l's candidates i <
// n at sel / h1 / h2 + l * in_stride, its threshold at thresh + l *
// thresh_stride, source k's value at src[k] + l * src_stride[k] + i, its
// slab's lane k row r at dst[k] + l * dst_stride + r (k < n_lanes <=
// kMaxLanes), its counters at occ / dropped + l * count_stride.
struct One {
  const bool* sel;
  const long long* h1;
  const long long* h2;
  long long n, in_stride;
  const long long* thresh;
  long long thresh_stride;
  const long long* src[kMaxLanes];
  long long src_stride[kMaxLanes];
  long long* dst[kMaxLanes];
  long long dst_stride;
  int n_lanes;
  long long scap, step_cap;
  long long* occ;                 // occupied
  long long* dropped;             // dropped, or null: nothing can drop (step_cap >= n)
  long long count_stride;
  unsigned long long* ticket;     // [lanes] arrived blocks | captures << 32; zero between launches
  unsigned* next;                 // [lanes] tiles taken; zero between launches
  unsigned* status;               // [lanes, tiles] kReady | a tile's count; zero between launches
  int tiles;
};

// Whether candidate i is captured, with its three loads issued together
// (latency, not bytes, bounds this pass).
__device__ __forceinline__ bool below(const bool* sel, const long long* h1, const long long* h2,
                                      long long i, long long n, uint32_t t1, uint32_t t2) {
  if (i >= n) return false;
  const bool s = sel[i];
  const uint32_t a = (uint32_t)h1[i];
  const uint32_t b = (uint32_t)h2[i];
  return s && (a < t1 || (a == t1 && b < t2));
}

__global__ void __launch_bounds__(kThreads) one_kernel(const __grid_constant__ One in) {
  __shared__ int warp_sum[kWarps];
  __shared__ long long before_sum[kWarps];
  __shared__ short order[kTile];  // the tile's captures, by rank: their offsets in the tile
  __shared__ bool last;
  __shared__ long long occ;
  __shared__ int tile_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long l = blockIdx.y;
  const bool* sel = in.sel + l * in.in_stride;
  const long long* h1 = in.h1 + l * in.in_stride;
  const long long* h2 = in.h2 + l * in.in_stride;
  const uint32_t t1 = (uint32_t)in.thresh[l * in.thresh_stride];
  const uint32_t t2 = (uint32_t)in.thresh[l * in.thresh_stride + 1];
  long long* occ_l = in.occ + l * in.count_stride;
  unsigned* status = in.status + l * in.tiles;
  if (threadIdx.x == 0) {
    tile_s = (int)atomicAdd(in.next + l, 1u);
    occ = *occ_l;  // read before the ticket: the last block advances it
  }
  __syncthreads();
  const int tile = tile_s;
  const int c0 = threadIdx.x * kItems;
  const long long first = (long long)tile * kTile + c0;
  unsigned nib = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) nib |= (unsigned)below(sel, h1, h2, first + k, in.n, t1, t2) << k;
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
  // Publish at once: a later tile may be waiting for this count.
  if (threadIdx.x == 0) *(volatile unsigned*)(status + tile) = kReady | (unsigned)total;
  long long base = 0;  // the tile's first rank in the lane
  if (total) {
    int r = before + x - cnt;
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if ((nib >> k) & 1u) order[r++] = (short)(c0 + k);
    // The look-back: every earlier tile's count at once, a thread a tile.
    long long mine = 0;
    for (int j = threadIdx.x; j < tile; j += kThreads) {
      unsigned s;
      do {
        s = *(volatile unsigned*)(status + j);
      } while (!(s & kReady));
      mine += s & ~kReady;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) mine += __shfl_xor_sync(0xffffffffu, mine, d);
    if (lane == 0) before_sum[warp] = mine;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) base += before_sum[w];
  }
  if (threadIdx.x == 0) {
    // Every status word this block reads or writes is done with before
    // its arrival: the lane's last block clears them after the last one.
    __threadfence();
    const unsigned long long old = atomicAdd(&in.ticket[l], 1ull | (unsigned long long)total << 32);
    last = (old & 0xffffffffull) + 1 == (unsigned long long)in.tiles;
    if (last) {
      const long long n_c = (long long)(old >> 32) + total;
      const long long fit = n_c < in.step_cap ? n_c : in.step_cap;
      if (n_c) {
        *occ_l = occ + fit;
        if (in.dropped != nullptr) in.dropped[l * in.count_stride] += n_c - fit;
      }
      in.ticket[l] = 0;
      in.next[l] = 0;  // every block of the lane took its tile before it arrived
    }
  }
  // The tile's rows below step_cap: a thread a (lane, capture) pair.
  const long long room = in.step_cap - base;
  const int rows = room <= 0 ? 0 : (room < total ? (int)room : total);
  const int pairs = rows * in.n_lanes;
  const long long tile0 = (long long)tile * kTile;
  for (int p0 = threadIdx.x; p0 < pairs; p0 += kUnroll * kThreads) {
    long long v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u * kThreads;
      const int q = p / rows;
      v[u] = p < pairs ? in.src[q][l * in.src_stride[q] + tile0 + order[p - q * rows]] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u * kThreads;
      if (p >= pairs) break;
      const int q = p / rows;
      const long long pos = occ + base + (p - q * rows);
      in.dst[q][l * in.dst_stride + (pos < in.scap ? pos : in.scap)] = v[u];
    }
  }
  __syncthreads();
  if (last)
    for (int j = threadIdx.x; j < in.tiles; j += kThreads) status[j] = 0;
}

// Int32 words of the scratch for `lanes` lanes of n candidates: the
// tickets (two words each), the tile counters, then the tiles' status
// words.
inline long long one_scratch(long long lanes, long long n) { return lanes * (3 + tiles(n)); }

inline int launch_one(One in, long long lanes, int* scratch, long long scratch_len,
                      cudaStream_t st) {
  if (in.n < 0 || in.scap < 1 || in.step_cap < 0 || lanes < 1 || lanes > 65535 || in.n_lanes < 1 ||
      in.n_lanes > kMaxLanes || (in.dropped == nullptr && in.step_cap < in.n))
    return (int)cudaErrorInvalidValue;
  if (in.n == 0) return (int)cudaSuccess;
  const long long grid = tiles(in.n);
  if (scratch == nullptr || (reinterpret_cast<uintptr_t>(scratch) & 7) != 0 ||
      scratch_len < one_scratch(lanes, in.n) || grid > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  in.tiles = (int)grid;
  in.ticket = (unsigned long long*)scratch;
  in.next = (unsigned*)(scratch + 2 * lanes);
  in.status = (unsigned*)(scratch + 3 * lanes);
  one_kernel<<<dim3((unsigned)grid, (unsigned)lanes), kThreads, 0, st>>>(in);
  return (int)cudaGetLastError();
}

}  // namespace capture
