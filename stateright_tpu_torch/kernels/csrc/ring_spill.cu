// K7s: the host spill's ring drain and refill, one launch over every ring
// (one a group of 64 rings).
//
// Replaces the JAX engines' eager spill programs: the solo drain
// (stateright_tpu/engines/tpu_bfs.py:1924-1948, S1) and refill (:2060-2087,
// S2), and the sharded engine's per-shard twins
// (stateright_tpu/parallel/mesh.py:1776-1800, S3; :1952-1985, S4).
//
// The rings are one int64 tensor [lanes, W, stride]: W state-row lanes
// each (state lanes, eventually-bits, depth), a power-of-two capacity
// qcap = qmask + 1 and stride = qcap + 1, ring l starting lane_stride
// elements after ring l-1; the last column of a ring is the torch
// version's trash slot, never written here. The solo engine is the
// one-ring case, the sharded engine passes its shards as the rings.
//
// A spill block is row-major uint32 [k, W], the JAX layout (the JAX ring
// is uint32, tpu_bfs.py:219): rows[off_l + i, w] is ring l's row i of its
// k_l, off_l the exclusive sum of k. pos_l is the ring position of row 0
// (drain: head + count - k_l, the newest k_l rows; refill: the tail, head
// + count).
//
//   DRAIN:  rows[off_l + i, w] = (uint32) ring[l, w, (pos_l + i) & qmask]
//   REFILL: ring[l, w, (pos_l + i) & qmask] = rows[off_l + i, w]
//
// Bound on the card: bytes. Each row is read once and written once (8
// bytes a lane on the ring side, 4 on the block side). Design: the host
// plans the work (ops/frontier.py spill_plan): one run (ring, off, k,
// pos) a ring with rows, cut into blocks of R rows, R * W <= 4,096 block-
// side words (16 KB; 32 KB on the ring side) and smaller where the rows
// would fill fewer than two blocks an SM, so no block idles on a short
// ring and a small spill still spreads over the card. The runs reach the kernel as its parameters (a
// __grid_constant__ table of 64), so a call copies nothing from pageable
// memory. A block turns its rows around in shared memory, laid out as the
// block's own row-major words (one pad word every 32 against bank
// conflicts): on the ring side each lane is read (or written) along the
// rows as 16-byte pairs of positions, with a scalar where a lane's run
// of positions starts off 16-byte alignment or ends odd, and the ring's
// wrap splitting a run; on the block side the block's n * W contiguous
// words go as 16-byte vectors, with a scalar head and tail where (off +
// r0) * W is not a multiple of 4. No loop divides. W = 5 (the 2PC
// models) is a template constant, so a thread has a pair of every lane
// in flight at once (with a runtime W, DRAIN is 6.6% slower on an H100;
// PERF.md §6); other widths, paxos-3's 32 among them, run the same
// kernel with a runtime W (at W = 32 a block holds at most 128 rows, too
// few pairs for the unrolled loop). `specialise = 0` takes the runtime-W
// kernel at W = 5 too, to time one against the other.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Block-side words a block, at most: its shared memory (ops/frontier.py
// SPILL_BLOCK_WORDS plans within it).
constexpr int kWords = 4096;
constexpr int kMaxRuns = 64;
constexpr int kUnrollLanes = 8;  // lanes a thread has in flight at once

struct Runs {
  long long ring[kMaxRuns], off[kMaxRuns], k[kMaxRuns], pos[kMaxRuns];
  int first[kMaxRuns + 1];  // each run's first block; first[n] = blocks
  int n;
};
static_assert(sizeof(Runs) <= 3072, "the runs travel in the kernel's 4 KB of parameters");

__device__ __forceinline__ int pad(int j) { return j + (j >> 5); }

// One position of one lane: ring element e and block word j.
template <bool kDrain>
__device__ __forceinline__ void move1(long long* e, uint32_t* sh, int j) {
  if (kDrain) sh[pad(j)] = (uint32_t)e[0];
  else e[0] = (long long)sh[pad(j)];
}

// Pair q of lane w's run of m positions from ring position a (block row
// i first): two positions as one 16-byte access, past the lane's scalar
// head, if its run has that pair.
template <bool kDrain>
__device__ __forceinline__ void move2(long long* lane0, long long stride, long long a, int odd,
                                      int m, int i, int q, int w, int W, uint32_t* sh) {
  const int head = odd ^ (w & (int)stride & 1);
  if (q >= ((m - head) >> 1)) return;
  longlong2* e2 = reinterpret_cast<longlong2*>(lane0 + w * stride + a + head) + q;
  const int row = i + head + 2 * q;
  if (kDrain) {
    const longlong2 x = *e2;
    sh[pad(row * W + w)] = (uint32_t)x.x;
    sh[pad((row + 1) * W + w)] = (uint32_t)x.y;
  } else {
    longlong2 x;
    x.x = (long long)sh[pad(row * W + w)];
    x.y = (long long)sh[pad((row + 1) * W + w)];
    *e2 = x;
  }
}

// Ring side: each lane w of rows [0, n) at positions (p0 + i) & qmask, a
// run of contiguous positions at a time (the wrap splits a block's rows
// in two). Lane w's run starts 16-byte aligned or not by the parity of
// w * stride, so each lane has its own scalar head and tail. The pairs
// between: with W a constant and a pair a thread or more, q outside and
// every lane inside, unrolled, so a thread has a pair of several lanes
// in flight at once; otherwise (a runtime W, a short run: a wide W, a
// block cut by the wrap) as (pair q, lane group g), qs threads a group
// (a power of two), group g taking lanes g, g + groups, ..., so short
// runs keep every thread busy.
template <int kW, bool kDrain>
__device__ __forceinline__ void ring_side(long long* lane0, int W, long long stride,
                                          long long qmask, long long p0, int n,
                                          uint32_t* sh) {
  for (int i = 0; i < n;) {
    const long long a = (p0 + i) & qmask;
    const int m = (int)(qmask + 1 - a < n - i ? qmask + 1 - a : n - i);
    const int odd = (int)((reinterpret_cast<uintptr_t>(lane0 + a) >> 3) & 1);
    // The scalar heads and tails, a thread a lane.
    for (int w = threadIdx.x; w < W; w += kThreads) {
      long long* e = lane0 + w * stride + a;
      const int head = odd ^ (w & (int)stride & 1);
      if (head) move1<kDrain>(e, sh, i * W + w);
      if ((m - head) & 1) move1<kDrain>(e + m - 1, sh, (i + m - 1) * W + w);
    }
    const int qmax = m >> 1;
    if (kW > 0 && qmax >= kThreads) {
      for (int q = threadIdx.x; q < qmax; q += kThreads) {
#pragma unroll(kUnrollLanes)
        for (int w = 0; w < kW; ++w) move2<kDrain>(lane0, stride, a, odd, m, i, q, w, kW, sh);
      }
    } else {
      const int qs = qmax >= kThreads ? kThreads : qmax <= 1 ? 1 : 1 << (32 - __clz(qmax - 1));
      const int shift = __ffs(qs) - 1;
      const int groups = kThreads >> shift;
      for (int q = threadIdx.x & (qs - 1); q < qmax; q += qs)
        for (int w = threadIdx.x >> shift; w < W; w += groups)
          move2<kDrain>(lane0, stride, a, odd, m, i, q, w, W, sh);
    }
    i += m;
  }
}

// Block side: the M contiguous words at blk.
template <bool kDrain>
__device__ __forceinline__ void block_side(uint32_t* blk, int M, uint32_t* sh) {
  int head = (int)((4 - ((reinterpret_cast<uintptr_t>(blk) >> 2) & 3)) & 3);
  if (head > M) head = M;
  const int quads = (M - head) >> 2;
  const int tail = head + (quads << 2);
  const int t = threadIdx.x;
  if (t < head) {
    if (kDrain) blk[t] = sh[pad(t)];
    else sh[pad(t)] = blk[t];
  }
  if (tail + t < M) {
    if (kDrain) blk[tail + t] = sh[pad(tail + t)];
    else sh[pad(tail + t)] = blk[tail + t];
  }
  uint4* b4 = reinterpret_cast<uint4*>(blk + head);
#pragma unroll 4
  for (int q = t; q < quads; q += kThreads) {
    const int j = head + 4 * q;
    if (kDrain) {
      b4[q] = make_uint4(sh[pad(j)], sh[pad(j + 1)], sh[pad(j + 2)], sh[pad(j + 3)]);
    } else {
      const uint4 x = b4[q];
      sh[pad(j)] = x.x;
      sh[pad(j + 1)] = x.y;
      sh[pad(j + 2)] = x.z;
      sh[pad(j + 3)] = x.w;
    }
  }
}

template <int kW, bool kDrain>
__global__ void __launch_bounds__(kThreads)
spill_kernel(long long* __restrict__ ring, int width, long long stride, long long lane_stride,
             long long qmask, const __grid_constant__ Runs runs, int rows_per_block,
             uint32_t* __restrict__ rows) {
  extern __shared__ uint32_t sh[];  // pad(rows_per_block * W - 1) + 1 words
  const int W = kW > 0 ? kW : width;
  // This block's run: the last whose first block is at or before it.
  const int b = blockIdx.x;
  int g = 0;
  while (g + 1 < runs.n && runs.first[g + 1] <= b) ++g;
  const long long r0 = (long long)(b - runs.first[g]) * rows_per_block;
  const int n = (int)(runs.k[g] - r0 < rows_per_block ? runs.k[g] - r0 : rows_per_block);
  long long* lane0 = ring + runs.ring[g] * lane_stride;
  const long long p0 = runs.pos[g] + r0;
  uint32_t* blk = rows + (runs.off[g] + r0) * W;
  if (kDrain) {
    ring_side<kW, true>(lane0, W, stride, qmask, p0, n, sh);
    __syncthreads();
    block_side<true>(blk, n * W, sh);
  } else {
    block_side<false>(blk, n * W, sh);
    __syncthreads();
    ring_side<kW, false>(lane0, W, stride, qmask, p0, n, sh);
  }
}

template <bool kDrain>
void launch_runs(int width, bool specialise, dim3 grid, cudaStream_t st, long long* ring, long long stride,
                 long long lane_stride, long long qmask, const Runs& runs, int rpb,
                 uint32_t* rows) {
  const int words = rpb * width;
  const size_t shared = (size_t)(words + (words - 1) / 32) * sizeof(uint32_t);
  if (specialise && width == 5)
    spill_kernel<5, kDrain><<<grid, kThreads, shared, st>>>(ring, width, stride, lane_stride,
                                                      qmask, runs, rpb, rows);
  else
    spill_kernel<0, kDrain><<<grid, kThreads, shared, st>>>(ring, width, stride, lane_stride,
                                                      qmask, runs, rpb, rows);
}

int launch(bool drain, void* ring, long long width, long long stride, long long lane_stride,
           long long qmask, const long long* plan, long long n_runs, long long rows_per_block,
           long long specialise, void* rows, void* stream) {
  if (width <= 0 || rows_per_block <= 0 || rows_per_block * width > kWords || n_runs < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  for (long long g0 = 0; g0 < n_runs; g0 += kMaxRuns) {
    Runs runs;
    runs.n = (int)(n_runs - g0 < kMaxRuns ? n_runs - g0 : kMaxRuns);
    long long blocks = 0;
    for (int g = 0; g < runs.n; ++g) {
      const long long* x = plan + 4 * (g0 + g);
      if (x[2] < 0) return (int)cudaErrorInvalidValue;
      runs.ring[g] = x[0];
      runs.off[g] = x[1];
      runs.k[g] = x[2];
      runs.pos[g] = x[3];
      runs.first[g] = (int)blocks;
      blocks += (x[2] + rows_per_block - 1) / rows_per_block;
    }
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    runs.first[runs.n] = (int)blocks;
    if (blocks == 0) continue;
    const dim3 grid((unsigned)blocks);
    if (drain)
      launch_runs<true>((int)width, specialise != 0, grid, st, (long long*)ring, stride, lane_stride, qmask, runs,
                        (int)rows_per_block, (uint32_t*)rows);
    else
      launch_runs<false>((int)width, specialise != 0, grid, st, (long long*)ring, stride, lane_stride, qmask, runs,
                         (int)rows_per_block, (uint32_t*)rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// plan: host int64 [n_runs, 4], one (ring, off, k, pos) a ring with rows
// (ops/frontier.py spill_plan); rows_per_block * width <= 4,096.
extern "C" int srt_ring_drain(const void* ring, long long width, long long stride,
                              long long lane_stride, long long qmask, const void* plan,
                              long long n_runs, long long rows_per_block, long long specialise,
                              void* rows, void* stream) {
  return launch(true, (void*)ring, width, stride, lane_stride, qmask, (const long long*)plan,
                n_runs, rows_per_block, specialise, rows, stream);
}

extern "C" int srt_ring_refill(void* ring, long long width, long long stride,
                               long long lane_stride, long long qmask, const void* plan,
                               long long n_runs, long long rows_per_block, long long specialise,
                               const void* rows, void* stream) {
  return launch(false, ring, width, stride, lane_stride, qmask, (const long long*)plan, n_runs,
                rows_per_block, specialise, (void*)rows, stream);
}
