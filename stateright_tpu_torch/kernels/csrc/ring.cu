// K7: the BFS ring queue — pop and append, one ring per lane.
//
// Replaces stateright_tpu/ops/frontier.py:55 ring_gather (pop) and :62
// ring_scatter (append), and their jax.vmap over the lanes of the
// multiplexed engine. The rings are one int64 tensor [lanes, W, stride]:
// W state-row lanes each (the state lanes, eventually-bits, depth), a
// power-of-two capacity qcap = qmask + 1 and stride = qcap + 1 (the last
// column is the trash slot of the torch version; the kernels never write
// it); ring l starts lane_stride elements after ring l-1. The solo engine
// is the one-lane case.
//
// Ring l's head (pop) or tail (append) is base + bases[l] (bases NULL:
// base for every ring), so one launch serves every lane with the lanes'
// positions in a small [lanes] vector (the era keeps them on the card).
//
//   pop    (srt_ring): buf[w, l*n + i] = ring[l, w, (head_l + i) & qmask],
//          i < n: the n consecutive rows from each head, wrapping; the
//          lanes' rows sit side by side in buf.
//   append (srt_ring_append, two launches: COUNT, then WRITE):
//          ring[l, w, (tail_l + r) & qmask] = cand[w, l*m + i] for the
//          r-th set column i of lane l's mask [m]: the valid candidates
//          at tail + rank in candidate order; other positions untouched.
//
// Bound on the card: bytes. The pop reads and writes W*n rows of 8 bytes
// once. The append reads the mask (1 byte a column) and reads and writes
// each valid column's W values once.
//
// Design.
//   pop: each thread writes one 16-byte-aligned pair of buf with one
//        16-byte store, loading it as one 16-byte load where the ring
//        pair is aligned and does not straddle the wrap, else as two
//        8-byte loads (ring rows have the odd stride qcap + 1, so every
//        other state-row lane is misaligned): the wrapped range is copied
//        as its two contiguous spans, [head, qcap) and [0, rest).
//   append: the compaction is folded into the ring write — no id buffer,
//        no valid lane, no count is written between the launches but one
//        int32 a tile, and no atomic decides a rank.
//     COUNT, grid (tile, lane): each of kThreads threads reads 16 mask
//        bytes (one uint4 where the lane's mask is 16-byte aligned) and
//        counts the set ones; the block's sum goes to scratch[lane, tile].
//     WRITE, grid (tile, lane, state-row lane w): the block sums the
//        counts of the tiles before its own (the tile's exclusive offset),
//        ranks its tile's columns again (each thread's 16 flags, a block
//        scan of the threads' counts) into a shared list of the tile's
//        set columns in order, then thread r copies the r-th set column
//        of row w to ring position tail + offset + r: reads in column
//        order from one tile of one row, writes to consecutive positions
//        (coalesced except where the wrap splits a warp). One row a
//        block keeps enough blocks in flight at one lane (paxos-3: 12
//        tiles x 32 rows); the mask is re-read from L2 by each row's
//        block.
//   The scratch is rewritten on every call, so a CUDA graph replays the
//   step with no reset node.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;                 // mask bytes a thread
constexpr int kTile = kThreads * kPerThread;   // 4,096 columns a tile
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ long long position(long long base,
                                              const long long* bases,
                                              long long l) {
  return bases ? base + bases[l] : base;
}

__global__ void pop_kernel(const long long* __restrict__ ring,
                           long long stride, long long lane_stride,
                           long long qmask, long long base,
                           const long long* __restrict__ bases,
                           long long* __restrict__ buf, long long buf_stride,
                           long long n) {
  const long long w = blockIdx.y;
  const long long l = blockIdx.z;
  const long long* src = ring + l * lane_stride + w * stride;
  long long* dst = buf + w * buf_stride + l * n;
  // dst[peel] is the row's first 16-byte-aligned element.
  const long long peel = ((uintptr_t)dst & 8) ? 1 : 0;
  const long long i0 = 2 * ((long long)blockIdx.x * blockDim.x + threadIdx.x) - peel;
  if (i0 >= n) return;
  const long long i1 = i0 + 1;
  const long long head = position(base, bases, l);
  if (i0 >= 0 && i1 < n) {
    const long long s0 = (head + i0) & qmask;
    longlong2 v;
    if (s0 != qmask && ((uintptr_t)(src + s0) & 15) == 0) {
      v = *reinterpret_cast<const longlong2*>(src + s0);
    } else {
      v.x = src[s0];
      v.y = src[(head + i1) & qmask];
    }
    *reinterpret_cast<longlong2*>(dst + i0) = v;
  } else if (i0 >= 0) {
    dst[i0] = src[(head + i0) & qmask];
  } else if (i1 < n) {
    dst[i1] = src[(head + i1) & qmask];
  }
}

// The set flags of this thread's 16 mask bytes [col, col + 16) of a lane
// of m columns, bit j for column col + j.
__device__ __forceinline__ unsigned mask_bits(const unsigned char* lane_mask,
                                              long long m, long long col) {
  unsigned bits = 0;
  if (col + kPerThread <= m && ((uintptr_t)(lane_mask + col) & 15) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(lane_mask + col);
    const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if ((words[q] >> (8 * b)) & 0xFFu) bits |= 1u << (4 * q + b);
      }
    }
  } else {
    for (int j = 0; j < kPerThread && col + j < m; ++j) {
      if (lane_mask[col + j]) bits |= 1u << j;
    }
  }
  return bits;
}

// The block's sum of one int a thread, returned to every thread.
__device__ __forceinline__ int block_sum(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = __reduce_add_sync(0xffffffffu, (unsigned)v);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) total += warp_sums[q];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kThreads)
    count_kernel(const unsigned char* __restrict__ mask, long long mask_stride,
                 long long m, long long tiles, int* __restrict__ counts) {
  __shared__ int warp_sums[kWarps];
  const long long l = blockIdx.y;
  const long long col = (long long)blockIdx.x * kTile + (long long)threadIdx.x * kPerThread;
  const int c = col < m ? __popc(mask_bits(mask + l * mask_stride, m, col)) : 0;
  const int total = block_sum(c, warp_sums);
  if (threadIdx.x == 0) counts[l * tiles + blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
    write_kernel(long long* __restrict__ ring, long long stride,
                 long long lane_stride, long long qmask, long long base,
                 const long long* __restrict__ bases,
                 const long long* __restrict__ cand, long long cand_stride,
                 const unsigned char* __restrict__ mask, long long mask_stride,
                 long long m, long long tiles, const int* __restrict__ counts) {
  __shared__ int warp_sums[kWarps];
  __shared__ int list[kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long l = blockIdx.y;
  const long long w = blockIdx.z;
  const long long tile = blockIdx.x;
  // The tile's exclusive offset: the counts of the tiles before it.
  int before = 0;
  for (long long t = threadIdx.x; t < tile; t += kThreads) before += counts[l * tiles + t];
  const long long offset = block_sum(before, warp_sums);
  // Rank the tile's columns again: each thread's flags, then a block scan.
  const long long col0 = tile * kTile;
  const long long col = col0 + (long long)threadIdx.x * kPerThread;
  unsigned bits = col < m ? mask_bits(mask + l * mask_stride, m, col) : 0u;
  const int c = __popc(bits);
  int incl = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int warp_before = 0, total = 0;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) {
    warp_before += q < warp ? warp_sums[q] : 0;
    total += warp_sums[q];
  }
  int at = warp_before + incl - c;
  const int first = threadIdx.x * kPerThread;
  while (bits) {
    const int j = __ffs(bits) - 1;
    list[at++] = first + j;
    bits &= bits - 1;
  }
  __syncthreads();
  const long long tail = position(base, bases, l) + offset;
  long long* dst = ring + l * lane_stride + w * stride;
  const long long* src = cand + w * cand_stride + l * m + col0;
#pragma unroll 4
  for (int r = threadIdx.x; r < total; r += kThreads) {
    dst[(tail + r) & qmask] = src[list[r]];
  }
}

}  // namespace

// Pop. lanes (grid z) and width (grid y) <= 65535; n: rows popped a
// lane. bases: int64[lanes] or NULL.
extern "C" int srt_ring(const void* ring, long long lanes, long long width,
                        long long stride, long long lane_stride,
                        long long qmask, long long base, const void* bases,
                        void* buf, long long buf_stride, long long n,
                        void* stream) {
  if (n > 0 && width > 0 && lanes > 0) {
    const long long pairs = n / 2 + 1;  // the pairs an unaligned row spans
    dim3 grid((unsigned)((pairs + kThreads - 1) / kThreads), (unsigned)width,
              (unsigned)lanes);
    pop_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const long long*)ring, stride, lane_stride, qmask, base,
        (const long long*)bases, (long long*)buf, buf_stride, n);
  }
  return (int)cudaGetLastError();
}

// Append, one stage a call: stage 0 COUNT, stage 1 WRITE (the wrapper
// makes both calls, in that order, on one stream). mask: bool [lanes, m]
// rows mask_stride bytes apart; cand: int64 [width, cand_stride], lane l's
// columns at l*m; scratch: int32 [lanes, ceil(m / kTile)] (kTile is
// kernels.APPEND_TILE). lanes <= 65535,
// width <= 65535. bases: int64[lanes] or NULL.
extern "C" int srt_ring_append(int stage, void* ring, long long lanes,
                               long long width, long long stride,
                               long long lane_stride, long long qmask,
                               long long base, const void* bases,
                               const void* cand, long long cand_stride,
                               const void* mask, long long mask_stride,
                               long long m, void* scratch, void* stream) {
  const long long tiles = (m + kTile - 1) / kTile;
  if (tiles > 0 && width > 0 && lanes > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (stage == 0) {
      count_kernel<<<dim3((unsigned)tiles, (unsigned)lanes), kThreads, 0, st>>>(
          (const unsigned char*)mask, mask_stride, m, tiles, (int*)scratch);
    } else {
      write_kernel<<<dim3((unsigned)tiles, (unsigned)lanes, (unsigned)width), kThreads, 0, st>>>(
          (long long*)ring, stride, lane_stride, qmask, base,
          (const long long*)bases, (const long long*)cand, cand_stride,
          (const unsigned char*)mask, mask_stride, m, tiles,
          (const int*)scratch);
    }
  }
  return (int)cudaGetLastError();
}
