// K11's two kernels for one model M, over expand_row.cuh's per-row
// semantics: EXPAND (one launch a BFS step) and WALK (one launch a
// simulation step). Included by expand_2pc.cu, expand_paxos.cu,
// expand_abd.cu, expand_increment.cu, expand_increment_lock.cu and
// expand_single_copy.cu.
//
// Design: one thread a popped row (a walk), so the terminal rule and the
// eventually bits stay in the thread; the model's arrays are indexed by
// compile-time constants and stay in registers. For a fixed (s, a) the
// threads of a warp write consecutive words of flat (and of succ), so
// every store is coalesced. EXPAND's `generated` (the valid candidates of
// the call) is summed in each block, then by the last block to finish: a
// ticket taken with atomicAdd after a __threadfence picks it, and it
// resets the ticket, so a replayed graph needs no memset and no reset.
//
// Bound on the card: bytes. The successor lanes (S x A words a row, as
// int64) are most of them; the model arithmetic is a few hundred 32-bit
// operations an action.

#pragma once

#include <cuda_runtime.h>

#include "expand_row.cuh"

namespace srt {

constexpr int kExpandThreads = 128;

template <class M>
__global__ void __launch_bounds__(kExpandThreads)
    expand_kernel(const M m, const long long* __restrict__ rows, const long long* __restrict__ ebits,
                  const long long* __restrict__ depth, const bool* __restrict__ active,
                  const long long* dl, long long dl_value, long long dl_stride, long long W,
                  long long* __restrict__ ebits_out, long long* __restrict__ flat,
                  bool* __restrict__ valid, bool* __restrict__ hits, long long* partials,
                  unsigned int* ticket, long long* generated) {
  __shared__ int warp_sum[kExpandThreads / 32];
  __shared__ bool last;
  const long long c = (long long)blockIdx.x * kExpandThreads + threadIdx.x;
  int n = 0;
  if (c < W)
    n = expand_one(m, c, W, rows, ebits, depth, active, dl, dl_value, dl_stride, ebits_out, flat,
                   valid, hits);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_down_sync(0xFFFFFFFFu, n, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long sum = 0;
    for (int w = 0; w < kExpandThreads / 32; ++w) sum += warp_sum[w];
    partials[blockIdx.x] = sum;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  long long sum = 0;
  for (long long b = threadIdx.x; b < gridDim.x; b += kExpandThreads)
    sum += ((volatile long long*)partials)[b];
  __shared__ long long block_sum[kExpandThreads];
  block_sum[threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long total = 0;
    for (int t = 0; t < kExpandThreads; ++t) total += block_sum[t];
    *generated = total;
    *ticket = 0u;
  }
}

template <class M>
__global__ void __launch_bounds__(kExpandThreads)
    walk_kernel(const M m, const long long* __restrict__ rows, long long B,
                bool* __restrict__ checks, bool* __restrict__ valid, long long* __restrict__ succ) {
  const long long b = (long long)blockIdx.x * kExpandThreads + threadIdx.x;
  if (b < B) walk_one(m, b, B, rows, checks, valid, succ);
}

inline unsigned int expand_blocks(long long W) {
  const long long g = (W + kExpandThreads - 1) / kExpandThreads;
  return (unsigned int)(g > 0 ? g : 1);
}

template <class M>
int launch_expand(const M& m, const void* rows, const void* ebits, const void* depth,
                  const void* active, const void* dl, long long dl_value, long long dl_stride,
                  long long W, void* ebits_out, void* flat, void* valid, void* hits, void* partials,
                  void* ticket, void* generated, cudaStream_t stream) {
  expand_kernel<M><<<expand_blocks(W), kExpandThreads, 0, stream>>>(
      m, (const long long*)rows, (const long long*)ebits, (const long long*)depth,
      (const bool*)active, (const long long*)dl, dl_value, dl_stride, W, (long long*)ebits_out,
      (long long*)flat, (bool*)valid, (bool*)hits, (long long*)partials, (unsigned int*)ticket,
      (long long*)generated);
  return (int)cudaGetLastError();
}

template <class M>
int launch_walk(const M& m, const void* rows, long long B, void* checks, void* valid, void* succ,
                cudaStream_t stream) {
  if (B <= 0) return 0;
  walk_kernel<M><<<expand_blocks(B), kExpandThreads, 0, stream>>>(
      m, (const long long*)rows, B, (bool*)checks, (bool*)valid, (long long*)succ);
  return (int)cudaGetLastError();
}

// The two entries of model M, for a source's dispatch on its size
// arguments (expand_paxos.cu, expand_abd.cu, expand_increment.cu).
template <class M>
struct ExpandEntry {
  static int run(const void* rows, const void* ebits, const void* depth, const void* active,
                 const void* dl, long long dl_value, long long dl_stride, long long W,
                 void* ebits_out, void* flat, void* valid, void* hits, void* partials,
                 void* ticket, void* generated, cudaStream_t stream) {
    return launch_expand(M{}, rows, ebits, depth, active, dl, dl_value, dl_stride, W, ebits_out,
                         flat, valid, hits, partials, ticket, generated, stream);
  }
};

template <class M>
struct WalkEntry {
  static int run(const void* rows, long long B, void* checks, void* valid, void* succ,
                 cudaStream_t stream) {
    return launch_walk(M{}, rows, B, checks, valid, succ, stream);
  }
};

}  // namespace srt
