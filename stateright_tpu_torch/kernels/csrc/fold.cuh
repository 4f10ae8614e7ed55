// The step fold's block-level helpers, shared by K8f's COMMIT
// (era_step.cu) and K15f's COMMIT grid (mesh_era.cu): a thread reads a
// run of 16 bool elements as bits (one 16-byte load where the row allows),
// a warp adds its runs' bits to per-row counters in shared memory, a
// block sums a count, and a run's new inserts go into a depth histogram.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fold {

constexpr int kRun = 16;  // elements a thread: one 16-byte load

// Four bool bytes (0 or 1) as four bits, byte k at bit k.
__device__ __forceinline__ unsigned pack4(unsigned w) {
  return ((w & 0x01010101u) * 0x01020408u) >> 24;
}

// The 16 elements e0 .. e0 + 15 (those below `total`) of a bool matrix
// [R, C] whose row r starts at row(r), as bits (element e0 + k at bit
// k). `vec`: C is a multiple of 16 and every row start is 16-byte
// aligned, so a whole run is one load from one row.
template <class Row>
__device__ __forceinline__ unsigned run_bits(Row row, long long C, long long total, long long e0,
                                             bool vec) {
  if (vec && e0 + kRun <= total) {
    const long long r = e0 / C;
    const uint4 v = *reinterpret_cast<const uint4*>(row(r) + (e0 - r * C));
    return pack4(v.x) | pack4(v.y) << 4 | pack4(v.z) << 8 | pack4(v.w) << 12;
  }
  unsigned m = 0;
  for (int k = 0; k < kRun && e0 + k < total; ++k) {
    const long long e = e0 + k, r = e / C;
    m |= (unsigned)(row(r)[e - r * C] != 0) << k;
  }
  return m;
}

// Adds the set bits of a thread's run (element e0 + k at bit k, rows of
// C elements) to cnt[row]: the bits of the run's first row summed over
// the warp's threads that share that row first, one shared atomic each
// group; the rest of a run that crosses rows one atomic a bit. Every
// thread of the warp calls it (a run past the end has no bits).
__device__ __forceinline__ void add_rows(unsigned m, long long e0, long long C, int* cnt) {
  const long long r0 = e0 / C;
  const long long left = (r0 + 1) * C - e0;  // elements of the run in row r0
  unsigned first = m, rest = 0;
  if (left < kRun) {
    first = m & ((1u << left) - 1u);
    rest = m & ~((1u << left) - 1u);
  }
  const unsigned peers = __match_any_sync(0xffffffffu, (int)r0);
  const int tot = __reduce_add_sync(peers, __popc(first));
  if (tot && (threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&cnt[r0], tot);
  while (rest) {
    const int k = __ffs(rest) - 1;
    rest &= rest - 1;
    atomicAdd(&cnt[(e0 + k) / C], 1);
  }
}

// The block's sum of v (kWarps warps; `red` holds kWarps words); also a
// barrier.
template <int kWarps>
__device__ __forceinline__ long long block_sum(long long v, long long* red) {
  v = __reduce_add_sync(0xffffffffu, (unsigned)v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  long long total = 0;
  for (int w = 0; w < kWarps; ++w) total += red[w];
  __syncthreads();
  return total;
}

// A run's new inserts (bits of `bn`, their depths dk) into a shared
// histogram of `bins` bins at min(depth, bins - 1): a thread's inserts
// by bin, a run of one bin counted at once; the last run's count summed
// over the warp's threads that end in the same bin, one shared atomic
// each group. Every thread of the warp calls it.
__device__ __forceinline__ void hist_run(unsigned bn, const long long* dk, int bins, int* hist) {
  int bin = -1, run = 0;
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    if (!((bn >> k) & 1u)) continue;
    const int b = (int)(dk[k] < bins - 1 ? dk[k] : bins - 1);
    if (b != bin) {
      if (run) atomicAdd(&hist[bin], run);
      bin = b;
      run = 0;
    }
    ++run;
  }
  const unsigned peers = __match_any_sync(0xffffffffu, bin);
  const int tot = (int)__reduce_add_sync(peers, (unsigned)run);
  if (tot && (threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&hist[bin], tot);
}

}  // namespace fold
