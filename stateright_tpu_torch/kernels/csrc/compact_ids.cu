// K2: stable stream compaction of a mask into a fixed-width id buffer.
//
// Replaces stateright_tpu/ops/visited_set.py:250 _compact_ids. Returns
// ids[cap] (the indices of the set bits, in index order, 0 past the last),
// valid[cap] (i < min(n_set, cap)) and n_set. Set bits ranked >= cap are
// counted but not stored. Ring order, and so every later result of the
// BFS, depends on this order, so the kernel is a deterministic scan: no
// atomics decide a rank.
//
// Design: four launches on one stream.
//   1. count: each block counts the set bits of its tile of TILE elements.
//   2. scan:  one block turns the per-tile counts into exclusive offsets
//             and writes n_set.
//   3. scatter: each block ranks its tile again (warp ballots + a scan of
//             the warp totals, in four ordered rounds) and writes
//             ids[offset + rank] = index for ranks below cap.
//   4. finish: valid[i] = i < min(n_set, cap); ids past that are zeroed.
//
// Bound on the card: bytes. The mask (1 byte/element) is read twice, the
// ids (8 bytes) and valid (1 byte) written once; the scan is O(n / TILE).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;

__global__ void count_kernel(const bool* __restrict__ mask, long long n,
                             long long* __restrict__ counts) {
  long long base = (long long)blockIdx.x * kTile;
  int total = 0;
  for (int k = 0; k < kItems; ++k) {
    long long i = base + (long long)k * kThreads + threadIdx.x;
    int flag = (i < n) && mask[i];
    total += __syncthreads_count(flag);
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// Exclusive scan of `counts` in place (one block, carried across chunks of
// kThreads); the grand total goes to n_set.
__global__ void scan_kernel(long long* __restrict__ counts, long long nblocks,
                            long long* __restrict__ n_set) {
  __shared__ long long warp_sums[kWarps];
  __shared__ long long carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (long long base = 0; base < nblocks; base += kThreads) {
    long long i = base + threadIdx.x;
    long long v = i < nblocks ? counts[i] : 0;
    long long x = v;
    for (int d = 1; d < 32; d <<= 1) {
      long long y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      long long w = warp_sums[lane];
      for (int d = 1; d < 32; d <<= 1) {
        long long y = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += y;
      }
      warp_sums[lane] = w;  // inclusive
    }
    __syncthreads();
    long long before = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
    if (i < nblocks) counts[i] = before;
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sums[kWarps - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) *n_set = carry;
}

__global__ void scatter_kernel(const bool* __restrict__ mask, long long n,
                               const long long* __restrict__ offsets,
                               long long cap, long long* __restrict__ ids) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long base = (long long)blockIdx.x * kTile;
  long long running = offsets[blockIdx.x];
  for (int k = 0; k < kItems; ++k) {
    long long i = base + (long long)k * kThreads + threadIdx.x;
    bool flag = (i < n) && mask[i];
    unsigned ballot = __ballot_sync(0xffffffffu, flag);
    int in_warp = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) warp_sums[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
      for (int d = 1; d < 32; d <<= 1) {
        int y = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += y;
      }
      warp_sums[lane] = w;  // inclusive
    }
    __syncthreads();
    long long rank = running + (warp > 0 ? warp_sums[warp - 1] : 0) + in_warp;
    if (flag && rank < cap) ids[rank] = i;
    running += warp_sums[kWarps - 1];
    __syncthreads();
  }
}

__global__ void finish_kernel(const long long* __restrict__ n_set, long long cap,
                              long long* __restrict__ ids,
                              bool* __restrict__ valid) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  long long lim = *n_set < cap ? *n_set : cap;
  bool v = i < lim;
  valid[i] = v;
  if (!v) ids[i] = 0;
}

}  // namespace

// scratch: int64[max(1, ceil(n / kTile))] per-tile counts/offsets.
extern "C" int srt_compact_ids(const void* mask, long long n, long long cap,
                               void* ids, void* valid, void* n_set,
                               void* scratch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  long long nblocks = (n + kTile - 1) / kTile;
  long long* counts = (long long*)scratch;
  if (nblocks > 0) {
    count_kernel<<<(unsigned)nblocks, kThreads, 0, st>>>((const bool*)mask, n,
                                                         counts);
  }
  scan_kernel<<<1, kThreads, 0, st>>>(counts, nblocks, (long long*)n_set);
  if (nblocks > 0) {
    scatter_kernel<<<(unsigned)nblocks, kThreads, 0, st>>>(
        (const bool*)mask, n, counts, cap, (long long*)ids);
  }
  if (cap > 0) {
    finish_kernel<<<(unsigned)((cap + 255) / 256), 256, 0, st>>>(
        (const long long*)n_set, cap, (long long*)ids, (bool*)valid);
  }
  return (int)cudaGetLastError();
}
