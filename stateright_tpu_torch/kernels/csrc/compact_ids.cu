// K2: stable stream compaction of a mask into a fixed-width id buffer,
// one compaction per lane.
//
// Replaces stateright_tpu/ops/visited_set.py:250 _compact_ids, and its
// jax.vmap over the lanes of the multiplexed engine
// (stateright_tpu/engines/multiplex.py:86). For each lane l it returns
// ids[l, :cap] (the indices of the lane's set bits, in index order, 0
// past the last), valid[l, :cap] (i < min(n_set[l], cap)) and n_set[l].
// Set bits ranked >= cap are counted but not stored. Ring order, and so
// every later result of the BFS, depends on this order, so the kernel is
// a deterministic scan: no atomics decide a rank. The solo engine is the
// one-lane case.
//
// The mask of lane l is read as n = nseg * seg elements in row-major
// order from a strided view: element j sits at
//   mask[l * lane_stride + (j / seg) * seg_stride + j % seg].
// A contiguous [N, n] mask is nseg = 1; the multiplexed step's validity
// mask, laid out action-major over all lanes ([A, N, C]), is read as
// lane l's [A, C] in the solo order a*C + c (seg = C, seg_stride = N*C,
// lane_stride = C), without a copy.
//
// Design: four launches on one stream, each over (tile, lane).
//   1. count: each block counts the set bits of its lane's tile of TILE
//             elements.
//   2. scan:  one block a lane turns its per-tile counts into exclusive
//             offsets and writes n_set[l].
//   3. scatter: each block ranks its tile again (warp ballots + a scan of
//             the warp totals, in four ordered rounds) and writes
//             ids[l, offset + rank] = index for ranks below cap.
//   4. finish: valid[l, i] = i < min(n_set[l], cap); ids past that are
//             zeroed.
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

struct MaskView {
  const bool* mask;
  long long n;            // elements a lane
  long long seg;          // contiguous run length
  long long seg_stride;   // elements between runs
  long long lane_stride;  // elements between lanes

  __device__ __forceinline__ bool at(long long lane, long long j) const {
    if (j >= n) return false;
    long long s = j / seg;
    return mask[lane * lane_stride + s * seg_stride + (j - s * seg)];
  }
};

__global__ void count_kernel(MaskView v, long long tiles,
                             long long* __restrict__ counts) {
  long long lane = blockIdx.y;
  long long base = (long long)blockIdx.x * kTile;
  int total = 0;
  for (int k = 0; k < kItems; ++k) {
    long long i = base + (long long)k * kThreads + threadIdx.x;
    total += __syncthreads_count(v.at(lane, i));
  }
  if (threadIdx.x == 0) counts[lane * tiles + blockIdx.x] = total;
}

// Exclusive scan of lane blockIdx.x's `tiles` counts in place (carried
// across chunks of kThreads); the lane's total goes to n_set[lane].
__global__ void scan_kernel(long long* __restrict__ counts, long long tiles,
                            long long* __restrict__ n_set) {
  __shared__ long long warp_sums[kWarps];
  __shared__ long long carry;
  long long* c = counts + (long long)blockIdx.x * tiles;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (long long base = 0; base < tiles; base += kThreads) {
    long long i = base + threadIdx.x;
    long long v = i < tiles ? c[i] : 0;
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
    if (i < tiles) c[i] = before;
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sums[kWarps - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) n_set[blockIdx.x] = carry;
}

__global__ void scatter_kernel(MaskView v, long long tiles,
                               const long long* __restrict__ offsets,
                               long long cap, long long* __restrict__ ids) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long l = blockIdx.y;
  long long* out = ids + l * cap;
  long long base = (long long)blockIdx.x * kTile;
  long long running = offsets[l * tiles + blockIdx.x];
  for (int k = 0; k < kItems; ++k) {
    long long i = base + (long long)k * kThreads + threadIdx.x;
    bool flag = v.at(l, i);
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
    if (flag && rank < cap) out[rank] = i;
    running += warp_sums[kWarps - 1];
    __syncthreads();
  }
}

__global__ void finish_kernel(const long long* __restrict__ n_set,
                              long long lanes, long long cap,
                              long long* __restrict__ ids,
                              bool* __restrict__ valid) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes * cap) return;
  long long l = i / cap;
  long long lim = n_set[l] < cap ? n_set[l] : cap;
  bool v = i - l * cap < lim;
  valid[i] = v;
  if (!v) ids[i] = 0;
}

}  // namespace

// lanes <= 65535. scratch: int64[lanes * max(1, ceil(n / kTile))]
// per-tile counts/offsets. ids: int64[lanes, cap], valid: bool[lanes,
// cap], n_set: int64[lanes].
extern "C" int srt_compact_ids(const void* mask, long long lanes, long long n,
                               long long seg, long long seg_stride,
                               long long lane_stride, long long cap,
                               void* ids, void* valid, void* n_set,
                               void* scratch, void* stream) {
  if (lanes <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  MaskView v{(const bool*)mask, n, seg > 0 ? seg : 1, seg_stride, lane_stride};
  long long tiles = (n + kTile - 1) / kTile;
  long long* counts = (long long*)scratch;
  if (tiles > 0) {
    dim3 grid((unsigned)tiles, (unsigned)lanes);
    count_kernel<<<grid, kThreads, 0, st>>>(v, tiles, counts);
  }
  scan_kernel<<<(unsigned)lanes, kThreads, 0, st>>>(counts, tiles,
                                                    (long long*)n_set);
  if (tiles > 0) {
    dim3 grid((unsigned)tiles, (unsigned)lanes);
    scatter_kernel<<<grid, kThreads, 0, st>>>(v, tiles, counts, cap,
                                              (long long*)ids);
  }
  if (cap > 0) {
    long long total = lanes * cap;
    finish_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        (const long long*)n_set, lanes, cap, (long long*)ids, (bool*)valid);
  }
  return (int)cudaGetLastError();
}
