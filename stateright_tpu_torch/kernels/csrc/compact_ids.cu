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
// Bound on the card: bytes (the mask read once, ids and valid written
// once), a few hundred KB at the BFS widths, so a call is latency: the
// number of dependent launches and the round trips inside each. Design:
// two launches on one stream over (tile, lane), a tile `per` sub-tiles
// of kSub elements (the host's plan, ops/visited_set.py compact_plan,
// keeps a lane at most 1,024 tiles):
//   1. COUNT: each block counts the set bits of its tile and writes one
//      int32 to the scratch, counts[l, tile].
//   2. WRITE, launched as COUNT's programmatic dependent (Hopper), so its
//      blocks are scheduled and read their mask bytes while COUNT runs,
//      then wait for COUNT's grid: each block sums its lane's counts itself (the tiles before
//      its own: its offset; all of them: n_set), ranks its tile (a scan
//      of the threads' counts; each thread holds 16 mask bytes, read as
//      one 16-byte load where the view's run and alignment allow), stages
//      the ranks' positions in shared memory and writes ids[offset + rank]
//      coalesced, then writes valid and zeroes the ids past min(n_set,
//      cap) over its stripe of [0, cap): the old scan and finish launches
//      are folded in.
// COUNT writes every count WRITE reads, so the scratch needs no reset: a
// CUDA graph replays a call with no memset node and no host write.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;                // mask bytes a thread: one 16-byte load
constexpr int kSub = kThreads * kItems;   // 4,096 elements ranked at once
constexpr int kWarps = kThreads / 32;

struct MaskView {
  const unsigned char* mask;
  long long n;            // elements a lane
  long long seg;          // contiguous run length
  long long seg_stride;   // elements between runs
  long long lane_stride;  // elements between lanes
};

// Bit k (k < 4) set iff byte k of x is nonzero.
__device__ __forceinline__ unsigned nonzero_bits(uint32_t x) {
  uint32_t hi = (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
  return (((hi >> 7) * 0x01020408u) >> 24) & 0xFu;
}

// Bit k set iff element j0 + k of the lane is set (0 past n).
__device__ __forceinline__ unsigned load16(const MaskView& v, long long lane, long long j0) {
  if (j0 >= v.n) return 0u;
  const unsigned char* base = v.mask + lane * v.lane_stride;
  long long s = 0, r = j0;
  if (v.seg < v.n) {
    s = j0 / v.seg;
    r = j0 - s * v.seg;
  }
  const unsigned char* p = base + s * v.seg_stride + r;
  if (j0 + kItems <= v.n && r + kItems <= v.seg && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
    return nonzero_bits(w.x) | nonzero_bits(w.y) << 4 | nonzero_bits(w.z) << 8 |
           nonzero_bits(w.w) << 12;
  }
  unsigned bits = 0;
  const int m = (int)(v.n - j0 < kItems ? v.n - j0 : kItems);
  for (int k = 0; k < m; ++k) {
    if (base[s * v.seg_stride + r]) bits |= 1u << k;
    if (++r == v.seg) {
      r = 0;
      ++s;
    }
  }
  return bits;
}

__device__ __forceinline__ long long warp_sum(long long x) {
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  return x;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(MaskView v, int per, int tiles, int* __restrict__ counts) {
  __shared__ int warp_sums[kWarps];
  // WRITE may be scheduled now: it waits for this grid's counts itself.
  asm volatile("griddepcontrol.launch_dependents;");
  const long long lane = blockIdx.y;
  const int tile = blockIdx.x;
  const long long base = (long long)tile * per * kSub + threadIdx.x * kItems;
  int c = 0;
  for (int s = 0; s < per; ++s) c += __popc(load16(v, lane, base + (long long)s * kSub));
  c = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += warp_sums[w];
    counts[lane * tiles + tile] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
write_kernel(MaskView v, int per, int tiles, long long cap, const int* __restrict__ counts,
             long long* __restrict__ ids, bool* __restrict__ valid, long long* __restrict__ n_set) {
  __shared__ long long sums[2][kWarps];
  __shared__ int warp_sums[kWarps];
  __shared__ unsigned short loc[kSub];
  const int lane_id = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long lane = blockIdx.y;
  const int tile = blockIdx.x;
  const bool ranks = tile < tiles;
  const long long base = (long long)tile * per * kSub;
  // The first sub-tile's bytes are asked for before the counts, so the
  // two reads overlap.
  unsigned bits = ranks ? load16(v, lane, base + threadIdx.x * kItems) : 0u;
  // COUNT's counts, complete and visible (a no-op when launched plainly).
  asm volatile("griddepcontrol.wait;" ::: "memory");

  // This tile's offset in its lane and the lane's total, from COUNT.
  long long before = 0, total = 0;
  const int* c = counts + lane * tiles;
  for (int i = threadIdx.x; i < tiles; i += kThreads) {
    long long x = c[i];
    total += x;
    if (i < tile) before += x;
  }
  before = warp_sum(before);
  total = warp_sum(total);
  if (lane_id == 0) {
    sums[0][warp] = before;
    sums[1][warp] = total;
  }
  __syncthreads();
  before = 0;
  total = 0;
  for (int w = 0; w < kWarps; ++w) {
    before += sums[0][w];
    total += sums[1][w];
  }
  const long long lim = total < cap ? total : cap;
  long long* out = ids + lane * cap;

  // Rank the tile's set bits, a sub-tile at a time, and write their ids
  // (every rank below cap is below lim).
  if (ranks && before < cap) {
    long long running = before;
    for (int s = 0; s < per && running < cap; ++s) {
      const long long j0 = base + (long long)s * kSub;
      if (s) bits = load16(v, lane, j0 + threadIdx.x * kItems);
      const int cnt = __popc(bits);
      int inc = cnt;
      for (int d = 1; d < 32; d <<= 1) {
        int y = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane_id >= d) inc += y;
      }
      if (lane_id == 31) warp_sums[warp] = inc;
      __syncthreads();
      int at = inc - cnt, sub_total = 0;
      for (int w = 0; w < kWarps; ++w) {
        int x = warp_sums[w];
        if (w < warp) at += x;
        sub_total += x;
      }
      for (unsigned b = bits; b; b &= b - 1)
        loc[at++] = (unsigned short)(threadIdx.x * kItems + __ffs(b) - 1);
      __syncthreads();
      for (int i = threadIdx.x; i < sub_total; i += kThreads) {
        long long r = running + i;
        if (r < cap) out[r] = j0 + loc[i];
      }
      running += sub_total;
      __syncthreads();  // loc and warp_sums are reused
    }
  }

  // The finish, over this block's stripe of [0, cap).
  const long long stripe = (cap + gridDim.x - 1) / gridDim.x;
  const long long lo = (long long)tile * stripe;
  const long long hi = lo + stripe < cap ? lo + stripe : cap;
  bool* vrow = valid + lane * cap;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    const bool ok = i < lim;
    vrow[i] = ok;
    if (!ok) out[i] = 0;
  }
  if (tile == 0 && threadIdx.x == 0) n_set[lane] = total;
}

}  // namespace

// lanes <= 65535. The plan (ops/visited_set.py compact_plan): `per`
// sub-tiles of 4,096 elements a tile, `tiles` tiles a lane (0 when n is
// 0) and `blocks` >= max(1, tiles) WRITE blocks a lane. scratch:
// int32[lanes * max(1, tiles)], written by COUNT before WRITE reads it.
// ids: int64[lanes, cap], valid: bool[lanes, cap], n_set: int64[lanes].
extern "C" int srt_compact_ids(const void* mask, long long lanes, long long n,
                               long long seg, long long seg_stride,
                               long long lane_stride, long long cap,
                               long long per, long long tiles, long long blocks,
                               void* ids, void* valid, void* n_set,
                               void* scratch, void* stream) {
  if (lanes <= 0) return (int)cudaGetLastError();
  if (lanes > 65535 || per <= 0 || tiles < 0 || blocks < 1 || blocks < tiles ||
      tiles * per * kSub < n || (tiles > 0 && (tiles - 1) * per * kSub >= n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  MaskView v{(const unsigned char*)mask, n, seg > 0 ? seg : 1, seg_stride, lane_stride};
  int* counts = (int*)scratch;
  if (tiles > 0) {
    count_kernel<<<dim3((unsigned)tiles, (unsigned)lanes), kThreads, 0, st>>>(
        v, (int)per, (int)tiles, counts);
  }
  // WRITE as a programmatic dependent of COUNT: its blocks are scheduled
  // while COUNT runs and read the mask, then wait for the counts.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, (unsigned)lanes);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = tiles > 0;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, write_kernel, v, (int)per, (int)tiles, cap,
                                     (const int*)counts, (long long*)ids, (bool*)valid,
                                     (long long*)n_set);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
