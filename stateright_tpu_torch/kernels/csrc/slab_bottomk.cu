// K9b: the sample slab's era epilogue — the bottom-k rows by h1, one
// slab a block, every shard's slab in one launch.
//
// Replaces stateright_tpu/engines/tpu_bfs.py:983-995: over the scap slab
// rows, key = (i < occupied) ? ~fp1 : 0 (uint32), and `lax.top_k(key,
// sk2)` picks the sk2 LARGEST keys — the smallest fp1 among the used rows
// — in descending key order, lower row index first among equal keys. The
// output is those rows' (fp1, fp2, depth, action) and a validity lane
// (row < occupied: a real fp1 of 0xFFFFFFFF also keys to 0). The sharded
// engine runs the same tail on every shard's slab (parallel/mesh.py's
// per-shard rows, mesh.py:762-810): grid = lanes, slab l in block l.
//
// Bound on the card: bytes (read fp1 and occupied, gather and write
// 5 x sk2 values: about 13 KB at scap = 1,024), far under one launch's
// latency; what costs is the passes over shared memory and the barriers
// between them: a bitonic sort of every slab row on one SM takes 55
// barrier passes at 1,024 rows (105 at 16,384) to keep sk2 = 128 of them,
// and a launch a shard leaves the mesh's slabs one after another.
//
// Design: select, then sort only what is kept.
//   1. Each row's 64-bit word key << 32 | (0xFFFFFFFF - i) goes to
//      dynamic shared memory (128 KB at 16,384 rows). The words are
//      distinct, so their order is total and exactly top_k's (key
//      descending, then index ascending), and the sk2-th largest word is
//      one exact threshold.
//   2. Radix select of that threshold: passes over 8-bit digits from the
//      top, each a 256-bin shared histogram of the words that match the
//      digits chosen so far (warp-aggregated shared atomics, which only
//      count), then one warp scans the bins from the top. It stops once
//      the chosen bin holds exactly the rows still needed: at most 8
//      passes, 2-3 on distinct random keys.
//   3. The exactly sk2 words at or above the threshold are compacted to
//      the front of the array (in chunks of the block, each read before
//      any write lands) and sorted descending by a bitonic network over
//      the next power of two: one word a thread in registers, strides
//      below 32 by __shfl_xor_sync with no barrier, strides of 32 and up
//      through shared memory (at sk2 = 128: 3 of 28 passes). Above 1,024
//      kept rows the network runs in shared memory, several words a
//      thread.
//   4. Gather fp1, fp2, depth and action of each kept row and write the
//      validity lane.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 16384;
constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
    bottomk_kernel(const long long* __restrict__ sfp1,
                   const long long* __restrict__ sfp2,
                   const long long* __restrict__ sdep,
                   const long long* __restrict__ sact, long long lane_stride,
                   int scap, const long long* __restrict__ counts,
                   long long count_stride, int k_out, int kpow2,
                   long long* __restrict__ o1, long long* __restrict__ o2,
                   long long* __restrict__ od, long long* __restrict__ oa,
                   bool* __restrict__ ovalid) {
  extern __shared__ unsigned long long word[];  // max(scap, kpow2) words
  __shared__ int bins[256];
  __shared__ unsigned long long s_prefix;
  __shared__ int s_need, s_done, s_fill;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long l = blockIdx.x;
  const long long* f1 = sfp1 + l * lane_stride;
  const long long occ = counts[l * count_stride];

  // 1. The words.
  for (int i = tid; i < scap; i += kThreads) {
    const uint32_t key = i < occ ? ~(uint32_t)f1[i] : 0u;
    word[i] = ((unsigned long long)key << 32) | (0xFFFFFFFFu - (uint32_t)i);
  }
  if (tid == 0) {
    s_prefix = 0ull;
    s_need = k_out;
    s_done = 0;
    s_fill = 0;
  }

  // 2. The threshold: the k_out-th largest word.
  unsigned long long prefix = 0ull, decided = 0ull;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int b = tid; b < 256; b += kThreads) bins[b] = 0;
    __syncthreads();
    for (int base = warp * 32; base < scap; base += kThreads) {  // warp-uniform
      const int i = base + lane;
      bool in = false;
      unsigned digit = 0;
      if (i < scap) {
        const unsigned long long w = word[i];
        in = (w & decided) == prefix;
        digit = (unsigned)(w >> shift) & 0xFFu;
      }
      const unsigned peers = __match_any_sync(0xffffffffu, in ? digit : 0xFFFFFFFFu);
      if (in && (__ffs(peers) - 1) == lane) atomicAdd(&bins[digit], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {
      // Lane j holds bins 255 - 8j down to 248 - 8j: the scan runs from
      // the top digit down.
      int c[8];
      int sum = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        c[q] = bins[255 - (lane * 8 + q)];
        sum += c[q];
      }
      int incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      const int need = s_need;
      int acc = incl - sum;
      if (acc < need && need <= incl) {
        bool found = false;
#pragma unroll
        for (int q = 0; q < 8; ++q) {  // unrolled, no break: c[] stays in registers
          if (!found && acc + c[q] >= need) {
            const unsigned long long digit = 255 - (lane * 8 + q);
            s_need = need - acc;
            s_prefix = prefix | (digit << shift);
            s_done = c[q] == need - acc;
            found = true;
          }
          if (!found) acc += c[q];
        }
      }
    }
    __syncthreads();
    prefix = s_prefix;
    decided |= 0xFFull << shift;
    if (s_done) break;
  }

  // 3. Compact the k_out words >= prefix to the front, then sort them.
  for (int base = 0; base < scap; base += kThreads) {
    const int i = base + tid;
    const unsigned long long w = i < scap ? word[i] : 0ull;
    __syncthreads();  // every word of the chunk read before any lands
    if (i < scap && w >= prefix) word[atomicAdd(&s_fill, 1)] = w;
  }
  __syncthreads();
  for (int i = k_out + tid; i < kpow2; i += kThreads) word[i] = 0ull;  // below every real word
  __syncthreads();
  if (kpow2 <= kThreads) {
    unsigned long long v = tid < kpow2 ? word[tid] : 0ull;
    for (int size = 2; size <= kpow2; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        unsigned long long p;
        if (stride >= 32) {
          __syncthreads();
          if (tid < kpow2) word[tid] = v;
          __syncthreads();
          p = tid < kpow2 ? word[tid ^ stride] : 0ull;
        } else {
          p = __shfl_xor_sync(0xffffffffu, v, stride);
        }
        const bool keep_high = ((tid & size) == 0) == ((tid & stride) == 0);
        v = keep_high ? (v > p ? v : p) : (v > p ? p : v);
      }
    }
    __syncthreads();
    if (tid < kpow2) word[tid] = v;
  } else {
    for (int size = 2; size <= kpow2; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = tid; i < kpow2; i += kThreads) {
          const int j = i ^ stride;
          if (j > i) {
            const unsigned long long a = word[i], b = word[j];
            if (((i & size) == 0) ? (a < b) : (a > b)) {
              word[i] = b;
              word[j] = a;
            }
          }
        }
        __syncthreads();
      }
    }
  }
  __syncthreads();

  // 4. The rows.
  const long long out = l * k_out;
  for (int r = tid; r < k_out; r += kThreads) {
    const long long i = (long long)(0xFFFFFFFFu - (uint32_t)word[r]);
    o1[out + r] = f1[i];
    o2[out + r] = sfp2[l * lane_stride + i];
    od[out + r] = sdep[l * lane_stride + i];
    oa[out + r] = sact[l * lane_stride + i];
    ovalid[out + r] = i < occ;
  }
}

}  // namespace

// lanes slabs, slab l's lanes at l * lane_stride, its occupancy at
// counts[l * count_stride]; scap <= 16384 rows, 0 < k_out <= scap;
// outputs [lanes, k_out].
extern "C" int srt_slab_bottomk(const void* sfp1, const void* sfp2,
                                const void* sdep, const void* sact,
                                long long lane_stride, long long scap,
                                const void* counts, long long count_stride,
                                long long k_out, void* o1, void* o2, void* od,
                                void* oa, void* ovalid, long long lanes,
                                void* stream) {
  if (scap < 1 || scap > kMaxRows || k_out < 1 || k_out > scap || lanes < 1 || lanes > 0x7FFFFFFF) {
    return (int)cudaErrorInvalidValue;
  }
  int kpow2 = 1;
  while (kpow2 < k_out) kpow2 <<= 1;
  const size_t bytes = (size_t)(scap > kpow2 ? scap : kpow2) * sizeof(unsigned long long);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(bottomk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  bottomk_kernel<<<(unsigned)lanes, kThreads, bytes, (cudaStream_t)stream>>>(
      (const long long*)sfp1, (const long long*)sfp2, (const long long*)sdep,
      (const long long*)sact, lane_stride, (int)scap, (const long long*)counts,
      count_stride, (int)k_out, kpow2, (long long*)o1, (long long*)o2,
      (long long*)od, (long long*)oa, (bool*)ovalid);
  return (int)cudaGetLastError();
}
