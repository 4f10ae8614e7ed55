// K9b: the sample slab's era epilogue — the bottom-k rows by h1.
//
// Replaces stateright_tpu/engines/tpu_bfs.py:983-995: over the scap slab
// rows, key = (i < occupied) ? ~fp1 : 0 (uint32), and `lax.top_k(key,
// sk2)` picks the sk2 LARGEST keys — the smallest fp1 among the used rows
// — in descending key order, lower row index first among equal keys. The
// output is those rows' (fp1, fp2, depth, action) and a validity lane
// (row < occupied: a real fp1 of 0xFFFFFFFF also keys to 0).
//
// Design: one block holds every (key, index) pair of the slab in shared
// memory as one 64-bit word, key << 32 | (0xFFFFFFFF - index), and sorts
// them descending with a bitonic network. The words are distinct, so the
// sort is total and the order is exactly top_k's: key descending, then
// index ascending. Padding up to the next power of two sorts as 0, below
// every real word. scap = 1,024 at the default k = 64 (8 KB of shared
// memory); the words live in dynamic shared memory, so a slab of up to
// 16,384 rows (128 KB, the sharded engine's per-shard slab of s_high + R
// rows, parallel/mesh.py) sorts in the same block.
//
// Bound on the card: bytes (read fp1 and occupied, gather and write
// 5 x sk2 values: about 13 KB at scap = 1,024), far under one launch's
// latency; the sort is log2(n)^2 / 2 = 55 shared-memory passes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 16384;
constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
    bottomk_kernel(const long long* __restrict__ sfp1,
                   const long long* __restrict__ sfp2,
                   const long long* __restrict__ sdep,
                   const long long* __restrict__ sact, int scap, int npow2,
                   const long long* __restrict__ counts, int k_out,
                   long long* __restrict__ o1, long long* __restrict__ o2,
                   long long* __restrict__ od, long long* __restrict__ oa,
                   bool* __restrict__ ovalid) {
  extern __shared__ unsigned long long word[];
  const long long occ = counts[0];
  for (int i = threadIdx.x; i < npow2; i += blockDim.x) {
    unsigned long long w = 0ull;
    if (i < scap) {
      uint32_t key = i < occ ? ~(uint32_t)sfp1[i] : 0u;
      w = ((unsigned long long)key << 32) | (0xFFFFFFFFu - (uint32_t)i);
    }
    word[i] = w;
  }
  __syncthreads();
  for (int size = 2; size <= npow2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < npow2; i += blockDim.x) {
        int j = i ^ stride;
        if (j > i) {
          unsigned long long a = word[i], b = word[j];
          bool desc = (i & size) == 0;
          if (desc ? (a < b) : (a > b)) {
            word[i] = b;
            word[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int r = threadIdx.x; r < k_out; r += blockDim.x) {
    long long i = (long long)(0xFFFFFFFFu - (uint32_t)word[r]);
    o1[r] = sfp1[i];
    o2[r] = sfp2[i];
    od[r] = sdep[i];
    oa[r] = sact[i];
    ovalid[r] = i < occ;
  }
}

}  // namespace

// scap <= 16384 slab rows, k_out <= scap; counts[0] = occupied.
extern "C" int srt_slab_bottomk(const void* sfp1, const void* sfp2,
                                const void* sdep, const void* sact,
                                long long scap, const void* counts,
                                long long k_out, void* o1, void* o2, void* od,
                                void* oa, void* ovalid, void* stream) {
  if (scap < 1 || scap > kMaxRows || k_out > scap) return (int)cudaErrorInvalidValue;
  int npow2 = 1;
  while (npow2 < scap) npow2 <<= 1;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t bytes = (size_t)npow2 * sizeof(unsigned long long);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(bottomk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  bottomk_kernel<<<1, kThreads, bytes, st>>>(
      (const long long*)sfp1, (const long long*)sfp2, (const long long*)sdep,
      (const long long*)sact, (int)scap, npow2, (const long long*)counts,
      (int)k_out, (long long*)o1, (long long*)o2, (long long*)od,
      (long long*)oa, (bool*)ovalid);
  return (int)cudaGetLastError();
}
