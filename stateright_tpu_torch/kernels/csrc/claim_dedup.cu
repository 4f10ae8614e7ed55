// K3: approximate in-batch dedup by slot claim, highest index wins.
//
// Replaces stateright_tpu/ops/frontier.py:20 claim_dedup. Each valid
// candidate claims scratch slot (h1 ^ h2*0x9E3779B9) & (scratch_cap-1);
// the winner is the HIGHEST candidate index in the slot (the rule the JAX
// scatter obeys on XLA:CPU). A candidate is kept if it won its slot or if
// the winner carries another key. Duplicates that survive (two keys on
// one slot) are arbitrated exactly by the visited-set insert.
//
// Design: zero the scratch, then one launch where every valid candidate
// does atomicMax(scratch[slot], idx+1) — an order-free way to elect the
// highest index — and one launch that reads the winner back.
//
// Bound on the card: bytes. h1, h2 (8 bytes each) and valid (1) are read,
// keep (1) written, plus one random 4-byte atomic and one random read per
// valid candidate into a scratch that fits in L2 at bench widths.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t slot_of(long long a, long long b,
                                            uint32_t mask) {
  return ((uint32_t)a ^ ((uint32_t)b * 0x9E3779B9u)) & mask;
}

__global__ void claim_kernel(const long long* __restrict__ h1,
                             const long long* __restrict__ h2,
                             const bool* __restrict__ valid, long long n,
                             unsigned* __restrict__ scratch, uint32_t mask) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  atomicMax(&scratch[slot_of(h1[i], h2[i], mask)], (unsigned)(i + 1));
}

__global__ void keep_kernel(const long long* __restrict__ h1,
                            const long long* __restrict__ h2,
                            const bool* __restrict__ valid, long long n,
                            const unsigned* __restrict__ scratch,
                            uint32_t mask, bool* __restrict__ keep) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!valid[i]) {
    keep[i] = false;
    return;
  }
  long long a = h1[i], b = h2[i];
  long long w = (long long)scratch[slot_of(a, b, mask)] - 1;
  keep[i] = (w == i) || h1[w] != a || h2[w] != b;
}

}  // namespace

// scratch: uint32[scratch_cap], scratch_cap a power of two; n < 2^32 - 1.
extern "C" int srt_claim_dedup(const void* h1, const void* h2,
                               const void* valid, long long n, void* scratch,
                               long long scratch_cap, void* keep,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(scratch, 0, (size_t)scratch_cap * sizeof(unsigned), st);
  if (n > 0) {
    const int threads = 256;
    unsigned blocks = (unsigned)((n + threads - 1) / threads);
    uint32_t mask = (uint32_t)(scratch_cap - 1);
    claim_kernel<<<blocks, threads, 0, st>>>(
        (const long long*)h1, (const long long*)h2, (const bool*)valid, n,
        (unsigned*)scratch, mask);
    keep_kernel<<<blocks, threads, 0, st>>>(
        (const long long*)h1, (const long long*)h2, (const bool*)valid, n,
        (const unsigned*)scratch, mask, (bool*)keep);
  }
  return (int)cudaGetLastError();
}
