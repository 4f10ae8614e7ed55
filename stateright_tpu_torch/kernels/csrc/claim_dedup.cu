// K3: approximate in-batch dedup by slot claim, highest index wins,
// within each lane.
//
// Replaces stateright_tpu/ops/frontier.py:20 claim_dedup, and its
// jax.vmap over the lanes of the multiplexed engine. Candidates are
// [lanes, n]; each valid candidate of lane l claims slot
// (h1 ^ h2*0x9E3779B9) & (scratch_cap-1) of the lane's own scratch row;
// the winner is the HIGHEST candidate index in the slot (the rule the JAX
// scatter obeys on XLA:CPU, vmapped or not: ROADMAP P4, P5). A candidate
// is kept if it won its slot or if the winner carries another key.
// Duplicates that survive (two keys on one slot) are arbitrated exactly
// by the visited-set insert. Lanes never share a slot. The solo engine is
// the one-lane case.
//
// Design: zero the scratch, then one launch where every valid candidate
// does atomicMax(scratch[lane, slot], idx+1) — an order-free way to elect
// the highest index — and one launch that reads the winner back.
//
// Bound on the card: bytes. h1, h2 (8 bytes each) and valid (1) are read,
// keep (1) written, plus one random 4-byte atomic and one random read per
// valid candidate, and the scratch zeroed (4 bytes a slot a lane).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t slot_of(long long a, long long b,
                                            uint32_t mask) {
  return ((uint32_t)a ^ ((uint32_t)b * 0x9E3779B9u)) & mask;
}

__global__ void claim_kernel(const long long* __restrict__ h1,
                             const long long* __restrict__ h2,
                             const bool* __restrict__ valid, long long total,
                             long long n, unsigned* __restrict__ scratch,
                             long long scratch_cap) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total || !valid[i]) return;
  long long lane = i / n;
  long long idx = i - lane * n;
  uint32_t mask = (uint32_t)(scratch_cap - 1);
  atomicMax(&scratch[lane * scratch_cap + slot_of(h1[i], h2[i], mask)],
            (unsigned)(idx + 1));
}

__global__ void keep_kernel(const long long* __restrict__ h1,
                            const long long* __restrict__ h2,
                            const bool* __restrict__ valid, long long total,
                            long long n, const unsigned* __restrict__ scratch,
                            long long scratch_cap, bool* __restrict__ keep) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  if (!valid[i]) {
    keep[i] = false;
    return;
  }
  long long lane = i / n;
  long long idx = i - lane * n;
  uint32_t mask = (uint32_t)(scratch_cap - 1);
  long long a = h1[i], b = h2[i];
  long long w =
      (long long)scratch[lane * scratch_cap + slot_of(a, b, mask)] - 1;
  long long wi = lane * n + w;
  keep[i] = (w == idx) || h1[wi] != a || h2[wi] != b;
}

}  // namespace

// h1, h2, valid, keep: [lanes, n]; scratch: uint32[lanes, scratch_cap],
// scratch_cap a power of two; n < 2^32 - 1.
extern "C" int srt_claim_dedup(const void* h1, const void* h2,
                               const void* valid, long long lanes, long long n,
                               void* scratch, long long scratch_cap, void* keep,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(scratch, 0,
                  (size_t)lanes * (size_t)scratch_cap * sizeof(unsigned), st);
  long long total = lanes * n;
  if (total > 0) {
    const int threads = 256;
    unsigned blocks = (unsigned)((total + threads - 1) / threads);
    claim_kernel<<<blocks, threads, 0, st>>>(
        (const long long*)h1, (const long long*)h2, (const bool*)valid, total,
        n, (unsigned*)scratch, scratch_cap);
    keep_kernel<<<blocks, threads, 0, st>>>(
        (const long long*)h1, (const long long*)h2, (const bool*)valid, total,
        n, (const unsigned*)scratch, scratch_cap, (bool*)keep);
  }
  return (int)cudaGetLastError();
}
