// K6: batched parent lookup in the visited table, or in the lanes' stacked
// tables.
//
// Replaces stateright_tpu/ops/visited_set.py:411 lookup_parent (jitted at
// :486), and the per-lane lookups of the multiplexed engine's path
// reconstruction (stateright_tpu/engines/multiplex.py:280). A query may
// name its lane (lane[i]; NULL = lane 0 for every query, the solo table):
// it then probes rows lane[i] * cap .. of the stacked [lanes, cap] table.
// For each fingerprint (h1, h2) it walks the insert's probe
// sequence — slot h1 & mask, then + (h2 | 1) each step, at most
// MAX_PROBES positions, the sequence of visited_insert.cu and of
// ops/visited_set.py lookup_parent_np — and returns (found, parent_h1,
// parent_h2). An empty slot ends the walk (the key is absent); a key
// past MAX_PROBES positions is never stored, so the walk stops there too.
//
// Table layout (visited_insert.cu): keys[lanes, cap] u64 = (h1 << 32) |
// h2, 0 = empty; parents[lanes, cap] u64 = (p1 << 32) | p2.
//
// Path reconstruction calls it once per hop with every chain of the run
// (of every lane of a multiplexed batch) batched together, so the tables
// never leave the card.
//
// Bound on the card: latency of dependent random reads. Per fingerprint:
// h1, h2 read (16 bytes), found/p1/p2 written (17 bytes), and about one
// random 8-byte key read and one parent read at low load — one 32-byte
// sector each. Design: one thread per fingerprint; the batch is small
// (a few dozen to a few thousand chains), so the kernel is one short
// wave.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxProbes = 24;  // == ops/visited_set.py MAX_PROBES

__global__ void lookup_kernel(const unsigned long long* __restrict__ keys,
                              const unsigned long long* __restrict__ parents,
                              unsigned long long mask,
                              const long long* __restrict__ lane,
                              const long long* __restrict__ h1,
                              const long long* __restrict__ h2, long long n,
                              bool* __restrict__ found,
                              long long* __restrict__ p1,
                              long long* __restrict__ p2) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t a = (uint32_t)h1[i];
  uint32_t b = (uint32_t)h2[i];
  unsigned long long key = ((unsigned long long)a << 32) | b;
  unsigned long long base =
      lane ? (unsigned long long)lane[i] * (mask + 1ull) : 0ull;
  unsigned long long pos = a & mask;
  unsigned long long stride = b | 1u;
  bool hit = false;
  unsigned long long par = 0ull;
  for (int k = 0; k < kMaxProbes; ++k) {
    unsigned long long cur = keys[base + pos];
    if (cur == key) {
      hit = true;
      par = parents[base + pos];
      break;
    }
    if (cur == 0ull) break;
    pos = (pos + stride) & mask;
  }
  found[i] = hit;
  p1[i] = (long long)(par >> 32);
  p2[i] = (long long)(par & 0xFFFFFFFFull);
}

}  // namespace

// cap: slots a lane; lane: int64[n] lane of each query, or NULL.
extern "C" int srt_lookup_parent(const void* keys, const void* parents,
                                 long long cap, const void* lane,
                                 const void* h1, const void* h2, long long n,
                                 void* found, void* p1, void* p2,
                                 void* stream) {
  if (n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = 256;
    unsigned blocks = (unsigned)((n + threads - 1) / threads);
    lookup_kernel<<<blocks, threads, 0, st>>>(
        (const unsigned long long*)keys, (const unsigned long long*)parents,
        (unsigned long long)cap - 1ull, (const long long*)lane,
        (const long long*)h1,
        (const long long*)h2, n, (bool*)found, (long long*)p1, (long long*)p2);
  }
  return (int)cudaGetLastError();
}
