// K13d: the simulation sample slab's era epilogue — dedup, then the
// bottom sk2 rows by fp1.
//
// Replaces stateright_tpu/engines/tpu_simulation.py:502-531. Over the
// scap slab rows, the first `occupied` are used. A used row whose
// (fp1, fp2) appeared at a lower row is a duplicate (walks revisit
// states); key = (used && !duplicate) ? ~fp1 : 0 (uint32), and
// `lax.top_k(key, sk2)` picks the sk2 largest keys — the smallest fp1 of
// the distinct rows — key descending, lower row first among equal keys.
// Out: those rows' 3 + S lanes (fp1, fp2, depth, state lanes; an unused
// row reads 0, as the JAX slab, zeroed each era, holds there) and ok =
// used && !duplicate.
//
// Why not K9b: its one-block sort holds at most 4,096 rows, and this
// slab holds slab_high_water(k) + B rows (17k at B = 16,384, 66k at
// B = 65,536); the JAX epilogue's [scap, scap] duplicate matrix would be
// 4.3 G compares there. Design, four launches in one call:
//   1. dedup: each used row claims a slot of an open-addressing table of
//      row indices (2*scap rounded up to a power of two, filled with
//      INT_MAX by the wrapper) keyed by its fingerprint: an empty slot is
//      taken by atomicCAS, a slot of the same fingerprint is lowered by
//      atomicMin. The survivor is the lowest row whatever the order of
//      the atomics, so "first occurrence wins" is exact;
//   2. keys: each block takes 4,096 rows, forms one 64-bit word a row,
//      key << 32 | (0xFFFFFFFF - row) (distinct words, so the order is
//      total and is top_k's), marks ok, sorts the words descending with a
//      bitonic network in shared memory (32 KB) and keeps its first sk2;
//   3. the same block sort over the kept words, until one block's worth
//      is left (one more pass at B = 65,536 with the default k);
//   4. one block sorts the rest and gathers the sk2 rows' lanes.
//
// Bound on the card: bytes. fp1 and fp2 of every used row are read (16
// bytes a row) and sk2 rows of 3 + S lanes are gathered; the table costs
// a few bytes a row more. The sorts are (log2 4096)^2 / 2 = 78 passes of
// shared memory a block, on about a dozen SMs at B = 65,536.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kTile = 4096;
constexpr int kEmpty = 0x7FFFFFFF;

__device__ __forceinline__ unsigned long long row_key(const long long* slab,
                                                      long long stride,
                                                      long long r) {
  return ((unsigned long long)(uint32_t)slab[r] << 32) |
         (uint32_t)slab[stride + r];
}

__device__ __forceinline__ unsigned long long slot_of(unsigned long long k,
                                                      unsigned long long mask) {
  k ^= k >> 33;
  k *= 0xFF51AFD7ED558CCDull;
  k ^= k >> 33;
  return k & mask;
}

__global__ void dedup_kernel(const long long* __restrict__ slab, long long scap,
                             const long long* __restrict__ stats,
                             int* __restrict__ table, unsigned long long tmask) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long occ = stats[1];
  if (occ > scap) occ = scap;
  if (r >= occ) return;
  const long long stride = scap + 1;
  const unsigned long long key = row_key(slab, stride, r);
  unsigned long long h = slot_of(key, tmask);
  for (;;) {
    int cur = atomicCAS(table + h, kEmpty, (int)r);
    if (cur == kEmpty) return;
    // Every row in a slot carries the slot's fingerprint.
    if (row_key(slab, stride, cur) == key) {
      atomicMin(table + h, (int)r);
      return;
    }
    h = (h + 1) & tmask;
  }
}

__device__ void sort_desc(unsigned long long* word) {
  for (int size = 2; size <= kTile; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long a = word[i], b = word[j];
          const bool desc = (i & size) == 0;
          if (desc ? (a < b) : (a > b)) {
            word[i] = b;
            word[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Gather the lanes of the rows named by the first sk2 sorted words.
__device__ void gather(const unsigned long long* word, int sk2,
                       const long long* slab, int lanes, long long scap,
                       long long occ, const bool* rowok, long long* out,
                       bool* ok) {
  const long long stride = scap + 1;
  for (int j = threadIdx.x; j < sk2; j += blockDim.x) {
    const long long r = (long long)(0xFFFFFFFFu - (uint32_t)word[j]);
    for (int c = 0; c < lanes; ++c)
      out[(long long)c * sk2 + j] = r < occ ? slab[c * stride + r] : 0;
    ok[j] = rowok[r];
  }
}

__global__ void __launch_bounds__(kThreads)
    keys_kernel(const long long* __restrict__ slab, int lanes, long long scap,
                const long long* __restrict__ stats,
                const int* __restrict__ table, unsigned long long tmask,
                bool* __restrict__ rowok, int sk2,
                unsigned long long* __restrict__ kept, int final_pass,
                long long* __restrict__ out, bool* __restrict__ ok) {
  __shared__ unsigned long long word[kTile];
  long long occ = stats[1];
  if (occ > scap) occ = scap;
  const long long stride = scap + 1;
  for (int t = threadIdx.x; t < kTile; t += blockDim.x) {
    const long long r = (long long)blockIdx.x * kTile + t;
    unsigned long long w = 0ull;
    if (r < scap) {
      bool good = false;
      if (r < occ) {
        const unsigned long long key = row_key(slab, stride, r);
        unsigned long long h = slot_of(key, tmask);
        // Linear probing with no deletions: the rows' slot comes before
        // any empty one on the probe path.
        int cur = table[h];
        while (cur != kEmpty && row_key(slab, stride, cur) != key) {
          h = (h + 1) & tmask;
          cur = table[h];
        }
        good = cur == r;
      }
      rowok[r] = good;
      const uint32_t k = good ? ~(uint32_t)slab[r] : 0u;
      w = ((unsigned long long)k << 32) | (0xFFFFFFFFu - (uint32_t)r);
    }
    word[t] = w;
  }
  __syncthreads();
  sort_desc(word);
  if (final_pass) {
    __syncthreads();
    gather(word, sk2, slab, lanes, scap, occ, rowok, out, ok);
    return;
  }
  for (int j = threadIdx.x; j < sk2; j += blockDim.x)
    kept[(long long)blockIdx.x * sk2 + j] = word[j];
}

__global__ void __launch_bounds__(kThreads)
    merge_kernel(const unsigned long long* __restrict__ in, long long n, int sk2,
                 unsigned long long* __restrict__ kept, int final_pass,
                 const long long* __restrict__ slab, int lanes, long long scap,
                 const long long* __restrict__ stats,
                 const bool* __restrict__ rowok, long long* __restrict__ out,
                 bool* __restrict__ ok) {
  __shared__ unsigned long long word[kTile];
  for (int t = threadIdx.x; t < kTile; t += blockDim.x) {
    const long long i = (long long)blockIdx.x * kTile + t;
    word[t] = i < n ? in[i] : 0ull;  // 0 sorts below every real word
  }
  __syncthreads();
  sort_desc(word);
  if (final_pass) {
    long long occ = stats[1];
    if (occ > scap) occ = scap;
    gather(word, sk2, slab, lanes, scap, occ, rowok, out, ok);
    return;
  }
  for (int j = threadIdx.x; j < sk2; j += blockDim.x)
    kept[(long long)blockIdx.x * sk2 + j] = word[j];
}

}  // namespace

// slab int64 [lanes, scap + 1]; table int32 [tsize] filled with INT_MAX,
// tsize a power of two >= 2 * scap; rowok bool [scap]; scratch int64
// [2 * n_cand], n_cand = ceil(scap / 4096) * sk2; out int64 [lanes, sk2];
// ok bool [sk2]. 0 < sk2 <= min(scap, 2048).
extern "C" int srt_walk_slab(const void* slab, int lanes, long long scap,
                             const void* stats, int sk2, void* table,
                             long long tsize, void* rowok, void* scratch,
                             long long n_cand, void* out, void* ok,
                             void* stream) {
  if (scap < 1 || sk2 < 1 || sk2 > scap || sk2 > kTile / 2 || tsize < 2 * scap ||
      (tsize & (tsize - 1)) || scap >= kEmpty)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long* sl = (const long long*)slab;
  const long long* stt = (const long long*)stats;
  const unsigned long long tmask = (unsigned long long)(tsize - 1);
  dedup_kernel<<<(unsigned)((scap + 255) / 256), 256, 0, st>>>(
      sl, scap, stt, (int*)table, tmask);
  long long blocks = (scap + kTile - 1) / kTile;
  unsigned long long* buf[2] = {(unsigned long long*)scratch,
                                (unsigned long long*)scratch + n_cand};
  keys_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      sl, lanes, scap, stt, (const int*)table, tmask, (bool*)rowok, sk2, buf[0],
      blocks == 1, (long long*)out, (bool*)ok);
  long long n = blocks * sk2;
  int cur = 0;
  while (blocks > 1) {
    blocks = (n + kTile - 1) / kTile;
    merge_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        buf[cur], n, sk2, buf[cur ^ 1], blocks == 1, sl, lanes, scap, stt,
        (const bool*)rowok, (long long*)out, (bool*)ok);
    n = blocks * sk2;
    cur ^= 1;
  }
  return (int)cudaGetLastError();
}
