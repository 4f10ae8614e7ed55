// K3: approximate in-batch dedup by slot claim, highest index wins,
// within each lane.
//
// Replaces stateright_tpu/ops/frontier.py:20 claim_dedup, and its
// jax.vmap over the lanes of the multiplexed engine. Candidates are
// [lanes, n], of which only lane l's prefix [0, n_val[l]) can be valid
// (the compaction before K3 packs the valid candidates to the front);
// inside the prefix the `valid` mask still decides, so the function is
// JAX's claim_dedup of (valid & index < n_val) for any mask. Each valid
// candidate of lane l claims slot (h1 ^ h2*0x9E3779B9) & (scratch_cap-1)
// of the lane's own scratch row; the winner is the HIGHEST candidate index
// in the slot (the rule the JAX scatter obeys on XLA:CPU, vmapped or not:
// ROADMAP P4, P5). A candidate is kept if it won its slot or if the winner
// carries another key. Duplicates that survive (two keys on one slot) are
// arbitrated exactly by the visited-set insert. Lanes never share a slot.
// The solo engine is the one-lane case.
//
// Design: no memset. A slot is 64 bits, (epoch << 32) | (idx + 1), set by
// a 64-bit atomicMax. The epoch is the scratch's last word: CLAIM tags
// this call's slots with epoch + 1 and KEEP raises the word once CLAIM's
// grid is done, so a slot left by an earlier call carries a smaller epoch
// and always loses: a valid candidate's slot holds this call's highest
// index. The epoch is the scratch's own rather than the visited insert's
// (which rises once a step in the solo era), so that every caller — the
// era, the lanes, the mesh and the stage programs, whose claim stage runs
// without an insert — owns one self-contained workspace. Its 32 bits wrap
// after 2^32 calls, far beyond any run (2pc-10 takes about 5,600 steps).
//
// Two launches over (tile of 256 candidates, lane), a thread a candidate
// (the parallelism that hides the random slot accesses: a design with 16
// candidates a thread and 16-byte keep stores was 2.4x slower at the solo
// widths): CLAIM, then KEEP as its programmatic dependent (Hopper), so a
// KEEP block is scheduled and loads its key while CLAIM runs, then waits
// for CLAIM's grid before it reads a slot. A tile past the lane's n_val
// exits at once in CLAIM and, in KEEP, writes keep = false (16-byte
// stores where the row allows) and exits without reading h1, h2 or
// valid. Every scratch word is left as a later call expects it (slots
// stale, the epoch raised), so a CUDA graph replays a call with no memset
// node and no reset.
//
// Bound on the card: bytes. For the prefix, h1, h2 (8 bytes each) and
// valid (1) read, one random 8-byte atomic a valid candidate and one
// random 8-byte slot read plus the winner's two 8-byte key halves; keep
// (1) written over the whole width. Latency in practice: two dependent
// launches and two dependent round trips in KEEP after its wait.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // candidates a block: a thread each
constexpr int kStore = 16;                     // keep bytes a 16-byte store
constexpr unsigned long long kLow = 0xFFFFFFFFull;

__device__ __forceinline__ uint32_t slot_of(long long a, long long b, uint32_t mask) {
  return ((uint32_t)a ^ ((uint32_t)b * 0x9E3779B9u)) & mask;
}

struct Args {
  const long long* h1;           // [lanes, n]
  const long long* h2;
  const bool* valid;             // [lanes, n]
  const long long* n_val;        // [lanes], or null: the whole width
  long long n, lanes;
  unsigned long long* slots;     // [lanes, cap], then the epoch word
  long long cap;
  bool* keep;                    // [lanes, n]
  bool vec;                      // keep rows are whole 16-byte runs, aligned
};

// The lane's prefix: min(n_val, n).
__device__ __forceinline__ long long prefix(const Args& a, long long lane) {
  if (a.n_val == nullptr) return a.n;
  const long long v = a.n_val[lane];
  return v < a.n ? (v > 0 ? v : 0) : a.n;
}

__global__ void __launch_bounds__(kThreads) claim_kernel(const Args a) {
  // KEEP may be scheduled now: it waits for this grid itself.
  asm volatile("griddepcontrol.launch_dependents;");
  const long long lane = blockIdx.y;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long lim = prefix(a, lane);
  if ((long long)blockIdx.x * kThreads >= lim) return;
  // The epoch, the mask and the key in one round trip before the atomic
  // (a thread past the prefix reads its block's first candidate).
  const long long j = lane * a.n + (i < lim ? i : (long long)blockIdx.x * kThreads);
  const unsigned long long epoch = a.slots[a.lanes * a.cap];
  const bool v = a.valid[j];
  const long long k1 = a.h1[j], k2 = a.h2[j];
  if (i >= lim || !v) return;
  const unsigned long long tag = ((epoch + 1) & kLow) << 32;
  atomicMax(a.slots + lane * a.cap + slot_of(k1, k2, (uint32_t)(a.cap - 1)), tag | (unsigned long long)(i + 1));
}

__global__ void __launch_bounds__(kThreads) keep_kernel(const Args a) {
  const long long lane = blockIdx.y;
  const long long lo = (long long)blockIdx.x * kThreads;
  const long long lim = prefix(a, lane);
  bool* krow = a.keep + lane * a.n;
  const int t = threadIdx.x;
  if (blockIdx.x == 0 && blockIdx.y == 0 && t == 0) {
    // The epoch rises once CLAIM's grid, the last reader of it, is done.
    asm volatile("griddepcontrol.wait;" ::: "memory");
    a.slots[a.lanes * a.cap] += 1;
  }
  if (lo >= lim) {
    // Past the prefix: keep is false, h1 / h2 / valid are not read.
    const long long e0 = lo + (long long)t * kStore;
    if (a.vec) {
      if (t < kThreads / kStore && e0 < a.n) *reinterpret_cast<uint4*>(krow + e0) = make_uint4(0, 0, 0, 0);
    } else if (lo + t < a.n) {
      krow[lo + t] = false;
    }
    return;
  }
  const long long i = lo + t;
  if (i >= a.n) return;
  const long long j = lane * a.n + i;
  // The key is asked for before CLAIM's grid is waited on.
  const bool v = i < lim && a.valid[j];
  const long long k1 = a.h1[j], k2 = a.h2[j];
  asm volatile("griddepcontrol.wait;" ::: "memory");
  bool keep = false;
  if (v) {
    const unsigned long long* row = a.slots + lane * a.cap;
    const long long w = (long long)(__ldcg(row + slot_of(k1, k2, (uint32_t)(a.cap - 1))) & kLow) - 1;
    keep = w == i || a.h1[lane * a.n + w] != k1 || a.h2[lane * a.n + w] != k2;
  }
  krow[i] = keep;
}

}  // namespace

// h1, h2, keep: [lanes, n]; valid: bool [lanes, n]; n_val: int64
// [lanes] (each lane's valid prefix) or null (the whole width); scratch:
// uint64 [lanes * scratch_cap + 1] (ops/frontier.py dedup_scratch: zero
// when made, then left by each call for the next), scratch_cap a
// power of two; n < 2^32 - 1, lanes <= 65535.
extern "C" int srt_claim_dedup(const void* h1, const void* h2, const void* valid,
                               const void* n_val, long long lanes, long long n, void* scratch,
                               long long scratch_cap, void* keep, void* stream) {
  if (lanes < 1 || lanes > 65535 || n < 0 || scratch_cap < 2 || (scratch_cap & (scratch_cap - 1)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  Args a{};
  a.h1 = (const long long*)h1;
  a.h2 = (const long long*)h2;
  a.valid = (const bool*)valid;
  a.n_val = (const long long*)n_val;
  a.n = n;
  a.lanes = lanes;
  a.slots = (unsigned long long*)scratch;
  a.cap = scratch_cap;
  a.keep = (bool*)keep;
  a.vec = n % kStore == 0 && (reinterpret_cast<uintptr_t>(keep) & 15) == 0;
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)lanes);
  claim_kernel<<<grid, kThreads, 0, st>>>(a);
  // KEEP as a programmatic dependent of CLAIM.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, keep_kernel, a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
