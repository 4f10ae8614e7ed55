// K4: batched insert into the open-addressing visited table, one table
// per lane.
//
// Replaces stateright_tpu/ops/visited_set.py:335 insert (its claim rounds
// `_probe_rounds:169` and tail stages `_probe_all:274`), and its jax.vmap
// over the lanes of the multiplexed engine. The TPU version needs claim
// rounds because the TPU has no atomics a kernel can use; here a new key
// is placed with one 64-bit atomicCAS.
//
// Tables: keys[lanes, cap] u64 = (h1 << 32) | h2, 0 = empty (fingerprint
// pairs are never both 0); parents[lanes, cap] u64 = (p1 << 32) | p2, 0 =
// no parent; stamps[lanes, cap] u64, the winner-rule scratch below. cap is
// a power of two. Candidates are [lanes, m]: candidate i belongs to lane
// i / m and probes only that lane's row, from base (i / m) * cap. The
// solo engine is the one-lane case.
//
// Probe sequence, exactly as the JAX table: slot h1 & mask, then
// + (h2 | 1) each step, at most MAX_PROBES positions. A candidate that
// finds neither its key nor an empty slot in those positions is reported
// `unresolved` and placed nowhere: a key further along would be lost to
// lookup_parent_np and to the JAX lookups, which stop at MAX_PROBES.
//
// The winner rule. Among candidates of one call (and one lane) that carry
// the same new key, the JAX claim protocol on XLA:CPU, vmapped or not
// (ROADMAP P4, P5), always keeps the HIGHEST index:
// that candidate stores its parent and is the one marked is_new (which
// fixes the ring order downstream). CAS order here is arbitrary, so three
// ordered launches restore the rule with a per-slot stamp:
//   1. probe: place-or-find with CAS; the placer raises stamps[slot] to
//      epoch << 32 (epoch grows with every call, so stamps never need
//      clearing and older stamps are always smaller; a caller that
//      replays the call from a CUDA graph passes the epoch on the card,
//      and its step raises it after every call);
//   2. stamp: every candidate whose slot carries this epoch raises it to
//      epoch << 32 | (idx + 1) — atomicMax elects the highest index (idx
//      counts over all lanes; within a lane it orders as the lane's own);
//   3. commit: the candidate that owns the stamp writes its parent and
//      sets is_new.
//
// Bound on the card: bytes, and latency of dependent random reads. Per
// active candidate: h1, h2, p1, p2 (32 bytes) read, is_new/unresolved and
// the slot scratch written, and about one random 8-byte table read, one
// CAS and two stamp atomics at low load — one 32-byte sector each, which
// is what the kernel pays on a table far bigger than L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxProbes = 24;  // == ops/visited_set.py MAX_PROBES

// This call's epoch << 32: by value, or from the card when epoch_dev is
// not null.
__device__ __forceinline__ unsigned long long epoch_bits(unsigned long long epoch_hi,
                                                         const long long* epoch_dev) {
  return epoch_dev ? (unsigned long long)*epoch_dev << 32 : epoch_hi;
}

__global__ void probe_kernel(unsigned long long* __restrict__ keys,
                             unsigned long long* __restrict__ stamps,
                             unsigned long long mask,
                             unsigned long long epoch_hi,
                             const long long* __restrict__ epoch_dev,
                             const long long* __restrict__ h1,
                             const long long* __restrict__ h2,
                             const bool* __restrict__ active, long long n,
                             long long m, long long* __restrict__ slot,
                             bool* __restrict__ is_new,
                             bool* __restrict__ unresolved) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  is_new[i] = false;
  unresolved[i] = false;
  slot[i] = -1;
  if (!active[i]) return;
  epoch_hi = epoch_bits(epoch_hi, epoch_dev);
  uint32_t a = (uint32_t)h1[i];
  uint32_t b = (uint32_t)h2[i];
  unsigned long long key = ((unsigned long long)a << 32) | b;
  unsigned long long base = (unsigned long long)(i / m) * (mask + 1ull);
  unsigned long long pos = a & mask;
  unsigned long long stride = b | 1u;
  for (int k = 0; k < kMaxProbes; ++k) {
    unsigned long long s = base + pos;
    unsigned long long cur =
        *reinterpret_cast<volatile unsigned long long*>(&keys[s]);
    if (cur == 0ull) {
      cur = atomicCAS(&keys[s], 0ull, key);
      if (cur == 0ull) {
        slot[i] = (long long)s;
        atomicMax(&stamps[s], epoch_hi);
        return;
      }
    }
    if (cur == key) {
      slot[i] = (long long)s;
      return;
    }
    pos = (pos + stride) & mask;
  }
  unresolved[i] = true;
}

__global__ void stamp_kernel(unsigned long long* __restrict__ stamps,
                             unsigned long long epoch_hi,
                             const long long* __restrict__ epoch_dev,
                             const long long* __restrict__ slot, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long s = slot[i];
  if (s < 0) return;
  epoch_hi = epoch_bits(epoch_hi, epoch_dev);
  if ((stamps[s] & 0xFFFFFFFF00000000ull) == epoch_hi)
    atomicMax(&stamps[s], epoch_hi | (unsigned long long)(i + 1));
}

__global__ void commit_kernel(const unsigned long long* __restrict__ stamps,
                              unsigned long long* __restrict__ parents,
                              unsigned long long epoch_hi,
                              const long long* __restrict__ epoch_dev,
                              const long long* __restrict__ p1,
                              const long long* __restrict__ p2,
                              const long long* __restrict__ slot, long long n,
                              bool* __restrict__ is_new) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long s = slot[i];
  if (s < 0) return;
  epoch_hi = epoch_bits(epoch_hi, epoch_dev);
  if (stamps[s] == (epoch_hi | (unsigned long long)(i + 1))) {
    parents[s] = ((unsigned long long)(uint32_t)p1[i] << 32) |
                 (uint32_t)p2[i];
    is_new[i] = true;
  }
}

}  // namespace

// epoch: this call's epoch, >= 1 and above every earlier call's on these
// tables; or, where epoch_dev (int64[1] on the card) is not null, the
// value there at the launch. Candidates: n = lanes * m of them, m a lane. slot: int64[n]
// scratch (a slot index over all lanes). n < 2^32 - 1.
extern "C" int srt_visited_insert(void* keys, void* parents, void* stamps,
                                  long long cap, unsigned long long epoch,
                                  const void* epoch_dev, const void* h1, const void* h2,
                                  const void* p1, const void* p2,
                                  const void* active, long long n, long long m,
                                  void* slot, void* is_new, void* unresolved,
                                  void* stream) {
  if (n > 0 && m > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = 256;
    unsigned blocks = (unsigned)((n + threads - 1) / threads);
    unsigned long long epoch_hi = epoch << 32;
    unsigned long long mask = (unsigned long long)cap - 1ull;
    probe_kernel<<<blocks, threads, 0, st>>>(
        (unsigned long long*)keys, (unsigned long long*)stamps, mask, epoch_hi,
        (const long long*)epoch_dev, (const long long*)h1, (const long long*)h2, (const bool*)active, n, m,
        (long long*)slot, (bool*)is_new, (bool*)unresolved);
    stamp_kernel<<<blocks, threads, 0, st>>>(
        (unsigned long long*)stamps, epoch_hi, (const long long*)epoch_dev,
        (const long long*)slot, n);
    commit_kernel<<<blocks, threads, 0, st>>>(
        (const unsigned long long*)stamps, (unsigned long long*)parents,
        epoch_hi, (const long long*)epoch_dev, (const long long*)p1, (const long long*)p2,
        (const long long*)slot, n, (bool*)is_new);
  }
  return (int)cudaGetLastError();
}
