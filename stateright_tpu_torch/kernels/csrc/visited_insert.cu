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
// a power of two. Candidates are [lanes, m]: candidate i of lane l probes
// only that lane's row, from base l * cap. The solo engine is the
// one-lane case.
//
// Probe sequence, exactly as the JAX table: slot h1 & mask, then
// + (h2 | 1) each step, at most MAX_PROBES positions. A candidate that
// finds neither its key nor an empty slot in those positions is reported
// `unresolved` and placed nowhere: a key further along would be lost to
// lookup_parent_np and to the JAX lookups, which stop at MAX_PROBES.
//
// The winner rule. Among candidates of one call (and one lane) that carry
// the same new key, the JAX claim protocol on XLA:CPU, vmapped or not
// (ROADMAP P4, P5), always keeps the HIGHEST index: that candidate
// stores its parent and is the one marked is_new (which fixes the ring
// order downstream). CAS order here is arbitrary, so three ordered
// phases restore the rule with a per-slot stamp, epoch << 32 | (i + 1)
// for candidate i of its lane (epoch grows with every call, so stamps
// never need clearing and older stamps are always smaller; a caller that
// replays the call from a CUDA graph passes the epoch on the card, and
// its step raises it after every call). A finder cannot tell a key
// placed in this call from an older one until every placement is
// visible, hence the phases:
//   1. PROBE: place-or-find with CAS. A placer finishes its own work at
//      once: it stores its stamp, writes its parent and marks itself
//      is_new provisionally. Each candidate leaves a state byte (none,
//      placed or found), and a finder its slot within the lane (32 bits).
//   2. STAMP, finders only: a finder whose slot carries this call's epoch
//      and a lower index raises it with atomicMax and, where that took,
//      marks itself contested and clears the is_new of the candidate the
//      old stamp named (the placer, whose is_new PROBE set, or a finder
//      that cannot win now); a finder of an older key is done after one
//      stamp read. Exactly one finder sees a given stamp as the old
//      value, so each is_new has one writer in this phase.
//   3. COMMIT, contested finders only: the finder the stamp still names
//      writes its parent and sets is_new.
// Per new key that is one random stamp touch (the placer's store) where
// the three-pass version made three, and one per finder of an older key
// where it made two; in-batch copies of a new key (rare after K3's
// dedup) pay one more read and an atomic each. STAMP and COMMIT are
// programmatic dependents (Hopper): their blocks are scheduled while the
// phase before runs and wait for its grid before their first read of
// what it wrote. The grid is (tile, lane), so no thread divides in 64
// bits.
//
// Bound on the card: bytes, and latency of dependent random reads. Per
// active candidate: h1, h2, p1, p2 (32 bytes) read, is_new/unresolved and
// the state byte written; per placed or found candidate its 4-byte slot;
// and about one random 8-byte key read, for a new key one CAS, one stamp
// store and one parent store, for a found key one stamp read — one
// 32-byte sector each, which is what the kernel pays on a table far
// bigger than L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxProbes = 24;  // == ops/visited_set.py MAX_PROBES
constexpr int kThreads = 256;
constexpr unsigned long long kHi = 0xFFFFFFFF00000000ull;

enum : unsigned char { kNone = 0, kPlaced = 1, kFound = 2, kContested = 3 };

// This call's epoch << 32: by value, or from the card when epoch_dev is
// not null (written before PROBE, which launches after it completes).
__device__ __forceinline__ unsigned long long epoch_bits(unsigned long long epoch_hi,
                                                         const long long* epoch_dev) {
  return epoch_dev ? (unsigned long long)*epoch_dev << 32 : epoch_hi;
}

__device__ __forceinline__ unsigned long long pack(long long hi, long long lo) {
  return ((unsigned long long)(uint32_t)hi << 32) | (uint32_t)lo;
}

struct Args {
  unsigned long long* keys;
  unsigned long long* parents;
  unsigned long long* stamps;
  unsigned long long cap;
  unsigned long long epoch_hi;
  const long long* epoch_dev;
  const long long* h1;
  const long long* h2;
  const long long* p1;
  const long long* p2;
  const bool* active;
  long long m;
  uint32_t* slot;
  unsigned char* state;
  bool* is_new;
  bool* unresolved;
};

__global__ void __launch_bounds__(kThreads) probe_kernel(Args a) {
  // STAMP may be scheduled now: it waits for this grid itself.
  asm volatile("griddepcontrol.launch_dependents;");
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.m) return;
  const long long g = (long long)blockIdx.y * a.m + i;
  bool placed = false, unres = false;
  unsigned char st = kNone;
  // One round trip for the inputs: the fingerprint halves are read
  // beside the mask, not after it.
  const bool act = a.active[g];
  const uint32_t h = (uint32_t)a.h1[g], b = (uint32_t)a.h2[g];
  if (act) {
    const unsigned long long eh = epoch_bits(a.epoch_hi, a.epoch_dev);
    // The parent, in flight while the key is probed.
    const unsigned long long par = pack(a.p1[g], a.p2[g]);
    const unsigned long long key = ((unsigned long long)h << 32) | b;
    const unsigned long long mask = a.cap - 1ull;
    const unsigned long long base = (unsigned long long)blockIdx.y * a.cap;
    unsigned long long pos = h & mask;
    const unsigned long long stride = b | 1u;
    unres = true;
    for (int k = 0; k < kMaxProbes; ++k) {
      unsigned long long* p = &a.keys[base + pos];
      unsigned long long cur = *reinterpret_cast<volatile unsigned long long*>(p);
      if (cur == 0ull) {
        cur = atomicCAS(p, 0ull, key);
        if (cur == 0ull) {
          a.stamps[base + pos] = eh | (unsigned long long)(i + 1);
          a.parents[base + pos] = par;
          placed = true;
          st = kPlaced;
        }
      }
      if (placed || cur == key) {
        if (!placed) {
          st = kFound;
          a.slot[g] = (uint32_t)pos;
        }
        unres = false;
        break;
      }
      pos = (pos + stride) & mask;
    }
  }
  a.is_new[g] = placed;
  a.unresolved[g] = unres;
  a.state[g] = st;
}

__global__ void __launch_bounds__(kThreads) stamp_kernel(Args a) {
  asm volatile("griddepcontrol.launch_dependents;");
  const unsigned long long eh = epoch_bits(a.epoch_hi, a.epoch_dev);
  // PROBE's slots, states and stamps, complete and visible.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.m) return;
  const long long g = (long long)blockIdx.y * a.m + i;
  if (a.state[g] != kFound) return;
  unsigned long long* p = &a.stamps[(unsigned long long)blockIdx.y * a.cap + a.slot[g]];
  const unsigned long long cur = __ldcg(p);
  const unsigned long long mine = eh | (unsigned long long)(i + 1);
  // An older key, or a higher index already holds the stamp: done.
  if ((cur & kHi) != eh || cur > mine) return;
  const unsigned long long old = atomicMax(p, mine);
  if (old < mine) {
    a.state[g] = kContested;
    // The stamp's epoch is this call's from PROBE on, so `old` names the
    // candidate (placer or finder) that held it: not the winner now.
    a.is_new[(long long)blockIdx.y * a.m + (long long)(old & 0xFFFFFFFFull) - 1] = false;
  }
}

__global__ void __launch_bounds__(kThreads) commit_kernel(Args a) {
  const unsigned long long eh = epoch_bits(a.epoch_hi, a.epoch_dev);
  // STAMP's grid (and so PROBE's), complete and visible.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.m) return;
  const long long g = (long long)blockIdx.y * a.m + i;
  if (a.state[g] != kContested) return;
  const unsigned long long s = (unsigned long long)blockIdx.y * a.cap + a.slot[g];
  if (__ldcg(&a.stamps[s]) == (eh | (unsigned long long)(i + 1))) {
    a.parents[s] = pack(a.p1[g], a.p2[g]);
    a.is_new[g] = true;
  }
}

cudaError_t launch_dependent(void (*kernel)(Args), dim3 grid, const Args& a, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

}  // namespace

// epoch: this call's epoch, >= 1 and above every earlier call's on these
// tables; or, where epoch_dev (int64[1] on the card) is not null, the
// value there at the launch. Candidates: n = lanes * m of them, m a
// lane, lanes <= 65535, m < 2^32 - 1, cap <= 2^32. Scratch: slot
// uint32[n] (a slot within the lane) and state uint8[n].
extern "C" int srt_visited_insert(void* keys, void* parents, void* stamps,
                                  long long cap, unsigned long long epoch,
                                  const void* epoch_dev, const void* h1, const void* h2,
                                  const void* p1, const void* p2,
                                  const void* active, long long n, long long m,
                                  void* slot, void* state, void* is_new, void* unresolved,
                                  void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaGetLastError();
  if (n % m || n / m > 65535 || m >= 0xFFFFFFFFll || cap < 1 || cap > (1ll << 32) || (cap & (cap - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Args a{(unsigned long long*)keys, (unsigned long long*)parents, (unsigned long long*)stamps,
         (unsigned long long)cap, epoch << 32, (const long long*)epoch_dev,
         (const long long*)h1, (const long long*)h2, (const long long*)p1, (const long long*)p2,
         (const bool*)active, m, (uint32_t*)slot, (unsigned char*)state, (bool*)is_new,
         (bool*)unresolved};
  const dim3 grid((unsigned)((m + kThreads - 1) / kThreads), (unsigned)(n / m));
  probe_kernel<<<grid, kThreads, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) e = launch_dependent(stamp_kernel, grid, a, st);
  if (e == cudaSuccess) e = launch_dependent(commit_kernel, grid, a, st);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
