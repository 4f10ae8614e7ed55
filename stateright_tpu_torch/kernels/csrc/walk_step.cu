// K13b: the rest of one walk step, and the era prologue's restart.
//
// Replaces stateright_tpu/engines/tpu_simulation.py:268-380 (property
// evaluation, terminal and capped walks, eventually hits at a walk's end,
// first-hit snapshots and freezing, the PRNG choice, advance or restart)
// and the prologue :394-405 (walks that arrive frozen restart and thaw).
// Per walk w, after K13a gave counted[w] and cycle[w]:
//   - property i on the current state, from the raw predicate
//     checks[i, w]: an eventually property clears its ebit when counted
//     and satisfied; an always property hits when counted and violated;
//     a sometimes property hits when counted and satisfied;
//   - ne = the number of valid successors (valid[a, w]); terminal =
//     counted && ne == 0; capped = counted && ptr >= L; an eventually
//     property whose ebit is still set hits when the walk ends
//     (terminal or cycle);
//   - a hit sets hseen[i, w]; the first one this era records plen[i, w] =
//     ptr and freezes the walk (stats[4] counts the walks frozen this
//     era); stats[2] |= 1 << i and, with coverage, cov[A + i] += 1;
//   - r = prng(seed ^ ptr * 0x9E3779B9), pick = r % ne: the pick-th
//     valid action in action order; an advancing walk (counted, not
//     terminal, capped or newly frozen) takes its successor row
//     succ[a, :, w] and, with coverage, cov[a] += 1;
//   - a restarting walk (active, not newly frozen, cycle/terminal/capped)
//     takes seed2 = prng(seed + 0x6A09E667), the init row
//     prng(seed2) % n_init, ebits = init_ebits and ptr = 0.
// The era prologue (its own entry point, srt_walk_prologue) runs only the
// last rule, for the frozen walks, and thaws every walk.
//
// walk int64 [S + 4, B] (S lanes, seed, ptr, ebits, frozen); checks bool
// [P, B]; valid bool [A, B]; succ int64 [A, S, B], the successor lanes
// stacked once a step by the wrapper's caller (a copy of A*S*B words: one
// coalesced pass, where an array of A*S lane pointers would cost an upload
// a step); inits int64 [S, n_init]; hseen bool [P, B]; plen int64 [P, B];
// stats int64 [5]; cov int64 [A + P + ...] or null. P <= 32, A <= 64.
//
// Bound on the card: bytes. Each walk reads seed, ptr, ebits and frozen,
// counted and cycle, P predicate and A validity bytes, and writes ebits;
// an advancing walk reads its successor row and writes its S lanes, a
// restarting walk writes S + 3 lanes, and a first hit writes its hseen
// and plen. The arithmetic is two short hash chains. Design: one thread
// per walk; the valid actions form a
// 64-bit mask, so the pick-th one is found by clearing the lowest bit
// pick times; per-property hit counts and recorded bits are reduced in
// the warp by vote before their atomics, and the taken-action counts in a
// shared-memory histogram before one atomic per action and block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kChooseMul = 0x9E3779B9u;
constexpr uint32_t kRestartAdd = 0x6A09E667u;

__device__ __forceinline__ uint32_t prng(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

__device__ __forceinline__ void restart_walk(long long* walk, int S, long long B,
                                             long long w, uint32_t seed,
                                             const long long* inits,
                                             long long n_init,
                                             long long init_ebits) {
  const uint32_t seed2 = prng(seed + kRestartAdd);
  const uint32_t pick = prng(seed2) % (uint32_t)n_init;
  for (int s = 0; s < S; ++s) walk[(long long)s * B + w] = inits[(long long)s * n_init + pick];
  walk[(long long)S * B + w] = seed2;
  walk[(long long)(S + 1) * B + w] = 0;
  walk[(long long)(S + 2) * B + w] = init_ebits;
}

__global__ void __launch_bounds__(kThreads)
    prologue_kernel(long long* __restrict__ walk, int S, long long B,
                    const long long* __restrict__ inits, long long n_init,
                    long long init_ebits) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= B) return;
  long long* frozen = walk + (long long)(S + 3) * B + w;
  if (*frozen == 0) return;
  restart_walk(walk, S, B, w, (uint32_t)walk[(long long)S * B + w], inits,
               n_init, init_ebits);
  *frozen = 0;
}

__global__ void __launch_bounds__(kThreads)
    step_kernel(long long* __restrict__ walk, int S, long long B, int L,
                const bool* __restrict__ checks, int P, uint32_t ev_mask,
                uint32_t al_mask, const bool* __restrict__ valid, int A,
                const long long* __restrict__ succ,
                const long long* __restrict__ inits, long long n_init,
                long long init_ebits, const bool* __restrict__ counted_in,
                const bool* __restrict__ cycle_in, bool* __restrict__ hseen,
                long long* __restrict__ plen,
                unsigned long long* __restrict__ stats,
                unsigned long long* __restrict__ cov) {
  __shared__ unsigned int act_sh[64];
  for (int a = threadIdx.x; a < A; a += blockDim.x) act_sh[a] = 0;
  __syncthreads();

  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = w < B;
  const int lane = threadIdx.x & 31;
  uint32_t seed = 0;
  long long ptr = 0;
  unsigned long long ebits = 0;
  bool frozen = true, counted = false, cycle = false;
  if (in) {
    seed = (uint32_t)walk[(long long)S * B + w];
    ptr = walk[(long long)(S + 1) * B + w];
    ebits = (unsigned long long)walk[(long long)(S + 2) * B + w];
    frozen = walk[(long long)(S + 3) * B + w] != 0;
    counted = counted_in[w];
    cycle = cycle_in[w];
  }
  const bool active = in && !frozen;

  // Property evaluation on the current state.
  uint32_t hitbits = 0;
  int e = 0;
  for (int i = 0; i < P; ++i) {
    const bool c = in && checks[(long long)i * B + w];
    if ((ev_mask >> i) & 1u) {
      if (counted && c) ebits &= ~(1ull << e);
      ++e;
    } else if ((al_mask >> i) & 1u) {
      if (counted && !c) hitbits |= 1u << i;
    } else if (counted && c) {
      hitbits |= 1u << i;
    }
  }

  unsigned long long vmask = 0;
  if (in)
    for (int a = 0; a < A; ++a)
      if (valid[(long long)a * B + w]) vmask |= 1ull << a;
  const int ne = __popcll(vmask);
  const bool terminal = counted && ne == 0;
  const bool capped = counted && ptr >= L;
  if (terminal || cycle) {
    e = 0;
    for (int i = 0; i < P; ++i) {
      if (!((ev_mask >> i) & 1u)) continue;
      if ((ebits >> e) & 1ull) hitbits |= 1u << i;
      ++e;
    }
  }

  // First hits: snapshot, freeze; counts reduced in the warp.
  bool newly = false;
  for (int i = 0; i < P; ++i) {
    const bool h = (hitbits >> i) & 1u;
    if (h) {
      bool* seen = hseen + (long long)i * B + w;
      if (!*seen) {
        plen[(long long)i * B + w] = ptr;
        *seen = true;
        newly = true;
      }
    }
    if (cov != nullptr) {
      const int n = __popc(__ballot_sync(0xffffffffu, h));
      if (lane == 0 && n) atomicAdd(cov + A + i, (unsigned long long)n);
    }
  }
  const uint32_t rec = __reduce_or_sync(0xffffffffu, hitbits);
  if (lane == 0 && rec) atomicOr(stats + 2, (unsigned long long)rec);
  const int n_frozen = __popc(__ballot_sync(0xffffffffu, newly));
  if (lane == 0 && n_frozen) atomicAdd(stats + 4, (unsigned long long)n_frozen);

  // The choice: the pick-th valid action, in action order.
  const bool advance = counted && !terminal && !capped && !newly;
  const bool restart = active && !newly && (cycle || terminal || capped);
  if (advance) {
    const uint32_t r = prng(seed ^ ((uint32_t)ptr * kChooseMul));
    uint32_t pick = r % (uint32_t)ne;
    unsigned long long m = vmask;
    while (pick--) m &= m - 1;
    const int a = __ffsll((long long)m) - 1;
    for (int s = 0; s < S; ++s)
      walk[(long long)s * B + w] =
          succ[((long long)a * S + s) * B + w] & 0xFFFFFFFFll;
    if (cov != nullptr) atomicAdd(&act_sh[a], 1u);
  }
  if (in) {
    walk[(long long)(S + 2) * B + w] = (long long)ebits;
    if (newly) walk[(long long)(S + 3) * B + w] = 1;
  }
  if (restart) restart_walk(walk, S, B, w, seed, inits, n_init, init_ebits);

  if (cov != nullptr) {
    __syncthreads();
    for (int a = threadIdx.x; a < A; a += blockDim.x)
      if (act_sh[a]) atomicAdd(cov + a, (unsigned long long)act_sh[a]);
  }
}

}  // namespace

extern "C" int srt_walk_step(void* walk, int S, long long B, int L,
                             const void* checks, int P, long long ev_mask,
                             long long al_mask, const void* valid, int A,
                             const void* succ, const void* inits,
                             long long n_init, long long init_ebits,
                             const void* counted, const void* cycle,
                             void* hseen, void* plen, void* stats, void* cov,
                             void* stream) {
  if (B < 1 || n_init < 1 || A > 64 || P > 32) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  step_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (long long*)walk, S, B, L, (const bool*)checks, P, (uint32_t)ev_mask,
      (uint32_t)al_mask, (const bool*)valid, A, (const long long*)succ,
      (const long long*)inits, n_init, init_ebits, (const bool*)counted,
      (const bool*)cycle, (bool*)hseen, (long long*)plen,
      (unsigned long long*)stats, (unsigned long long*)cov);
  return (int)cudaGetLastError();
}

// The era prologue: restart the frozen walks and thaw every walk.
extern "C" int srt_walk_prologue(void* walk, int S, long long B,
                                 const void* inits, long long n_init,
                                 long long init_ebits, void* stream) {
  if (B < 1 || n_init < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  prologue_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (long long*)walk, S, B, (const long long*)inits, n_init, init_ebits);
  return (int)cudaGetLastError();
}
