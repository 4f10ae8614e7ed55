// K13f: the simulation era's gate, step commit and epilogue, on the card.
//
// Replaces, in stateright_tpu/engines/tpu_simulation.py:140 `loop`, the
// `lax.while_loop` predicate `cond` (:168-182), the era's zeroed carry
// (:407-453) and the epilogue (:457-495) that packs `params_out`. With
// it the simulation era runs as one CUDA graph (engines/gpu_simulation.py):
// the walk step's kernels (K1, K13a-c) and the model's step inside a
// conditional WHILE node whose condition this kernel sets.
//
// The era's state is one int64 vector of uint32 values (ops/walk_era.py):
// the JAX `params_out` words, word for word — P_REC .. P_SEED, disc_walk[P],
// disc_plen[P], the coverage tail act[A] | hits[P] | depth[DEPTH_CAP] and
// the sample tail [t1, t2, occupied, 0] | the slab's sk2 smallest rows |
// their ok lane — then, from word x on, the port's words: the step
// counts the walk kernels update (gen, occupied, the recorded bits, maxd,
// frozen; ops/walk.py `stats`), the era's steps, the steps run and the
// gate.
//
// Modes:
//   BEGIN     once an era, after the prologue (K13b's restart of frozen
//             walks): take the era's inputs from `era_in` (the head words
//             P_REC .. P_SEED and the sample threshold: the host's one
//             small upload an era), zero the era's counts, first-hit lanes
//             (hseen, plen [P, B]) and coverage tail, then the gate. A grid
//             of blocks zeroes; thread 0 of block 0 does the words.
//   COMMIT    once a step, after it: steps + 1, then the gate. The gate
//             (`cond`): open while steps < max_steps, the finish masks
//             are unmet, gen0 + gen < the generated target (when one is
//             set) and, sampling on, occupied <= s_high. Beyond JAX: when
//             every walk is frozen the steps left would change nothing but
//             the step count, so steps becomes max_steps (the reference's
//             count) and the gate closes: no no-op step runs.
//   EPILOGUE  once an era: each property's shortest first hit (the least
//             plen among the walks that hit it, the first walk on ties,
//             `jnp.argmin` over where(hseen, plen, MAX); walk 0 when none
//             did) into disc_walk / disc_plen, the recorded bits, the
//             generated total gen0 + gen, the steps, max depth and the
//             occupancy words. The sample rows come from K13d's launch
//             right after it.
// A conditional-node handle other than 0 receives the gate (BEGIN,
// COMMIT).
//
// Bound on the card: latency for BEGIN's words and COMMIT (a few scalar
// words: the launch is the cost); bytes for BEGIN's zeroing and the
// epilogue's scan (hseen 1 byte and plen 8 bytes of P x B walks, written
// once by BEGIN and read once by EPILOGUE). Design: the epilogue is one
// block of 1,024 threads that scans each property's walks for the least
// plen << 32 | walk key (a block min over 64-bit keys).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// stateright_tpu/engines/tpu_simulation.py:61-71.
constexpr int P_REC = 0, P_MAX_STEPS = 1, P_FIN_ANY = 2, P_FIN_ALL = 3, P_FIN_ALL_EN = 4,
              P_TARGET_GEN = 5, P_GEN0 = 6, P_GEN = 7, P_STEPS = 8, P_MAXD = 9, P_SEED = 10,
              P_LEN = 11;
// The port's words from cfg.x (ops/walk_era.py X_*); the first five are
// ops/walk.py's stats, in its order.
constexpr int X_GEN = 0, X_OCC = 1, X_REC = 2, X_MAXD = 3, X_FROZEN = 4, X_STEPS = 5, X_RUN = 6,
              X_OPEN = 7;
constexpr int MODE_BEGIN = 0, MODE_COMMIT = 1, MODE_EPILOGUE = 2;
constexpr long long M32 = 0xFFFFFFFFll;
constexpr int kThreads = 1024;
constexpr int kMaxProps = 32;
constexpr unsigned long long kNone = ~0ull;

// The host's config vector (ops/walk_era.py CFG_FIELDS), in this order;
// an absent tail's offset is -1.
struct Cfg {
  long long P, B, cov_base, n_cov, s_base, s_high, x;
};
constexpr int kCfgLen = 7;

__device__ void gate(const Cfg& c, long long* s, cudaGraphConditionalHandle h) {
  long long* x = s + c.x;
  const long long rec = x[X_REC];
  const bool fin = (rec & s[P_FIN_ANY]) != 0 ||
                   (s[P_FIN_ALL_EN] != 0 && (rec & s[P_FIN_ALL]) == s[P_FIN_ALL]);
  const long long target = s[P_TARGET_GEN];
  bool open = x[X_STEPS] < s[P_MAX_STEPS] && !fin &&
              (target == 0 || s[P_GEN0] + x[X_GEN] < target);
  if (c.s_base >= 0) open = open && x[X_OCC] <= c.s_high;
  if (open && x[X_FROZEN] >= c.B) {
    // Every walk frozen: the rest of the era is no-op steps.
    x[X_STEPS] = s[P_MAX_STEPS];
    open = false;
  }
  x[X_OPEN] = open;
  if (h) cudaGraphSetConditional(h, open ? 1u : 0u);
}

__global__ void begin_kernel(const Cfg c, long long* s, const long long* era_in, bool* hseen,
                             long long* plen, cudaGraphConditionalHandle h) {
  const long long n = c.P * c.B;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    hseen[i] = false;
    plen[i] = 0;
  }
  if (blockIdx.x != 0) return;
  for (long long i = threadIdx.x; i < c.n_cov; i += blockDim.x) s[c.cov_base + i] = 0;
  if (threadIdx.x != 0) return;
  for (int i = 0; i < P_LEN; ++i) s[i] = era_in[i];
  if (c.s_base >= 0) {
    s[c.s_base] = era_in[P_LEN];
    s[c.s_base + 1] = era_in[P_LEN + 1];
  }
  long long* x = s + c.x;
  x[X_GEN] = x[X_OCC] = x[X_MAXD] = x[X_FROZEN] = 0;
  x[X_REC] = s[P_REC];
  x[X_STEPS] = x[X_RUN] = 0;
  gate(c, s, h);
}

__global__ void commit_kernel(const Cfg c, long long* s, cudaGraphConditionalHandle h) {
  long long* x = s + c.x;
  if (!x[X_OPEN]) {
    if (h) cudaGraphSetConditional(h, 0u);
    return;
  }
  x[X_STEPS] += 1;
  x[X_RUN] += 1;
  gate(c, s, h);
}

__global__ void __launch_bounds__(kThreads)
    epilogue_kernel(const Cfg c, long long* s, const bool* hseen, const long long* plen) {
  __shared__ unsigned long long warp_min[kThreads / 32];
  __shared__ unsigned long long best[kMaxProps];
  const int t = threadIdx.x;
  for (long long i = 0; i < c.P; ++i) {
    unsigned long long key = kNone;
    for (long long b = t; b < c.B; b += kThreads) {
      const long long j = i * c.B + b;
      if (hseen[j]) {
        const unsigned long long k = ((unsigned long long)(plen[j] & M32) << 32) | (unsigned long long)b;
        key = k < key ? k : key;
      }
    }
    for (int d = 16; d > 0; d >>= 1) {
      const unsigned long long o = __shfl_down_sync(0xffffffffu, key, d);
      key = o < key ? o : key;
    }
    if ((t & 31) == 0) warp_min[t >> 5] = key;
    __syncthreads();
    if (t == 0) {
      unsigned long long m = kNone;
      for (int w = 0; w < kThreads / 32; ++w) m = warp_min[w] < m ? warp_min[w] : m;
      best[i] = m;
    }
    __syncthreads();
  }
  if (t != 0) return;
  long long* x = s + c.x;
  long long rec = s[P_REC];
  for (long long i = 0; i < c.P; ++i) {
    const bool found = best[i] != kNone;
    const long long walk = found ? (long long)(best[i] & M32) : 0;
    s[P_LEN + i] = walk;
    s[P_LEN + c.P + i] = plen[i * c.B + walk] & M32;
    if (found) rec |= 1ll << i;
  }
  s[P_REC] = rec;
  const long long total = (s[P_GEN0] + x[X_GEN]) & M32;
  s[P_GEN0] = s[P_GEN] = total;
  s[P_STEPS] = x[X_STEPS] & M32;
  s[P_MAXD] = x[X_MAXD] & M32;
  if (c.s_base >= 0) {
    s[c.s_base + 2] = x[X_OCC] & M32;
    s[c.s_base + 3] = 0;
  }
}

}  // namespace

// mode: 0 BEGIN, 1 COMMIT, 2 EPILOGUE. cfg: the host's config vector (Cfg).
// state: the era's int64 vector. era_in: the era's P_LEN head words and
// the two threshold words (BEGIN). hseen bool [P, B], plen int64 [P, B]:
// the era's first-hit lanes (BEGIN, EPILOGUE). handle: a conditional
// node's handle, or 0. P <= 32.
extern "C" int srt_walk_era(int mode, const void* cfg, void* state, const void* era_in,
                            void* hseen, void* plen, unsigned long long handle, void* stream) {
  Cfg c;
  long long* dst = &c.P;
  for (int i = 0; i < kCfgLen; ++i) dst[i] = ((const long long*)cfg)[i];
  if (c.P < 0 || c.P > kMaxProps || c.B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  long long* s = (long long*)state;
  const cudaGraphConditionalHandle h = (cudaGraphConditionalHandle)handle;
  if (mode == MODE_BEGIN) {
    const long long n = c.P * c.B;
    long long grid = (n + 255) / 256;
    grid = grid < 1 ? 1 : grid > 1024 ? 1024 : grid;
    begin_kernel<<<(unsigned)grid, 256, 0, st>>>(c, s, (const long long*)era_in, (bool*)hseen,
                                                 (long long*)plen, h);
  } else if (mode == MODE_COMMIT) {
    commit_kernel<<<1, 1, 0, st>>>(c, s, h);  // one thread: it sets the conditional once
  } else if (mode == MODE_EPILOGUE) {
    epilogue_kernel<<<1, kThreads, 0, st>>>(c, s, (const bool*)hseen, (const long long*)plen);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
