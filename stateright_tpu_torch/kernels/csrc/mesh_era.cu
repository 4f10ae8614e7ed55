// K15f: the sharded era's shard-coupled gate, step commit, epilogue and
// dispatch tail, on the card.
//
// Replaces, in stateright_tpu/parallel/mesh.py:152 `_build_block`, the
// scalar work of the era: `global_gates` (:257-298, the stacked psum
// that gives every shard the same gate), the overflow / unresolved veto
// and the commit (:437-500), the era epilogue (:562-640: each shard's
// shallowest first hit, its max depth, the psum'd pressure / error /
// work / discovery bits and the adaptive next budget), the fused outer
// loop's continuation and its per-shard best-discovery fold (:697-760),
// and the dispatch's output rows (:762-810: the coverage tail psum'd
// into every row, the error word as 0/1, the sample tail's header).
//
// The state is [N, L]: one row a local shard, each the JAX shard's
// params row, then rec_fp1[P] | rec_fp2[P] | disc_depth[P] from d_base,
// then the port's words from x (ops/mesh_era.py X_*). Every global value
// is a SUM over the mesh's shards in the `sums` vector: a phase writes
// this rank's partial sums there and the next phase reads the totals.
// On one rank a launch runs every phase of a mode in order (ph0, ph1,
// ph2; -1 ends the list), so its partials are the totals; across ranks
// the host launches one phase at a time and all-reduces `sums` between.
//
// Phases: START (zero the dispatch's outputs and the sample slabs,
// clamp fuse_lim), BEGIN (open the era), C1 (count each shard's new and
// unresolved inserts; the veto's sums), C2 (commit each shard under the
// global veto), GATE / CGATE (the uniform gate; CGATE keeps a closed
// gate closed), E1 / E2 (the epilogue's sums, then its work), T1 / T2
// (the coverage sums, then the output rows). The last phase of a launch
// sets a conditional-node handle other than 0: the gate (GATE, CGATE),
// 1 (START) or the fused loop's continuation (E2) — what ends the
// sharded era graph's WHILE loops (parallel/mesh.py).
//
// Design: one block of 1,024 threads for the whole rank — the work is a
// few dozen words a shard, a count over each shard's [R] insert masks
// and a min over each (property, shard)'s [chunk] first-hit lanes (one
// warp a pair); one thread a shard does the scalar rules. Phases are
// separated by __syncthreads, so one block needs no grid-wide sync.
//
// Bound on the card: latency — a launch moves a few kilobytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxShards = 64;
constexpr int kMaxProps = 32;
constexpr long long M32 = 0xFFFFFFFFll;
constexpr unsigned long long kNone = ~0ull;

constexpr int P_HEAD = 0, P_COUNT = 1, P_UNIQUE = 2, P_REC = 3, P_GROW_LIMIT = 5,
              P_HIGH_WATER = 6, P_MAX_STEPS = 7, P_GEN = 8, P_MAXD = 9, P_STEPS = 10,
              P_ERR = 11, P_TAKE_CAP = 12, P_FIN_ANY = 13, P_FIN_ALL = 14, P_FIN_ALL_EN = 15,
              P_BUDGET_CAP = 16;
constexpr int X_TAKE = 0, X_OPEN = 1, X_TAIL = 2, X_REC0 = 3, X_UNIQ_IN = 4, X_ESTEPS = 5,
              X_EGEN = 6, X_ITS = 7, X_ITER = 8, X_PARTIAL = 9, X_K = 10, X_MORE = 11,
              X_NEW = 12, X_UNRES = 13;
constexpr int S_UNRES = 0, S_SHRINK = 1, S_GATE = 2;
enum { PH_START, PH_BEGIN, PH_C1, PH_C2, PH_GATE, PH_E1, PH_E2, PH_T1, PH_T2, PH_CGATE };

// The host's config vector, in this order (ops/mesh_era.py CFG_FIELDS).
struct Cfg {
  long long chunk, qmask, P, A, cov_base, s_base, s_high, f_base, fuse, d_base, x, regrow,
      budget_min, n_cov, scap, sum_cov, vcap;
};
constexpr int kCfgLen = 17;

struct In {
  long long* s0;
  long long N, L;
  long long* sums;
  const bool* is_new;      // [N, n]
  const bool* unres;       // [N, n]
  long long n;
  const long long* n_ovf;      // [N]
  const long long* n_val;      // [N]
  const long long* generated;  // [N]
  const long long* hs;         // [P, N]
  const long long* pa;         // [N, A]
  bool* hseen;                 // [P, N * chunk]
  long long* facc1;
  long long* facc2;
  long long* faccd;
  const long long* ring_depth;  // shard l's at ring_depth + l * ring_stride
  long long ring_stride;
  long long* slab;         // [4, N, scap + 1]
  long long* slab_counts;  // [N, 2]
  cudaGraphConditionalHandle h;
};

struct Shared {
  int cnt[2][kMaxShards];                       // new, unresolved (C1)
  int bits[kMaxProps][kMaxShards];              // a first hit of p at shard l
  unsigned long long best[kMaxProps][kMaxShards];  // depth << 32 | position (E2)
  int open;
};

__device__ __forceinline__ bool fin_hit(const long long* s, long long rec) {
  return (rec & s[P_FIN_ANY]) != 0 ||
         (s[P_FIN_ALL_EN] != 0 && (rec & s[P_FIN_ALL]) == s[P_FIN_ALL]);
}

__device__ __forceinline__ long long occupied(const In& in, long long l) {
  return in.slab_counts ? in.slab_counts[2 * l] : 0;
}

// Each (property, shard)'s "any first hit this era", one warp a pair.
__device__ void hit_bits(const Cfg& c, const In& in, Shared& sh) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long pairs = c.P * in.N, C = c.chunk;
  for (long long pr = warp; pr < pairs; pr += kWarps) {
    const long long p = pr / in.N, l = pr - p * in.N;
    const bool* h = in.hseen + p * in.N * C + l * C;
    int any = 0;
    for (long long i = lane; i < C; i += 32) any |= h[i];
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) sh.bits[p][l] = any;
  }
}

// The gate's (and the epilogue's) partial sums over this rank's shards:
// work, pressure, error, each property's first hit, slab past high water.
__device__ void gate_partials(const Cfg& c, const In& in, Shared& sh, bool epilogue) {
  hit_bits(c, in, sh);
  __syncthreads();
  if (threadIdx.x == 0) {
    long long work = 0, pressure = 0, err = 0, slab = 0;
    for (long long l = 0; l < in.N; ++l) {
      const long long* s = in.s0 + l * in.L;
      work += s[P_COUNT] > 0;
      pressure += s[P_COUNT] > s[P_HIGH_WATER] || s[P_UNIQUE] > s[P_GROW_LIMIT];
      err += s[P_ERR] > 0;
      if (c.s_base >= 0 && (!epilogue || c.f_base >= 0)) slab += occupied(in, l) > c.s_high;
    }
    long long* g = in.sums + S_GATE;
    g[0] = work;
    g[1] = pressure;
    g[2] = err;
    for (long long p = 0; p < c.P; ++p) {
      long long b = 0;
      for (long long l = 0; l < in.N; ++l) b += sh.bits[p][l];
      g[3 + p] = b;
    }
    g[3 + c.P] = slab;
  }
}

__device__ long long rec_bits(const Cfg& c, const In& in, long long rec0) {
  const long long* g = in.sums + S_GATE;
  for (long long p = 0; p < c.P; ++p)
    if (g[3 + p] > 0) rec0 |= 1ll << p;
  return rec0;
}

__device__ void gate(const Cfg& c, const In& in, long long l) {
  long long* s = in.s0 + l * in.L;
  long long* x = s + c.x;
  const long long* g = in.sums + S_GATE;
  const long long rec = rec_bits(c, in, x[X_REC0]);
  bool open = g[0] > 0 && g[1] == 0 && g[2] == 0 && !fin_hit(s, rec) &&
              x[X_ITS] < s[P_MAX_STEPS];
  if (c.s_base >= 0) open = open && g[3 + c.P] == 0;
  long long take = 0;
  if (open && s[P_COUNT] > 0) take = min(min(s[P_COUNT], c.chunk), s[P_TAKE_CAP]);
  x[X_OPEN] = open;
  x[X_TAKE] = take;
  x[X_TAIL] = (s[P_HEAD] + s[P_COUNT]) & c.qmask;
}

__device__ void commit(const Cfg& c, const In& in, long long l) {
  long long* s = in.s0 + l * in.L;
  long long* x = s + c.x;
  const long long g_unres = in.sums[S_UNRES], g_shrink = in.sums[S_SHRINK];
  const long long take = x[X_TAKE], nw = x[X_NEW];
  const bool pred = s[P_COUNT] > 0;
  if (g_shrink == 0) s[P_ERR] = (s[P_ERR] + g_unres) & M32;
  const bool ovf = in.n_ovf[l] > 0 || in.n_val[l] > c.vcap || g_unres > 0;
  const long long consumed = ovf ? 0 : take;
  s[P_HEAD] = (s[P_HEAD] + consumed) & c.qmask;
  s[P_COUNT] = (s[P_COUNT] - consumed + nw) & M32;
  s[P_UNIQUE] = (s[P_UNIQUE] + nw) & M32;
  if (!ovf) {
    x[X_EGEN] = (x[X_EGEN] + in.generated[l]) & M32;
    x[X_ESTEPS] += pred;
    s[P_TAKE_CAP] = min(s[P_TAKE_CAP] + c.regrow, c.chunk);
  } else {
    s[P_TAKE_CAP] = max(take >> 1, 1ll);
  }
  if (c.cov_base >= 0) {
    long long* cv = s + c.cov_base;
    if (!ovf) {
      for (long long a = 0; a < c.A; ++a) cv[a] = (cv[a] + in.pa[l * c.A + a]) & M32;
      for (long long p = 0; p < c.P; ++p) cv[c.A + p] = (cv[c.A + p] + in.hs[p * in.N + l]) & M32;
    }
    cv[c.A + c.P] = (cv[c.A + c.P] + consumed) & M32;
  }
  x[X_ITS] += 1;
  x[X_ITER] += 1;
  x[X_PARTIAL] += ovf;
}

// E2 for shard l, after sh.best holds its shallowest first hits.
__device__ void epilogue(const Cfg& c, const In& in, const Shared& sh, long long l) {
  long long* s = in.s0 + l * in.L;
  long long* x = s + c.x;
  const long long* g = in.sums + S_GATE;
  const bool work = g[0] > 0, pressure = g[1] > 0, err = g[2] > 0;
  const long long rec_all = rec_bits(c, in, x[X_REC0]);
  const long long max_steps = s[P_MAX_STEPS], cap = s[P_BUDGET_CAP];
  const bool budget_only =
      x[X_ITS] >= max_steps && work && !pressure && !err && !fin_hit(s, rec_all);
  long long nxt = max_steps;
  if (cap != 0) {
    if (pressure)
      nxt = max(min(max_steps, cap) >> 1, c.budget_min);
    else if (budget_only)
      nxt = min(max(max_steps, 1ll) * 2, cap);
  }
  const long long steps = x[X_ESTEPS];
  const long long maxd = steps > 0 ? in.ring_depth[l * in.ring_stride + ((s[P_HEAD] - 1) & c.qmask)] : 0;
  const long long k = x[X_K], C = c.chunk, row = in.N * C;
  long long* d = s + c.d_base;
  for (long long p = 0; p < c.P; ++p) {
    const unsigned long long b = sh.best[p][l];
    long long f1 = 0, f2 = 0, dd = M32;
    if (b != kNone) {
      const long long j = p * row + l * C + (long long)(b & 0xFFFFFFFFull);
      f1 = in.facc1[j];
      f2 = in.facc2[j];
      dd = (long long)(b >> 32);
    }
    if (dd < d[2 * c.P + p]) {
      d[p] = f1;
      d[c.P + p] = f2;
      d[2 * c.P + p] = dd;
      if (c.f_base >= 0) s[c.f_base + 2 + 4 * c.fuse + p] = k;
    }
  }
  s[P_STEPS] = (s[P_STEPS] + steps) & M32;
  s[P_GEN] = (s[P_GEN] + x[X_EGEN]) & M32;
  s[P_MAXD] = max(s[P_MAXD], maxd);
  bool more = false;
  long long kk = 1;
  if (c.f_base >= 0) {
    long long* lanes = s + c.f_base + 2;
    lanes[k] = steps;
    lanes[c.fuse + k] = x[X_EGEN];
    lanes[2 * c.fuse + k] = (s[P_UNIQUE] - x[X_UNIQ_IN]) & M32;
    lanes[3 * c.fuse + k] = s[P_COUNT];
    kk = k + 1;
    s[c.f_base + 1] = kk;
    const bool slab_full = c.s_base >= 0 && g[3 + c.P] > 0;
    more = budget_only && !slab_full && kk < s[c.f_base];
  }
  s[P_REC] = rec_all;
  s[P_MAX_STEPS] = nxt & M32;
  x[X_K] = kk;
  x[X_MORE] = more;
}

__device__ void run_phase(int ph, const Cfg& c, const In& in, Shared& sh) {
  const int t = threadIdx.x;
  const long long N = in.N;
  switch (ph) {
    case PH_START:
      for (long long l = t; l < N; l += kThreads) {
        long long* s = in.s0 + l * in.L;
        long long* x = s + c.x;
        for (long long i = 0; i < (c.cov_base >= 0 ? c.n_cov : 0); ++i) s[c.cov_base + i] = 0;
        if (c.f_base >= 0) {
          s[c.f_base] = min(max(s[c.f_base], 1ll), c.fuse);
          for (long long i = 1; i < 2 + 4 * c.fuse + c.P; ++i) s[c.f_base + i] = 0;
        }
        for (long long p = 0; p < c.P; ++p) {
          s[c.d_base + p] = s[c.d_base + c.P + p] = 0;
          s[c.d_base + 2 * c.P + p] = M32;
        }
        s[P_GEN] = s[P_STEPS] = s[P_MAXD] = 0;
        x[X_ITER] = x[X_PARTIAL] = x[X_K] = 0;
      }
      if (in.slab) {
        for (long long i = t; i < 4 * N * (c.scap + 1); i += kThreads) in.slab[i] = 0;
        for (long long i = t; i < 2 * N; i += kThreads) in.slab_counts[i] = 0;
      }
      break;
    case PH_BEGIN:
      for (long long l = t; l < N; l += kThreads) {
        long long* s = in.s0 + l * in.L;
        long long* x = s + c.x;
        x[X_ESTEPS] = x[X_EGEN] = x[X_ITS] = 0;
        x[X_REC0] = s[P_REC];
        x[X_UNIQ_IN] = s[P_UNIQUE];
        s[P_TAKE_CAP] = min(max(s[P_TAKE_CAP], 1ll), c.chunk);
      }
      __syncthreads();
      gate_partials(c, in, sh, false);
      break;
    case PH_C1:
      if (!sh.open) break;
      for (long long l = t; l < N; l += kThreads) sh.cnt[0][l] = sh.cnt[1][l] = 0;
      __syncthreads();
      for (long long l = 0; l < N; ++l) {
        int nw = 0, un = 0;
        for (long long i = t; i < in.n; i += kThreads) {
          nw += in.is_new[l * in.n + i];
          un += in.unres[l * in.n + i];
        }
        nw = __reduce_add_sync(0xffffffffu, nw);
        un = __reduce_add_sync(0xffffffffu, un);
        if ((t & 31) == 0) {
          if (nw) atomicAdd(&sh.cnt[0][l], nw);
          if (un) atomicAdd(&sh.cnt[1][l], un);
        }
      }
      __syncthreads();
      if (t == 0) {
        long long unres = 0, shrink = 0;
        for (long long l = 0; l < N; ++l) {
          long long* x = in.s0 + l * in.L + c.x;
          x[X_NEW] = sh.cnt[0][l];
          x[X_UNRES] = sh.cnt[1][l];
          unres += sh.cnt[1][l];
          shrink += x[X_TAKE] > 1;
        }
        in.sums[S_UNRES] = unres;
        in.sums[S_SHRINK] = shrink;
      }
      break;
    case PH_C2:
      if (!sh.open) break;
      for (long long l = t; l < N; l += kThreads) commit(c, in, l);
      __syncthreads();
      gate_partials(c, in, sh, false);
      break;
    case PH_GATE:
    case PH_CGATE:
      if (ph == PH_CGATE && !sh.open) break;
      for (long long l = t; l < N; l += kThreads) gate(c, in, l);
      break;
    case PH_E1:
      gate_partials(c, in, sh, true);
      break;
    case PH_E2: {
      const int lane = t & 31, warp = t >> 5;
      const long long C = c.chunk, row = N * C;
      for (long long pr = warp; pr < c.P * N; pr += kWarps) {
        const long long p = pr / N, l = pr - p * N;
        unsigned long long key = kNone;
        for (long long i = lane; i < C; i += 32) {
          const long long j = p * row + l * C + i;
          if (in.hseen[j]) {
            const unsigned long long k =
                ((unsigned long long)(in.faccd[j] & M32) << 32) | (unsigned long long)i;
            key = k < key ? k : key;
          }
        }
        for (int dlt = 16; dlt > 0; dlt >>= 1) {
          const unsigned long long o = __shfl_down_sync(0xffffffffu, key, dlt);
          key = o < key ? o : key;
        }
        if (lane == 0) sh.best[p][l] = key;
      }
      __syncthreads();
      for (long long l = t; l < N; l += kThreads) epilogue(c, in, sh, l);
      __syncthreads();
      for (long long i = t; i < c.P * row; i += kThreads) {
        in.hseen[i] = false;
        in.facc1[i] = in.facc2[i] = in.faccd[i] = 0;
      }
      break;
    }
    case PH_T1:
      if (c.cov_base >= 0)
        for (long long i = t; i < c.n_cov; i += kThreads) {
          long long v = 0;
          for (long long l = 0; l < N; ++l) v += in.s0[l * in.L + c.cov_base + i];
          in.sums[c.sum_cov + i] = v;
        }
      break;
    case PH_T2:
      if (c.cov_base >= 0)
        for (long long j = t; j < N * c.n_cov; j += kThreads) {
          const long long l = j / c.n_cov, i = j - l * c.n_cov;
          in.s0[l * in.L + c.cov_base + i] = in.sums[c.sum_cov + i] & M32;
        }
      for (long long l = t; l < N; l += kThreads) {
        long long* s = in.s0 + l * in.L;
        s[P_ERR] = s[P_ERR] != 0;
        if (c.s_base >= 0) {
          s[c.s_base + 2] = occupied(in, l);
          s[c.s_base + 3] = 0;
        }
      }
      break;
  }
}

__global__ void __launch_bounds__(kThreads)
    mesh_era_kernel(int ph0, int ph1, int ph2, const Cfg c, const __grid_constant__ In in) {
  __shared__ Shared sh;
  const int phases[3] = {ph0, ph1, ph2};
  if (threadIdx.x == 0) sh.open = in.s0[c.x + X_OPEN] != 0;
  __syncthreads();
  int last = -1;
  for (int i = 0; i < 3 && phases[i] >= 0; ++i) {
    run_phase(phases[i], c, in, sh);
    last = phases[i];
    __syncthreads();
  }
  if (threadIdx.x == 0 && in.h) {
    unsigned v = 0;
    if (last == PH_START) v = 1;
    else if (last == PH_GATE || last == PH_CGATE) v = in.s0[c.x + X_OPEN] != 0;
    else if (last == PH_E2) v = in.s0[c.x + X_MORE] != 0;
    cudaGraphSetConditional(in.h, v);
  }
}

}  // namespace

// ph0..ph2: the phases to run in order (-1: none). cfg: the host's
// config vector (Cfg). state: [N, L] int64; sums: int64 (ops/mesh_era.py
// sums_len). The operands (null where the phases do not read them):
// is_new / unresolved bool [N, n], n_ovf / n_val / generated int64 [N], hs [P, N],
// pa [N, A], hseen bool and facc1 / facc2 / faccd int64 [P, N * chunk],
// ring_depth (shard l's depth lane at + l * ring_stride), slab int64
// [4, N, scap + 1], slab_counts int64 [N, 2]. handle: a conditional
// node's handle, or 0. N <= 64 local shards, P <= 32 properties.
extern "C" int srt_mesh_era(int ph0, int ph1, int ph2, const void* cfg, void* state, long long N,
                            long long L, void* sums, const void* is_new, const void* unresolved,
                            long long n, const void* n_ovf, const void* n_val,
                            const void* generated, const void* hs,
                            const void* pa, void* hseen, void* facc1, void* facc2, void* faccd,
                            const void* ring_depth, long long ring_stride, void* slab,
                            void* slab_counts, unsigned long long handle, void* stream) {
  Cfg c;
  long long* dst = &c.chunk;
  for (int i = 0; i < kCfgLen; ++i) dst[i] = ((const long long*)cfg)[i];
  if (N < 1 || N > kMaxShards || c.P > kMaxProps || ph0 < 0) return (int)cudaErrorInvalidValue;
  In in{};
  in.s0 = (long long*)state;
  in.N = N;
  in.L = L;
  in.sums = (long long*)sums;
  in.is_new = (const bool*)is_new;
  in.unres = (const bool*)unresolved;
  in.n = n;
  in.n_ovf = (const long long*)n_ovf;
  in.n_val = (const long long*)n_val;
  in.generated = (const long long*)generated;
  in.hs = (const long long*)hs;
  in.pa = (const long long*)pa;
  in.hseen = (bool*)hseen;
  in.facc1 = (long long*)facc1;
  in.facc2 = (long long*)facc2;
  in.faccd = (long long*)faccd;
  in.ring_depth = (const long long*)ring_depth;
  in.ring_stride = ring_stride;
  in.slab = (long long*)slab;
  in.slab_counts = (long long*)slab_counts;
  in.h = (cudaGraphConditionalHandle)handle;
  mesh_era_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(ph0, ph1, ph2, c, in);
  return (int)cudaGetLastError();
}
