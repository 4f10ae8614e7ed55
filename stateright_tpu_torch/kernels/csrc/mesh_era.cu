// K15f: the sharded era's shard-coupled gate, step commit, epilogue and
// dispatch tail, on the card.
//
// Replaces, in stateright_tpu/parallel/mesh.py:152 `_build_block`, the
// scalar work of the era: `global_gates` (:257-298, the stacked psum
// that gives every shard the same gate), the overflow / unresolved veto
// and the commit with the step's coverage counts and first hits
// (:437-500), the era epilogue (:562-640: each shard's
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
// clamp fuse_lim), BEGIN (open the era), C1 (fold the step's operands
// and count each shard's new and unresolved inserts; the veto's sums),
// C2 (commit each shard under the global veto), GATE / CGATE (the
// uniform gate; CGATE keeps a closed gate closed), E1 / E2 (the
// epilogue's sums, then its work), T1 / T2 (the coverage sums, then the
// output rows). The last phase of a launch sets a conditional-node
// handle other than 0: the gate (GATE, CGATE), 1 (START) or the fused
// loop's continuation (E2) — what ends the sharded era graph's WHILE
// loops (parallel/mesh.py).
//
// Two kernels. COMMIT (`srt_mesh_commit`) is a grid of (tile, shard)
// blocks, a thread a run of 16 elements (fold.cuh, as K8f's COMMIT): a
// shard's tiles are its [R] insert masks (4,096 bytes a tile), its [P, C]
// hits and its [A, C] valid mask (4,096 elements a tile). Each block
// folds its tile as the step's glue did before it: the unresolved and
// new counts, the owner's depth histogram of its new inserts (at
// min(depth, DEPTH_CAP - 1), into the state row, on every step), the
// first hits (facc1/2/d where a hit was not seen, then hseen), each
// (property, shard)'s hits (hs) and hit-or-seen count (the gate's "any
// first hit this era", which C2 read by rescanning hseen before), and
// each (action, shard)'s valid count (pa; their sum is `generated`); it
// adds them to the shard's accumulators in the scratch. The grid's last
// block (one ticket for the grid, taken after a fence; a shard's own
// ticket would only add a round trip, since that block reads every
// shard's accumulators in one) stages each shard's scalars and
// accumulators in shared memory in one round trip and runs C1, then, on
// one rank, C2 (a thread a shard; the coverage counts a thread a word),
// the gate partials and CGATE, writes the rows back, sets the conditional
// and leaves the scratch zero. Across ranks it stops after C1: the
// accumulators wait in the scratch for the all_reduce of the sums and
// the C2 launch, which reads and zeroes them. The fold runs whatever the
// gate (a closed step's masks are all false); C1 and C2 only while it is
// open. No memset: a CUDA-graph replay needs no reset node.
//
// The other phases (`srt_mesh_era`) run in one block of 1,024 threads —
// a few dozen words a shard, a min over each (property, shard)'s [chunk]
// first-hit lanes (one warp a pair); one thread a shard does the scalar
// rules. Phases are separated by __syncthreads.
//
// Bound on the card: bytes for COMMIT (the two insert masks, the hits,
// the valid mask and hseen read once, each new insert's depth, each
// first hit's hashes and depth read and its four lanes written, each
// shard's scalars read and written); latency in practice (a few hundred
// KB a step). The other phases move a few kilobytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fold.cuh"

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
              P_BUDGET_CAP = 16, P_LEN = 17;
constexpr int X_TAKE = 0, X_OPEN = 1, X_TAIL = 2, X_REC0 = 3, X_UNIQ_IN = 4, X_ESTEPS = 5,
              X_EGEN = 6, X_ITS = 7, X_ITER = 8, X_PARTIAL = 9, X_K = 10, X_MORE = 11,
              X_NEW = 12, X_UNRES = 13, X_LEN = 14;
constexpr int S_UNRES = 0, S_SHRINK = 1, S_GATE = 2;
enum { PH_START, PH_BEGIN, PH_C1, PH_C2, PH_GATE, PH_E1, PH_E2, PH_T1, PH_T2, PH_CGATE };
// A shard's accumulators in the commit scratch (ops/mesh_era.py
// commit_scratch): unresolved, new, valid (generated), a spare word,
// then hs[P], the hit-or-seen counts[P] and pa[A]; after every shard's,
// the grid's ticket.
constexpr int ACC_UNRES = 0, ACC_NEW = 1, ACC_GEN = 2, ACC_HS = 4;
constexpr int kStaged = P_LEN + X_LEN;  // a shard's scalars staged by the commit

// The host's config vector, in this order (ops/mesh_era.py CFG_FIELDS).
struct Cfg {
  long long chunk, qmask, P, A, cov_base, s_base, s_high, f_base, fuse, d_base, x, regrow,
      budget_min, n_cov, scap, sum_cov, vcap;
};
constexpr int kCfgLen = 17;

Cfg load_cfg(const long long* v) {
  Cfg c;
  long long* dst = &c.chunk;
  for (int i = 0; i < kCfgLen; ++i) dst[i] = v[i];
  return c;
}

__host__ __device__ inline long long acc_words(const Cfg& c) { return ACC_HS + 2 * c.P + c.A; }

struct In {
  long long* s0;
  long long N, L;
  long long* sums;
  const long long* n_ovf;      // [N]
  const long long* n_val;      // [N]
  bool* hseen;                 // [P, N * chunk]
  long long* facc1;
  long long* facc2;
  long long* faccd;
  const long long* ring_depth;  // shard l's at ring_depth + l * ring_stride
  long long ring_stride;
  long long* slab;         // [4, N, scap + 1]
  long long* slab_counts;  // [N, 2]
  unsigned long long* scratch;  // the commit's accumulators and ticket
  cudaGraphConditionalHandle h;
};

// The commit's staged shards: scalars (params then X words), the
// accumulators' counts, each shard's veto and consumed rows.
struct Staged {
  long long row[kMaxShards][kStaged];
  long long unres[kMaxShards], fresh[kMaxShards], gen[kMaxShards];
  unsigned seen[kMaxShards];  // bit p: a hit of p seen at the shard this era
  long long n_ovf[kMaxShards], n_val[kMaxShards], occ[kMaxShards], consumed[kMaxShards];
  bool ovf[kMaxShards];
};

struct Shared {
  int bits[kMaxProps][kMaxShards];              // a first hit of p at shard l
  unsigned long long best[kMaxProps][kMaxShards];  // depth << 32 | position (E2)
  Staged st;
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

// The gate's partial sums over this rank's shards (s(l): shard l's
// params, bit(p, l): a first hit of p at shard l this era): work,
// pressure, error, each property's first hit, slab past high water.
template <class Row, class Bit, class Occ>
__device__ void write_gate_partials(const Cfg& c, const In& in, Row s, Bit bit, Occ occ,
                                    bool epilogue) {
  long long work = 0, pressure = 0, err = 0, slab = 0;
  for (long long l = 0; l < in.N; ++l) {
    const long long* r = s(l);
    work += r[P_COUNT] > 0;
    pressure += r[P_COUNT] > r[P_HIGH_WATER] || r[P_UNIQUE] > r[P_GROW_LIMIT];
    err += r[P_ERR] > 0;
    if (c.s_base >= 0 && (!epilogue || c.f_base >= 0)) slab += occ(l) > c.s_high;
  }
  long long* g = in.sums + S_GATE;
  g[0] = work;
  g[1] = pressure;
  g[2] = err;
  for (long long p = 0; p < c.P; ++p) {
    long long b = 0;
    for (long long l = 0; l < in.N; ++l) b += bit(p, l);
    g[3 + p] = b;
  }
  g[3 + c.P] = slab;
}

// The gate partials from the rows in device memory and hseen (BEGIN, E1).
__device__ void gate_partials(const Cfg& c, const In& in, Shared& sh, bool epilogue) {
  hit_bits(c, in, sh);
  __syncthreads();
  if (threadIdx.x == 0)
    write_gate_partials(
        c, in, [&](long long l) { return in.s0 + l * in.L; },
        [&](long long p, long long l) { return sh.bits[p][l]; },
        [&](long long l) { return occupied(in, l); }, epilogue);
}

__device__ long long rec_bits(const Cfg& c, const In& in, long long rec0) {
  const long long* g = in.sums + S_GATE;
  for (long long p = 0; p < c.P; ++p)
    if (g[3 + p] > 0) rec0 |= 1ll << p;
  return rec0;
}

// The gate of one shard: its params `s`, its X words `x`.
__device__ void gate(const Cfg& c, const In& in, long long* s, long long* x) {
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

// The commit of shard l's staged scalars under the global veto; returns
// the rows it consumed (the coverage counts follow, a word a thread).
__device__ void commit_scalars(const Cfg& c, const In& in, Staged& st, long long l) {
  long long* s = st.row[l];
  long long* x = s + P_LEN;
  const long long g_unres = in.sums[S_UNRES], g_shrink = in.sums[S_SHRINK];
  const long long take = x[X_TAKE], nw = x[X_NEW];
  const bool pred = s[P_COUNT] > 0;
  if (g_shrink == 0) s[P_ERR] = (s[P_ERR] + g_unres) & M32;
  const bool ovf = st.n_ovf[l] > 0 || st.n_val[l] > c.vcap || g_unres > 0;
  const long long consumed = ovf ? 0 : take;
  s[P_HEAD] = (s[P_HEAD] + consumed) & c.qmask;
  s[P_COUNT] = (s[P_COUNT] - consumed + nw) & M32;
  s[P_UNIQUE] = (s[P_UNIQUE] + nw) & M32;
  if (!ovf) {
    x[X_EGEN] = (x[X_EGEN] + st.gen[l]) & M32;
    x[X_ESTEPS] += pred;
    s[P_TAKE_CAP] = min(s[P_TAKE_CAP] + c.regrow, c.chunk);
  } else {
    s[P_TAKE_CAP] = max(take >> 1, 1ll);
  }
  x[X_ITS] += 1;
  x[X_ITER] += 1;
  x[X_PARTIAL] += ovf;
  st.ovf[l] = ovf;
  st.consumed[l] = consumed;
}

// C1, C2 and CGATE of the commit on the shards' staged scalars, by the
// whole block (the commit grid's last block, or the C2 launch across
// ranks), from the accumulators the grid left in the scratch. `c1`:
// the new and unresolved counts and the veto's partial sums; `c2`: each
// shard's commit, its coverage counts, the gate partials, then the
// scratch zeroed; `cgate`: the gate. The rows are read and written back
// in one round trip each; a closed gate changes no row.
__device__ void commit_phases(const Cfg& c, const In& in, Staged& st, bool c1, bool c2, bool cgate) {
  const int t = threadIdx.x, nt = blockDim.x;
  const long long N = in.N, W = acc_words(c);
  for (long long j = t; j < N * kStaged; j += nt) {
    const long long l = j / kStaged, w = j - l * kStaged;
    const long long* s = in.s0 + l * in.L;
    st.row[l][w] = __ldcg(w < P_LEN ? s + w : s + c.x + (w - P_LEN));
  }
  for (long long l = t; l < N; l += nt) {
    const unsigned long long* acc = in.scratch + l * W;
    st.unres[l] = (long long)__ldcg(acc + ACC_UNRES);
    st.fresh[l] = (long long)__ldcg(acc + ACC_NEW);
    st.gen[l] = (long long)__ldcg(acc + ACC_GEN);
    unsigned seen = 0;
    for (long long p = 0; p < c.P; ++p) seen |= (__ldcg(acc + ACC_HS + c.P + p) != 0 ? 1u : 0u) << p;
    st.seen[l] = seen;
    st.n_ovf[l] = in.n_ovf[l];
    st.n_val[l] = in.n_val[l];
    st.occ[l] = occupied(in, l);
  }
  __syncthreads();
  const bool open = st.row[0][P_LEN + X_OPEN] != 0;
  if (open && c1 && t == 0) {
    long long unres = 0, shrink = 0;
    for (long long l = 0; l < N; ++l) {
      long long* x = st.row[l] + P_LEN;
      x[X_NEW] = st.fresh[l];
      x[X_UNRES] = st.unres[l];
      unres += st.unres[l];
      shrink += x[X_TAKE] > 1;
    }
    in.sums[S_UNRES] = unres;
    in.sums[S_SHRINK] = shrink;
  }
  __syncthreads();
  if (open && c2) {
    for (long long l = t; l < N; l += nt) commit_scalars(c, in, st, l);
    __syncthreads();
    if (c.cov_base >= 0) {
      // act[a] += pa[a] and hits[p] += hs[p] on a clean step, expanded +=
      // the consumed rows: a word a thread.
      const long long K = c.A + c.P + 1;
      for (long long j = t; j < N * K; j += nt) {
        const long long l = j / K, i = j - l * K;
        long long add;
        if (i == c.A + c.P) add = st.consumed[l];
        else if (st.ovf[l]) continue;
        else add = (long long)__ldcg(in.scratch + l * W + (i < c.A ? ACC_HS + 2 * c.P + i : ACC_HS + i - c.A));
        long long* cv = in.s0 + l * in.L + c.cov_base + i;
        *cv = (*cv + add) & M32;
      }
    }
    if (t == 0)
      write_gate_partials(
          c, in, [&](long long l) { return (const long long*)st.row[l]; },
          [&](long long p, long long l) { return (int)((st.seen[l] >> p) & 1u); },
          [&](long long l) { return st.occ[l]; }, false);
    __syncthreads();
  }
  if (open && cgate) {
    for (long long l = t; l < N; l += nt) gate(c, in, st.row[l], st.row[l] + P_LEN);
    __syncthreads();
  }
  if (open && (c1 || c2 || cgate)) {
    for (long long j = t; j < N * kStaged; j += nt) {
      const long long l = j / kStaged, w = j - l * kStaged;
      long long* s = in.s0 + l * in.L;
      (w < P_LEN ? s[w] : s[c.x + (w - P_LEN)]) = st.row[l][w];
    }
  }
  if (c2)
    for (long long j = t; j < N * W; j += nt) in.scratch[j] = 0;
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
    case PH_C2:
      // Across ranks, after the commit grid's C1 and the all_reduce.
      commit_phases(c, in, sh.st, false, true, false);
      break;
    case PH_GATE:
    case PH_CGATE:
      if (ph == PH_CGATE && !sh.open) break;
      for (long long l = t; l < N; l += kThreads) {
        long long* s = in.s0 + l * in.L;
        gate(c, in, s, s + c.x);
      }
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

// -- COMMIT: the step's fold over (tile, shard), then the commit ----------------

constexpr int kCommitThreads = 256;
constexpr int kCommitWarps = kCommitThreads / 32;
constexpr int kTile = kCommitThreads * fold::kRun;  // 4,096 elements a block
constexpr int kMaxRows = 1024;                      // actions a tile's counters hold
constexpr int kDepthCap = 128;                      // obs/coverage.py DEPTH_CAP

struct CommitIn {
  In base;
  const bool* is_new;          // [N, n] (the owner's insert)
  const bool* unres;           // [N, n]
  long long n;
  const long long* rdepth;     // [N, n] each received row's depth, or null (no coverage)
  const bool* hits[kMaxProps]; // P masks [N * C]: rows that hit property i
  const bool* valid;           // [A, N, C] valid candidates (at the sender)
  const long long* row_h1;     // [N * C] the popped rows' hash halves and depths
  const long long* row_h2;
  const long long* depth;
  int t_mask, t_hits, t_valid; // a shard's tiles of each operand
  bool vec_masks, vec_hits, vec_valid;  // whole 16-byte runs, aligned (hits: hseen's too)
  bool final_;                 // one rank: C1, C2 and CGATE; else C1 alone
};

__global__ void __launch_bounds__(kCommitThreads)
    mesh_commit_kernel(const Cfg c, const __grid_constant__ CommitIn ci) {
  __shared__ int cnt[kMaxRows];
  __shared__ int cnt_seen[kMaxProps];
  __shared__ int hist[kDepthCap];
  __shared__ long long red[kCommitWarps];
  __shared__ Staged st;
  __shared__ bool last;
  const In& in = ci.base;
  const int t = threadIdx.x;
  const long long l = blockIdx.y, N = in.N, C = c.chunk;
  const int tile = blockIdx.x;
  const long long W = acc_words(c);
  unsigned long long* acc = in.scratch + l * W;

  if (tile < ci.t_mask) {
    // The insert masks: unresolved and new counts, the depth histogram.
    const bool hist_on = c.cov_base >= 0 && ci.rdepth != nullptr;
    if (hist_on)
      for (int b = t; b < kDepthCap; b += kCommitThreads) hist[b] = 0;
    __syncthreads();
    const long long e0 = (long long)tile * kTile + (long long)t * fold::kRun;
    const bool* um = ci.unres + l * ci.n;
    const bool* nm = ci.is_new + l * ci.n;
    // The run's depths are loaded with its masks: one round trip.
    long long dk[fold::kRun];
    if (hist_on) {
      const long long* dd = ci.rdepth + l * ci.n;
#pragma unroll
      for (int k = 0; k < fold::kRun; ++k) dk[k] = e0 + k < ci.n ? dd[e0 + k] : 0;
    }
    const unsigned bu = fold::run_bits([&](long long) { return um; }, ci.n, ci.n, e0, ci.vec_masks);
    const unsigned bn = fold::run_bits([&](long long) { return nm; }, ci.n, ci.n, e0, ci.vec_masks);
    if (hist_on) fold::hist_run(bn, dk, kDepthCap, hist);
    const long long unres = fold::block_sum<kCommitWarps>(__popc(bu), red);
    const long long fresh = fold::block_sum<kCommitWarps>(__popc(bn), red);
    if (t == 0) {
      if (unres) atomicAdd(acc + ACC_UNRES, (unsigned long long)unres);
      if (fresh) atomicAdd(acc + ACC_NEW, (unsigned long long)fresh);
    }
    if (hist_on) {
      unsigned long long* dh =
          reinterpret_cast<unsigned long long*>(in.s0 + l * in.L + c.cov_base + c.A + c.P + 1);
      for (int b = t; b < kDepthCap; b += kCommitThreads)
        if (hist[b]) atomicAdd(dh + b, (unsigned long long)hist[b]);
    }
  } else {
    // The hits ([P, C], rows of property i) or the valid mask ([A, C]).
    const bool hits = tile < ci.t_mask + ci.t_hits;
    const long long R = hits ? c.P : c.A;
    const long long total = R * C;
    const long long lo = (long long)(tile - ci.t_mask - (hits ? 0 : ci.t_hits)) * kTile;
    const long long r_lo = lo / C, r_hi = min((lo + kTile - 1) / C, R - 1);
    for (long long r = r_lo + t; r <= r_hi; r += kCommitThreads) {
      cnt[r] = 0;
      if (hits) cnt_seen[r] = 0;
    }
    __syncthreads();
    const long long e0 = lo + (long long)t * fold::kRun;
    unsigned m;
    if (hits) {
      // The run's hseen bytes beside its hits: the first hits, and the
      // (property, shard)'s hit-or-seen count (the gate's any bit).
      const auto seen_row = [&](long long r) { return in.hseen + r * N * C + l * C; };
      const unsigned seen = fold::run_bits(seen_row, C, total, e0, ci.vec_hits);
      m = fold::run_bits([&](long long r) { return ci.hits[r] + l * C; }, C, total, e0, ci.vec_hits);
      for (unsigned b = m & ~seen; b; b &= b - 1) {
        const int k = __ffs(b) - 1;
        const long long e = e0 + k, i = e / C, p = e - i * C;
        const long long j = i * N * C + l * C + p;
        in.facc1[j] = ci.row_h1[l * C + p];
        in.facc2[j] = ci.row_h2[l * C + p];
        in.faccd[j] = ci.depth[l * C + p];
        in.hseen[j] = true;
      }
      fold::add_rows(m | seen, e0, C, cnt_seen);
    } else {
      m = fold::run_bits([&](long long r) { return ci.valid + r * N * C + l * C; }, C, total, e0,
                         ci.vec_valid);
    }
    fold::add_rows(m, e0, C, cnt);
    const long long all = hits ? 0 : fold::block_sum<kCommitWarps>(__popc(m), red);  // a barrier
    if (hits) __syncthreads();
    if (t == 0 && all) atomicAdd(acc + ACC_GEN, (unsigned long long)all);
    const long long base = hits ? ACC_HS : ACC_HS + 2 * c.P;
    for (long long r = r_lo + t; r <= r_hi; r += kCommitThreads) {
      if (cnt[r]) atomicAdd(acc + base + r, (unsigned long long)cnt[r]);
      if (hits && cnt_seen[r]) atomicAdd(acc + ACC_HS + c.P + r, (unsigned long long)cnt_seen[r]);
    }
  }

  // The grid's last block commits every shard. (The block's atomics
  // precede thread 0's fence through the barrier.)
  __syncthreads();
  unsigned long long* ticket = in.scratch + N * W;
  if (t == 0) {
    __threadfence();
    const unsigned long long blocks = (unsigned long long)gridDim.x * gridDim.y;
    last = atomicAdd(ticket, 1ull) == blocks - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  commit_phases(c, in, st, true, ci.final_, ci.final_);
  __syncthreads();
  if (t == 0) {
    *ticket = 0;
    if (in.h) cudaGraphSetConditional(in.h, st.row[0][P_LEN + X_OPEN] ? 1u : 0u);
  }
}

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

In make_in(void* state, long long N, long long L, void* sums, const void* n_ovf,
           const void* n_val, void* hseen, void* facc1, void* facc2, void* faccd, void* slab_counts,
           void* scratch, unsigned long long handle) {
  In in{};
  in.s0 = (long long*)state;
  in.N = N;
  in.L = L;
  in.sums = (long long*)sums;
  in.n_ovf = (const long long*)n_ovf;
  in.n_val = (const long long*)n_val;
  in.hseen = (bool*)hseen;
  in.facc1 = (long long*)facc1;
  in.facc2 = (long long*)facc2;
  in.faccd = (long long*)faccd;
  in.slab_counts = (long long*)slab_counts;
  in.scratch = (unsigned long long*)scratch;
  in.h = (cudaGraphConditionalHandle)handle;
  return in;
}

}  // namespace

// ph0..ph2: the phases to run in order (-1: none; not PH_C1, which only
// the commit grid runs). cfg: the host's config vector (Cfg). state:
// [N, L] int64; sums: int64 (ops/mesh_era.py sums_len). The operands
// (null where the phases do not read them): n_ovf / n_val int64 [N],
// hseen bool and facc1 / facc2 / faccd int64 [P, N * chunk], ring_depth
// (shard l's depth lane at + l * ring_stride), slab int64 [4, N, scap +
// 1], slab_counts int64 [N, 2], scratch (C2: the commit grid's
// accumulators, ops/mesh_era.py commit_scratch). handle: a conditional
// node's handle, or 0. N <= 64 local shards, P <= 32 properties.
extern "C" int srt_mesh_era(int ph0, int ph1, int ph2, const void* cfg, void* state, long long N,
                            long long L, void* sums, const void* n_ovf, const void* n_val,
                            void* hseen, void* facc1, void* facc2, void* faccd,
                            const void* ring_depth, long long ring_stride, void* slab,
                            void* slab_counts, void* scratch, unsigned long long handle,
                            void* stream) {
  const Cfg c = load_cfg((const long long*)cfg);
  if (N < 1 || N > kMaxShards || c.P > kMaxProps || ph0 < 0 || ph0 == PH_C1 || ph1 == PH_C1 ||
      ph2 == PH_C1)
    return (int)cudaErrorInvalidValue;
  In in = make_in(state, N, L, sums, n_ovf, n_val, hseen, facc1, facc2, faccd, slab_counts,
                  scratch, handle);
  in.ring_depth = (const long long*)ring_depth;
  in.ring_stride = ring_stride;
  in.slab = (long long*)slab;
  mesh_era_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(ph0, ph1, ph2, c, in);
  return (int)cudaGetLastError();
}

// COMMIT over (tile, shard). final: 1 on one rank (C1, C2, CGATE and the
// conditional `handle`), 0 across ranks (C1 only: the accumulators stay
// in the scratch for the C2 launch). is_new / unresolved bool [N, n],
// rdepth int64 [N, n] (null without coverage), n_ovf / n_val int64 [N],
// hits: P pointers, each bool [N * chunk]; valid bool [A, N, chunk];
// row_h1 / row_h2 / depth int64 [N * chunk]; hseen and facc1 / facc2 /
// faccd [P, N * chunk]; slab_counts [N, 2] or null; scratch:
// commit_scratch (N * (4 + 2P + A) + 1 int64, zero, left zero by a final
// launch; a launch with final 0 leaves the accumulators to C2).
extern "C" int srt_mesh_commit(int final_, const void* cfg, void* state, long long N, long long L,
                               void* sums, const void* is_new, const void* unresolved, long long n,
                               const void* rdepth, const void* n_ovf, const void* n_val,
                               const void* const* hits, const void* valid, const void* row_h1,
                               const void* row_h2, const void* depth, void* hseen, void* facc1,
                               void* facc2, void* faccd, void* slab_counts, void* scratch,
                               unsigned long long handle, void* stream) {
  const Cfg c = load_cfg((const long long*)cfg);
  const long long C = c.chunk;
  if (N < 1 || N > kMaxShards || c.P < 0 || c.P > kMaxProps || c.A < 1 || c.A > kMaxRows || n < 1 ||
      C < 1 || scratch == nullptr || valid == nullptr || (final_ == 0 && handle != 0) ||
      (c.P > 0 && (hits == nullptr || row_h1 == nullptr || hseen == nullptr)) ||
      (c.cov_base >= 0 && (rdepth == nullptr || c.n_cov - c.A - c.P - 1 != kDepthCap)))
    return (int)cudaErrorInvalidValue;
  CommitIn ci{};
  ci.base = make_in(state, N, L, sums, n_ovf, n_val, hseen, facc1, facc2, faccd, slab_counts,
                    scratch, handle);
  ci.is_new = (const bool*)is_new;
  ci.unres = (const bool*)unresolved;
  ci.n = n;
  ci.rdepth = (const long long*)rdepth;
  bool vec_hits = C % fold::kRun == 0 && (reinterpret_cast<uintptr_t>(hseen) & 15) == 0;
  for (long long i = 0; i < c.P; ++i) {
    ci.hits[i] = (const bool*)hits[i];
    vec_hits = vec_hits && (reinterpret_cast<uintptr_t>(hits[i]) & 15) == 0;
  }
  ci.valid = (const bool*)valid;
  ci.row_h1 = (const long long*)row_h1;
  ci.row_h2 = (const long long*)row_h2;
  ci.depth = (const long long*)depth;
  ci.vec_masks = n % fold::kRun == 0 &&
                 ((reinterpret_cast<uintptr_t>(is_new) | reinterpret_cast<uintptr_t>(unresolved)) & 15) == 0;
  ci.vec_hits = vec_hits;
  ci.vec_valid = C % fold::kRun == 0 && (reinterpret_cast<uintptr_t>(valid) & 15) == 0;
  ci.t_mask = (int)tiles_of(n);
  ci.t_hits = (int)tiles_of(c.P * C);
  ci.t_valid = (int)tiles_of(c.A * C);
  ci.final_ = final_ != 0;
  const dim3 grid((unsigned)(ci.t_mask + ci.t_hits + ci.t_valid), (unsigned)N);
  mesh_commit_kernel<<<grid, kCommitThreads, 0, (cudaStream_t)stream>>>(c, ci);
  return (int)cudaGetLastError();
}
