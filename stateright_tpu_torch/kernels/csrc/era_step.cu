// K8f, the step half: the BFS era's gate and step commit, on the card;
// with a lane axis, K14f's (the multiplexed lanes' era, under jax.vmap).
//
// Replaces, in stateright_tpu/engines/tpu_bfs.py:361 `_build_loop.loop`,
// the `lax.while_loop` predicate `cond` (:403-426), the take (:449-455),
// the step's coverage counts and first-hit accumulation (:621-681), the
// commit rules at the end of `body` (:585-621, :627-685: overflow, head,
// count, unique, generated, steps, take_cap, the error count, the
// coverage counts and the scalar discovery bits) and the era and
// dispatch prologues of `run_era` (:730-760) and of the fused outer loop
// (:884-937). One launch a step, after it: it commits the step and
// decides the next one, so the era needs no host round trip.
//
// Modes:
//   START   once a dispatch (one block a lane): zero the dispatch's
//           outputs (generated, steps, max depth, the coverage tail, the
//           fusion lanes), clamp fuse_lim, zero the sample slab, and open
//           the outer (fusion) loop;
//   BEGIN   once an era (one block a lane): zero the era's step and
//           generated counts, keep its input discovery bits and unique
//           count, clamp take_cap to [1, chunk], then the gate;
//   COMMIT  once a step (a grid of blocks a lane, below): fold the
//           step's operands, then, if the gate was open, commit the step
//           (a partial step on overflow), raise the visited-insert epoch,
//           then the gate for the next step.
// The gate (`cond`): open while 0 < count <= high_water, unique <=
// grow_limit, steps < max_steps, no error, the finish masks unmet and
// (sampling on) slab occupancy <= s_high; the take is min(count, chunk,
// take_cap) and, while the sample threshold is still (MAX, MAX), at most
// s_take; 0 when the gate is closed, so a closed step changes nothing.
//
// COMMIT's fold, on every step whatever the gate (the step's masks are
// all false at take 0), as the JAX body does it before its commit:
//   - the insert masks' sums: unresolved and new (c_new) counts, rcap wide;
//   - the depth histogram of the coverage tail: each new insert counted
//     at min(its depth, DEPTH_CAP - 1), an overflowing step's too
//     (tpu_bfs.py:626-653);
//   - the first hits: property i's hit at chunk position p sets
//     hseen[i, p] and, where it was not set, stores the row's hash halves
//     and depth into facc1/facc2/faccd (tpu_bfs.py:657-681), and counts
//     into hs[i];
//   - the valid candidates of each action (coverage, pa[a]) and, where the
//     caller gives no generated count (the lanes), their sum.
// The K7 append's COUNT tiles also count c_new, but this kernel's own sum
// is kept: it reads the same bytes in the same pass as the histogram, and
// K7 stays as it is.
//
// Lanes (engines/multiplex.py): the state is [lanes, stride], one JAX
// params row (then the X_* words) a lane, and the step operands are per
// lane (n_val[N], n_d[N], unresolved / c_new [N, n], ddepth [N * n],
// generated[N], the hits [P] x [N * C], valid [A, N, C], the hit rows'
// hashes and depths [N * C], the first-hit lanes [P, N * C]). Lane l
// commits and gates alone; a lane whose gate closed keeps every word, as
// vmap's select does in the JAX lane program. The loop runs while ANY
// lane is open.
//
// Design of COMMIT: a grid of (tile, lane) blocks, a thread a run of 16
// elements (one 16-byte load where the row is aligned and a run lies in
// one row), so every load of the step's operands is in flight at once
// over the SMs. A lane's tiles are its insert masks (4,096 bytes a
// tile), its [P, C] hits and its [A, C] valid mask (4,096 elements a
// tile). Each block folds its tile into shared counters (a warp sums the
// counts of its threads that share a row, or a histogram bin, first;
// BFS steps put nearly every new insert in one or two bins) and adds
// them to the lane's accumulators in the scratch with atomics (the
// histogram into the state row's coverage tail). The last block of a
// lane (a ticket taken after a fence) reads and zeroes the accumulators,
// stages the lane's state row in shared memory and reads the lane's
// counts, all in one round trip (a word a thread), then commits and
// gates the lane on the staged row (the action and hit counts over the
// block) and writes it back (one thread walking the row in device
// memory cost 1-2 us more a call). With
// lanes, the last lane (a second ticket) ORs the lanes' gates, sets the
// conditional once, raises the epoch once and zeroes its ticket. Every
// scratch word is left zero, so a CUDA-graph replay needs no reset node.
//
// A conditional-node handle other than 0 receives the gate (BEGIN,
// COMMIT; with lanes, the OR of the lanes' gates) or 1 (START): that is
// what ends the era's CUDA-graph WHILE loop on the card (engines/graph.py).
// This source also holds the host functions that build that graph
// (srt_graph_*).
//
// Bound on the card: bytes: the two masks (rcap bytes each), the hits
// (P x C bytes) and the valid mask (A x C bytes) read once, the depth of
// each candidate, and the hashes and depth of each first hit, read once,
// the first-hit lanes written where they change, and a few hundred state
// words; latency in practice (a few hundred KB a step).

#include "era.cuh"
#include "fold.cuh"

namespace {

using namespace era;
using fold::add_rows;
using fold::kRun;
using fold::run_bits;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * kRun;      // 4,096 elements a block
constexpr int kMaxProps = 32;
constexpr int kMaxRows = 1024;              // actions or properties a tile's counters hold
constexpr int kDepthCap = 128;              // obs/coverage.py DEPTH_CAP
constexpr int MODE_START = 0, MODE_BEGIN = 1, MODE_COMMIT = 2;
// A lane's accumulators in the scratch: unresolved, new, the valid sum,
// its ticket, then hs[P] and pa[A]; after every lane's, the last ticket.
constexpr int ACC_UNRES = 0, ACC_NEW = 1, ACC_VALID = 2, ACC_TICKET = 3, ACC_HS = 4;
// The staged state row's dynamic shared memory: up to 32 KB with no
// attribute set beside the ~14 KB static, at most 200 KB.
constexpr size_t kDefaultDynamicBytes = 32 * 1024, kMaxRowBytes = 200 * 1024;

struct StepIn {
  const long long* n_val;      // [N] valid candidates
  const long long* n_d;        // [N] distinct candidates
  const bool* unresolved;      // [N, n] insert left unresolved
  const bool* c_new;           // [N, n] newly inserted
  long long n;
  const long long* ddepth;     // [N * n] depth of each distinct candidate (coverage), or null
  const long long* generated;  // [N] valid successors, or null: the valid mask's count
  const bool* hits[kMaxProps]; // P masks [N * C]: rows that hit property i
  const bool* valid;           // [A, N, C] valid candidates, or null
  const long long* row_h1;     // [N * C] the popped rows' hash halves and depths
  const long long* row_h2;
  const long long* depth;
  bool* hseen;                 // [P, N * C] the era's first-hit lanes
  long long* facc1;
  long long* facc2;
  long long* faccd;
  long long* slab[4];          // the sample slab's lanes (scap + 1 rows; one lane only)
  long long* slab_counts;      // [occupied, dropped]
  long long* epoch;            // the visited insert's epoch
  long long lanes;             // N
  long long stride;            // words of one lane's state row
  unsigned long long* scratch; // [N * (ACC_HS + P + A) + 1], zero between launches
  int t_mask, t_hits, t_valid; // a lane's tiles of each operand
  bool vec_hits, vec_valid;    // rows of C whole 16-byte runs, aligned (hits: hseen's too)
};

// The gate on row `s`; `occupied`: the sample slab's occupancy (read
// only with sampling on).
__device__ void gate(const Cfg& c, long long* s, long long occupied) {
  long long* x = s + c.x;
  const long long count = s[P_COUNT];
  bool open = count > 0 && count <= s[P_HIGH_WATER] && s[P_UNIQUE] <= s[P_GROW_LIMIT] &&
              x[X_ESTEPS] < s[P_MAX_STEPS] && s[P_ERR] == 0 && !fin_hit(s, s[P_REC]);
  if (c.s_base >= 0) open = open && occupied <= c.s_high;
  long long take = 0;
  if (open) {
    take = min(min(count, c.chunk), s[P_TAKE_CAP]);
    if (c.s_base >= 0 && s[c.s_base] == M32 && s[c.s_base + 1] == M32)
      take = min(take, c.s_take);  // the loose-threshold clamp (tpu_bfs.py:449-455)
  }
  x[X_OPEN] = open;
  x[X_TAKE] = take;
  x[X_TAIL] = (s[P_HEAD] + count) & c.qmask;
}

// Lane l's commit on its row `s` (staged in shared memory), from its
// counts and folded sums: n_val, n_d, unres, new_count, the generated
// count and hs[P]; thread 0 does the scalar rules and returns whether
// the step overflowed, then the block adds the action and hit counts
// (`cover`).
__device__ bool commit_scalars(const Cfg& c, long long* s, long long n_val, long long n_d,
                               long long unres, long long new_count, long long gen,
                               const long long* hs) {
  long long* x = s + c.x;
  const long long take = x[X_TAKE];
  if (take <= 1) s[P_ERR] = (s[P_ERR] + unres) & M32;
  const bool ovf = n_val > c.vcap || n_d > c.rcap || unres > 0;
  const long long consumed = ovf ? 0 : take;
  s[P_HEAD] = (s[P_HEAD] + consumed) & c.qmask;
  s[P_COUNT] = (s[P_COUNT] - consumed + new_count) & M32;
  s[P_UNIQUE] = (s[P_UNIQUE] + new_count) & M32;
  if (!ovf) {
    x[X_EGEN] = (x[X_EGEN] + gen) & M32;
    s[P_GEN] = (s[P_GEN] + gen) & M32;
    x[X_ESTEPS] += 1;
    s[P_STEPS] = (s[P_STEPS] + 1) & M32;
    s[P_TAKE_CAP] = min(s[P_TAKE_CAP] + c.regrow, c.chunk);
  } else {
    s[P_TAKE_CAP] = max(take >> 1, 1ll);
  }
  if (c.cov_base >= 0) s[c.cov_base + c.A + c.P] = (s[c.cov_base + c.A + c.P] + consumed) & M32;
  for (long long i = 0; i < c.P; ++i)
    if (hs[i] > 0) s[P_REC] |= 1ll << i;
  x[X_ITER] += 1;
  x[X_PARTIAL] += ovf;
  return ovf;
}

// A clean step's coverage counts, over the block: act[a] += pa[a],
// hits[i] += hs[i].
__device__ void cover(const Cfg& c, long long* s, const long long* hs, const long long* pa) {
  long long* cv = s + c.cov_base;
  for (long long a = threadIdx.x; a < c.A; a += blockDim.x) cv[a] = (cv[a] + pa[a]) & M32;
  for (long long i = threadIdx.x; i < c.P; i += blockDim.x) cv[c.A + i] = (cv[c.A + i] + hs[i]) & M32;
}

// START and BEGIN: one block a lane.
__global__ void __launch_bounds__(kThreads)
    era_open_kernel(int mode, const Cfg c, long long* s0, const __grid_constant__ StepIn in,
                    cudaGraphConditionalHandle h) {
  __shared__ bool last;
  const long long l = blockIdx.x;
  long long* s = s0 + l * in.stride;
  long long* x = s + c.x;
  const int t = threadIdx.x;
  if (mode == MODE_START) {
    if (c.cov_base >= 0)
      for (long long i = t; i < c.n_cov; i += kThreads) s[c.cov_base + i] = 0;
    if (c.f_base >= 0)
      for (long long i = t; i < 4 * c.fuse; i += kThreads) s[c.f_base + 2 + i] = 0;
    if (c.s_base >= 0) {
      for (int k = 0; k < 4; ++k)
        for (long long i = t; i <= c.scap; i += kThreads) in.slab[k][i] = 0;
      if (t < 2) in.slab_counts[t] = 0;
    }
    if (t == 0) {
      s[P_GEN] = s[P_STEPS] = s[P_MAXD] = 0;
      x[X_ITER] = x[X_PARTIAL] = x[X_K] = 0;
      if (c.f_base >= 0) {
        s[c.f_base] = min(max(s[c.f_base], 1ll), c.fuse);
        s[c.f_base + 1] = 0;
      }
      if (h) cudaGraphSetConditional(h, 1u);
    }
    return;
  }
  if (t == 0) {
    x[X_ESTEPS] = x[X_EGEN] = 0;
    x[X_REC0] = s[P_REC];
    x[X_UNIQ_IN] = s[P_UNIQUE];
    s[P_TAKE_CAP] = min(max(s[P_TAKE_CAP], 1ll), c.chunk);
    gate(c, s, c.s_base >= 0 ? in.slab_counts[0] : 0);
  }
  if (in.lanes == 1) {
    if (t == 0 && h) cudaGraphSetConditional(h, x[X_OPEN] ? 1u : 0u);
    return;
  }
  // Lanes: the last block to get here (on COMMIT's last ticket) ORs
  // every lane's gate.
  unsigned long long* ticket = in.scratch + in.lanes * (ACC_HS + c.P + c.A);
  __syncthreads();
  if (t == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1ull) == (unsigned long long)(in.lanes - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int any = 0;
  const volatile long long* vs = s0;
  for (long long j = t; j < in.lanes; j += kThreads) any |= vs[j * in.stride + c.x + X_OPEN] != 0;
  any = __syncthreads_or(any);
  if (t == 0) {
    if (h) cudaGraphSetConditional(h, any ? 1u : 0u);
    *ticket = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    era_commit_kernel(const Cfg c, long long* s0, const __grid_constant__ StepIn in,
                      cudaGraphConditionalHandle h) {
  __shared__ int cnt[kMaxRows];
  __shared__ int hist[kDepthCap];
  __shared__ long long red[kWarps];
  __shared__ long long sums[ACC_HS + kMaxRows + kMaxProps];
  __shared__ long long scal[4];         // n_val, n_d, generated, occupancy
  __shared__ bool last, ovf;
  extern __shared__ long long srow[];   // the lane's state row, in its last block
  const int t = threadIdx.x;
  const long long l = blockIdx.y, N = in.lanes, C = c.chunk;
  const int tile = blockIdx.x;
  const int W = ACC_HS + (int)(c.P + c.A);
  unsigned long long* acc = in.scratch + l * W;
  long long* s = s0 + l * in.stride;

  if (tile < in.t_mask) {
    // The insert masks: unresolved and new counts, the depth histogram.
    const bool hist_on = c.cov_base >= 0 && in.ddepth != nullptr;
    if (hist_on)
      for (int b = t; b < kDepthCap; b += kThreads) hist[b] = 0;
    __syncthreads();
    const long long e0 = (long long)tile * kTile + (long long)t * kRun;
    const bool* um = in.unresolved + l * in.n;
    const bool* nm = in.c_new + l * in.n;
    const bool vec = ((reinterpret_cast<uintptr_t>(um) | reinterpret_cast<uintptr_t>(nm)) & 15) == 0;
    // The run's depths are loaded with its masks, not after them: one
    // round trip, not two.
    long long dk[kRun];
    if (hist_on) {
      const long long* dd = in.ddepth + l * in.n;
#pragma unroll
      for (int k = 0; k < kRun; ++k) dk[k] = e0 + k < in.n ? dd[e0 + k] : 0;
    }
    const unsigned bu = run_bits([&](long long) { return um; }, in.n, in.n, e0, vec);
    const unsigned bn = run_bits([&](long long) { return nm; }, in.n, in.n, e0, vec);
    if (hist_on) fold::hist_run(bn, dk, kDepthCap, hist);
    const long long unres = fold::block_sum<kWarps>(__popc(bu), red);
    const long long fresh = fold::block_sum<kWarps>(__popc(bn), red);
    if (t == 0) {
      if (unres) atomicAdd(acc + ACC_UNRES, (unsigned long long)unres);
      if (fresh) atomicAdd(acc + ACC_NEW, (unsigned long long)fresh);
    }
    if (hist_on) {
      unsigned long long* dh = reinterpret_cast<unsigned long long*>(s + c.cov_base + c.A + c.P + 1);
      for (int b = t; b < kDepthCap; b += kThreads)
        if (hist[b]) atomicAdd(dh + b, (unsigned long long)hist[b]);
    }
  } else {
    // The hits ([P, C], rows of property i) or the valid mask ([A, C]).
    const bool hits = tile < in.t_mask + in.t_hits;
    const long long R = hits ? c.P : c.A;
    const long long total = R * C;
    const long long lo = (long long)(tile - in.t_mask - (hits ? 0 : in.t_hits)) * kTile;
    const long long r_lo = lo / C, r_hi = min((lo + kTile - 1) / C, R - 1);
    for (long long r = r_lo + t; r <= r_hi; r += kThreads) cnt[r] = 0;
    __syncthreads();
    const long long e0 = lo + (long long)t * kRun;
    unsigned m;
    if (hits) {
      // The run's hseen bytes are loaded with its hits where the run is
      // one aligned load of each.
      const auto seen_row = [&](long long r) { return in.hseen + r * N * C + l * C; };
      const bool whole = in.vec_hits && e0 + kRun <= total;
      const unsigned seen = whole ? run_bits(seen_row, C, total, e0, true) : 0u;
      m = run_bits([&](long long r) { return in.hits[r] + l * C; }, C, total, e0, in.vec_hits);
      // First hits: a row's hashes and depth where its bit was not seen.
      for (unsigned b = m; b; b &= b - 1) {
        const int k = __ffs(b) - 1;
        const long long e = e0 + k, i = e / C, p = e - i * C;
        const long long j = i * N * C + l * C + p;
        if (whole ? !((seen >> k) & 1u) : !in.hseen[j]) {
          in.facc1[j] = in.row_h1[l * C + p];
          in.facc2[j] = in.row_h2[l * C + p];
          in.faccd[j] = in.depth[l * C + p];
          in.hseen[j] = true;
        }
      }
    } else {
      m = run_bits([&](long long r) { return in.valid + r * N * C + l * C; }, C, total, e0,
                   in.vec_valid);
    }
    add_rows(m, e0, C, cnt);
    const long long all = hits ? 0 : fold::block_sum<kWarps>(__popc(m), red);  // also the barrier
    if (hits) __syncthreads();
    if (t == 0 && all) atomicAdd(acc + ACC_VALID, (unsigned long long)all);
    const int base = hits ? ACC_HS : ACC_HS + (int)c.P;
    for (long long r = r_lo + t; r <= r_hi; r += kThreads)
      if (cnt[r]) atomicAdd(acc + base + r, (unsigned long long)cnt[r]);
  }

  // The lane's last block commits it, on its row staged in shared memory.
  // (The block's atomics precede thread 0's fence through the barrier.)
  __syncthreads();
  if (t == 0) {
    __threadfence();
    const int tiles = in.t_mask + in.t_hits + in.t_valid;
    last = atomicAdd(acc + ACC_TICKET, 1ull) == (unsigned long long)(tiles - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // One round trip: the accumulators (read and zeroed), the row and the
  // lane's counts, each word by a thread of its own.
  for (int w = t; w < W; w += kThreads)
    sums[w] = w == ACC_TICKET ? 0 : (long long)atomicExch(acc + w, 0ull);
  for (long long w = t; w < in.stride; w += kThreads) srow[w] = __ldcg(s + w);
  if (t == kThreads - 1) scal[0] = in.n_val[l];
  if (t == kThreads - 2) scal[1] = in.n_d[l];
  if (t == kThreads - 3) scal[2] = in.generated ? in.generated[l] : -1;
  if (t == kThreads - 4) scal[3] = c.s_base >= 0 ? in.slab_counts[0] : 0;
  __syncthreads();
  long long* x = srow + c.x;
  const bool was_open = x[X_OPEN] != 0;
  if (was_open) {
    if (t == 0) {
      const long long gen = in.generated ? scal[2] : sums[ACC_VALID];
      ovf = commit_scalars(c, srow, scal[0], scal[1], sums[ACC_UNRES], sums[ACC_NEW], gen,
                           sums + ACC_HS);
    }
    __syncthreads();
    if (c.cov_base >= 0 && !ovf) cover(c, srow, sums + ACC_HS, sums + ACC_HS + c.P);
    if (t == 0) {
      if (N == 1) atomicAdd(reinterpret_cast<unsigned long long*>(in.epoch), 1ull);
      gate(c, srow, scal[3]);
    }
    __syncthreads();
    for (long long w = t; w < in.stride; w += kThreads) s[w] = srow[w];
  }
  if (t == 0) {
    acc[ACC_TICKET] = 0;
    if (N == 1 && h) cudaGraphSetConditional(h, x[X_OPEN] ? 1u : 0u);
  }
  if (N == 1) return;
  // Lanes: the last lane to commit ORs every lane's gate.
  unsigned long long* final_ticket = in.scratch + N * W;
  __syncthreads();
  if (t == 0) {
    __threadfence();
    last = atomicAdd(final_ticket, 1ull) == (unsigned long long)(N - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int any = 0;
  const volatile long long* vs = s0;
  for (long long j = t; j < N; j += kThreads) any |= vs[j * in.stride + c.x + X_OPEN] != 0;
  any = __syncthreads_or(any);
  if (t == 0) {
    if (h) cudaGraphSetConditional(h, any ? 1u : 0u);
    if (in.epoch) atomicAdd(reinterpret_cast<unsigned long long*>(in.epoch), 1ull);
    *final_ticket = 0;
  }
}

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

// mode: 0 START, 1 BEGIN, 2 COMMIT. cfg: the host's config vector
// (era.cuh Cfg). state: [lanes, stride] int64 (stride: a lane's words).
// COMMIT reads the step operands (see StepIn; n: the width of one lane's
// insert masks; hits: P pointers, each [lanes * chunk]; ddepth, valid,
// generated, the hit rows and the first-hit lanes may be null where the
// config has no coverage, no properties, or the caller gives generated).
// The slab (null without sampling; one lane only) is read by START and
// the gate. scratch: lanes * (4 + P + A) + 1 zeroed int64 words (COMMIT;
// BEGIN with lanes > 1; ops/era.py step_scratch), left zero by every
// launch. handle: a conditional node's handle, or 0 (START: one lane
// only).
extern "C" int srt_era_step(int mode, const void* cfg, void* state, long long lanes,
                            long long stride, const void* n_val, const void* n_d,
                            const void* unresolved, const void* c_new, long long n,
                            const void* ddepth, const void* generated, const void* const* hits,
                            const void* valid, const void* row_h1, const void* row_h2,
                            const void* depth, void* hseen, void* facc1, void* facc2, void* faccd,
                            void* sfp1, void* sfp2, void* sdep, void* sact, void* slab_counts,
                            void* epoch, void* scratch, unsigned long long handle, void* stream) {
  if (mode < MODE_START || mode > MODE_COMMIT || lanes < 1 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  const Cfg c = load_cfg((const long long*)cfg);
  if (lanes > 1 && (c.s_base >= 0 || c.f_base >= 0 ||
                    (mode == MODE_START ? handle != 0 : scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  StepIn in{};
  in.n_val = (const long long*)n_val;
  in.n_d = (const long long*)n_d;
  in.unresolved = (const bool*)unresolved;
  in.c_new = (const bool*)c_new;
  in.n = n;
  in.ddepth = (const long long*)ddepth;
  in.generated = (const long long*)generated;
  in.valid = (const bool*)valid;
  in.row_h1 = (const long long*)row_h1;
  in.row_h2 = (const long long*)row_h2;
  in.depth = (const long long*)depth;
  in.hseen = (bool*)hseen;
  in.facc1 = (long long*)facc1;
  in.facc2 = (long long*)facc2;
  in.faccd = (long long*)faccd;
  in.slab[0] = (long long*)sfp1;
  in.slab[1] = (long long*)sfp2;
  in.slab[2] = (long long*)sdep;
  in.slab[3] = (long long*)sact;
  in.slab_counts = (long long*)slab_counts;
  in.epoch = (long long*)epoch;
  in.lanes = lanes;
  in.stride = stride;
  in.scratch = (unsigned long long*)scratch;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode != MODE_COMMIT) {
    era_open_kernel<<<(unsigned)lanes, kThreads, 0, st>>>(mode, c, (long long*)state, in,
                                                          (cudaGraphConditionalHandle)handle);
    return (int)cudaGetLastError();
  }
  const long long C = c.chunk;
  if (scratch == nullptr || n < 1 || C < 1 || c.P < 0 || c.P > kMaxProps || c.A < 0 ||
      c.A > kMaxRows || (lanes == 1 && epoch == nullptr) ||
      (c.P > 0 && (hits == nullptr || row_h1 == nullptr || hseen == nullptr)) ||
      (c.cov_base >= 0 && (valid == nullptr || ddepth == nullptr ||
                           c.n_cov - c.A - c.P - 1 != kDepthCap)) ||
      (generated == nullptr && valid == nullptr))
    return (int)cudaErrorInvalidValue;
  bool vec_hits = C % kRun == 0 && (reinterpret_cast<uintptr_t>(hseen) & 15) == 0;
  for (long long i = 0; i < c.P; ++i) {
    in.hits[i] = (const bool*)hits[i];
    vec_hits = vec_hits && (reinterpret_cast<uintptr_t>(hits[i]) & 15) == 0;
  }
  in.vec_hits = vec_hits;
  in.vec_valid = C % kRun == 0 && (reinterpret_cast<uintptr_t>(valid) & 15) == 0;
  in.t_mask = (int)tiles_of(n);
  in.t_hits = (int)tiles_of(c.P * C);
  in.t_valid = valid ? (int)tiles_of(c.A * C) : 0;
  const size_t row_bytes = (size_t)stride * sizeof(long long);
  if (row_bytes > kMaxRowBytes) return (int)cudaErrorInvalidValue;
  if (row_bytes > kDefaultDynamicBytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        era_commit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)row_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)(in.t_mask + in.t_hits + in.t_valid), (unsigned)lanes);
  era_commit_kernel<<<grid, kThreads, row_bytes, st>>>(c, (long long*)state, in,
                                                       (cudaGraphConditionalHandle)handle);
  return (int)cudaGetLastError();
}

// The device-program graphs (engines/graph.py): conditional WHILE nodes whose bodies
// hold the torch-captured segments as child graphs. Every function
// returns a cudaError_t as int.
namespace {

int depend(cudaGraph_t g, void* after, cudaGraphNode_t node) {
  if (after == nullptr) return 0;
  cudaGraphNode_t from = (cudaGraphNode_t)after;
  return (int)cudaGraphAddDependencies(g, &from, &node, 1);
}

}  // namespace

extern "C" int srt_graph_create(void** graph) {
  return (int)cudaGraphCreate((cudaGraph_t*)graph, 0);
}

// A conditional handle of `graph`, 0 at every launch until a kernel sets it.
extern "C" int srt_graph_handle(void* graph, unsigned long long* handle) {
  return (int)cudaGraphConditionalHandleCreate((cudaGraphConditionalHandle*)handle,
                                               (cudaGraph_t)graph, 0,
                                               cudaGraphCondAssignDefault);
}

// A WHILE node on `handle` after node `after` (or a root), and its body.
extern "C" int srt_graph_while(void* graph, void* after, unsigned long long handle, void** node,
                               void** body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = (cudaGraphConditionalHandle)handle;
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
  int e = (int)cudaGraphAddNode((cudaGraphNode_t*)node, (cudaGraph_t)graph, nullptr, 0, &p);
  if (e) return e;
  *body = p.conditional.phGraph_out[0];
  return depend((cudaGraph_t)graph, after, (cudaGraphNode_t)*node);
}

// A child-graph node (a copy of `child`) after node `after` (or a root).
extern "C" int srt_graph_child(void* graph, void* after, void* child, void** node) {
  int e = (int)cudaGraphAddChildGraphNode((cudaGraphNode_t*)node, (cudaGraph_t)graph, nullptr,
                                          0, (cudaGraph_t)child);
  if (e) return e;
  return depend((cudaGraph_t)graph, after, (cudaGraphNode_t)*node);
}

extern "C" int srt_graph_instantiate(void* graph, void** exec) {
  return (int)cudaGraphInstantiate((cudaGraphExec_t*)exec, (cudaGraph_t)graph, 0);
}

extern "C" int srt_graph_launch(void* exec, void* stream) {
  cudaError_t e = cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The nodes of `graph` by type: counts[0] kernels, [1] memsets, [2] all
// (a captured call's launches, counted on the card; child graphs are not
// entered).
extern "C" int srt_graph_nodes(void* graph, long long* counts) {
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes((cudaGraph_t)graph, nullptr, &n);
  if (e != cudaSuccess) return (int)e;
  counts[0] = counts[1] = 0;
  counts[2] = (long long)n;
  if (n == 0) return 0;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  e = cudaGraphGetNodes((cudaGraph_t)graph, nodes, &n);
  for (size_t i = 0; e == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType t = cudaGraphNodeTypeEmpty;
    e = cudaGraphNodeGetType(nodes[i], &t);
    if (t == cudaGraphNodeTypeKernel) ++counts[0];
    if (t == cudaGraphNodeTypeMemset) ++counts[1];
  }
  delete[] nodes;
  return (int)e;
}

extern "C" int srt_graph_destroy(void* exec, void* graph) {
  cudaError_t e = cudaSuccess;
  if (exec) e = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  if (graph && e == cudaSuccess) e = cudaGraphDestroy((cudaGraph_t)graph);
  return (int)e;
}
