// K8f, the era half: the BFS era's epilogue, on the card; with a lane
// axis, K14f's (the multiplexed lanes' era epilogue, under jax.vmap).
//
// Replaces, in stateright_tpu/engines/tpu_bfs.py:361 `_build_loop.loop`,
// the once-per-era epilogue of `run_era` (:781-853) and the continuation
// of the fused outer loop (:896-922):
//   - discoveries (:790-807): for each property i hit this era, the
//     fingerprint of its shallowest first hit, at the lowest chunk
//     position among equally shallow ones (`jnp.argmin` over
//     where(hseen, faccd, MAX)), recorded into rec_fp1/rec_fp2 unless the
//     era's input discovery bits already held i; the bits gain every hit;
//   - max depth (:808-810): the depth lane at ring slot head - 1, if the
//     era ran a step, folded into the dispatch's maximum;
//   - the next step budget (:823-849): doubled after a budget-only exit
//     (clamped at budget_cap), halved under ring or table pressure
//     (floored at BUDGET_MIN), passed through when budget_cap == 0;
//   - the fusion continuation (:908-922): with fuse > 1 the era's steps,
//     generated states, new unique states and frontier go to the fusion
//     lanes at the era's index, and the next inner era runs only after a
//     budget-only exit with slab headroom, below fuse_lim;
//   - the error word becomes 0/1 (:1001) and the era's accumulators
//     (hseen, facc1, facc2, faccd) are zeroed for the next era.
// A conditional-node handle other than 0 receives the continuation: it
// ends the outer (fusion) WHILE loop of the era graph (engines/era.py).
//
// Lanes (engines/multiplex.py): lane l's state row (state [lanes,
// stride]), its first-hit lanes (position p of property i at
// i * lanes * chunk + l * chunk + p) and its ring's depth lane
// (ring_depth + l * ring_stride). Lanes have no sample slab and no
// fusion tail, so nothing crosses lanes.
//
// Design: a grid over (tile of kTile chunk positions, lane), a thread a
// position. Each block folds its positions' keys depth << 32 | position
// of every property at once into a shared minimum a property (atomicMin
// on 64-bit keys: exact, and the lowest position wins a depth tie, as
// argmin's first index does), keeps the fingerprints of its own minima
// in the scratch, raises the lane's minimum a property in the scratch
// with one atomicMin each, and clears its slice of the four
// accumulators. The last block of a lane (a ticket taken after a fence)
// stages the lane's state row in shared memory, reads each property's
// minimum and takes its fingerprints from the slot of the tile that
// holds that position (a thread a property), does the scalar work on the
// staged row and writes it back; it resets the minima and its ticket, so
// a CUDA-graph replay needs no reset node.
//
// Bound on the card: bytes: hseen (1 byte) and faccd (8 bytes) of P x
// chunk positions read once, the four accumulators (25 bytes a position)
// written once, and a few scalar words.

#include "era.cuh"

namespace {

using namespace era;

constexpr int kThreads = 256;
constexpr int kTile = kThreads;  // chunk positions a block
constexpr int kMaxProps = 32;
constexpr unsigned long long kNone = ~0ull;
// The staged state row's dynamic shared memory: up to 32 KB with no
// attribute set, at most 200 KB.
constexpr size_t kDefaultDynamicBytes = 32 * 1024, kMaxRowBytes = 200 * 1024;

struct Scratch {
  unsigned long long* best;    // [lanes, P] each property's minimum key; kNone between launches
  unsigned long long* ticket;  // [lanes] zero between launches
  long long* fp;               // [lanes, tiles, P, 2] each tile's minima's fingerprints
};

// The era's scalar rules on lane row `s` (one thread), its discovery
// bits `rec` folded: max depth, the next budget, the error word, the
// fusion lanes and the continuation (`h`). `last_depth`: the ring's
// depth at slot head - 1, `occupied`: the sample slab's occupancy (read
// by the caller).
__device__ void epilogue_scalars(const Cfg& c, long long* s, long long rec, long long last_depth,
                                 long long occupied, cudaGraphConditionalHandle h) {
  long long* x = s + c.x;
  s[P_REC] = rec;
  const long long steps = x[X_ESTEPS];
  const long long count = s[P_COUNT], unique = s[P_UNIQUE];
  const long long maxd = steps > 0 ? last_depth : 0;
  s[P_MAXD] = max(s[P_MAXD], maxd);
  const long long max_steps = s[P_MAX_STEPS], cap = s[P_BUDGET_CAP];
  const bool pressure = count > s[P_HIGH_WATER] || unique > s[P_GROW_LIMIT];
  const bool budget_only =
      steps >= max_steps && count > 0 && !pressure && s[P_ERR] == 0 && !fin_hit(s, rec);
  const long long grown = min(max(max_steps, 1ll) * 2, cap);
  const long long shrunk = max(min(max_steps, cap) >> 1, c.budget_min);
  s[P_MAX_STEPS] =
      (cap == 0 ? max_steps : pressure ? shrunk : budget_only ? grown : max_steps) & M32;
  s[P_ERR] = s[P_ERR] != 0;
  long long k = x[X_K];
  bool more = false;
  if (c.f_base >= 0) {
    long long* fl = s + c.f_base + 2;
    fl[k] = steps;
    fl[c.fuse + k] = x[X_EGEN];
    fl[2 * c.fuse + k] = (unique - x[X_UNIQ_IN]) & M32;
    fl[3 * c.fuse + k] = count;
    k += 1;
    s[c.f_base + 1] = k;
    const bool room = c.s_base < 0 || occupied <= c.s_high;
    more = budget_only && room && k < s[c.f_base];
  } else {
    k = 1;
  }
  x[X_K] = k;
  x[X_MORE] = more;
  if (h) cudaGraphSetConditional(h, more ? 1u : 0u);
}

__global__ void __launch_bounds__(kThreads)
    era_epilogue_kernel(const Cfg c, long long* s0, long long stride, bool* hseen,
                        long long* facc1, long long* facc2, long long* faccd,
                        const long long* ring_depth0, long long ring_stride,
                        const long long* slab_counts, const Scratch sc,
                        cudaGraphConditionalHandle h) {
  __shared__ unsigned long long kmin[kMaxProps];
  __shared__ long long fps[2][kMaxProps];
  __shared__ long long scal[2];  // the depth at ring slot head - 1, the slab's occupancy
  __shared__ bool last;
  extern __shared__ long long srow[];  // the lane's state row, in its last block
  const int t = threadIdx.x;
  const int tile = blockIdx.x, tiles = gridDim.x;
  const long long l = blockIdx.y, lanes = gridDim.y;
  const long long C = c.chunk, P = c.P;
  const long long row = lanes * C;  // property i's first-hit lane starts at i * row
  const long long p = (long long)tile * kTile + t;
  if (t < P) kmin[t] = kNone;
  __syncthreads();
  if (p < C)
    for (long long i = 0; i < P; ++i) {
      const long long j = i * row + l * C + p;
      const long long d = faccd[j];  // loaded beside hseen, not after it
      if (hseen[j])
        atomicMin(&kmin[i], ((unsigned long long)(d & M32) << 32) | (unsigned long long)p);
    }
  __syncthreads();
  if (t < P && kmin[t] != kNone) {
    const long long j = t * row + l * C + (long long)(kmin[t] & M32);
    long long* fp = sc.fp + ((l * tiles + tile) * P + t) * 2;
    fp[0] = facc1[j];
    fp[1] = facc2[j];
    atomicMin(&sc.best[l * P + t], kmin[t]);
  }
  __syncthreads();
  if (p < C)
    for (long long i = 0; i < P; ++i) {
      const long long j = i * row + l * C + p;
      hseen[j] = false;
      facc1[j] = facc2[j] = faccd[j] = 0;
    }
  // (The block's writes precede thread 0's fence through the barrier.)
  __syncthreads();
  if (t == 0) {
    __threadfence();
    last = atomicAdd(&sc.ticket[l], 1ull) == (unsigned long long)(tiles - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The lane's last block: its row staged in shared memory, each
  // property's minimum (reset) and its fingerprints read by a thread of
  // its own, the two words the scalar work needs from elsewhere, all in
  // one round trip; then the scalar work on the staged row.
  long long* s = s0 + l * stride;
  long long* x = srow + c.x;
  for (long long w = t; w < stride; w += kThreads) srow[w] = __ldcg(s + w);
  if (t == kThreads - 1) {
    const volatile long long* vs = s;
    scal[0] = ring_depth0[l * ring_stride + ((vs[P_HEAD] + c.qmask) & c.qmask)];
  }
  if (t == kThreads - 2) scal[1] = c.s_base >= 0 ? slab_counts[0] : 0;
  if (t < P) {
    const unsigned long long m = atomicExch(&sc.best[l * P + t], kNone);
    kmin[t] = m;
    if (m != kNone) {
      const volatile long long* fp = sc.fp + ((l * tiles + (long long)(m & M32) / kTile) * P + t) * 2;
      fps[0][t] = fp[0];
      fps[1][t] = fp[1];
    }
  }
  __syncthreads();
  if (t == 0) {
    sc.ticket[l] = 0;
    const long long rec0 = x[X_REC0];
    long long rec = rec0;
    for (long long i = 0; i < P; ++i) {
      if (kmin[i] == kNone) continue;
      if (!((rec0 >> i) & 1)) {
        srow[P_LEN + i] = fps[0][i];
        srow[P_LEN + P + i] = fps[1][i];
      }
      rec |= 1ll << i;
    }
    epilogue_scalars(c, srow, rec, scal[0], scal[1], h);
  }
  __syncthreads();
  for (long long w = t; w < stride; w += kThreads) s[w] = srow[w];
}

long long tiles_of(long long chunk) { return (chunk + kTile - 1) / kTile; }

}  // namespace

// cfg: the host's config vector (era.cuh Cfg). state: [lanes, stride]
// int64. hseen bool [P, lanes * chunk] and facc1/facc2/faccd int64
// [P, lanes * chunk]: the era's first-hit lanes. ring_depth: lane 0's
// ring depth lane (qcap + 1 int64), lane l's at + l * ring_stride.
// slab_counts: the sample slab's [occupied, dropped], or null without
// sampling. scratch: int64, the minima (lanes * P words, all bits
// set), the tickets (lanes words, zero), then the tiles' fingerprints
// (lanes * ceil(chunk / 256) * P * 2 words; ops/era.py
// epilogue_scratch). handle: a conditional node's handle, or 0. P <= 32;
// with lanes > 1 no slab, no fusion tail and no handle.
extern "C" int srt_era_epilogue(const void* cfg, void* state, long long lanes, long long stride,
                                void* hseen, void* facc1, void* facc2, void* faccd,
                                const void* ring_depth, long long ring_stride,
                                const void* slab_counts, void* scratch, unsigned long long handle,
                                void* stream) {
  const Cfg c = load_cfg((const long long*)cfg);
  if (c.P < 0 || c.P > kMaxProps || c.chunk < 1 || lanes < 1 || lanes > 65535 ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  if (lanes > 1 && (c.s_base >= 0 || c.f_base >= 0 || handle)) return (int)cudaErrorInvalidValue;
  const size_t row_bytes = (size_t)stride * sizeof(long long);
  if (row_bytes > kMaxRowBytes) return (int)cudaErrorInvalidValue;
  if (row_bytes > kDefaultDynamicBytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        era_epilogue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)row_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  Scratch sc;
  sc.best = (unsigned long long*)scratch;
  sc.ticket = sc.best + lanes * c.P;
  sc.fp = (long long*)(sc.ticket + lanes);
  const dim3 grid((unsigned)tiles_of(c.chunk), (unsigned)lanes);
  era_epilogue_kernel<<<grid, kThreads, row_bytes, (cudaStream_t)stream>>>(
      c, (long long*)state, stride, (bool*)hseen, (long long*)facc1, (long long*)facc2,
      (long long*)faccd, (const long long*)ring_depth, ring_stride,
      (const long long*)slab_counts, sc, (cudaGraphConditionalHandle)handle);
  return (int)cudaGetLastError();
}
