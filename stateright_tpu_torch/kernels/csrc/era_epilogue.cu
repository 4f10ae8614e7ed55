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
// Lanes (engines/multiplex.py): one block a lane, on lane l's state row
// (state [lanes, stride]), its first-hit lanes (position p of property i
// at i * lanes * chunk + l * chunk + p) and its ring's depth lane
// (ring_depth + l * ring_stride). Lanes have no sample slab and no
// fusion tail, so nothing crosses lanes.
//
// Design: one block of 1,024 threads a lane. Each property's first-hit lanes
// (chunk wide) are scanned by the whole block for the minimum of
// depth << 32 | position among the hit positions (a block min over 64-bit
// keys: the lowest position wins a depth tie, as argmin's first index
// does); one thread then does the scalar work.
//
// Bound on the card: bytes: hseen (1 byte) and faccd (8 bytes) of P x
// chunk positions read once, the four accumulators (25 bytes a position)
// written once, and a few scalar words.

#include "era.cuh"

namespace {

using namespace era;

constexpr int kThreads = 1024;
constexpr int kMaxProps = 32;
constexpr unsigned long long kNone = ~0ull;

__global__ void __launch_bounds__(kThreads)
    era_epilogue_kernel(const Cfg c, long long* s0, long long stride, bool* hseen0,
                        long long* facc10, long long* facc20, long long* faccd0,
                        const long long* ring_depth0, long long ring_stride,
                        const long long* slab_counts, cudaGraphConditionalHandle h) {
  __shared__ unsigned long long warp_min[kThreads / 32];
  __shared__ unsigned long long best[kMaxProps];
  __shared__ long long fp[2][kMaxProps];
  const int t = threadIdx.x;
  const long long l = blockIdx.x, lanes = gridDim.x;
  const long long C = c.chunk;
  long long* s = s0 + l * stride;
  const long long* ring_depth = ring_depth0 + l * ring_stride;
  // Lane l's first-hit lanes: property i's row starts at i * lanes * C.
  bool* hseen = hseen0 + l * C;
  long long* facc1 = facc10 + l * C;
  long long* facc2 = facc20 + l * C;
  long long* faccd = faccd0 + l * C;
  const long long row = lanes * C;
  for (long long i = 0; i < c.P; ++i) {
    unsigned long long key = kNone;
    for (long long p = t; p < C; p += kThreads) {
      const long long j = i * row + p;
      if (hseen[j]) {
        const unsigned long long k = ((unsigned long long)(faccd[j] & M32) << 32) | (unsigned long long)p;
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
      if (m != kNone) {
        const long long sel = i * row + (long long)(m & M32);
        fp[0][i] = facc1[sel];
        fp[1][i] = facc2[sel];
      }
    }
    __syncthreads();
  }
  for (long long i = 0; i < c.P; ++i)
    for (long long p = t; p < C; p += kThreads) {
      const long long j = i * row + p;
      hseen[j] = false;
      facc1[j] = facc2[j] = faccd[j] = 0;
    }
  if (t != 0) return;
  long long* x = s + c.x;
  const long long rec0 = x[X_REC0];
  long long rec = rec0;
  for (long long i = 0; i < c.P; ++i) {
    if (best[i] == kNone) continue;
    if (!((rec0 >> i) & 1)) {
      s[P_LEN + i] = fp[0][i];
      s[P_LEN + c.P + i] = fp[1][i];
    }
    rec |= 1ll << i;
  }
  s[P_REC] = rec;
  const long long steps = x[X_ESTEPS];
  const long long head = s[P_HEAD], count = s[P_COUNT], unique = s[P_UNIQUE];
  const long long maxd = steps > 0 ? ring_depth[(head + c.qmask) & c.qmask] : 0;
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
    const bool room = c.s_base < 0 || slab_counts[0] <= c.s_high;
    more = budget_only && room && k < s[c.f_base];
  } else {
    k = 1;
  }
  x[X_K] = k;
  x[X_MORE] = more;
  if (h) cudaGraphSetConditional(h, more ? 1u : 0u);
}

}  // namespace

// cfg: the host's config vector (era.cuh Cfg). state: [lanes, stride]
// int64. hseen bool [P, lanes * chunk] and facc1/facc2/faccd int64
// [P, lanes * chunk]: the era's first-hit lanes. ring_depth: lane 0's
// ring depth lane (qcap + 1 int64), lane l's at + l * ring_stride.
// slab_counts: the sample slab's [occupied, dropped], or null without
// sampling. handle: a conditional node's handle, or 0. P <= 32; with
// lanes > 1 no slab, no fusion tail and no handle.
extern "C" int srt_era_epilogue(const void* cfg, void* state, long long lanes, long long stride,
                                void* hseen, void* facc1, void* facc2, void* faccd,
                                const void* ring_depth, long long ring_stride,
                                const void* slab_counts, unsigned long long handle,
                                void* stream) {
  const Cfg c = load_cfg((const long long*)cfg);
  if (c.P < 0 || c.P > kMaxProps || lanes < 1) return (int)cudaErrorInvalidValue;
  if (lanes > 1 && (c.s_base >= 0 || c.f_base >= 0 || handle)) return (int)cudaErrorInvalidValue;
  era_epilogue_kernel<<<(unsigned)lanes, kThreads, 0, (cudaStream_t)stream>>>(
      c, (long long*)state, stride, (bool*)hseen, (long long*)facc1, (long long*)facc2,
      (long long*)faccd, (const long long*)ring_depth, ring_stride,
      (const long long*)slab_counts, (cudaGraphConditionalHandle)handle);
  return (int)cudaGetLastError();
}
