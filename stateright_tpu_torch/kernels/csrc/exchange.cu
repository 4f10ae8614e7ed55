// K15a: the sharded step's owner exchange — each shard's candidates
// bucketed by owner into the receive layout of a tiled all_to_all.
//
// Replaces stateright_tpu/parallel/mesh.py:337-384: owner = h1 % N for
// every candidate the dedup kept, its rank within its owner's bucket
// (the [vcap, N] one-hot cumsum: the number of EARLIER kept candidates
// of the same shard with the same owner), a candidate ranked below
// `quota` scattered to slot owner * quota + rank of each of the X
// exchanged lanes, the rest counted as the shard's overflow, and the
// tiled all_to_all that gives owner o the slots [src][quota].
//
// Layout: a rank holds nl = n_total / world shards. The send buffer is
// [world, X, nl, nl, quota] (destination rank, lane, local owner, local
// source, rank): with one rank it is every local owner's receive buffer
// [X, nl, n_total * quota] already, so this call is the whole exchange;
// across ranks one all_to_all_single moves it (ops/exchange.py).
// Slots that no candidate fills are 0: an all-zero parent pair marks an
// empty receive slot (mesh.py:392).
//
// Bound on the card: bytes — h1, reps and the X lanes of the candidates
// read once, the send buffer written once (its zeroes included): 55.6 MB
// at the paxos-3 mesh widths, 17 us at the HBM rate. So the design
// spreads the work over every SM and writes each slot once. Two launches
// over a grid of (tile, source shard), a tile `per` sub-tiles of 256
// candidates (the host's plan, ops/exchange.py exchange_plan):
//   1. COUNT: each block counts its tile's kept candidates per owner and
//      writes one int32 a (source, tile, owner) to the scratch.
//   2. WRITE, launched as COUNT's programmatic dependent (Hopper): each
//      block reads its first sub-tile's h1 and reps and ranks it within
//      the tile while COUNT runs, then waits for COUNT's grid, sums the
//      earlier tiles' counts of each owner (its base) and all of them
//      (the bucket's total), and writes the X lanes of every candidate
//      ranked below quota. The rank is a stable scan in candidate order:
//      within a warp, __match_any_sync groups the lanes with one owner
//      and a popcount gives each lane's rank in its group; per-warp,
//      per-owner counts in shared memory become an exclusive prefix over
//      the warps. So the ranks are exactly the cumsum's, whatever the
//      schedule — an atomic counter would give schedule-dependent slots,
//      and the owner's insert winner and ring order would drift from the
//      reference. Then the block zeroes its share of the empty slots:
//      bucket (x, owner) of its source is zero in [min(total, quota),
//      quota) only, cut into chunks of kZero slots dealt round-robin over
//      the source's blocks. Every slot is written exactly once, and
//      block 0 of each source writes its n_ovf from the same totals.
// COUNT writes every count WRITE reads, so the scratch needs no reset: a
// CUDA graph replays a call with no memset node and no host write.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxShards = 256;  // == ops/exchange.py MAX_SHARDS
constexpr int kZero = 1024;      // empty slots a block zeroes at once

// h1 % n as the plain version computes it (int64 %), in 32 bits where
// the value fits, as fingerprint halves do.
__device__ __forceinline__ int owner_of(long long h, int n) {
  const unsigned long long u = (unsigned long long)h;
  return (u >> 32) ? (int)(u % (unsigned long long)n) : (int)((unsigned)u % (unsigned)n);
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const long long* __restrict__ h1, const bool* __restrict__ reps, long long V, int n_total,
             int per, int tiles, int* __restrict__ counts) {
  __shared__ int cnt[kMaxShards];
  // WRITE may be scheduled now: it waits for this grid's counts itself.
  asm volatile("griddepcontrol.launch_dependents;");
  const int t = threadIdx.x, lane = t & 31;
  const long long l = blockIdx.y;
  const int tile = blockIdx.x;
  for (int o = t; o < n_total; o += kThreads) cnt[o] = 0;
  __syncthreads();
  const long long* hl = h1 + l * V;
  const bool* rl = reps + l * V;
  for (int s = 0; s < per; ++s) {
    const long long i = ((long long)tile * per + s) * kThreads + t;
    const bool ok = i < V && rl[i];
    const int o = ok ? owner_of(hl[i], n_total) : -1;
    const unsigned group = __match_any_sync(0xffffffffu, o);
    if (ok && (group & ((1u << lane) - 1u)) == 0) atomicAdd(&cnt[o], __popc(group));
  }
  __syncthreads();
  int* out = counts + (l * tiles + tile) * n_total;
  for (int o = t; o < n_total; o += kThreads) out[o] = cnt[o];
}

struct Tile {
  bool ok;
  int o, in_group;
};

__global__ void __launch_bounds__(kThreads)
write_kernel(const long long* __restrict__ h1, const bool* __restrict__ reps,
             const long long* __restrict__ vals, long long val_stride, int nl, long long V, int X,
             int n_total, long long quota, int per, int tiles, const int* __restrict__ counts,
             long long* __restrict__ send, long long* __restrict__ n_ovf) {
  // Per-warp, per-owner counts of a sub-tile, and each warp's first rank
  // within the tile (the earlier sub-tiles and warps).
  __shared__ int cnt[kWarps * kMaxShards];
  __shared__ int pre[kWarps * kMaxShards];
  __shared__ int run[kMaxShards];    // the tile's kept candidates so far
  __shared__ int base[kMaxShards];   // the earlier tiles' (COUNT)
  __shared__ int total[kMaxShards];  // the source's bucket sizes (COUNT)
  __shared__ int ovf_warp[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int l = blockIdx.y;
  const int tile = blockIdx.x;
  const bool ranks = tile < tiles;
  for (int i = t; i < kWarps * n_total; i += kThreads) cnt[i] = 0;
  for (int o = t; o < n_total; o += kThreads) run[o] = base[o] = total[o] = 0;
  __syncthreads();
  const long long* hl = h1 + (long long)l * V;
  const bool* rl = reps + (long long)l * V;

  // Rank sub-tile s within the tile (needs nothing of COUNT).
  auto local = [&](int s, long long i) {
    Tile c;
    c.ok = i < V && rl[i];
    c.o = c.ok ? owner_of(hl[i], n_total) : -1;
    const unsigned group = __match_any_sync(0xffffffffu, c.o);
    c.in_group = __popc(group & ((1u << lane) - 1u));
    if (c.ok && c.in_group == 0) cnt[warp * n_total + c.o] = __popc(group);
    __syncthreads();
    for (int o = t; o < n_total; o += kThreads) {
      int r = run[o];
      for (int w = 0; w < kWarps; ++w) {
        const int k = w * n_total + o;
        pre[k] = r;
        r += cnt[k];
        cnt[k] = 0;
      }
      run[o] = r;
    }
    __syncthreads();
    return c;
  };

  const long long first = (long long)tile * per * kThreads + t;
  Tile c{false, -1, 0};
  if (ranks) c = local(0, first);
  // COUNT's counts, complete and visible (a no-op when launched plainly).
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int* cl = counts + (long long)l * tiles * n_total;
  for (int e = t; e < tiles * n_total; e += kThreads) {
    const int tt = e / n_total, o = e - tt * n_total;
    const int k = cl[e];
    if (tt < tile) atomicAdd(&base[o], k);
    atomicAdd(&total[o], k);
  }
  __syncthreads();

  const long long step = (long long)nl * nl * quota;  // one lane x to the next
  if (ranks) {
    for (int s = 0; s < per; ++s) {
      const long long i = first + (long long)s * kThreads;
      if (s) c = local(s, i);
      if (c.ok) {
        const long long rank = (long long)base[c.o] + pre[warp * n_total + c.o] + c.in_group;
        if (rank < quota) {
          const int d = c.o / nl, ol = c.o - d * nl;
          const long long* v = vals + (long long)l * V + i;
          long long* dst = send + (((long long)d * X * nl + ol) * nl + l) * quota + rank;
          // Eight lanes' loads in flight before their stores.
          int x = 0;
          for (; x + 8 <= X; x += 8) {
            long long r[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) r[j] = __ldg(v + (x + j) * val_stride);
#pragma unroll
            for (int j = 0; j < 8; ++j) dst[(x + j) * step] = r[j];
          }
          for (; x < X; ++x) dst[x * step] = __ldg(v + x * val_stride);
        }
      }
    }
  }

  // The empty slots: chunks of kZero slots of each (x, owner) bucket of
  // this source, dealt round-robin over the source's blocks.
  const unsigned chunks = (unsigned)((quota + kZero - 1) / kZero);
  const unsigned units = (unsigned)X * (unsigned)n_total * chunks;
  for (unsigned u = blockIdx.x; u < units; u += gridDim.x) {
    const unsigned p = u / chunks, ch = u - p * chunks;
    const int x = (int)(p / (unsigned)n_total), o = (int)(p - (unsigned)x * n_total);
    const long long filled = total[o] < quota ? total[o] : quota;
    const long long lo = filled > (long long)ch * kZero ? filled : (long long)ch * kZero;
    const long long hi = quota < (long long)(ch + 1) * kZero ? quota : (long long)(ch + 1) * kZero;
    const int d = o / nl, ol = o - d * nl;
    long long* dst = send + ((((long long)d * X + x) * nl + ol) * nl + l) * quota;
    for (long long r = lo + t; r < hi; r += kThreads) dst[r] = 0;
  }

  if (tile == 0) {
    int ovf = 0;
    for (int o = t; o < n_total; o += kThreads) ovf += total[o] > quota ? total[o] - (int)quota : 0;
    for (int d = 16; d > 0; d >>= 1) ovf += __shfl_xor_sync(0xffffffffu, ovf, d);
    if (lane == 0) ovf_warp[warp] = ovf;
    __syncthreads();
    if (t == 0) {
      long long sum = 0;
      for (int w = 0; w < kWarps; ++w) sum += ovf_warp[w];
      n_ovf[l] = sum;
    }
  }
}

}  // namespace

// h1: int64 [nl * V]; reps: bool [nl * V]; vals: int64 lanes, lane x of
// candidate (l, i) at x * val_stride + l * V + i; send: int64 [world, X,
// nl, nl, quota]; n_ovf: int64 [nl]. n_total = nl * world <= 256. The
// plan (ops/exchange.py exchange_plan): `per` sub-tiles of 256
// candidates a tile, `tiles` tiles a source (0 when V is 0). scratch:
// int32 [nl * max(1, tiles) * n_total], written by COUNT before WRITE
// reads it.
extern "C" int srt_exchange(const void* h1, const void* reps, const void* vals,
                            long long val_stride, long long nl, long long V, long long X,
                            long long n_total, long long quota, long long world, long long per,
                            long long tiles, void* scratch, void* send, void* n_ovf,
                            void* stream) {
  if (nl < 1 || V < 0 || V >= (1ll << 31) || X < 1 || quota < 1 || quota >= (1ll << 31) ||
      world < 1 || n_total != nl * world || n_total > kMaxShards || per < 1 || tiles < 0 ||
      tiles > 65535 || tiles * per * kThreads < V || (tiles > 0 && (tiles - 1) * per * kThreads >= V) ||
      X * n_total * ((quota + kZero - 1) / kZero) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int* counts = (int*)scratch;
  if (tiles > 0) {
    count_kernel<<<dim3((unsigned)tiles, (unsigned)nl), kThreads, 0, st>>>(
        (const long long*)h1, (const bool*)reps, V, (int)n_total, (int)per, (int)tiles, counts);
  }
  // WRITE as a programmatic dependent of COUNT: its blocks are scheduled
  // while COUNT runs and rank their first sub-tile, then wait for the counts.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles > 0 ? tiles : 1), (unsigned)nl);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = tiles > 0;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, write_kernel, (const long long*)h1, (const bool*)reps,
                                     (const long long*)vals, val_stride, (int)nl, V, (int)X,
                                     (int)n_total, quota, (int)per, (int)tiles, (const int*)counts,
                                     (long long*)send, (long long*)n_ovf);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
