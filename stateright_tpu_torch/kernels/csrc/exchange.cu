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
// [X, nl, n_total * quota] already, so this launch is the whole exchange;
// across ranks one all_to_all_single moves it (ops/exchange.py).
// Slots that no candidate fills are 0: an all-zero parent pair marks an
// empty receive slot (mesh.py:392).
//
// Design: one block of 1,024 threads a source shard. Block l owns every
// slot whose source is l, so it zeroes them itself and no other block
// writes there: no grid-wide ordering is needed. The rank is a stable
// scan in candidate order, tile by tile: within a warp, __match_any_sync
// groups the lanes with one owner and a popcount gives each lane's rank
// in its group; a per-warp, per-owner count in shared memory becomes an
// exclusive prefix over the warps (one thread an owner), added to the
// owner's running count from the earlier tiles. The ranks are therefore
// exactly the cumsum's, whatever the schedule — an atomic counter would
// give schedule-dependent slots, and the owner's insert winner and ring
// order would drift from the reference.
//
// Bound on the card: bytes — h1, reps and the X lanes of the candidates
// read once, the send buffer written once (its zeroes included).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxShards = 256;

__global__ void __launch_bounds__(kThreads)
    exchange_kernel(const long long* __restrict__ h1, const bool* __restrict__ reps,
                    const long long* __restrict__ vals, long long val_stride, long long nl,
                    long long V, long long X, long long n_total, long long quota,
                    long long world, long long* __restrict__ send,
                    long long* __restrict__ n_ovf) {
  // Per-warp, per-owner counts of a tile, then their exclusive prefix.
  __shared__ int warp_cnt[kWarps * kMaxShards];
  // Each owner's kept candidates of the earlier tiles, and of this one.
  __shared__ long long base[kMaxShards];
  __shared__ int tile_total[kMaxShards];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long l = blockIdx.x;
  const long long triples = world * X * nl;  // (destination, lane, owner)
  for (long long i = t; i < triples * quota; i += kThreads) {
    const long long trip = i / quota, r = i - trip * quota;
    send[(trip * nl + l) * quota + r] = 0;
  }
  for (long long o = t; o < n_total; o += kThreads) base[o] = 0;
  __syncthreads();
  const long long* hl = h1 + l * V;
  const bool* rl = reps + l * V;
  for (long long start = 0; start < V; start += kThreads) {
    for (long long i = t; i < (long long)kWarps * n_total; i += kThreads) warp_cnt[i] = 0;
    __syncthreads();
    const long long i = start + t;
    const bool ok = i < V && rl[i];
    const int o = ok ? (int)((unsigned long long)hl[i] % (unsigned long long)n_total) : -1;
    const unsigned group = __match_any_sync(0xffffffffu, o);
    const int in_group = __popc(group & ((1u << lane) - 1u));
    if (ok && in_group == 0) warp_cnt[warp * n_total + o] = __popc(group);
    __syncthreads();
    for (long long oo = t; oo < n_total; oo += kThreads) {
      int run = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int c = warp_cnt[w * n_total + oo];
        warp_cnt[w * n_total + oo] = run;
        run += c;
      }
      tile_total[oo] = run;
    }
    __syncthreads();
    if (ok) {
      const long long rank = base[o] + warp_cnt[warp * n_total + o] + in_group;
      if (rank < quota) {
        const long long d = o / nl, ol = o - d * nl;
        const long long* v = vals + l * V + i;
        for (long long x = 0; x < X; ++x)
          send[(((d * X + x) * nl + ol) * nl + l) * quota + rank] = v[x * val_stride];
      }
    }
    __syncthreads();
    for (long long oo = t; oo < n_total; oo += kThreads) base[oo] += tile_total[oo];
    __syncthreads();
  }
  if (t == 0) {
    long long ovf = 0;
    for (long long o = 0; o < n_total; ++o) ovf += base[o] > quota ? base[o] - quota : 0;
    n_ovf[l] = ovf;
  }
}

}  // namespace

// h1: int64 [nl * V]; reps: bool [nl * V]; vals: int64 lanes, lane x of
// candidate (l, i) at x * val_stride + l * V + i; send: int64 [world, X,
// nl, nl, quota]; n_ovf: int64 [nl]. n_total = nl * world <= 256.
extern "C" int srt_exchange(const void* h1, const void* reps, const void* vals,
                            long long val_stride, long long nl, long long V, long long X,
                            long long n_total, long long quota, long long world, void* send,
                            void* n_ovf, void* stream) {
  if (nl < 1 || V < 0 || X < 1 || quota < 1 || world < 1 || n_total != nl * world ||
      n_total > kMaxShards)
    return (int)cudaErrorInvalidValue;
  exchange_kernel<<<(unsigned)nl, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)h1, (const bool*)reps, (const long long*)vals, val_stride, nl, V, X,
      n_total, quota, world, (long long*)send, (long long*)n_ovf);
  return (int)cudaGetLastError();
}
