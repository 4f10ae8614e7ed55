// K13a: the walk step's cycle test and path record, one launch a step.
//
// Replaces stateright_tpu/engines/tpu_simulation.py:199-217 (the [B, L]
// membership compare, the path-buffer scatter, counted/ptr/gen) and
// :254-266 (the depth histogram and the per-walk maxd). Per walk w, from
// the fingerprint (h1[w], h2[w]) of its current state:
//   in_path = the packed word h1 << 32 | h2 is in path[w, 0:min(ptr, L)];
//   cycle   = !frozen && in_path;  counted = !frozen && !in_path;
//   a counted walk writes the word at path[w, ptr] (when ptr < L) and
//   ptr += 1; gen += counted; dhist[min(ptr, depth_cap - 1)] += counted;
//   maxd = max(maxd, ptr) over every walk, frozen ones included.
// The JAX loop also multiplies a restarted walk's whole path row by 0;
// only slots below ptr are ever read (here and by the discovery harvest),
// and a restart sets ptr = 0, so this port never clears a row.
//
// walk is int64 [S + 4, B] (S state lanes, seed, ptr, ebits, frozen),
// path int64 [B, L], stats int64 [5] = (gen, occupied, rec_acc, maxd,
// frozen), dhist int64 [depth_cap] or null (coverage off), depth_cap <=
// kMaxBins.
//
// Bound on the card: bytes, B x 32 (ptr, frozen, h1, h2) + sum(min(ptr,
// L)) x 8 (the rows below ptr) + B x 2 (counted, cycle) + counted x 16
// (the slot and ptr written) + the histogram's bins: about 1.6 MB at B =
// 16,384 and 5 MB at B = 65,536 after an era, a microsecond or two of
// HBM time, and up to 60 MB where the paths run to L. After an era what
// costs is latency: a walk is a chain of two dependent round trips (its
// ptr, then its row). Design:
//   - kWalks walks a block, one block per kWalks walks (no loop over
//     several walks): a thread of the first kWalks loads its walk's ptr,
//     frozen, h1 and h2 together, so that every walk's loads are in
//     flight at once and the neighbours' words are coalesced;
//   - the rows below ptr are read by all kThreads of the block as one
//     flat run of units (16-byte slot pairs where L is even and the path
//     starts on 16 bytes, else single slots), a block-wide scan of the
//     walks' unit counts placing each walk's run; a thread takes every
//     kThreads-th unit, kUnroll loads issued together, and finds its
//     unit's walk by a binary search of the scan. After an era (a few
//     slots a walk) every row is read in one round trip; a deep walk's
//     row is spread over the whole block, so it holds up no neighbour;
//   - a hit marks its walk in shared memory; then each walk's thread
//     settles it (counted / cycle bytes, the slot, ptr);
//   - the depth histogram is binned in shared memory and merged with one
//     atomic per non-empty bin a block; gen and maxd are reduced in the
//     block before one atomic each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWalks = 128;    // walks a block
constexpr int kThreads = 512;  // threads a block: four a walk to read the rows
constexpr int kUnroll = 8;     // units a thread keeps in flight
constexpr int kMaxBins = 1024;

template <bool kPairs>
__global__ void __launch_bounds__(kThreads)
    record_kernel(const long long* __restrict__ h1, const long long* __restrict__ h2,
                  long long* __restrict__ walk, int S, long long B, long long* __restrict__ path, int L,
                  bool* __restrict__ counted_out, bool* __restrict__ cycle_out,
                  unsigned long long* __restrict__ stats, unsigned long long* __restrict__ dhist,
                  int depth_cap) {
  constexpr int kPer = kPairs ? 2 : 1;  // slots a unit
  __shared__ unsigned bins[kMaxBins];
  __shared__ int off[kWalks + 1];  // the walks' first units; off[kWalks] the block's total
  __shared__ int n_s[kWalks];      // slots below min(ptr, L), 0 for a frozen walk
  __shared__ unsigned long long key_s[kWalks];
  __shared__ int hit_s[kWalks];
  __shared__ int warp_units[kWalks / 32];
  __shared__ unsigned warp_gen[kWalks / 32], warp_max[kWalks / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long w0 = (long long)blockIdx.x * kWalks;
  long long* ptr_lane = walk + (long long)(S + 1) * B;
  const long long* frozen_lane = walk + (long long)(S + 3) * B;

  // The walk's four words, issued together; the block's bins are cleared
  // while they are in flight.
  long long ptr = 0, f = 1, a = 0, b = 0;
  const bool mine = t < kWalks && w0 + t < B;
  if (mine) {
    ptr = ptr_lane[w0 + t];
    f = frozen_lane[w0 + t];
    a = h1[w0 + t];
    b = h2[w0 + t];
  }
  if (dhist != nullptr)
    for (int i = t; i < depth_cap; i += kThreads) bins[i] = 0;
  const bool frozen = f != 0;
  const unsigned long long key = ((unsigned long long)(uint32_t)a << 32) | (uint32_t)b;
  if (t < kWalks) {
    const int n = frozen ? 0 : (int)(ptr < L ? ptr : L);
    const int units = (n + kPer - 1) / kPer;
    int x = units;  // inclusive scan over the block's walks
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_units[warp] = x;
    n_s[t] = n;
    key_s[t] = key;
    hit_s[t] = 0;
    off[t] = x - units;  // within the warp; the earlier warps' added below
  }
  __syncthreads();
  if (t < kWalks) {
    int before = 0;
#pragma unroll
    for (int i = 0; i < kWalks / 32; ++i) before += i < warp ? warp_units[i] : 0;
    off[t] += before;
    if (t == kWalks - 1) off[kWalks] = before + warp_units[warp];
  }
  __syncthreads();

  // The rows: the block's units, every kThreads-th a thread, kUnroll loads
  // in flight before the first compare.
  const int total = off[kWalks];
  for (int p0 = t; p0 < total; p0 += kUnroll * kThreads) {
    int j[kUnroll], s[kUnroll];
    long long v0[kUnroll], v1[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u * kThreads;
      j[u] = 0;
      s[u] = 0;
      v0[u] = v1[u] = 0;
      if (p < total) {
        // The last walk whose run starts at or before p (walks with no
        // units share their successor's start).
        int lo = 0, hi = kWalks - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (off[mid] <= p) lo = mid;
          else hi = mid - 1;
        }
        j[u] = lo;
        s[u] = (p - off[lo]) * kPer;
        const long long* row = path + (w0 + lo) * (long long)L;
        if (kPairs) {
          const longlong2 v = reinterpret_cast<const longlong2*>(row)[s[u] >> 1];
          v0[u] = v.x;
          v1[u] = v.y;
        } else {
          v0[u] = row[s[u]];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (p0 + u * kThreads >= total) break;
      const unsigned long long k = key_s[j[u]];
      const bool hit = (unsigned long long)v0[u] == k ||
                       (kPairs && s[u] + 1 < n_s[j[u]] && (unsigned long long)v1[u] == k);
      if (hit) hit_s[j[u]] = 1;
    }
  }
  __syncthreads();

  // Each walk settled by its own thread.
  unsigned gen = 0, maxd = 0;
  if (mine) {
    const long long w = w0 + t;
    const bool hit = hit_s[t] != 0;
    const bool counted = !frozen && !hit;
    counted_out[w] = counted;
    cycle_out[w] = !frozen && hit;
    if (counted) {
      if (ptr < L) path[w * (long long)L + ptr] = (long long)key;
      ptr += 1;
      ptr_lane[w] = ptr;
      gen = 1;
      if (dhist != nullptr) atomicAdd(bins + (ptr < depth_cap - 1 ? (int)ptr : depth_cap - 1), 1u);
    }
    maxd = (unsigned)ptr;
  }
  if (t < kWalks) {
    const unsigned g = __reduce_add_sync(0xffffffffu, gen);
    const unsigned m = __reduce_max_sync(0xffffffffu, maxd);
    if (lane == 0) {
      warp_gen[warp] = g;
      warp_max[warp] = m;
    }
  }
  __syncthreads();
  if (t == 0) {
    unsigned long long gs = 0;
    unsigned ms = 0;
#pragma unroll
    for (int i = 0; i < kWalks / 32; ++i) {
      gs += warp_gen[i];
      ms = warp_max[i] > ms ? warp_max[i] : ms;
    }
    if (gs) atomicAdd(stats + 0, gs);
    if (ms) atomicMax(stats + 3, (unsigned long long)ms);
  }
  if (dhist != nullptr)
    for (int i = t; i < depth_cap; i += kThreads)
      if (bins[i]) atomicAdd(dhist + i, (unsigned long long)bins[i]);
}

}  // namespace

extern "C" int srt_walk_record(const void* h1, const void* h2, void* walk,
                               int S, long long B, void* path, int L,
                               void* counted, void* cycle, void* stats,
                               void* dhist, int depth_cap, void* stream) {
  if (B < 1 || L < 1 || S < 0 || (dhist != nullptr && (depth_cap < 1 || depth_cap > kMaxBins)))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (B + kWalks - 1) / kWalks;
  if (blocks > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  // 16-byte slot pairs where every row starts on 16 bytes.
  const bool pairs = L % 2 == 0 && (reinterpret_cast<uintptr_t>(path) & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  auto kernel = pairs ? record_kernel<true> : record_kernel<false>;
  kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      (const long long*)h1, (const long long*)h2, (long long*)walk, S, B, (long long*)path, L,
      (bool*)counted, (bool*)cycle, (unsigned long long*)stats, (unsigned long long*)dhist, depth_cap);
  return (int)cudaGetLastError();
}
