// K13a: the walk step's cycle test and path record, one launch a step.
//
// Replaces stateright_tpu/engines/tpu_simulation.py:199-217 (the [B, L]
// membership compare, the path-buffer scatter, counted/ptr/gen) and
// :254-266 (the depth histogram and the per-walk maxd). Per walk w, from
// the fingerprint (h1[w], h2[w]) of its current state:
//   in_path = the packed word h1 << 32 | h2 is in path[w, 0:ptr];
//   cycle   = !frozen && in_path;  counted = !frozen && !in_path;
//   a counted walk writes the word at path[w, ptr] (when ptr < L) and
//   ptr += 1; gen += counted; dhist[min(ptr, depth_cap - 1)] += counted;
//   maxd = max(maxd, ptr) over every walk.
// The JAX loop also multiplies a restarted walk's whole path row by 0;
// only slots below ptr are ever read (here and by the discovery harvest),
// and a restart sets ptr = 0, so this port never clears a row.
//
// walk is int64 [S + 4, B] (S state lanes, seed, ptr, ebits, frozen),
// path int64 [B, L], stats int64 [5] = (gen, occupied, rec_acc, maxd,
// frozen),
// dhist int64 [depth_cap] or null (coverage off).
//
// Bound on the card: bytes. Each walk reads its own path row up to ptr
// (8 bytes a slot) and its lanes, and writes one slot; the compares are a
// handful of operations a byte. Design: one warp per walk, the 32 lanes
// reading 32 consecutive slots of the row (one coalesced 256-byte load),
// stopping at the first match by a warp vote; lane 0 does the walk's
// bookkeeping. gen and maxd are reduced in the block before one atomic
// each; the depth histogram is run-length merged per warp (walks that
// move in step share a depth) before its atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    record_kernel(const long long* __restrict__ h1,
                  const long long* __restrict__ h2, long long* __restrict__ walk,
                  int S, long long B, long long* __restrict__ path, int L,
                  bool* __restrict__ counted_out, bool* __restrict__ cycle_out,
                  unsigned long long* __restrict__ stats,
                  unsigned long long* __restrict__ dhist, int depth_cap) {
  __shared__ unsigned long long warp_gen[kWarps];
  __shared__ unsigned long long warp_max[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long nwarps = (long long)gridDim.x * kWarps;
  long long* ptr_lane = walk + (long long)(S + 1) * B;
  const long long* frozen_lane = walk + (long long)(S + 3) * B;
  unsigned long long gen = 0, maxd = 0, run_n = 0;
  int run_bin = -1;
  for (long long w = (long long)blockIdx.x * kWarps + warp; w < B; w += nwarps) {
    long long ptr = ptr_lane[w];
    const bool frozen = frozen_lane[w] != 0;
    const unsigned long long key =
        ((unsigned long long)(uint32_t)h1[w] << 32) | (uint32_t)h2[w];
    long long* row = path + w * (long long)L;
    bool hit = false;
    if (!frozen) {
      const long long n = ptr < L ? ptr : L;
      for (long long base = 0; base < n; base += 32) {
        const long long k = base + lane;
        const bool m = k < n && (unsigned long long)row[k] == key;
        if (__any_sync(0xffffffffu, m)) {
          hit = true;
          break;
        }
      }
    }
    if (lane == 0) {
      const bool counted = !frozen && !hit;
      counted_out[w] = counted;
      cycle_out[w] = !frozen && hit;
      if (counted) {
        if (ptr < L) row[ptr] = (long long)key;
        ptr += 1;
        ptr_lane[w] = ptr;
        gen += 1;
        if (dhist != nullptr) {
          const int bin = ptr < depth_cap - 1 ? (int)ptr : depth_cap - 1;
          if (bin != run_bin) {
            if (run_n) atomicAdd(dhist + run_bin, run_n);
            run_bin = bin;
            run_n = 0;
          }
          run_n += 1;
        }
      }
      if ((unsigned long long)ptr > maxd) maxd = (unsigned long long)ptr;
    }
  }
  if (lane == 0) {
    if (run_n) atomicAdd(dhist + run_bin, run_n);
    warp_gen[warp] = gen;
    warp_max[warp] = maxd;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long g = 0, m = 0;
    for (int i = 0; i < kWarps; ++i) {
      g += warp_gen[i];
      m = warp_max[i] > m ? warp_max[i] : m;
    }
    if (g) atomicAdd(stats + 0, g);
    atomicMax(stats + 3, m);
  }
}

}  // namespace

extern "C" int srt_walk_record(const void* h1, const void* h2, void* walk,
                               int S, long long B, void* path, int L,
                               void* counted, void* cycle, void* stats,
                               void* dhist, int depth_cap, void* stream) {
  if (B < 1 || L < 1 || S < 0) return (int)cudaErrorInvalidValue;
  long long blocks = (B + kWarps - 1) / kWarps;
  if (blocks > 132 * 16) blocks = 132 * 16;
  cudaStream_t st = (cudaStream_t)stream;
  record_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      (const long long*)h1, (const long long*)h2, (long long*)walk, S, B,
      (long long*)path, L, (bool*)counted, (bool*)cycle,
      (unsigned long long*)stats, (unsigned long long*)dhist, depth_cap);
  return (int)cudaGetLastError();
}
