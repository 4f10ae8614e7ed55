// K12b: the simulation stage profiler's walk stages.
//
// Replaces three stages of stateright_tpu/engines/tpu_simulation.py:569
// `_build_sim_stage_kernels`, the parts of one walk step that the port's
// era runs inside K13a (walk_record.cu: the cycle test and the path
// record) and K13b (walk_step.cu: the choice), and that no port kernel
// computes alone:
//   CYCLE  (:622-640) per walk w, with h1 = h0[w] ^ (acc & 1): is the
//          packed word h1 << 32 | g0[w] in path[w, 0:ptr[w]]? -> out[w];
//   RECORD (:642-665) with h1 = h0[w] ^ (acc & 1) and the column
//          (acc + i) % L, i the round (the loop's count): a restarting walk
//          (restart[w]) zeroes its whole path row, any other writes
//          h1 << 32 | h1 at the column (the JAX loop writes h1 into both
//          path buffers, then multiplies restarted rows by 0);
//   CHOOSE (:686-724) ne = the valid actions of w (valid[a, w]),
//          r = prng((l227[w] ^ acc) ^ ptr[w] * 0x9E3779B9), pick = r % ne
//          when ne > 0 (else 0), and the first valid action a whose count
//          of valid actions before it equals pick gives out[s, w] =
//          succs[a * S + s, w]; with none, out[s, w] = rows[s, w].
// acc and i are st[0] and st[1], the loop state of K12a (stage_loop.cu),
// read on the card, so a captured round takes the round's values.
//
// path int64 [B, L] (the port's packed path rows, ops/walk.py); h0, g0,
// ptr, l227 int64 [B]; restart and valid bool ([B], [A, B]); rows and
// out int64 [S, B]; succs int64 [A * S, B]. All lanes hold uint32 values.
//
// Bound on the card: bytes. CYCLE reads each walk's path row below ptr
// (8 bytes a slot), RECORD writes one slot a walk or a restarted row,
// CHOOSE reads A validity bytes a walk and writes S lanes. Design, as in
// K13a and K13b: one warp a walk for CYCLE and RECORD (32 consecutive
// slots of the row a load, a warp vote ends the scan at the first match;
// a restarted row is cleared by the warp), one thread a walk for CHOOSE.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int MODE_CYCLE = 0, MODE_RECORD = 1, MODE_CHOOSE = 2;

__device__ __forceinline__ uint32_t prng(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

__global__ void __launch_bounds__(kThreads)
    cycle_kernel(const long long* __restrict__ st, long long B, int L,
                 const long long* __restrict__ path, const long long* __restrict__ h0,
                 const long long* __restrict__ g0, const long long* __restrict__ ptr,
                 bool* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const uint32_t flip = (uint32_t)st[0] & 1u;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); w < B; w += nwarps) {
    const unsigned long long key =
        ((unsigned long long)((uint32_t)h0[w] ^ flip) << 32) | (uint32_t)g0[w];
    const long long* row = path + w * (long long)L;
    const long long n = ptr[w] < L ? ptr[w] : L;
    bool hit = false;
    for (long long base = 0; base < n; base += 32) {
      const long long k = base + lane;
      if (__any_sync(0xffffffffu, k < n && (unsigned long long)row[k] == key)) {
        hit = true;
        break;
      }
    }
    if (lane == 0) out[w] = hit;
  }
}

__global__ void __launch_bounds__(kThreads)
    record_kernel(const long long* __restrict__ st, long long B, int L,
                  long long* __restrict__ path, const long long* __restrict__ h0,
                  const bool* __restrict__ restart) {
  const int lane = threadIdx.x & 31;
  const uint32_t acc = (uint32_t)st[0];
  const uint32_t col = (acc + (uint32_t)st[1]) % (uint32_t)L;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); w < B; w += nwarps) {
    long long* row = path + w * (long long)L;
    if (restart[w]) {
      for (long long k = lane; k < L; k += 32) row[k] = 0;
    } else if (lane == 0) {
      const unsigned long long h1 = (uint32_t)h0[w] ^ (acc & 1u);
      row[col] = (long long)((h1 << 32) | h1);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    choose_kernel(const long long* __restrict__ st, long long B, int S, int A,
                  const long long* __restrict__ rows, const long long* __restrict__ succs,
                  const bool* __restrict__ valid, const long long* __restrict__ ptr,
                  const long long* __restrict__ l227, long long* __restrict__ out) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= B) return;
  const uint32_t sd = (uint32_t)l227[w] ^ (uint32_t)st[0];
  uint32_t ne = 0;
  for (int a = 0; a < A; ++a) ne += valid[(long long)a * B + w];
  const uint32_t r = prng(sd ^ ((uint32_t)ptr[w] * 0x9E3779B9u));
  const uint32_t pick = ne > 0 ? r % ne : 0u;
  int chosen = -1;
  uint32_t cum = 0;
  for (int a = 0; a < A && chosen < 0; ++a) {
    const bool v = valid[(long long)a * B + w];
    if (v && cum == pick) chosen = a;
    cum += v;
  }
  for (int s = 0; s < S; ++s)
    out[(long long)s * B + w] = chosen >= 0 ? succs[((long long)chosen * S + s) * B + w]
                                            : rows[(long long)s * B + w];
}

}  // namespace

// mode: 0 CYCLE (x0 = h0, x1 = g0, x2 = ptr, out = bool [B]), 1 RECORD
// (x0 = h0, x1 = restart; path updated in place), 2 CHOOSE (x0 = rows,
// x1 = succs, x2 = valid, x3 = ptr, x4 = l227, out = int64 [S, B]).
// st: K12a's loop state on the card.
extern "C" int srt_stage_walk(int mode, const void* st, long long B, int L, int S, int A,
                              void* path, const void* x0, const void* x1, const void* x2,
                              const void* x3, const void* x4, void* out, void* stream) {
  if (B < 1 || L < 1 || !st) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  long long warp_blocks = (B + kWarps - 1) / kWarps;
  if (warp_blocks > 132 * 16) warp_blocks = 132 * 16;
  if (mode == MODE_CYCLE) {
    cycle_kernel<<<(unsigned)warp_blocks, kThreads, 0, s>>>(
        (const long long*)st, B, L, (const long long*)path, (const long long*)x0,
        (const long long*)x1, (const long long*)x2, (bool*)out);
  } else if (mode == MODE_RECORD) {
    record_kernel<<<(unsigned)warp_blocks, kThreads, 0, s>>>(
        (const long long*)st, B, L, (long long*)path, (const long long*)x0, (const bool*)x1);
  } else if (mode == MODE_CHOOSE) {
    if (S < 0 || A < 0) return (int)cudaErrorInvalidValue;
    choose_kernel<<<(unsigned)((B + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        (const long long*)st, B, S, A, (const long long*)x0, (const long long*)x1,
        (const bool*)x2, (const long long*)x3, (const long long*)x4, (long long*)out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
