// K12a: the stage profiler's loop kernel and its synthetic lanes.
//
// Replaces the carry of the stage microbenchmarks' `lax.fori_loop`
// (stateright_tpu/engines/tpu_bfs.py:1138 `_build_stage_kernels`,
// stateright_tpu/engines/tpu_simulation.py:569 `_build_sim_stage_kernels`)
// and the null loop (stateright_tpu/obs/stageprof.py:60), and the
// lowbias32 synthetic operands those kernels build (`_mix`, `_lane`,
// tpu_bfs.py:1180-1191). A stage program (engines/stages.py) is one CUDA
// graph: a START launch, then a conditional WHILE node whose body is one
// round of the stage's own kernels followed by FOLD, which adds the
// round's anchor terms to the accumulator and sets the loop's condition.
//
// The loop's state is one int64 vector st[5] on the card:
//   st[0] acc     the uint32 accumulator the rounds chain through;
//   st[1] count   rounds run (the fori_loop index `i` of the next round);
//   st[2] open    another round runs (the CPU loop reads it);
//   st[3] partial FOLD's cross-block sum, st[4] its last-block ticket
//                 (both 0 between launches).
//
// srt_stage_loop modes:
//   START  count = 0, open = iters > 0, then the condition;
//   FOLD   acc = (acc + add + sum of the terms) mod 2^32, count += 1,
//          the insert epoch (when given) += 1, open = count < iters, then
//          the condition;
//   ADD    the sum alone (the probe stage's term after its loop).
// A term is a strided run of int64 words (or bytes of a bool mask): a
// first element (n = 1) or a full-width sum; each word contributes
// (word >> shift) & mask, so an int64 lane that holds a uint32 value adds
// its low 32 bits and a packed table key can give one bit of its high
// half. The sum runs in every block; the last block to take the ticket
// does the scalar writes, from one thread: exactly one thread writes the
// count and sets the condition (the walk-era COMMIT raced when all did).
//
// srt_stage_lanes modes (the synthetic operands, int64 lanes of uint32):
//   MIX   out[r, i] = f(mix(v)), v = i * 0x9E3779B1 + salt_r, or, with a
//         source, src[r, i] ^ salt_r; salt_r = salt + r * step;
//         f(x) = (x & mask) % mod (no modulus when mod is 0);
//   XOR   out[r, i] = (src[r, i] ^ (r < xor_rows ? acc & acc_mask : 0)) & mask;
//   MASK  out[r, i] (bool) = ((src[r, i] ^ acc) & mask) == 0 (acc 0 with no st);
//   RING  out[w, j] = mix(j * 2654435761 + sum_c src[w, c] + 17 w), the
//         ring stage's appended rows from the popped rows; then
//         head = (head + head_add) & head_mask (one thread).
//
// Bound on the card: latency for START, FOLD's first-element terms and
// the per-round XOR of a few lanes; bytes for FOLD's full-width sums and
// for MIX, which runs once a program. Design: grid-stride loops, one
// thread an element; FOLD reduces in the warp, then the block, then one
// atomic a block; RING runs one block a ring lane (W blocks), each
// reducing its lane before writing its row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRingThreads = 1024;
constexpr int kMaxTerms = 8;
constexpr unsigned long long kM32 = 0xFFFFFFFFull;
constexpr int ST_ACC = 0, ST_COUNT = 1, ST_OPEN = 2, ST_PART = 3, ST_TICKET = 4;
constexpr int MODE_START = 0, MODE_FOLD = 1, MODE_ADD = 2;
constexpr int LANE_MIX = 0, LANE_XOR = 1, LANE_MASK = 2, LANE_RING = 3;
constexpr long long kTermBool = 1;

struct Term {
  const void* ptr;
  long long n, stride, shift, mask, flags;
};
struct Terms {
  Term t[kMaxTerms];
  int n;
};

// The host's lane arguments, in this order (ops/stage.py LANE_FIELDS).
struct LaneArgs {
  long long rows, n, salt, step, mask, mod, xor_rows, acc_mask, out_n, head_add, head_mask;
};
constexpr int kLaneArgs = 11;

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

__device__ __forceinline__ unsigned long long block_sum(unsigned long long v,
                                                        unsigned long long* red) {
  for (int o = 16; o; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned long long s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;  // thread 0's is the block's
}

__global__ void start_kernel(long long* st, long long iters, cudaGraphConditionalHandle h) {
  st[ST_COUNT] = 0;
  st[ST_PART] = 0;
  st[ST_TICKET] = 0;
  st[ST_OPEN] = iters > 0;
  if (h) cudaGraphSetConditional(h, iters > 0 ? 1u : 0u);
}

__global__ void __launch_bounds__(kThreads)
    fold_kernel(int mode, long long* st, long long iters, unsigned long long add, long long* epoch,
                const __grid_constant__ Terms terms, cudaGraphConditionalHandle h) {
  __shared__ unsigned long long red[kThreads / 32];
  __shared__ bool last;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long G = (long long)gridDim.x * blockDim.x;
  unsigned long long sum = 0;
  for (int k = 0; k < terms.n; ++k) {
    const Term& t = terms.t[k];
    for (long long i = g; i < t.n; i += G) {
      const unsigned long long v =
          (t.flags & kTermBool)
              ? (unsigned long long)((const unsigned char*)t.ptr)[i * t.stride]
              : (unsigned long long)((const long long*)t.ptr)[i * t.stride];
      sum += (v >> t.shift) & (unsigned long long)t.mask;
    }
  }
  sum = block_sum(sum, red);
  if (threadIdx.x == 0) {
    if (sum) atomicAdd((unsigned long long*)(st + ST_PART), sum);
    __threadfence();
    last = atomicAdd((unsigned long long*)(st + ST_TICKET), 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  volatile long long* v = st;
  const unsigned long long total = (unsigned long long)v[ST_PART];
  v[ST_PART] = 0;
  v[ST_TICKET] = 0;
  v[ST_ACC] = (long long)(((unsigned long long)v[ST_ACC] + add + total) & kM32);
  if (mode != MODE_FOLD) return;
  const long long count = v[ST_COUNT] + 1;
  v[ST_COUNT] = count;
  if (epoch) *epoch += 1;
  const bool open = count < iters;
  v[ST_OPEN] = open;
  if (h) cudaGraphSetConditional(h, open ? 1u : 0u);
}

__global__ void __launch_bounds__(kThreads)
    lanes_kernel(int mode, void* out, const long long* __restrict__ src,
                 const long long* __restrict__ st, const __grid_constant__ LaneArgs a) {
  const long long total = a.rows * a.n;
  const uint32_t acc = st ? (uint32_t)st[ST_ACC] : 0u;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long r = idx / a.n, i = idx - r * a.n;
    if (mode == LANE_MIX) {
      const uint32_t salt = (uint32_t)(a.salt + r * a.step);
      const uint32_t v = src ? ((uint32_t)src[idx] ^ salt) : ((uint32_t)i * 0x9E3779B1u + salt);
      uint32_t x = mix(v) & (uint32_t)a.mask;
      if (a.mod) x %= (uint32_t)a.mod;
      ((long long*)out)[idx] = x;
    } else if (mode == LANE_XOR) {
      const uint32_t x = r < a.xor_rows ? (acc & (uint32_t)a.acc_mask) : 0u;
      ((long long*)out)[idx] = ((uint32_t)src[idx] ^ x) & (uint32_t)a.mask;
    } else {
      ((bool*)out)[idx] = (((uint32_t)src[idx] ^ acc) & (uint32_t)a.mask) == 0u;
    }
  }
}

__global__ void __launch_bounds__(kRingThreads)
    ring_kernel(long long* __restrict__ out, const long long* __restrict__ src,
                long long* __restrict__ head, const __grid_constant__ LaneArgs a) {
  __shared__ unsigned long long red[kRingThreads / 32];
  __shared__ uint32_t lane_sum;
  const long long w = blockIdx.x;
  unsigned long long s = 0;
  for (long long c = threadIdx.x; c < a.n; c += blockDim.x) s += (uint32_t)src[w * a.n + c];
  s = block_sum(s, red);
  if (threadIdx.x == 0) lane_sum = (uint32_t)s;
  __syncthreads();
  const uint32_t add = lane_sum + (uint32_t)(17 * w);
  for (long long j = threadIdx.x; j < a.out_n; j += blockDim.x)
    out[w * a.out_n + j] = mix((uint32_t)j * 2654435761u + add);
  if (w == 0 && threadIdx.x == 0) *head = (*head + a.head_add) & a.head_mask;
}

unsigned grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 8) blocks = 132 * 8;
  return (unsigned)blocks;
}

}  // namespace

// mode: 0 START, 1 FOLD, 2 ADD. st: int64[5] on the card. terms: n_terms
// host records of (device pointer, n, stride, shift, mask, flags), read
// on the host at the call (a captured launch keeps them). epoch: the
// visited insert's epoch on the card (FOLD raises it), or null. handle:
// the WHILE node's conditional handle, or 0.
extern "C" int srt_stage_loop(int mode, void* st, long long iters, unsigned long long add,
                              void* epoch, int n_terms, const long long* terms,
                              unsigned long long handle, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const cudaGraphConditionalHandle h = (cudaGraphConditionalHandle)handle;
  if (mode == MODE_START) {
    start_kernel<<<1, 1, 0, s>>>((long long*)st, iters, h);
    return (int)cudaGetLastError();
  }
  if ((mode != MODE_FOLD && mode != MODE_ADD) || n_terms < 0 || n_terms > kMaxTerms)
    return (int)cudaErrorInvalidValue;
  Terms t = {};
  t.n = n_terms;
  long long widest = 1;
  for (int k = 0; k < n_terms; ++k) {
    const long long* r = terms + 6 * k;
    t.t[k] = Term{(const void*)r[0], r[1], r[2], r[3], r[4], r[5]};
    if (r[1] > widest) widest = r[1];
  }
  fold_kernel<<<grid_for(widest), kThreads, 0, s>>>(mode, (long long*)st, iters, add,
                                                    (long long*)epoch, t, h);
  return (int)cudaGetLastError();
}

// mode: 0 MIX, 1 XOR, 2 MASK, 3 RING. args: the kLaneArgs host words
// (LaneArgs). out: int64 [rows, n] (MASK: bool; RING: int64 [rows,
// out_n]). src: int64 [rows, n] or null (MIX only). st: the loop state
// (XOR, MASK: acc is read there) or null. head: int64[1] (RING).
extern "C" int srt_stage_lanes(int mode, void* out, const void* src, const void* st, void* head,
                               const long long* args, void* stream) {
  LaneArgs a;
  long long* dst = &a.rows;
  for (int i = 0; i < kLaneArgs; ++i) dst[i] = args[i];
  if (a.rows < 0 || a.n < 0 || mode < LANE_MIX || mode > LANE_RING) return (int)cudaErrorInvalidValue;
  if (mode != LANE_MIX && !src) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == LANE_RING) {
    if (!head || a.rows < 1) return (int)cudaErrorInvalidValue;
    ring_kernel<<<(unsigned)a.rows, kRingThreads, 0, s>>>((long long*)out, (const long long*)src,
                                                          (long long*)head, a);
  } else if (a.rows * a.n > 0) {
    lanes_kernel<<<grid_for(a.rows * a.n), kThreads, 0, s>>>(mode, out, (const long long*)src,
                                                             (const long long*)st, a);
  }
  return (int)cudaGetLastError();
}
