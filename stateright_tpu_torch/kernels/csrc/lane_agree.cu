// K16a: the agreement table of the speclint device and symmetry probes —
// a model's lane program run on the card against the same program run
// under numpy, reduced to the first disagreement per action and lane.
//
// Replaces the comparison half of stateright_tpu/analysis/device.py:336
// _check_host_device_agreement (:360-393: per action, the validity masks,
// then each successor lane on the rows valid on both sides) and of
// analysis/symmetry.py:166 _check_lanes (:221-237, one action, every row
// valid). The JAX package reads every lane back and compares on the host;
// here one launch reduces the A x S x B lanes to A + 2A + A x S words, and
// the host walks that table in the reference's order (ops/agree.py).
//
// Inputs: the card's lanes int64 [A, S, B] (uint32 values, high bits
// allowed: only the low 32 bits are compared) and masks bool [A, B];
// numpy's lanes uint32 [A, S, B] and masks bool [A, B]; all contiguous.
// Output: uint32 words [A + A + A + A * S]:
//   [0, A)            rows valid on the card, per action
//   [A, 2A)           rows valid under numpy, per action
//   [2A, 3A)          the first row whose masks differ, per action
//   [3A, 3A + A * S)  the first row valid on both sides whose lane differs,
//                     per (action, lane)
// The first-row words start at 0xFFFFFFFF (a memset, not a launch) and
// fall with atomicMin; the host reads any word at or past B as B, "none".
//
// Design: one block per (action, lane) pair on grid.y and 256 rows per
// block on grid.x, so a block never straddles a pair: the counts come from
// __syncthreads_count (one atomicAdd a block, in the lane-0 blocks only),
// and a disagreement, rare on a correct model, costs one atomicMin.
//
// Bound on the card: bytes — the card's lanes (8 bytes) and numpy's (4)
// read once, both masks once: (8 + 4) A S B + 2 A B bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    lane_agree_kernel(const long long* __restrict__ dev, const bool* __restrict__ dmask,
                      const uint32_t* __restrict__ host, const bool* __restrict__ hmask,
                      long long A, long long S, long long B, unsigned* __restrict__ out) {
  const long long pair = blockIdx.y;  // a * S + s
  const long long a = pair / S, s = pair - a * S;
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool in = b < B;
  const bool dm = in && dmask[a * B + b];
  const bool hm = in && hmask[a * B + b];
  if (s == 0) {  // uniform over the block
    const int nd = __syncthreads_count(dm);
    const int nh = __syncthreads_count(hm);
    if (threadIdx.x == 0) {
      if (nd) atomicAdd(&out[a], (unsigned)nd);
      if (nh) atomicAdd(&out[A + a], (unsigned)nh);
    }
    if (dm != hm) atomicMin(&out[2 * A + a], (unsigned)b);
  }
  if (dm && hm) {
    const long long i = pair * B + b;
    if ((uint32_t)((unsigned long long)dev[i] & 0xFFFFFFFFull) != host[i]) {
      atomicMin(&out[3 * A + pair], (unsigned)b);
    }
  }
}

}  // namespace

extern "C" int srt_lane_agree(const void* dev, const void* dmask, const void* host,
                              const void* hmask, long long A, long long S, long long B,
                              void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* o = (unsigned*)out;
  cudaError_t err = cudaMemsetAsync(o, 0, 2 * A * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(o + 2 * A, 0xFF, (A + A * S) * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  if (A == 0 || S == 0 || B == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((B + kThreads - 1) / kThreads), (unsigned)(A * S));
  lane_agree_kernel<<<grid, kThreads, 0, st>>>(
      (const long long*)dev, (const bool*)dmask, (const uint32_t*)host, (const bool*)hmask,
      A, S, B, o);
  return (int)cudaGetLastError();
}
