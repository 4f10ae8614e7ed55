// K11c, the 2PC symmetry canon, as a hand-written kernel: one thread a
// candidate row, the row's three lanes in, its representative out.
//
// Replaces stateright_tpu/models/two_phase_commit.py:270
// TwoPhaseTensor.representative_lanes as XLA compiles it into the BFS
// step (stateright_tpu/engines/tpu_bfs.py:478-482: the compacted
// candidates, canonicalized before they are hashed). The semantics live
// in models/two_phase.cuh (two_phase_canon<N>), which the CPU tests
// compile with g++ and hold against the JAX package bit for bit. One
// instantiation for each n in [1, 16], so the n descriptors and the
// odd-even network's n passes stay in registers (n(n-1)/2 compare-swaps
// a row).
//
// Rows come in and go out as [3, W] int64 words holding uint32 values;
// the outputs are zero-extended. For a fixed lane the threads of a warp
// read and write consecutive words, so every access is coalesced. Bound
// on the card: bytes, 2 x 3 x 8 bytes a row.

#include <cuda_runtime.h>

#include "models/two_phase.cuh"

namespace {

constexpr int kThreads = 256;

template <int N>
__global__ void __launch_bounds__(kThreads)
    canon_kernel(const long long* __restrict__ in, long long* __restrict__ out, long long W) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= W) return;
  uint32_t row[3], rep[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) row[s] = (uint32_t)in[s * W + c];
  srt::two_phase_canon<N>(row, rep);
#pragma unroll
  for (int s = 0; s < 3; ++s) out[s * W + c] = (long long)rep[s];
}

template <int N>
struct Canon {
  static int run(const void* in, void* out, long long W, cudaStream_t stream) {
    if (W <= 0) return 0;
    const unsigned int blocks = (unsigned int)((W + kThreads - 1) / kThreads);
    canon_kernel<N><<<blocks, kThreads, 0, stream>>>((const long long*)in, (long long*)out, W);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" int srt_canon_2pc(int n, const void* rows_in, void* rows_out, long long W,
                             void* stream) {
  return srt::by_rms<Canon>(n, (int)cudaErrorInvalidValue, rows_in, rows_out, W,
                            (cudaStream_t)stream);
}
