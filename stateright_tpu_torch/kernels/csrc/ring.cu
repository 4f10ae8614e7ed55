// K7: the BFS ring queue — pop and append, one ring per lane.
//
// Replaces stateright_tpu/ops/frontier.py:55 ring_gather (pop) and :62
// ring_scatter (append), and their jax.vmap over the lanes of the
// multiplexed engine. The rings are one int64 tensor [lanes, W, stride]:
// W state-row lanes each (the state lanes, eventually-bits, depth), a
// power-of-two capacity qcap = qmask + 1 and stride = qcap + 1 (the last
// column is the trash slot of the torch version; the kernel never writes
// it); ring l starts lane_stride elements after ring l-1. The solo engine
// is the one-lane case.
//
// Ring l's head (pop) or tail (append) is base + bases[l] (bases NULL:
// base for every ring), so one launch serves every lane with the lanes'
// positions in a small [lanes] vector.
//
//   pop    (ids == NULL): buf[w, l*n + i] = ring[l, w, (head_l + i) &
//          qmask], i < n — the n consecutive rows from each head,
//          wrapping; the lanes' rows sit side by side in buf.
//   append (ids != NULL): ring[l, w, (tail_l + r) & qmask] =
//          buf[w, l*n + ids[l, r]], r < min(n_set[l], n) — lane l's
//          valid candidate rows at tail + rank, in candidate order.
//          ids/n_set are K2's compaction of the lanes' validity masks
//          (compact_ids.cu), so rank r holds the lane's r-th valid
//          candidate and invalid rows write nothing.
//
// Bound on the card: bytes. Each moved row is read once and written
// once (8 bytes a state-row lane); the ids are read once. Design: a 3-D
// grid, x over rows, y over state-row lanes, z over rings, so consecutive
// threads touch consecutive ring positions and consecutive buffer columns
// (coalesced on both sides, except where a wrap splits a warp).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ long long position(long long base,
                                              const long long* bases,
                                              long long l) {
  return bases ? base + bases[l] : base;
}

__global__ void pop_kernel(const long long* __restrict__ ring,
                           long long stride, long long lane_stride,
                           long long qmask, long long base,
                           const long long* __restrict__ bases,
                           long long* __restrict__ buf, long long buf_stride,
                           long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long w = blockIdx.y;
  long long l = blockIdx.z;
  long long head = position(base, bases, l);
  buf[w * buf_stride + l * n + i] =
      ring[l * lane_stride + w * stride + ((head + i) & qmask)];
}

__global__ void append_kernel(long long* __restrict__ ring, long long stride,
                              long long lane_stride, long long qmask,
                              long long base,
                              const long long* __restrict__ bases,
                              const long long* __restrict__ buf,
                              long long buf_stride, long long n,
                              const long long* __restrict__ ids,
                              const long long* __restrict__ n_set) {
  long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long l = blockIdx.z;
  long long count = n_set[l] < n ? n_set[l] : n;
  if (r >= count) return;
  long long w = blockIdx.y;
  long long tail = position(base, bases, l);
  ring[l * lane_stride + w * stride + ((tail + r) & qmask)] =
      buf[w * buf_stride + l * n + ids[l * n + r]];
}

}  // namespace

// lanes (grid z) and width (grid y) <= 65535; n: rows popped a lane, or
// the width a lane of the candidate buffer and of ids when appending.
// bases: int64[lanes] or NULL.
extern "C" int srt_ring(void* ring, long long lanes, long long width,
                        long long stride, long long lane_stride,
                        long long qmask, long long base, const void* bases,
                        void* buf, long long buf_stride, long long n,
                        const void* ids, const void* n_set, void* stream) {
  if (n > 0 && width > 0 && lanes > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = 256;
    dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)width,
              (unsigned)lanes);
    if (ids == nullptr) {
      pop_kernel<<<grid, threads, 0, st>>>(
          (const long long*)ring, stride, lane_stride, qmask, base,
          (const long long*)bases, (long long*)buf, buf_stride, n);
    } else {
      append_kernel<<<grid, threads, 0, st>>>(
          (long long*)ring, stride, lane_stride, qmask, base,
          (const long long*)bases, (const long long*)buf, buf_stride, n,
          (const long long*)ids, (const long long*)n_set);
    }
  }
  return (int)cudaGetLastError();
}
