// K7: the BFS ring queue — pop and append.
//
// Replaces stateright_tpu/ops/frontier.py:55 ring_gather (pop) and :62
// ring_scatter (append). The ring is one int64 tensor [W, stride]: W lanes
// (state lanes, eventually-bits, depth), a power-of-two capacity
// qcap = qmask + 1 and stride = qcap + 1 (the last column is the trash
// slot of the torch version; the kernel never writes it).
//
//   pop    (ids == NULL): buf[w, i] = ring[w, (base + i) & qmask],
//          i < n — the n consecutive rows from the head, wrapping.
//   append (ids != NULL): ring[w, (base + r) & qmask] = buf[w, ids[r]],
//          r < min(*n_set, n) — the valid candidate rows at tail + rank,
//          in candidate order. ids/n_set are K2's compaction of the
//          validity mask (compact_ids.cu), so rank r holds the r-th valid
//          candidate and invalid rows write nothing.
//
// Bound on the card: bytes. Each moved row is read once and written
// once (8 bytes a lane); the ids are read once. Design: a 2-D grid, x over
// rows and y over lanes, so consecutive threads touch consecutive ring
// positions and consecutive buffer columns (coalesced on both sides,
// except where a wrap splits a warp).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void pop_kernel(const long long* __restrict__ ring,
                           long long stride, long long qmask, long long base,
                           long long* __restrict__ buf, long long buf_stride,
                           long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long w = blockIdx.y;
  buf[w * buf_stride + i] = ring[w * stride + ((base + i) & qmask)];
}

__global__ void append_kernel(long long* __restrict__ ring, long long stride,
                              long long qmask, long long base,
                              const long long* __restrict__ buf,
                              long long buf_stride, long long n,
                              const long long* __restrict__ ids,
                              const long long* __restrict__ n_set) {
  long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long count = *n_set < n ? *n_set : n;
  if (r >= count) return;
  long long w = blockIdx.y;
  ring[w * stride + ((base + r) & qmask)] = buf[w * buf_stride + ids[r]];
}

}  // namespace

// width: W lanes (grid y, <= 65535); n: rows popped, or the width of the
// candidate buffer and of ids when appending.
extern "C" int srt_ring(void* ring, long long width, long long stride,
                        long long qmask, long long base, void* buf,
                        long long buf_stride, long long n, const void* ids,
                        const void* n_set, void* stream) {
  if (n > 0 && width > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = 256;
    dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)width);
    if (ids == nullptr) {
      pop_kernel<<<grid, threads, 0, st>>>((const long long*)ring, stride,
                                           qmask, base, (long long*)buf,
                                           buf_stride, n);
    } else {
      append_kernel<<<grid, threads, 0, st>>>(
          (long long*)ring, stride, qmask, base, (const long long*)buf,
          buf_stride, n, (const long long*)ids, (const long long*)n_set);
    }
  }
  return (int)cudaGetLastError();
}
