// K7s: the host spill's ring drain and refill, one launch over every ring.
//
// Replaces the JAX engines' eager spill programs: the solo drain
// (stateright_tpu/engines/tpu_bfs.py:1924-1948, S1) and refill (:2060-2087,
// S2), and the sharded engine's per-shard twins
// (stateright_tpu/parallel/mesh.py:1776-1800, S3; :1952-1985, S4).
//
// The rings are one int64 tensor [lanes, W, stride]: W state-row lanes
// each (state lanes, eventually-bits, depth), a power-of-two capacity
// qcap = qmask + 1 and stride = qcap + 1, ring l starting lane_stride
// elements after ring l-1; the last column of a ring is the torch
// version's trash slot, never written here. The solo engine is the
// one-ring case, the sharded engine passes its shards as the rings.
//
// A spill block is row-major uint32 [k, W], the JAX layout (the JAX ring
// is uint32, tpu_bfs.py:219): rows[off_l + i, w] is ring l's row i of its
// k_l, off_l the exclusive sum of k. spans is int64 [3, lanes]: off_l,
// k_l and pos_l, the ring position of row 0 (drain: head + count - k_l,
// the newest k_l rows; refill: the tail, head + count).
//
//   DRAIN:  rows[off_l + i, w] = (uint32) ring[l, w, (pos_l + i) & qmask]
//   REFILL: ring[l, w, (pos_l + i) & qmask] = rows[off_l + i, w]
//
// Bound on the card: bytes. Each row is read once and written once (8
// bytes a lane on the ring side, 4 on the block side). Design: a block
// moves a tile of `tile` rows of one ring (grid y) through shared memory,
// so both sides are coalesced: the ring side along i for each lane w, the
// block side along the tile's tile * W contiguous words. The tile's
// shared rows are padded by one word against bank conflicts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Span {
  long long off, k, pos;
};

__device__ __forceinline__ Span span_of(const long long* spans, long long lanes,
                                        long long l) {
  return Span{spans[l], spans[lanes + l], spans[2 * lanes + l]};
}

__global__ void drain_kernel(const long long* __restrict__ ring, int width,
                             long long stride, long long lane_stride,
                             long long qmask,
                             const long long* __restrict__ spans,
                             long long lanes, int tile,
                             uint32_t* __restrict__ rows) {
  extern __shared__ uint32_t sh[];
  const long long l = blockIdx.y;
  const Span s = span_of(spans, lanes, l);
  const long long r0 = (long long)blockIdx.x * tile;
  if (r0 >= s.k) return;
  const int n = (int)(s.k - r0 < tile ? s.k - r0 : tile);
  const long long* src = ring + l * lane_stride;
  const long long p0 = s.pos + r0;
  for (int j = threadIdx.x; j < width * n; j += blockDim.x) {
    int w = j / n, i = j - w * n;
    sh[w * (tile + 1) + i] = (uint32_t)src[w * stride + ((p0 + i) & qmask)];
  }
  __syncthreads();
  uint32_t* dst = rows + (s.off + r0) * width;
  for (int j = threadIdx.x; j < width * n; j += blockDim.x) {
    int i = j / width, w = j - i * width;
    dst[j] = sh[w * (tile + 1) + i];
  }
}

__global__ void refill_kernel(long long* __restrict__ ring, int width,
                              long long stride, long long lane_stride,
                              long long qmask,
                              const long long* __restrict__ spans,
                              long long lanes, int tile,
                              const uint32_t* __restrict__ rows) {
  extern __shared__ uint32_t sh[];
  const long long l = blockIdx.y;
  const Span s = span_of(spans, lanes, l);
  const long long r0 = (long long)blockIdx.x * tile;
  if (r0 >= s.k) return;
  const int n = (int)(s.k - r0 < tile ? s.k - r0 : tile);
  const uint32_t* src = rows + (s.off + r0) * width;
  for (int j = threadIdx.x; j < width * n; j += blockDim.x) {
    int i = j / width, w = j - i * width;
    sh[w * (tile + 1) + i] = src[j];
  }
  __syncthreads();
  long long* dst = ring + l * lane_stride;
  const long long p0 = s.pos + r0;
  for (int j = threadIdx.x; j < width * n; j += blockDim.x) {
    int w = j / n, i = j - w * n;
    dst[w * stride + ((p0 + i) & qmask)] = (long long)sh[w * (tile + 1) + i];
  }
}

int launch(bool drain, void* ring, long long lanes, long long width,
           long long stride, long long lane_stride, long long qmask,
           const void* spans, long long max_k, long long tile, void* rows,
           void* stream) {
  if (lanes > 0 && width > 0 && max_k > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = 256;
    dim3 grid((unsigned)((max_k + tile - 1) / tile), (unsigned)lanes);
    size_t shared = (size_t)width * (size_t)(tile + 1) * sizeof(uint32_t);
    if (drain) {
      drain_kernel<<<grid, threads, shared, st>>>(
          (const long long*)ring, (int)width, stride, lane_stride, qmask,
          (const long long*)spans, lanes, (int)tile, (uint32_t*)rows);
    } else {
      refill_kernel<<<grid, threads, shared, st>>>(
          (long long*)ring, (int)width, stride, lane_stride, qmask,
          (const long long*)spans, lanes, (int)tile, (const uint32_t*)rows);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// lanes (grid y) <= 65535; max_k: the largest k_l; tile: rows a block,
// with width * (tile + 1) * 4 bytes of shared memory (<= 48 KiB).
extern "C" int srt_ring_drain(const void* ring, long long lanes,
                              long long width, long long stride,
                              long long lane_stride, long long qmask,
                              const void* spans, long long max_k,
                              long long tile, void* rows, void* stream) {
  return launch(true, (void*)ring, lanes, width, stride, lane_stride, qmask,
                spans, max_k, tile, rows, stream);
}

extern "C" int srt_ring_refill(void* ring, long long lanes, long long width,
                               long long stride, long long lane_stride,
                               long long qmask, const void* spans,
                               long long max_k, long long tile,
                               const void* rows, void* stream) {
  return launch(false, ring, lanes, width, stride, lane_stride, qmask, spans,
                max_k, tile, (void*)rows, stream);
}
