// K1: 64-bit state fingerprints of S uint32 lanes, as two 32-bit halves.
//
// Replaces stateright_tpu/fingerprint.py:262 hash_lanes_jnp (the mix is
// `_absorb`, fingerprint.py:180-194; parameters at :176-177). h1 absorbs
// the lanes in order, h2 absorbs them reversed with other multipliers and
// another rotation; a (0, 0) pair becomes (0, 1) so no fingerprint is the
// table's empty key.
//
// Input: lanes[S, n] int64 holding uint32 values (the port's lane type),
// row-major, so thread i reads lane s at s*n + i and each lane read is
// coalesced. Output: h1[n], h2[n] int64 holding uint32 values.
//
// Bound on the card: bytes. Each element is read once (8*S bytes) and two
// words are written (16 bytes); the mix is ~5 integer ops per word, far
// below the integer rate, so the kernel is one streaming pass and its
// design is only that: one thread per element, no shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPrime2 = 2246822519u;
constexpr uint32_t kPrime3 = 3266489917u;
constexpr uint32_t kPrime4 = 668265263u;
constexpr uint32_t kPrime5 = 374761393u;
constexpr uint32_t kSeed1 = 0x9E3779B1u;
constexpr uint32_t kSeed2 = 0x85EBCA77u;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t avalanche(uint32_t acc, uint32_t fin1,
                                              uint32_t fin2) {
  acc ^= acc >> 15;
  acc *= fin1;
  acc ^= acc >> 13;
  acc *= fin2;
  acc ^= acc >> 16;
  return acc;
}

__global__ void hash_lanes_kernel(const long long* __restrict__ lanes,
                                  long long n, int S,
                                  long long* __restrict__ h1,
                                  long long* __restrict__ h2) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t a = kSeed1 + kPrime5 + (uint32_t)(S * 4);
  uint32_t b = kSeed2 + kPrime5 + (uint32_t)(S * 4);
  for (int s = 0; s < S; ++s) {
    uint32_t w = (uint32_t)lanes[(long long)s * n + i];
    a += w * kPrime3;
    a = rotl32(a, 17);
    a *= kPrime4;
  }
  for (int s = S - 1; s >= 0; --s) {
    uint32_t w = (uint32_t)lanes[(long long)s * n + i];
    b += w * kPrime2;
    b = rotl32(b, 13);
    b *= kPrime5;
  }
  a = avalanche(a, kPrime2, kPrime3);
  b = avalanche(b, kPrime4, kPrime5);
  if (a == 0u && b == 0u) b = 1u;
  h1[i] = (long long)a;
  h2[i] = (long long)b;
}

}  // namespace

extern "C" int srt_hash_lanes(const void* lanes, long long n, int S,
                              void* h1, void* h2, void* stream) {
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    hash_lanes_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const long long*)lanes, n, S, (long long*)h1, (long long*)h2);
  }
  return (int)cudaGetLastError();
}
