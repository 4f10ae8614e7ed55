// K11 for the lock-protected increment: the evaluate-and-expand of a
// popped chunk (EXPAND) and the simulation's model step (WALK), as
// hand-written kernels.
//
// EXPAND replaces stateright_tpu/ops/expand.py:54 build_expand_lean as
// XLA compiles it for IncrementLockTensor (stateright_tpu/models/
// increment_lock.py:96 step_lanes, :136 tensor_properties): ebits, flat
// [S, A*W] (action-major), valid [A*W], generated and the property hits
// [P, W], as ExpandedLean lays them out. WALK replaces the model step of
// stateright_tpu/engines/tpu_simulation.py:268-300: checks [P, B], valid
// [A, B] and succ [A, S, B]. The semantics live in models/expand_row.cuh
// and models/increment_lock.cuh, which the CPU tests compile with g++
// and hold against the JAX package bit for bit; the design and the bound
// are in models/expand_launch.cuh. One instantiation for each thread
// count n in [1, 8] (S = 2 + 2n lanes, A = 4n actions, P = 2).

#include "models/expand_launch.cuh"
#include "models/increment_lock.cuh"

namespace {

template <template <class> class F, class... Args>
int by_threads(int n, Args... args) {
  switch (n) {
#define SRT_LOCK(N) \
  case N: return F<srt::IncrementLock<N>>::run(args...);
    SRT_LOCK(1) SRT_LOCK(2) SRT_LOCK(3) SRT_LOCK(4) SRT_LOCK(5) SRT_LOCK(6) SRT_LOCK(7) SRT_LOCK(8)
#undef SRT_LOCK
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int srt_expand_increment_lock(int n, const void* rows, const void* ebits,
                                         const void* depth, const void* active, const void* dl,
                                         long long dl_value, long long dl_stride, long long W,
                                         void* ebits_out, void* flat, void* valid, void* hits,
                                         void* partials, void* ticket, void* generated,
                                         void* stream) {
  return by_threads<srt::ExpandEntry>(n, rows, ebits, depth, active, dl, dl_value, dl_stride, W,
                                      ebits_out, flat, valid, hits, partials, ticket, generated,
                                      (cudaStream_t)stream);
}

extern "C" int srt_walk_increment_lock(int n, const void* rows, long long B, void* checks,
                                       void* valid, void* succ, void* stream) {
  return by_threads<srt::WalkEntry>(n, rows, B, checks, valid, succ, (cudaStream_t)stream);
}
