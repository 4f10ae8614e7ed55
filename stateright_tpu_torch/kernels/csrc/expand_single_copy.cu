// K11 for the single-copy register: the evaluate-and-expand of a popped
// chunk (EXPAND) and the simulation's model step (WALK), as hand-written
// kernels.
//
// EXPAND replaces stateright_tpu/ops/expand.py:54 build_expand_lean as
// XLA compiles it for SingleCopyTensor (stateright_tpu/models/
// single_copy.py:76 deliver, :138 tensor_properties, through
// stateright_tpu/lanes.py:321 ActorNetModel.step_lanes and :162
// net_step): ebits, flat [S, A*W] (action-major), valid [A*W], generated
// and the property hits [P, W], as ExpandedLean lays them out. WALK
// replaces the model step of stateright_tpu/engines/tpu_simulation.py:
// 268-300: checks [P, B], valid [A, B] and succ [A, S, B]. The semantics
// live in models/expand_row.cuh, models/actor_net.cuh and
// models/single_copy.cuh, which the CPU tests compile with g++ and hold
// against the JAX package bit for bit; the design and the bound are in
// models/expand_launch.cuh. One instantiation for each server count s in
// [1, 4] and client count c in [1, 5]: S = s + 2c + 1 lanes, A = K = c +
// 1 actions, P = 3; at (4, 5) a thread keeps a 15-lane row and a 15-lane
// successor in registers and writes 15 x 6 successor words.

#include "models/expand_launch.cuh"
#include "models/single_copy.cuh"

namespace {

template <template <class> class F, class... Args>
int by_model(int s, int c, Args... args) {
  if (c < 1 || c > 5) return (int)cudaErrorInvalidValue;
  switch (s * 8 + c) {
#define SRT_SC(SV, C) \
  case SV * 8 + C: return F<srt::SingleCopy<SV, C>>::run(args...);
#define SRT_SC_S(SV) SRT_SC(SV, 1) SRT_SC(SV, 2) SRT_SC(SV, 3) SRT_SC(SV, 4) SRT_SC(SV, 5)
    SRT_SC_S(1) SRT_SC_S(2) SRT_SC_S(3) SRT_SC_S(4)
#undef SRT_SC_S
#undef SRT_SC
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int srt_expand_single_copy(int s, int c, const void* rows, const void* ebits,
                                      const void* depth, const void* active, const void* dl,
                                      long long dl_value, long long dl_stride, long long W,
                                      void* ebits_out, void* flat, void* valid, void* hits,
                                      void* partials, void* ticket, void* generated,
                                      void* stream) {
  return by_model<srt::ExpandEntry>(s, c, rows, ebits, depth, active, dl, dl_value, dl_stride, W,
                                    ebits_out, flat, valid, hits, partials, ticket, generated,
                                    (cudaStream_t)stream);
}

extern "C" int srt_walk_single_copy(int s, int c, const void* rows, long long B, void* checks,
                                    void* valid, void* succ, void* stream) {
  return by_model<srt::WalkEntry>(s, c, rows, B, checks, valid, succ, (cudaStream_t)stream);
}
