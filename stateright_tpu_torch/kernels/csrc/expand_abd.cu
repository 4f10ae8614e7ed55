// K11 for ABD over the unordered and the ordered network: the
// evaluate-and-expand of a popped chunk (EXPAND) and the simulation's
// model step (WALK), as hand-written kernels.
//
// EXPAND replaces stateright_tpu/ops/expand.py:54 build_expand_lean as
// XLA compiles it for AbdTensor and AbdOrderedTensor
// (stateright_tpu/models/abd.py:101 deliver, :280 tensor_properties,
// through stateright_tpu/lanes.py:321 ActorNetModel.step_lanes and :162
// net_step or :81 net_step_ordered): ebits, flat [S, A*W]
// (action-major), valid [A*W], generated and the property hits [P, W], as
// ExpandedLean lays them out. WALK replaces the model step of
// stateright_tpu/engines/tpu_simulation.py:268-300: checks [P, B], valid
// [A, B] and succ [A, S, B]. The semantics live in models/expand_row.cuh,
// models/actor_net.cuh and models/abd.cuh, which the CPU tests compile
// with g++ and hold against the JAX package bit for bit; the design and
// the bound are in models/expand_launch.cuh. One instantiation for each
// client count c in [1, 5] and each network (ordered 0 or 1): S = 6 + 2c
// lanes, A = K = c + 2 actions, P = 3; at c = 3 a thread keeps a 12-lane
// row and a 12-lane successor in registers and writes 12 x 5 successor
// words.

#include "models/abd.cuh"
#include "models/expand_launch.cuh"

namespace {

template <template <class> class F, class... Args>
int by_model(int c, int ordered, Args... args) {
  if (ordered != 0 && ordered != 1) return (int)cudaErrorInvalidValue;
  switch (c * 2 + ordered) {
#define SRT_ABD(C)                                           \
  case 2 * C: return F<srt::Abd<C, false>>::run(args...);    \
  case 2 * C + 1: return F<srt::Abd<C, true>>::run(args...);
    SRT_ABD(1) SRT_ABD(2) SRT_ABD(3) SRT_ABD(4) SRT_ABD(5)
#undef SRT_ABD
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int srt_expand_abd(int c, int ordered, const void* rows, const void* ebits,
                              const void* depth, const void* active, const void* dl,
                              long long dl_value, long long dl_stride, long long W,
                              void* ebits_out, void* flat, void* valid, void* hits, void* partials,
                              void* ticket, void* generated, void* stream) {
  return by_model<srt::ExpandEntry>(c, ordered, rows, ebits, depth, active, dl, dl_value,
                                    dl_stride, W, ebits_out, flat, valid, hits, partials, ticket,
                                    generated, (cudaStream_t)stream);
}

extern "C" int srt_walk_abd(int c, int ordered, const void* rows, long long B, void* checks,
                            void* valid, void* succ, void* stream) {
  return by_model<srt::WalkEntry>(c, ordered, rows, B, checks, valid, succ, (cudaStream_t)stream);
}
