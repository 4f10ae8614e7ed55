// K11 for Single Decree Paxos: the evaluate-and-expand of a popped chunk
// (EXPAND) and the simulation's model step (WALK), as hand-written
// kernels.
//
// EXPAND replaces stateright_tpu/ops/expand.py:54 build_expand_lean as
// XLA compiles it for PaxosTensor and PaxosTensorExhaustive
// (stateright_tpu/models/paxos.py:114 _deliver, :362 linearizable_lanes,
// :370 tensor_properties, through stateright_tpu/lanes.py:321
// ActorNetModel.step_lanes and :162 net_step): ebits, flat [S, A*W]
// (action-major), valid [A*W], generated and the property hits [P, W], as
// ExpandedLean lays them out. WALK replaces the model step of
// stateright_tpu/engines/tpu_simulation.py:268-300: checks [P, B], valid
// [A, B] and succ [A, S, B]. The semantics live in models/expand_row.cuh,
// models/actor_net.cuh and models/paxos.cuh, which the CPU tests compile
// with g++ and hold against the JAX package bit for bit; the design and
// the bound are in models/expand_launch.cuh. One instantiation for each
// client count c <= 7 (S = 6 + 8c lanes, A = K = 7c actions, P = 4): at
// c = 3 a thread keeps a 30-lane row and a 30-lane successor in
// registers, and writes 30 x 21 successor words.

#include "models/expand_launch.cuh"
#include "models/paxos.cuh"

namespace {

template <template <class> class F, class... Args>
int by_clients(int c, Args... args) {
  switch (c) {
    case 1: return F<srt::Paxos<1>>::run(args...);
    case 2: return F<srt::Paxos<2>>::run(args...);
    case 3: return F<srt::Paxos<3>>::run(args...);
    case 4: return F<srt::Paxos<4>>::run(args...);
    case 5: return F<srt::Paxos<5>>::run(args...);
    case 6: return F<srt::Paxos<6>>::run(args...);
    case 7: return F<srt::Paxos<7>>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int srt_expand_paxos(int c, const void* rows, const void* ebits, const void* depth,
                                const void* active, const void* dl, long long dl_value,
                                long long dl_stride, long long W, void* ebits_out, void* flat,
                                void* valid, void* hits, void* partials, void* ticket,
                                void* generated, void* stream) {
  return by_clients<srt::ExpandEntry>(c, rows, ebits, depth, active, dl, dl_value, dl_stride, W,
                                      ebits_out, flat, valid, hits, partials, ticket, generated,
                                      (cudaStream_t)stream);
}

extern "C" int srt_walk_paxos(int c, const void* rows, long long B, void* checks, void* valid,
                              void* succ, void* stream) {
  return by_clients<srt::WalkEntry>(c, rows, B, checks, valid, succ, (cudaStream_t)stream);
}
