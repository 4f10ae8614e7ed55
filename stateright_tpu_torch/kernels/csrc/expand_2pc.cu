// K11 for two-phase commit: the evaluate-and-expand of a popped chunk
// (EXPAND) and the simulation's model step (WALK), as hand-written
// kernels.
//
// EXPAND replaces stateright_tpu/ops/expand.py:54 build_expand_lean as
// XLA compiles it for TwoPhaseTensor (stateright_tpu/models/
// two_phase_commit.py:184 step_lanes, :319 tensor_properties): ebits,
// flat [S, A*W] (action-major), valid [A*W], generated and the property
// hits [P, W], as ExpandedLean lays them out. WALK replaces the model
// step of stateright_tpu/engines/tpu_simulation.py:268-300: checks
// [P, B], valid [A, B] and succ [A, S, B]. The semantics live in
// models/expand_row.cuh and models/two_phase.cuh, which the CPU tests
// compile with g++ and hold against the JAX package bit for bit; the
// design and the bound are in models/expand_launch.cuh. n <= 16 RMs,
// S = 3, A = 2 + 5n, P = 3: a thread's work is a few hundred operations
// and 3 x A successor words.

#include "models/expand_launch.cuh"
#include "models/two_phase.cuh"

extern "C" int srt_expand_2pc(int n, const void* rows, const void* ebits, const void* depth,
                              const void* active, const void* dl, long long dl_value,
                              long long dl_stride, long long W, void* ebits_out, void* flat,
                              void* valid, void* hits, void* partials, void* ticket,
                              void* generated, void* stream) {
  if (n < 1 || n > 16) return (int)cudaErrorInvalidValue;
  return srt::launch_expand(srt::TwoPhase{n}, rows, ebits, depth, active, dl, dl_value, dl_stride,
                            W, ebits_out, flat, valid, hits, partials, ticket, generated,
                            (cudaStream_t)stream);
}

extern "C" int srt_walk_2pc(int n, const void* rows, long long B, void* checks, void* valid,
                            void* succ, void* stream) {
  if (n < 1 || n > 16) return (int)cudaErrorInvalidValue;
  return srt::launch_walk(srt::TwoPhase{n}, rows, B, checks, valid, succ, (cudaStream_t)stream);
}
