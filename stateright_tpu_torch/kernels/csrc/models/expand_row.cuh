// K11's semantics for one popped row, shared by the CUDA kernels
// (expand_2pc.cu, expand_paxos.cu) and the host harness (harness.cpp)
// that the CPU tests build with g++ and hold against the JAX package.
//
// Replaces, a row at a time, stateright_tpu/ops/expand.py:54
// build_expand_lean (EXPAND) and the model step of the simulation's walk,
// stateright_tpu/engines/tpu_simulation.py:268-300 (WALK):
//   EXPAND, row c of W: live = active[c] && depth[c] < depth_limit; each
//     property in order: an EVENTUALLY one clears its ebit (in e_idx
//     order) where it holds on a live row, an ALWAYS one hits where it
//     fails on a live row, a SOMETIMES one where it holds; then action a
//     writes its successor to flat[s, a*W + c] and valid[a*W + c] = mask
//     && live && in boundary; a live row with no valid action is
//     terminal, and an EVENTUALLY property hits there while its ebit is
//     still set. Returns the row's number of valid candidates.
//   WALK, walk b of B: the raw predicates checks[p, b], valid[a, b] =
//     mask && in boundary, and the successor lanes succ[a, s, b].
// Lanes come in and go out as int64 words holding uint32 values (the
// port's lane type); every model computes in uint32_t, so `~`, `-` and
// `>>` wrap as JAX's uint32 arithmetic does, and a successor goes out
// zero-extended.
//
// A model M gives: `S`, `P` (compile-time), `actions()`, `expect(p)`,
// `checks(row, out[P])`, `in_boundary(succ)` and `step(row, sink)`, which
// calls `sink.put(a, succ[S], mask)` once per action in action order.
// Under nvcc every function here is __host__ __device__ (SRT_HD); under
// g++ it is a plain inline function.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define SRT_HD __host__ __device__ __forceinline__
#define SRT_UNROLL _Pragma("unroll")
#define SRT_NO_UNROLL _Pragma("unroll 1")
#else
#define SRT_HD inline
#define SRT_UNROLL
#define SRT_NO_UNROLL
#endif

namespace srt {

enum Expect : int { ALWAYS = 0, SOMETIMES = 1, EVENTUALLY = 2 };

// EXPAND's successor writer: action a of row c into the action-major
// candidate batch.
template <class M>
struct ExpandSink {
  long long* flat;
  bool* valid;
  long long W, AW, c;
  const M* m;
  bool live;
  int count;

  SRT_HD void put(int a, const uint32_t* succ, bool mask) {
    const long long at = (long long)a * W + c;
    SRT_UNROLL
    for (int s = 0; s < M::S; ++s) flat[s * AW + at] = (long long)succ[s];
    const bool v = mask && live && m->in_boundary(succ);
    valid[at] = v;
    count += v;
  }
};

// WALK's successor writer: succ[a, s, b] and valid[a, b].
template <class M>
struct WalkSink {
  long long* succ;
  bool* valid;
  long long B, b;
  const M* m;

  SRT_HD void put(int a, const uint32_t* row, bool mask) {
    SRT_UNROLL
    for (int s = 0; s < M::S; ++s) succ[((long long)a * M::S + s) * B + b] = (long long)row[s];
    valid[(long long)a * B + b] = mask && m->in_boundary(row);
  }
};

// One popped row c of the EXPAND contract (see the head of this file).
// depth_limit: dl[c * dl_stride] when dl is given (a 0-d view: stride 0;
// a per-row limit: stride 1), else dl_value.
template <class M>
SRT_HD int expand_one(const M& m, long long c, long long W, const long long* rows,
                      const long long* ebits, const long long* depth, const bool* active,
                      const long long* dl, long long dl_value, long long dl_stride,
                      long long* ebits_out, long long* flat, bool* valid, bool* hits) {
  uint32_t row[M::S];
  SRT_UNROLL
  for (int s = 0; s < M::S; ++s) row[s] = (uint32_t)rows[s * W + c];
  const long long limit = dl ? dl[c * dl_stride] : dl_value;
  const bool live = active[c] && depth[c] < limit;

  bool check[M::P];
  m.checks(row, check);
  uint32_t e = (uint32_t)ebits[c];
  bool hit[M::P];
  int e_idx = 0;
  SRT_UNROLL
  for (int p = 0; p < M::P; ++p) {
    const Expect x = M::expect(p);
    hit[p] = false;
    if (x == EVENTUALLY) {
      if (check[p] && live) e &= ~(1u << e_idx);
      ++e_idx;
    } else if (x == ALWAYS) {
      hit[p] = live && !check[p];
    } else {
      hit[p] = live && check[p];
    }
  }

  ExpandSink<M> sink{flat, valid, W, (long long)m.actions() * W, c, &m, live, 0};
  m.step(row, sink);

  const bool terminal = live && sink.count == 0;
  e_idx = 0;
  SRT_UNROLL
  for (int p = 0; p < M::P; ++p) {
    if (M::expect(p) == EVENTUALLY) {
      hit[p] = terminal && ((e >> e_idx) & 1u);
      ++e_idx;
    }
    hits[p * W + c] = hit[p];
  }
  ebits_out[c] = (long long)e;
  return sink.count;
}

// One walk b of the WALK contract.
template <class M>
SRT_HD void walk_one(const M& m, long long b, long long B, const long long* rows, bool* checks,
                     bool* valid, long long* succ) {
  uint32_t row[M::S];
  SRT_UNROLL
  for (int s = 0; s < M::S; ++s) row[s] = (uint32_t)rows[s * B + b];
  bool check[M::P];
  m.checks(row, check);
  SRT_UNROLL
  for (int p = 0; p < M::P; ++p) checks[p * B + b] = check[p];
  WalkSink<M> sink{succ, valid, B, b, &m};
  m.step(row, sink);
}

}  // namespace srt
