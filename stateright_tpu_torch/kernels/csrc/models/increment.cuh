// The increment race's lane program for K11, a row at a time: the port's
// copy of stateright_tpu/models/increment.py:70 IncrementTensor (:86
// step_lanes, :111 tensor_properties).
//
// Row (S = 1 + 2N lanes, N threads): lane 0 the shared counter, lanes
// 1 + 2k and 2 + 2k thread k's local value t and program counter pc.
// Action 2k is Read(k): t <- shared, pc <- 2, enabled where pc == 1;
// action 2k + 1 is Write(k): shared <- (t + 1) & 0xFF, pc <- 3, enabled
// where pc == 2. Property: "fin" (always): #{k : pc_k == 3} & 0xFF ==
// shared.

#pragma once

#include "expand_row.cuh"

namespace srt {

template <int N>
struct Increment {
  static constexpr int S = 1 + 2 * N;
  static constexpr int P = 1;

  SRT_HD int actions() const { return 2 * N; }
  static SRT_HD Expect expect(int) { return ALWAYS; }
  SRT_HD bool in_boundary(const uint32_t*) const { return true; }

  SRT_HD void checks(const uint32_t* row, bool* out) const {
    uint32_t count = 0;
    SRT_UNROLL
    for (int k = 0; k < N; ++k) count += row[2 + 2 * k] == 3u ? 1u : 0u;
    out[0] = (count & 0xFFu) == row[0];
  }

  template <class Sink>
  SRT_HD void step(const uint32_t* row, Sink& sink) const {
    uint32_t s[S];
    SRT_UNROLL
    for (int t = 0; t < S; ++t) s[t] = row[t];
    SRT_UNROLL
    for (int k = 0; k < N; ++k) {
      const uint32_t t = row[1 + 2 * k], pc = row[2 + 2 * k];
      s[1 + 2 * k] = row[0];
      s[2 + 2 * k] = 2u;
      sink.put(2 * k, s, pc == 1u);
      s[1 + 2 * k] = t;
      s[0] = (t + 1u) & 0xFFu;
      s[2 + 2 * k] = 3u;
      sink.put(2 * k + 1, s, pc == 2u);
      s[0] = row[0];
      s[2 + 2 * k] = pc;
    }
  }
};

}  // namespace srt
