// The lock-protected increment's lane program for K11, a row at a time:
// the port's copy of stateright_tpu/models/increment_lock.py:85
// IncrementLockTensor (:98 step_lanes, :136 tensor_properties).
//
// Row (S = 2 + 2N lanes, N threads): lane 0 the shared counter, lane 1
// the lock bit, lanes 2 + 2k and 3 + 2k thread k's local value t and
// program counter pc. Actions 4k..4k + 3 are thread k's
//   Lock:    lock <- 1, pc <- 1, enabled where pc == 0 && lock == 0;
//   Read:    t <- shared, pc <- 2, enabled where pc == 1;
//   Write:   shared <- (t + 1) & 0xFF, pc <- 3, enabled where pc == 2;
//   Release: lock <- 0, pc <- 4, enabled where pc == 3 && lock == 1.
// Properties (both always): "fin", #{k : pc_k >= 3} & 0xFF == shared;
// "mutex", #{k : 1 <= pc_k < 4} <= 1.

#pragma once

#include "expand_row.cuh"

namespace srt {

template <int N>
struct IncrementLock {
  static constexpr int S = 2 + 2 * N;
  static constexpr int P = 2;

  SRT_HD int actions() const { return 4 * N; }
  static SRT_HD Expect expect(int) { return ALWAYS; }
  SRT_HD bool in_boundary(const uint32_t*) const { return true; }

  SRT_HD void checks(const uint32_t* row, bool* out) const {
    uint32_t fin = 0, inside = 0;
    SRT_UNROLL
    for (int k = 0; k < N; ++k) {
      const uint32_t pc = row[3 + 2 * k];
      fin += pc >= 3u ? 1u : 0u;
      inside += (pc >= 1u && pc < 4u) ? 1u : 0u;
    }
    out[0] = (fin & 0xFFu) == row[0];
    out[1] = inside <= 1u;
  }

  template <class Sink>
  SRT_HD void step(const uint32_t* row, Sink& sink) const {
    uint32_t s[S];
    SRT_UNROLL
    for (int t = 0; t < S; ++t) s[t] = row[t];
    const uint32_t lock = row[1];
    SRT_UNROLL
    for (int k = 0; k < N; ++k) {
      const uint32_t t = row[2 + 2 * k], pc = row[3 + 2 * k];
      s[1] = 1u;
      s[3 + 2 * k] = 1u;
      sink.put(4 * k, s, pc == 0u && lock == 0u);
      s[1] = lock;
      s[2 + 2 * k] = row[0];
      s[3 + 2 * k] = 2u;
      sink.put(4 * k + 1, s, pc == 1u);
      s[2 + 2 * k] = t;
      s[0] = (t + 1u) & 0xFFu;
      s[3 + 2 * k] = 3u;
      sink.put(4 * k + 2, s, pc == 2u);
      s[0] = row[0];
      s[1] = 0u;
      s[3 + 2 * k] = 4u;
      sink.put(4 * k + 3, s, pc == 3u && lock == 1u);
      s[1] = lock;
      s[3 + 2 * k] = pc;
    }
  }
};

}  // namespace srt
