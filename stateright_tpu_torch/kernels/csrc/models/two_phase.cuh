// Two-phase commit's lane program for K11: the port's copy of
// stateright_tpu/models/two_phase_commit.py:184 TwoPhaseTensor.step_lanes
// and :319 tensor_properties, a row at a time.
//
// Row (3 uint32 lanes, n <= 16 RMs): lane 0 = tm_state | prepared mask
// << 2; lane 1 = rm i's state in bits [2i, 2i+1] (0 working, 1 prepared,
// 2 committed, 3 aborted); lane 2 = Prepared{i} in bit i, Commit in bit
// 30, Abort in bit 31. Actions (2 + 5n): TmCommit, TmAbort, then for each
// rm: TmRcvPrepared, RmPrepare, RmChooseToAbort, RmRcvCommitMsg,
// RmRcvAbortMsg. Properties: "abort agreement" (sometimes), "commit
// agreement" (sometimes), "consistent" (always).
//
// K11c, the symmetry canon (`two_phase_canon<N>(row, out)`,
// two_phase_commit.py:270 representative_lanes): RM i becomes the descriptor rm(2b) << 6 | i << 2
// | prep << 1 | msg; n passes of odd-even transposition sort them (the
// index sits below the key, so ties keep their order: this exact network,
// not another sort, decides the stored rows); RM j of the result takes
// descriptor j. Lane 0 keeps tm_state, lane 1 the bits above 2n, lane 2
// the bits above n (Commit, Abort).

#pragma once

#include "expand_row.cuh"

namespace srt {

// The canon at a compile-time N, so the descriptors stay in registers.
template <int N>
SRT_HD void two_phase_canon(const uint32_t* row, uint32_t* out) {
  uint32_t d[N];
  SRT_UNROLL
  for (int i = 0; i < N; ++i) {
    const uint32_t rm = (row[1] >> (2 * i)) & 3u;
    const uint32_t prep = (row[0] >> (2 + i)) & 1u;
    const uint32_t msg = (row[2] >> i) & 1u;
    d[i] = (rm << 6) | ((uint32_t)i << 2) | (prep << 1) | msg;
  }
  SRT_UNROLL
  for (int p = 0; p < N; ++p) {
    SRT_UNROLL
    for (int m = p & 1; m < N - 1; m += 2) {
      const uint32_t lo = d[m] < d[m + 1] ? d[m] : d[m + 1];
      const uint32_t hi = d[m] < d[m + 1] ? d[m + 1] : d[m];
      d[m] = lo;
      d[m + 1] = hi;
    }
  }
  // JAX's masks are Python ints: at N = 16 the lane-1 mask ~(2^32 - 1) is
  // 0, which a 32-bit shift by 32 cannot give, so build it in 64 bits.
  uint32_t o0 = row[0] & 3u;
  uint32_t o1 = row[1] & (uint32_t)~((1ull << (2 * N)) - 1ull);
  uint32_t o2 = row[2] & (uint32_t)~((1ull << N) - 1ull);
  SRT_UNROLL
  for (int j = 0; j < N; ++j) {
    o0 |= ((d[j] >> 1) & 1u) << (2 + j);
    o1 |= ((d[j] >> 6) & 3u) << (2 * j);
    o2 |= (d[j] & 1u) << j;
  }
  out[0] = o0, out[1] = o1, out[2] = o2;
}

// F<N>::run(args...) for the runtime n in [1, 16]; `bad` otherwise.
template <template <int> class F, class R, class... Args>
R by_rms(int n, R bad, Args... args) {
  switch (n) {
#define SRT_RMS(N) \
  case N: return F<N>::run(args...);
    SRT_RMS(1) SRT_RMS(2) SRT_RMS(3) SRT_RMS(4) SRT_RMS(5) SRT_RMS(6) SRT_RMS(7) SRT_RMS(8)
    SRT_RMS(9) SRT_RMS(10) SRT_RMS(11) SRT_RMS(12) SRT_RMS(13) SRT_RMS(14) SRT_RMS(15) SRT_RMS(16)
#undef SRT_RMS
    default: return bad;
  }
}

struct TwoPhase {
  static constexpr int S = 3;
  static constexpr int P = 3;
  int n;

  SRT_HD int actions() const { return 2 + 5 * n; }
  static SRT_HD Expect expect(int p) { return p == 2 ? ALWAYS : SOMETIMES; }
  SRT_HD bool in_boundary(const uint32_t*) const { return true; }

  SRT_HD void checks(const uint32_t* row, bool* out) const {
    bool all_abort = true, all_commit = true, any_abort = false, any_commit = false;
    for (int rm = 0; rm < n; ++rm) {
      const uint32_t r = (row[1] >> (2 * rm)) & 3u;
      all_abort = all_abort && r == 3u;
      all_commit = all_commit && r == 2u;
      any_abort = any_abort || r == 3u;
      any_commit = any_commit || r == 2u;
    }
    out[0] = all_abort;
    out[1] = all_commit;
    out[2] = !(any_abort && any_commit);
  }

  template <class Sink>
  SRT_HD void step(const uint32_t* row, Sink& sink) const {
    const uint32_t l0 = row[0], l1 = row[1], l2 = row[2];
    const uint32_t full = (1u << n) - 1u;
    const bool tm_init = (l0 & 3u) == 0u;
    const bool all_prepared = ((l0 >> 2) & full) == full;
    const bool has_commit = ((l2 >> 30) & 1u) == 1u;
    const bool has_abort = ((l2 >> 31) & 1u) == 1u;
    uint32_t s[3];

    s[0] = (l0 & ~3u) | 1u, s[1] = l1, s[2] = l2 | (1u << 30);
    sink.put(0, s, tm_init && all_prepared);
    s[0] = (l0 & ~3u) | 2u, s[1] = l1, s[2] = l2 | (1u << 31);
    sink.put(1, s, tm_init);

    for (int rm = 0; rm < n; ++rm) {
      const int a = 2 + 5 * rm;
      const bool working = ((l1 >> (2 * rm)) & 3u) == 0u;
      const bool prepared_msg = ((l2 >> rm) & 1u) == 1u;
      const uint32_t cleared = l1 & ~(3u << (2 * rm));
      s[0] = l0 | (1u << (2 + rm)), s[1] = l1, s[2] = l2;
      sink.put(a, s, tm_init && prepared_msg);
      s[0] = l0, s[1] = cleared | (1u << (2 * rm)), s[2] = l2 | (1u << rm);
      sink.put(a + 1, s, working);
      s[1] = cleared | (3u << (2 * rm)), s[2] = l2;
      sink.put(a + 2, s, working);
      s[1] = cleared | (2u << (2 * rm));
      sink.put(a + 3, s, has_commit);
      s[1] = cleared | (3u << (2 * rm));
      sink.put(a + 4, s, has_abort);
    }
  }
};

}  // namespace srt
