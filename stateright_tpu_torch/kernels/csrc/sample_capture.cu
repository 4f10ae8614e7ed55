// K9a: bottom-k sample capture, one launch after the visited-set insert.
//
// Replaces the capture of stateright_tpu/engines/tpu_bfs.py:506-549
// (`below` and `_capture`, under the `lax.cond` at :547). It fuses:
//   1. the threshold test: candidate i is captured iff it was newly
//      inserted (is_new[i]) and its fingerprint is below the threshold
//      thresh[0..1] = (t1, t2), read on the card (the era's state vector
//      holds it, as the JAX loop reads it from its params), compared
//      lexicographically and UNSIGNED on the uint32 halves held in int64;
//   2. an order-preserving compaction of those candidates to
//      step_cap (= DEVICE_STEP_CAP, 512) slots, in candidate order, as
//      `vs._compact_ids(below, DEVICE_STEP_CAP)` orders them;
//   3. the append of (h1, h2, depth, action) at slab row occupied + rank,
//      for ranks below step_cap; a row at or past scap goes to the trash
//      row scap (the slab lanes are scap + 1 long);
//   4. the counter update on the card: occupied += fit and
//      dropped += n_c - fit, with fit = min(n_c, step_cap).
// When nothing is below the threshold it writes no slab row (the JAX
// `lax.cond` skips the capture then).
//
// counts[0] = occupied, counts[1] = dropped (int64, on the card), so the
// host loop reads the occupancy in the counts vector it already reads
// once per step.
//
// Bound on the card: bytes. is_new is read once (1 byte a candidate),
// h1 and h2 for each new candidate, and each captured row reads depth and
// action and writes 4 x 8 bytes. Design: the multi-block scan and append
// of capture_scan.cuh, shared with K13c.

#include "capture_scan.cuh"

// The slab lanes hold scap + 1 int64 rows; counts is int64[2]; thresh is
// int64[2] on the card; scratch holds at least ceil(n / 1024) + 1 int64.
extern "C" int srt_sample_capture(const void* is_new, const void* h1,
                                  const void* h2, const void* depth,
                                  const void* act, long long n,
                                  const void* thresh,
                                  void* sfp1, void* sfp2, void* sdep,
                                  void* sact, long long scap, void* counts,
                                  long long step_cap, void* scratch,
                                  long long scratch_len, void* stream) {
  capture::Lanes lanes{};
  const void* src[4] = {h1, h2, depth, act};
  void* dst[4] = {sfp1, sfp2, sdep, sact};
  for (int l = 0; l < 4; ++l) {
    lanes.src[l] = (const long long*)src[l];
    lanes.dst[l] = (long long*)dst[l];
  }
  lanes.n = 4;
  long long* c = (long long*)counts;
  return capture::launch((const bool*)is_new, (const long long*)h1,
                         (const long long*)h2, n, 0u, 0u,
                         (const long long*)thresh, lanes, scap, c, c + 1, step_cap, (long long*)scratch,
                         scratch_len, (cudaStream_t)stream);
}
