// K9a: bottom-k sample capture, one launch after the visited-set insert;
// with a lane axis, every shard's capture of the sharded step in the
// same launch (stateright_tpu/parallel/mesh.py:398-431, per shard).
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
// action and writes 4 x 8 bytes. Design: capture_scan.cuh's one launch
// over (tile, lane).

#include "capture_scan.cuh"

// lanes: slabs served (1: the solo step). is_new, h1, h2, depth: lane l's
// n candidates at + l * in_stride; act at + l * act_stride (0: one action
// lane for every slab). thresh: int64 [2] a lane at + l * thresh_stride
// (0: one threshold) on the card. sfp1..sact: lane 0's slab lanes (scap +
// 1 int64 rows), lane l's at + l * slab_stride. counts: int64 [lanes, 2].
// scratch: lanes * (2 + ceil(n / 1024) * 65) zeroed int32, 8-byte
// aligned (ops/slab.py capture_scratch), left as found.
extern "C" int srt_sample_capture(long long lanes, const void* is_new,
                                  const void* h1, const void* h2, const void* depth,
                                  const void* act, long long n, long long in_stride,
                                  long long act_stride, const void* thresh,
                                  long long thresh_stride, void* sfp1, void* sfp2, void* sdep,
                                  void* sact, long long slab_stride, long long scap,
                                  void* counts, long long step_cap, void* scratch,
                                  long long scratch_len, void* stream) {
  const void* src[4] = {h1, h2, depth, act};
  void* dst[4] = {sfp1, sfp2, sdep, sact};
  capture::One in{};
  in.sel = (const bool*)is_new;
  in.h1 = (const long long*)h1;
  in.h2 = (const long long*)h2;
  in.n = n;
  in.in_stride = in_stride;
  in.thresh = (const long long*)thresh;
  in.thresh_stride = thresh_stride;
  for (int k = 0; k < 4; ++k) {
    in.src[k] = (const long long*)src[k];
    in.src_stride[k] = k == 3 ? act_stride : in_stride;
    in.dst[k] = (long long*)dst[k];
  }
  in.dst_stride = slab_stride;
  in.scap = scap;
  in.step_cap = step_cap;
  in.counts = (long long*)counts;
  return capture::launch_one(in, lanes, (int*)scratch, scratch_len, (cudaStream_t)stream);
}
