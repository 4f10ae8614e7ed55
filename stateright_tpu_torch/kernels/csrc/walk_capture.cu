// K13c: bottom-k sample capture of the walk step, one launch a step.
//
// Replaces stateright_tpu/engines/tpu_simulation.py:219-252 (`below` and
// `_capture`, under its `lax.cond`). Walk w is captured iff it was
// counted this step and its fingerprint is below the threshold,
// (h1, h2) < (t1, t2) lexicographically, compared UNSIGNED on the uint32
// halves held in int64. thresh[0..1] = (t1, t2) is read on the card: the
// simulation era's state vector holds it (the sample tail's first two
// words, as the JAX loop reads it from its params), so a CUDA graph's
// replay sees each era's threshold. The captured walks are appended in
// walk order at slab rows occupied + rank: (h1, h2, ptr, the S state
// lanes), ptr as K13a left it. The slab holds scap = slab_high_water(k)
// + B rows and the era ends once occupied passes the high-water mark, so
// every capture fits (step_cap is B: nothing is dropped, and no dropped
// counter is kept); a row at or past scap would go to the trash row scap
// (the lanes are scap + 1 long). occupied (stats[1]) stays on the card
// and rides the counts the host reads each step. A step that captures
// nothing writes nothing.
//
// walk int64 [S + 4, B] (the state lanes, then seed, ptr, ...); slab
// int64 [3 + S, scap + 1]: fp1, fp2, depth, the S lanes; S + 3 <= 40.
//
// Bound on the card: bytes. counted (1 byte a walk) is read once, h1 and
// h2 for each counted walk, and a captured walk reads ptr and its S lanes
// and writes (3 + S) x 8 bytes. Design: capture_scan.cuh's one launch
// (K9a's), with one lane: a capturing tile finds its first rank by a
// look-back over the earlier tiles' counts and writes its own rows.

#include "capture_scan.cuh"

// thresh is int64 [2] on the card; scratch: capture::one_scratch(1, B)
// zeroed int32, 8-byte aligned (ops/slab.py capture_scratch), left as
// found.
extern "C" int srt_walk_capture(const void* counted, const void* h1,
                                const void* h2, const void* walk, int S,
                                long long B, const void* thresh, void* slab,
                                long long scap, void* stats, void* scratch,
                                long long scratch_len, void* stream) {
  if (B < 1 || S < 0 || S + 3 > capture::kMaxLanes) return (int)cudaErrorInvalidValue;
  const long long* w = (const long long*)walk;
  long long* out = (long long*)slab;
  capture::One in{};
  in.sel = (const bool*)counted;
  in.h1 = (const long long*)h1;
  in.h2 = (const long long*)h2;
  in.n = B;
  in.thresh = (const long long*)thresh;
  in.src[0] = in.h1;
  in.src[1] = in.h2;
  in.src[2] = w + (long long)(S + 1) * B;
  for (int s = 0; s < S; ++s) in.src[3 + s] = w + (long long)s * B;
  for (int l = 0; l < S + 3; ++l) in.dst[l] = out + l * (scap + 1);
  in.n_lanes = S + 3;
  in.scap = scap;
  in.step_cap = B;
  in.occ = (long long*)stats + 1;
  return capture::launch_one(in, 1, (int*)scratch, scratch_len, (cudaStream_t)stream);
}
