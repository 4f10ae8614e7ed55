// Host harness of K11's model headers: the same SRT_HD functions the
// kernels run (expand_row.cuh, two_phase.cuh, actor_net.cuh, paxos.cuh),
// looped over the rows on the CPU. The CPU tests build it with
//
//     g++ -std=c++17 -O2 -shared -fPIC -o libexpand_host.so harness.cpp
//
// and hold its outputs against the JAX package's build_expand_lean and
// walk step bit for bit (tests/test_torch_expand_kernel.py). The entry
// points take the kernels' arguments (host pointers, no stream) and fill
// the same layouts; `generated` is the sum the kernel's last block writes.

#include "expand_row.cuh"
#include "paxos.cuh"
#include "two_phase.cuh"

namespace {

template <class M>
int expand_rows(const M& m, const long long* rows, const long long* ebits, const long long* depth,
                const bool* active, const long long* dl, long long dl_value, long long dl_stride,
                long long W, long long* ebits_out, long long* flat, bool* valid, bool* hits,
                long long* generated) {
  long long total = 0;
  for (long long c = 0; c < W; ++c)
    total += srt::expand_one(m, c, W, rows, ebits, depth, active, dl, dl_value, dl_stride,
                             ebits_out, flat, valid, hits);
  *generated = total;
  return 0;
}

template <class M>
int walk_rows(const M& m, const long long* rows, long long B, bool* checks, bool* valid,
              long long* succ) {
  for (long long b = 0; b < B; ++b) srt::walk_one(m, b, B, rows, checks, valid, succ);
  return 0;
}

template <class M>
int paxos_expand(const long long* rows, const long long* ebits, const long long* depth,
                 const bool* active, const long long* dl, long long dl_value, long long dl_stride,
                 long long W, long long* ebits_out, long long* flat, bool* valid, bool* hits,
                 long long* generated) {
  return expand_rows(M{}, rows, ebits, depth, active, dl, dl_value, dl_stride, W, ebits_out, flat,
                     valid, hits, generated);
}

}  // namespace

extern "C" int srt_host_expand_2pc(int n, const long long* rows, const long long* ebits,
                                   const long long* depth, const bool* active, const long long* dl,
                                   long long dl_value, long long dl_stride, long long W,
                                   long long* ebits_out, long long* flat, bool* valid, bool* hits,
                                   long long* generated) {
  if (n < 1 || n > 16) return 1;
  return expand_rows(srt::TwoPhase{n}, rows, ebits, depth, active, dl, dl_value, dl_stride, W,
                     ebits_out, flat, valid, hits, generated);
}

extern "C" int srt_host_walk_2pc(int n, const long long* rows, long long B, bool* checks,
                                 bool* valid, long long* succ) {
  if (n < 1 || n > 16) return 1;
  return walk_rows(srt::TwoPhase{n}, rows, B, checks, valid, succ);
}

extern "C" int srt_host_expand_paxos(int c, const long long* rows, const long long* ebits,
                                     const long long* depth, const bool* active,
                                     const long long* dl, long long dl_value, long long dl_stride,
                                     long long W, long long* ebits_out, long long* flat,
                                     bool* valid, bool* hits, long long* generated) {
  switch (c) {
#define SRT_CASE(C)                                                                           \
  case C:                                                                                     \
    return paxos_expand<srt::Paxos<C>>(rows, ebits, depth, active, dl, dl_value, dl_stride, W, \
                                       ebits_out, flat, valid, hits, generated);
    SRT_CASE(1) SRT_CASE(2) SRT_CASE(3) SRT_CASE(4) SRT_CASE(5) SRT_CASE(6) SRT_CASE(7)
#undef SRT_CASE
    default: return 1;
  }
}

extern "C" int srt_host_walk_paxos(int c, const long long* rows, long long B, bool* checks,
                                   bool* valid, long long* succ) {
  switch (c) {
#define SRT_CASE(C) \
  case C: return walk_rows(srt::Paxos<C>{}, rows, B, checks, valid, succ);
    SRT_CASE(1) SRT_CASE(2) SRT_CASE(3) SRT_CASE(4) SRT_CASE(5) SRT_CASE(6) SRT_CASE(7)
#undef SRT_CASE
    default: return 1;
  }
}
