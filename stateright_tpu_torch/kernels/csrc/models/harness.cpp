// Host harness of K11's model headers: the same SRT_HD functions the
// kernels run (expand_row.cuh, two_phase.cuh, actor_net.cuh, paxos.cuh,
// abd.cuh, increment.cuh, increment_lock.cuh, single_copy.cuh), looped
// over the rows on the CPU. The CPU tests build it with
//
//     g++ -std=c++17 -O2 -shared -fPIC -o libexpand_host.so harness.cpp
//
// and hold its outputs against the JAX package's build_expand_lean, walk
// step and 2PC representative_lanes bit for bit (tests/
// test_torch_expand_kernel.py, test_torch_expand_kernel_abd.py,
// test_torch_expand_kernel_lock_copy.py, test_torch_canon_kernel.py). The entry
// points take the kernels' arguments (host pointers, no stream) and fill
// the same layouts; `generated` is the sum the kernel's last block writes.

#include "abd.cuh"
#include "expand_row.cuh"
#include "increment.cuh"
#include "increment_lock.cuh"
#include "paxos.cuh"
#include "single_copy.cuh"
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

// K11c: the 2PC canon over rows [3, W] (canon_2pc.cu's layout).
namespace {
template <int N>
struct CanonRows {
  static int run(const long long* in, long long* out, long long W) {
    for (long long c = 0; c < W; ++c) {
      uint32_t row[3], rep[3];
      for (int s = 0; s < 3; ++s) row[s] = (uint32_t)in[s * W + c];
      srt::two_phase_canon<N>(row, rep);
      for (int s = 0; s < 3; ++s) out[s * W + c] = (long long)rep[s];
    }
    return 0;
  }
};

template <class M>
struct ExpandRows {
  static int run(const long long* rows, const long long* ebits, const long long* depth,
                 const bool* active, const long long* dl, long long dl_value, long long dl_stride,
                 long long W, long long* ebits_out, long long* flat, bool* valid, bool* hits,
                 long long* generated) {
    return expand_rows(M{}, rows, ebits, depth, active, dl, dl_value, dl_stride, W, ebits_out,
                       flat, valid, hits, generated);
  }
};

template <class M>
struct WalkRows {
  static int run(const long long* rows, long long B, bool* checks, bool* valid, long long* succ) {
    return walk_rows(M{}, rows, B, checks, valid, succ);
  }
};

template <template <class> class F, class... Args>
int abd_model(int c, int ordered, Args... args) {
  if (ordered != 0 && ordered != 1) return 1;
  switch (c * 2 + ordered) {
#define SRT_ABD(C)                                        \
  case 2 * C: return F<srt::Abd<C, false>>::run(args...); \
  case 2 * C + 1: return F<srt::Abd<C, true>>::run(args...);
    SRT_ABD(1) SRT_ABD(2) SRT_ABD(3) SRT_ABD(4) SRT_ABD(5)
#undef SRT_ABD
    default: return 1;
  }
}

template <template <class> class F, class... Args>
int increment_model(int n, Args... args) {
  switch (n) {
#define SRT_INC(N) \
  case N: return F<srt::Increment<N>>::run(args...);
    SRT_INC(1) SRT_INC(2) SRT_INC(3) SRT_INC(4) SRT_INC(5) SRT_INC(6) SRT_INC(7) SRT_INC(8)
#undef SRT_INC
    default: return 1;
  }
}

template <template <class> class F, class... Args>
int increment_lock_model(int n, Args... args) {
  switch (n) {
#define SRT_LOCK(N) \
  case N: return F<srt::IncrementLock<N>>::run(args...);
    SRT_LOCK(1) SRT_LOCK(2) SRT_LOCK(3) SRT_LOCK(4) SRT_LOCK(5) SRT_LOCK(6) SRT_LOCK(7) SRT_LOCK(8)
#undef SRT_LOCK
    default: return 1;
  }
}

template <template <class> class F, class... Args>
int single_copy_model(int s, int c, Args... args) {
  if (c < 1 || c > 5) return 1;
  switch (s * 8 + c) {
#define SRT_SC(SV, C) \
  case SV * 8 + C: return F<srt::SingleCopy<SV, C>>::run(args...);
#define SRT_SC_S(SV) SRT_SC(SV, 1) SRT_SC(SV, 2) SRT_SC(SV, 3) SRT_SC(SV, 4) SRT_SC(SV, 5)
    SRT_SC_S(1) SRT_SC_S(2) SRT_SC_S(3) SRT_SC_S(4)
#undef SRT_SC_S
#undef SRT_SC
    default: return 1;
  }
}
}  // namespace

extern "C" int srt_host_canon_2pc(int n, const long long* rows_in, long long* rows_out,
                                  long long W) {
  return srt::by_rms<CanonRows>(n, 1, rows_in, rows_out, W);
}

extern "C" int srt_host_expand_abd(int c, int ordered, const long long* rows,
                                   const long long* ebits, const long long* depth,
                                   const bool* active, const long long* dl, long long dl_value,
                                   long long dl_stride, long long W, long long* ebits_out,
                                   long long* flat, bool* valid, bool* hits,
                                   long long* generated) {
  return abd_model<ExpandRows>(c, ordered, rows, ebits, depth, active, dl, dl_value, dl_stride, W,
                               ebits_out, flat, valid, hits, generated);
}

extern "C" int srt_host_walk_abd(int c, int ordered, const long long* rows, long long B,
                                 bool* checks, bool* valid, long long* succ) {
  return abd_model<WalkRows>(c, ordered, rows, B, checks, valid, succ);
}

extern "C" int srt_host_expand_increment(int n, const long long* rows, const long long* ebits,
                                         const long long* depth, const bool* active,
                                         const long long* dl, long long dl_value,
                                         long long dl_stride, long long W, long long* ebits_out,
                                         long long* flat, bool* valid, bool* hits,
                                         long long* generated) {
  return increment_model<ExpandRows>(n, rows, ebits, depth, active, dl, dl_value, dl_stride, W,
                                     ebits_out, flat, valid, hits, generated);
}

extern "C" int srt_host_walk_increment(int n, const long long* rows, long long B, bool* checks,
                                       bool* valid, long long* succ) {
  return increment_model<WalkRows>(n, rows, B, checks, valid, succ);
}

extern "C" int srt_host_expand_increment_lock(int n, const long long* rows,
                                              const long long* ebits, const long long* depth,
                                              const bool* active, const long long* dl,
                                              long long dl_value, long long dl_stride, long long W,
                                              long long* ebits_out, long long* flat, bool* valid,
                                              bool* hits, long long* generated) {
  return increment_lock_model<ExpandRows>(n, rows, ebits, depth, active, dl, dl_value, dl_stride,
                                          W, ebits_out, flat, valid, hits, generated);
}

extern "C" int srt_host_walk_increment_lock(int n, const long long* rows, long long B,
                                            bool* checks, bool* valid, long long* succ) {
  return increment_lock_model<WalkRows>(n, rows, B, checks, valid, succ);
}

extern "C" int srt_host_expand_single_copy(int s, int c, const long long* rows,
                                           const long long* ebits, const long long* depth,
                                           const bool* active, const long long* dl,
                                           long long dl_value, long long dl_stride, long long W,
                                           long long* ebits_out, long long* flat, bool* valid,
                                           bool* hits, long long* generated) {
  return single_copy_model<ExpandRows>(s, c, rows, ebits, depth, active, dl, dl_value, dl_stride,
                                       W, ebits_out, flat, valid, hits, generated);
}

extern "C" int srt_host_walk_single_copy(int s, int c, const long long* rows, long long B,
                                         bool* checks, bool* valid, long long* succ) {
  return single_copy_model<WalkRows>(s, c, rows, B, checks, valid, succ);
}
