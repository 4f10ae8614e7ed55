// The BFS era's state on the card, shared by K8f's two kernels
// (era_step.cu, era_epilogue.cu).
//
// One int64 vector holds uint32 values: first the packed params of the
// JAX era program, word for word (stateright_tpu/engines/tpu_bfs.py:106-126,
// :188 params_len, :947-1006): the scalars P_HEAD .. P_BUDGET_CAP, the
// discovery fingerprints rec_fp1[P] | rec_fp2[P], the coverage tail, the
// sample tail and the fusion tail; then, from word `x` on, the port's own
// per-step and per-era words (X_*), which the host never reads as params.
// The layout is fixed by the host's config vector (Cfg, below), which
// ops/era.py builds.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace era {

// stateright_tpu/engines/tpu_bfs.py:106-126.
constexpr int P_HEAD = 0, P_COUNT = 1, P_UNIQUE = 2, P_REC = 3, P_DEPTH_LIMIT = 4,
              P_GROW_LIMIT = 5, P_HIGH_WATER = 6, P_MAX_STEPS = 7, P_GEN = 8, P_MAXD = 9,
              P_STEPS = 10, P_ERR = 11, P_TAKE_CAP = 12, P_FIN_ANY = 13, P_FIN_ALL = 14,
              P_FIN_ALL_EN = 15, P_BUDGET_CAP = 16, P_LEN = 17;

// The port's words, from cfg.x: this step's take, the gate, the ring
// tail of this step's append, the era's input discovery bits and unique
// count, the era's clean steps and generated states, the dispatch's
// step-body runs, partial (overflow) steps and inner eras, and whether
// the fused loop runs another era (ops/era.py X_*).
constexpr int X_TAKE = 0, X_OPEN = 1, X_TAIL = 2, X_REC0 = 3, X_UNIQ_IN = 4, X_ESTEPS = 5,
              X_EGEN = 6, X_ITER = 7, X_PARTIAL = 8, X_K = 9, X_MORE = 10, X_LEN = 12;

// The host's config vector, in this order (ops/era.py CFG_FIELDS).
// An offset of -1 means the tail is absent.
struct Cfg {
  long long chunk, qmask, vcap, rcap, P, A, cov_base, s_base, s_high, s_take, f_base, fuse,
      x, regrow, budget_min, n_cov, scap;
};
constexpr int kCfgLen = 17;

constexpr long long M32 = 0xFFFFFFFFll;

inline Cfg load_cfg(const long long* v) {
  Cfg c;
  long long* dst = &c.chunk;
  for (int i = 0; i < kCfgLen; ++i) dst[i] = v[i];
  return c;
}

// The finish policy's early exit (tpu_bfs.py:404-406).
__device__ __forceinline__ bool fin_hit(const long long* s, long long rec) {
  return (rec & s[P_FIN_ANY]) != 0 ||
         (s[P_FIN_ALL_EN] != 0 && (rec & s[P_FIN_ALL]) == s[P_FIN_ALL]);
}

}  // namespace era
