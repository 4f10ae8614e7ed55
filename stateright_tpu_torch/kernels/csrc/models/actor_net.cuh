// The actor-system toolkit's lane programs for K11, a row at a time: the
// port's copy of stateright_tpu/lanes.py's unordered network
// (:162 net_step, as :321 ActorNetModel.step_lanes runs it) and its
// ordered network (:81 net_step_ordered), the
// register client's delivery handler (:385 register_client_deliver) and
// the register linearizability verdict (:419
// register_linearizable_lanes).
//
// The network is K ascending-sorted envelope words, zeros (empty slots)
// first. Delivering slot k removes it (the words below it shift up one),
// then each nonzero send v is inserted at rank = #{m in [1, K) : cur[m] <
// v} (the sum starts at m = 1, as lanes.py's does). Every array is
// indexed by compile-time constants (unrolled loops, selects on a runtime
// index), so it stays in registers.

#pragma once

#include "expand_row.cuh"

namespace srt {

// Envelope word: typ(4b) << 28 | src(4b) << 24 | dst(4b) << 20 | payload.
SRT_HD uint32_t env_word(uint32_t typ, uint32_t src, uint32_t dst, uint32_t pay) {
  return (typ << 28) | (src << 24) | (dst << 20) | pay;
}

// net[k] for a runtime k, by selects.
template <int K>
SRT_HD uint32_t net_slot(const uint32_t* net, int k) {
  uint32_t env = 0;
  SRT_UNROLL
  for (int m = 0; m < K; ++m) env = m == k ? net[m] : env;
  return env;
}

// cur = net with slot k removed (lanes.py:181-188).
template <int K>
SRT_HD void net_remove(const uint32_t* net, int k, uint32_t* cur) {
  SRT_UNROLL
  for (int m = 0; m < K; ++m) cur[m] = k >= m ? (m > 0 ? net[m - 1] : 0u) : net[m];
}

// Insert one send in sorted position, in place (lanes.py:189-203).
template <int K>
SRT_HD void net_insert(uint32_t* cur, uint32_t v) {
  if (v == 0u) return;
  uint32_t rank = 0;
  SRT_UNROLL
  for (int m = 1; m < K; ++m) rank += cur[m] < v ? 1u : 0u;
  SRT_UNROLL
  for (int m = 0; m < K; ++m) {
    const uint32_t shifted = m + 1 < K ? cur[m + 1] : v;
    cur[m] = (uint32_t)m < rank ? shifted : ((uint32_t)m == rank ? v : cur[m]);
  }
}

// The ordered network (lanes.py:81 net_step_ordered): each word carries
// its rank in its (src, dst) flow in bits 16-19; a flow is bits 20-27.
constexpr uint32_t kRankShift = 16;
constexpr uint32_t kRankField = 0xFu << kRankShift;

SRT_HD uint32_t net_flow(uint32_t env) { return (env >> 20) & 0xFFu; }

// cur = net with slot k (the delivered word `delivered`) removed, the rank
// of every other occupied word of its flow decremented (uint32 wrap, as
// JAX's, on a row whose ranks are not consistent), the order restored by
// K passes of odd-even transposition (lanes.py:106-131). An empty
// `delivered` decrements nothing.
template <int K>
SRT_HD void net_remove_ordered(const uint32_t* net, int k, uint32_t delivered, uint32_t* cur) {
  net_remove<K>(net, k, cur);
  const uint32_t dflow = net_flow(delivered);
  SRT_UNROLL
  for (int m = 0; m < K; ++m)
    if (delivered != 0u && cur[m] != 0u && net_flow(cur[m]) == dflow) cur[m] -= 1u << kRankShift;
  SRT_UNROLL
  for (int p = 0; p < K; ++p) {
    SRT_UNROLL
    for (int m = p & 1; m < K - 1; m += 2) {
      const uint32_t lo = cur[m] < cur[m + 1] ? cur[m] : cur[m + 1];
      const uint32_t hi = cur[m] < cur[m + 1] ? cur[m + 1] : cur[m];
      cur[m] = lo;
      cur[m + 1] = hi;
    }
  }
}

// Insert one send at its flow's tail (lanes.py:132-162): its rank field
// masked off, then its flow's current depth ORed in; placed in sorted
// position as net_insert places a word.
template <int K>
SRT_HD void net_insert_ordered(uint32_t* cur, uint32_t v) {
  v &= ~kRankField;
  if (v == 0u) return;
  const uint32_t flow = net_flow(v);
  uint32_t depth = 0;
  SRT_UNROLL
  for (int m = 0; m < K; ++m) depth += (cur[m] != 0u && net_flow(cur[m]) == flow) ? 1u : 0u;
  net_insert<K>(cur, v | (depth << kRankShift));
}

// The put_count=1 RegisterClient's delivery for client I of C, whose
// lanes are `cl` (lanes.py:385-416): `putok` / `getok` say this delivery
// is a PutOk / GetOk to the client; the new lane goes to *out, the send
// (a Get once the write completes, else 0) is returned, and *changed is
// set when either fires.
template <int C, int I>
SRT_HD uint32_t register_client_deliver(const uint32_t* cl, bool putok, bool getok,
                                        uint32_t getok_val, uint32_t get_env, uint32_t* out,
                                        bool* changed) {
  const uint32_t lane = cl[I];
  const uint32_t phase = lane & 3u;
  const bool b_pok = putok && phase == 0u;
  uint32_t ncl = (lane & ~3u) | 1u;
  SRT_UNROLL
  for (int p = 0; p < C; ++p) {
    if (p == I) continue;
    const uint32_t peer_phase = cl[p] & 3u;
    ncl = (ncl & ~(3u << (6 + 2 * p))) | (peer_phase << (6 + 2 * p));
  }
  const bool b_gok = getok && phase == 1u;
  const uint32_t gok_cl = (lane & ~0x3Fu) | 2u | ((getok_val & 15u) << 2);
  uint32_t o = lane;
  o = b_pok ? ncl : o;
  o = b_gok ? gok_cl : o;
  *out = o;
  *changed = b_pok || b_gok;
  return b_pok ? get_env : 0u;
}

// Register linearizability from the C client lanes (lanes.py:419-483):
// acyclicity of the write-precedence digraph, no completed read of None.
template <int C>
SRT_HD bool register_linearizable(const uint32_t* cl) {
  uint32_t val[C], kk[C], adj[C];
  bool done[C];
  SRT_UNROLL
  for (int i = 0; i < C; ++i) {
    val[i] = (cl[i] >> 2) & 15u;
    done[i] = (cl[i] & 3u) == 2u;
    kk[i] = (val[i] - 2u) & 15u;
    adj[i] = 0u;
  }
  bool none_read = false;
  SRT_UNROLL
  for (int j = 0; j < C; ++j) {
    const bool rj = done[j];
    none_read = none_read || (rj && val[j] == 1u);
    const uint32_t tgt = kk[j];
    // set_edge(row, tgt, cond): adj[row] |= 1 << tgt where cond && tgt != row.
    if (rj && tgt != (uint32_t)j) adj[j] |= 1u << tgt;
    SRT_UNROLL
    for (int i = 0; i < C; ++i) {
      if (i == j) continue;
      const uint32_t cij = (cl[j] >> (6 + 2 * i)) & 3u;
      if (rj && cij >= 1u && tgt != (uint32_t)i) adj[i] |= 1u << tgt;
      const bool rr = rj && cij == 2u;
      SRT_UNROLL
      for (int r = 0; r < C; ++r)
        if (rr && kk[i] == (uint32_t)r && tgt != (uint32_t)r) adj[r] |= 1u << tgt;
    }
  }
  int rounds = 0;
  for (int v = C - 1; v > 0; v >>= 1) ++rounds;
  if (rounds < 1) rounds = 1;
  for (int round = 0; round < rounds; ++round) {
    uint32_t nxt[C];
    SRT_UNROLL
    for (int i = 0; i < C; ++i) {
      uint32_t acc = adj[i];
      SRT_UNROLL
      for (int k = 0; k < C; ++k) acc |= ((adj[i] >> k) & 1u) == 1u ? adj[k] : 0u;
      nxt[i] = acc;
    }
    SRT_UNROLL
    for (int i = 0; i < C; ++i) adj[i] = nxt[i];
  }
  bool cyclic = false;
  SRT_UNROLL
  for (int i = 0; i < C; ++i) cyclic = cyclic || ((adj[i] >> i) & 1u) == 1u;
  return !(cyclic || none_read);
}

}  // namespace srt
