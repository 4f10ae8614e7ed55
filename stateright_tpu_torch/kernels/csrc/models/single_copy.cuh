// The single-copy register's lane program for K11, a row at a time: the
// port's copy of stateright_tpu/models/single_copy.py:47 SingleCopyTensor
// (:64 init_states_array, :76 deliver, :138 tensor_properties), run as
// stateright_tpu/lanes.py:321 ActorNetModel.step_lanes runs it on the
// unordered network (:162 net_step).
//
// Row (S = SV + C + K lanes, K = C + 1 net slots, 1 <= SV <= 4 servers,
// C <= 5 clients): server j's stored value in lane j (0 = None, 1..C =
// client i's value i + 1); client i's tester lane in SV + i; then the
// sorted network. Action k delivers net slot k. At most one handler
// fires, the one the word's dst names (servers 0..SV-1, client i at SV +
// i), so the handler is picked by a branch on dst, each instantiated for
// its actor; every arithmetic step is JAX's, in uint32, unmasked:
//   Put to server j:  store (pay >> 4) & 7, answer PutOk(rid) (changed);
//   Get to server j:  answer GetOk(rid | (val + 1) << 4), the tester's
//                     code 1 + val, so the empty register reads as None
//                     (no lane changes);
//   PutOk / GetOk to client i: the toolkit's register client, whose
//                     write completing sends Get(2 (SV + i)) to server
//                     (SV + i + 1) % SV.
// A successor is valid iff the slot held a word and the delivery changed
// a lane or sent one. A slot that is not valid still gets its successor
// lanes written, as JAX computes them. Properties: "linearizable"
// (always), "value chosen" (sometimes: a GetOk word whose value code is
// not None), "network within capacity" (always).

#pragma once

#include "actor_net.cuh"

namespace srt {

namespace single_copy {
enum Msg : uint32_t { PUT = 1, GET, PUTOK, GETOK };
constexpr uint32_t kPayMask = (1u << 20) - 1u;
}  // namespace single_copy

template <int SV, int C>
struct SingleCopy {
  static constexpr int K = C + 1;
  static constexpr int NA = SV + C;
  static constexpr int S = NA + K;
  static constexpr int P = 3;

  SRT_HD int actions() const { return K; }
  static SRT_HD Expect expect(int p) { return p == 1 ? SOMETIMES : ALWAYS; }
  SRT_HD bool in_boundary(const uint32_t*) const { return true; }

  SRT_HD void checks(const uint32_t* row, bool* out) const {
    using namespace single_copy;
    out[0] = register_linearizable<C>(row + SV);
    bool chosen = false;
    SRT_UNROLL
    for (int m = 0; m < K; ++m) {
      const uint32_t env = row[NA + m];
      chosen = chosen || ((env >> 28) == GETOK && ((env >> 4) & 15u) != 1u && env != 0u);
    }
    out[1] = chosen;
    out[2] = row[NA] == 0u;
  }

  // Server J's handler for a nonzero word addressed to it
  // (single_copy.py:89-105).
  template <int J>
  static SRT_HD void server(const uint32_t* row, uint32_t env, uint32_t* out, uint32_t* send,
                            bool* changed) {
    using namespace single_copy;
    const uint32_t typ = env >> 28, src = (env >> 24) & 15u, pay = env & kPayMask;
    const uint32_t rid = pay & 15u, val = row[J];
    const bool b_put = typ == PUT, b_get = typ == GET;
    out[J] = b_put ? (pay >> 4) & 7u : val;
    *changed = b_put;
    uint32_t s = 0u;
    if (b_put) s = env_word(PUTOK, J, src, rid);
    if (b_get) s = env_word(GETOK, J, src, rid | ((val + 1u) << 4));
    *send = s;
  }

  template <int J>
  static SRT_HD void servers(const uint32_t* row, uint32_t env, uint32_t dst, uint32_t* out,
                             uint32_t* send, bool* changed) {
    if constexpr (J < SV) {
      if (dst == (uint32_t)J)
        server<J>(row, env, out, send, changed);
      else
        servers<J + 1>(row, env, dst, out, send, changed);
    }
  }

  // Client I's handler for a nonzero word addressed to it
  // (single_copy.py:107-129, the toolkit's RegisterClient): its Get goes
  // to server (cid + 1) % SV with request id 2 cid.
  template <int I>
  static SRT_HD void client(const uint32_t* row, uint32_t env, uint32_t* out, uint32_t* send,
                            bool* changed) {
    using namespace single_copy;
    constexpr uint32_t cid = SV + I;
    const uint32_t typ = env >> 28;
    *send = register_client_deliver<C, I>(row + SV, typ == PUTOK, typ == GETOK,
                                          ((env & kPayMask) >> 4) & 15u,
                                          env_word(GET, cid, (cid + 1) % SV, 2 * cid), &out[SV + I],
                                          changed);
  }

  template <int I>
  static SRT_HD void clients(const uint32_t* row, uint32_t env, uint32_t dst, uint32_t* out,
                             uint32_t* send, bool* changed) {
    if constexpr (I < C) {
      if (dst == (uint32_t)(SV + I))
        client<I>(row, env, out, send, changed);
      else
        clients<I + 1>(row, env, dst, out, send, changed);
    }
  }

  template <class Sink>
  SRT_HD void step(const uint32_t* row, Sink& sink) const {
    const uint32_t* net = row + NA;
    SRT_NO_UNROLL
    for (int k = 0; k < K; ++k) {
      const uint32_t env = net_slot<K>(net, k);
      uint32_t out[S];
      SRT_UNROLL
      for (int t = 0; t < NA; ++t) out[t] = row[t];
      uint32_t send = 0u;
      bool changed = false;
      if (env != 0u) {
        const uint32_t dst = (env >> 20) & 15u;
        if (dst < (uint32_t)SV)
          servers<0>(row, env, dst, out, &send, &changed);
        else
          clients<0>(row, env, dst, out, &send, &changed);
      }
      uint32_t* cur = out + NA;
      net_remove<K>(net, k, cur);
      net_insert<K>(cur, send);
      sink.put(k, out, env != 0u && (changed || send != 0u));
    }
  }
};

}  // namespace srt
