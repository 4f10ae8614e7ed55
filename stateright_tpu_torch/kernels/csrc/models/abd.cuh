// ABD's lane program for K11, a row at a time: the port's copy of
// stateright_tpu/models/abd.py:68 AbdTensor (:101 deliver, :280
// tensor_properties) and :311 AbdOrderedTensor, run as
// stateright_tpu/lanes.py:321 ActorNetModel.step_lanes runs it, on the
// unordered network (:162 net_step) or the ordered one (:81
// net_step_ordered).
//
// Row (S = 6 + 2C lanes, K = C + 2 net slots, C <= 5 clients, 2
// servers): server j's core in lane 2j (seq 5b | val 3b << 5 | phase tag
// 2b << 8 | request id 4b << 10 | requester 4b << 14 | pending write 3b
// << 18) and its phase detail in lane 2j + 1 (phase 1: a present | seq |
// val slot of 9 bits a server; phase 2: is_read | read code << 1 | acks
// << 5); client i's tester lane in 4 + i; then the sorted network.
// Action k delivers net slot k. At most one handler fires (the one the
// word's dst names), so the handler is picked by a branch on dst, each
// instantiated for its actor, where lanes.py evaluates every actor's
// masked; every arithmetic step is JAX's, in uint32, unmasked (a write's
// clock bump can carry into the val field, as it does there).
//
// Unordered: a successor is valid iff the slot held a word and the
// delivery changed a lane (a Record only where it adopts) or sent one.
// Ordered: only a rank-0 word is deliverable, the handler sees it with
// its rank stripped, and every deliverable slot is valid (no no-op
// pruning). A slot that is not valid still gets its successor lanes
// written, as JAX computes them. Properties: "linearizable" (always),
// "value chosen" (sometimes: a GetOk word of the raw net, ranks and all,
// whose value code is not None), "network within capacity" (always).

#pragma once

#include "actor_net.cuh"

namespace srt {

namespace abd {
enum Msg : uint32_t { PUT = 1, GET, PUTOK, GETOK, QUERY, ACKQUERY, RECORD, ACKRECORD };
constexpr uint32_t kPayMask = (1u << 20) - 1u;
}  // namespace abd

template <int C, bool ORDERED>
struct Abd {
  static constexpr int K = C + 2;
  static constexpr int NA = 4 + C;
  static constexpr int S = NA + K;
  static constexpr int P = 3;

  SRT_HD int actions() const { return K; }
  static SRT_HD Expect expect(int p) { return p == 1 ? SOMETIMES : ALWAYS; }
  SRT_HD bool in_boundary(const uint32_t*) const { return true; }

  SRT_HD void checks(const uint32_t* row, bool* out) const {
    using namespace abd;
    out[0] = register_linearizable<C>(row + 4);
    bool chosen = false;
    SRT_UNROLL
    for (int m = 0; m < K; ++m) {
      const uint32_t env = row[NA + m];
      chosen = chosen || ((env >> 28) == GETOK && ((env >> 4) & 15u) != 1u && env != 0u);
    }
    out[1] = chosen;
    out[2] = row[NA] == 0u;
  }

  // Server J's handler for a nonzero word addressed to it (abd.py:117-247):
  // new lanes into out[2J], out[2J + 1].
  template <int J>
  static SRT_HD void server(const uint32_t* row, uint32_t env, uint32_t* out, uint32_t* send,
                            bool* changed) {
    using namespace abd;
    constexpr uint32_t peer = 1u - (uint32_t)J;
    const uint32_t typ = env >> 28, src = (env >> 24) & 15u, pay = env & kPayMask;
    const uint32_t rid = pay & 15u, mseq = (pay >> 4) & 31u, mval = (pay >> 9) & 7u;
    const uint32_t a = row[2 * J], b = row[2 * J + 1];
    const uint32_t seq = a & 31u, val = (a >> 5) & 7u, ptag = (a >> 8) & 3u;
    const uint32_t my_rid = (a >> 10) & 15u, req = (a >> 14) & 15u, wval = (a >> 18) & 7u;

    // Put/Get on an idle server: open phase 1 with the self response,
    // query the peer.
    const bool b_start = (typ == PUT || typ == GET) && ptag == 0u;
    const uint32_t start_wval = typ == PUT ? (pay >> 4) & 7u : 0u;
    const uint32_t start_a =
        seq | (val << 5) | (1u << 8) | (rid << 10) | (src << 14) | (start_wval << 18);
    const uint32_t start_b = (1u | (seq << 1) | (val << 6)) << (9 * J);

    // Query: reply with our (seq, val).
    const bool b_query = typ == QUERY;

    // AckQuery for the open phase 1: the peer's response completes the
    // quorum; pick the max seq, bump the clock on a write, self-adopt.
    const bool b_ackq = typ == ACKQUERY && ptag == 1u && rid == my_rid;
    const uint32_t self_seq = (b >> (9 * J + 1)) & 31u;
    const uint32_t self_val = (b >> (9 * J + 6)) & 7u;
    const bool peer_better = mseq > self_seq;
    const uint32_t best_seq = peer_better ? mseq : self_seq;
    const uint32_t best_val = peer_better ? mval : self_val;
    const bool is_read = wval == 0u;
    const uint32_t chosen_seq = is_read ? best_seq : (((best_seq >> 1) + 1u) << 1) | (uint32_t)J;
    const uint32_t chosen_val = is_read ? best_val : wval;
    const uint32_t read_code = best_val + 1u;
    const bool adopt = chosen_seq > seq;
    const uint32_t ackq_a = (adopt ? chosen_seq : seq) | ((adopt ? chosen_val : val) << 5) |
                            (2u << 8) | (my_rid << 10) | (req << 14);
    const uint32_t ackq_b =
        (is_read ? 1u : 0u) | ((is_read ? read_code : 0u) << 1) | ((1u << J) << 5);

    // Record: ack, and adopt the recorded (seq, val) if greater.
    const bool b_rec = typ == RECORD;
    const bool rec_adopt = mseq > seq;
    const uint32_t rec_a =
        (rec_adopt ? mseq : seq) | ((rec_adopt ? mval : val) << 5) | (a & ~(31u | (7u << 5)));

    // AckRecord for the open phase 2: reply to the requester, go idle.
    const uint32_t acks = (b >> 5) & 3u;
    const bool b_ackr =
        typ == ACKRECORD && ptag == 2u && rid == my_rid && (acks & (1u << src)) == 0u;
    const bool p2_is_read = (b & 1u) == 1u;
    const uint32_t p2_code = (b >> 1) & 15u;
    const uint32_t ackr_a = seq | (val << 5);

    uint32_t na = a, nb = b;
    na = b_start ? start_a : na;
    nb = b_start ? start_b : nb;
    na = b_ackq ? ackq_a : na;
    nb = b_ackq ? ackq_b : nb;
    na = b_rec ? rec_a : na;
    na = b_ackr ? ackr_a : na;
    nb = b_ackr ? 0u : nb;
    out[2 * J] = na;
    out[2 * J + 1] = nb;
    *changed = b_start || b_ackq || (b_rec && rec_adopt) || b_ackr;

    uint32_t s = 0u;
    if (b_start) s = env_word(QUERY, J, peer, rid);
    if (b_query) s = env_word(ACKQUERY, J, src, rid | (seq << 4) | (val << 9));
    if (b_ackq) s = env_word(RECORD, J, peer, my_rid | (chosen_seq << 4) | (chosen_val << 9));
    if (b_rec) s = env_word(ACKRECORD, J, src, rid);
    if (b_ackr)
      s = p2_is_read ? env_word(GETOK, J, req, my_rid | (p2_code << 4))
                     : env_word(PUTOK, J, req, my_rid);
    *send = s;
  }

  // Client I's handler for a nonzero word addressed to it (abd.py:249-269,
  // the toolkit's RegisterClient).
  template <int I>
  static SRT_HD void client(const uint32_t* row, uint32_t env, uint32_t* out, uint32_t* send,
                            bool* changed) {
    using namespace abd;
    constexpr uint32_t cid = 2 + I;
    const uint32_t typ = env >> 28;
    *send = register_client_deliver<C, I>(row + 4, typ == PUTOK, typ == GETOK,
                                          ((env & kPayMask) >> 4) & 15u,
                                          env_word(GET, cid, (cid + 1) % 2, 2 * cid), &out[4 + I],
                                          changed);
  }

  template <int I>
  static SRT_HD void clients(const uint32_t* row, uint32_t env, uint32_t dst, uint32_t* out,
                             uint32_t* send, bool* changed) {
    if constexpr (I < C) {
      if (dst == 2u + I)
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
      const uint32_t raw = net_slot<K>(net, k);
      const uint32_t env = ORDERED ? raw & ~kRankField : raw;
      uint32_t out[S];
      SRT_UNROLL
      for (int t = 0; t < NA; ++t) out[t] = row[t];
      uint32_t send = 0u;
      bool changed = false;
      if (env != 0u) {
        const uint32_t dst = (env >> 20) & 15u;
        if (dst == 0u)
          server<0>(row, env, out, &send, &changed);
        else if (dst == 1u)
          server<1>(row, env, out, &send, &changed);
        else
          clients<0>(row, env, dst, out, &send, &changed);
      }
      uint32_t* cur = out + NA;
      bool mask;
      if constexpr (ORDERED) {
        net_remove_ordered<K>(net, k, raw, cur);
        net_insert_ordered<K>(cur, send);
        mask = raw != 0u && (raw & kRankField) == 0u;
      } else {
        net_remove<K>(net, k, cur);
        net_insert<K>(cur, send);
        mask = raw != 0u && (changed || send != 0u);
      }
      sink.put(k, out, mask);
    }
  }
};

}  // namespace srt
