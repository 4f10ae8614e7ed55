// Single Decree Paxos's lane program for K11, a row at a time: the port's
// copy of stateright_tpu/models/paxos.py:114 PaxosTensor._deliver (with
// :63 _pop3), :362 linearizable_lanes and :370 tensor_properties, run as
// stateright_tpu/lanes.py:321 ActorNetModel.step_lanes runs it on the
// unordered network.
//
// Row (S = 6 + C + K lanes, K = 7C net slots, C <= 7 clients): server j's
// packed core in lane 2j (ballot 5b | proposal 3b << 5 | accepts 3b << 8
// | accepted present << 11 | its ballot 5b << 12 | its proposal 3b << 17
// | decided << 20) and its prepares map in lane 2j + 1 (10 bits a peer);
// client i's tester lane in 6 + i; then the sorted network. Action k
// delivers net slot k: at most one handler fires (the one its dst names),
// so the handler is picked by a branch on dst, each instantiated for its
// actor, where lanes.py evaluates all of them masked. A successor is
// valid iff the slot held a message and the delivery changed a lane or
// sent one. Properties: "linearizable" (always), "value chosen"
// (sometimes), "network within capacity" (always), "ballot rounds within
// range" (always).

#pragma once

#include "actor_net.cuh"

namespace srt {

namespace paxos {
enum Msg : uint32_t {
  PUT = 1, GET, PUTOK, GETOK, PREPARE, PREPARED, ACCEPT, ACCEPTED, DECIDED
};
constexpr uint32_t kPayMask = (1u << 20) - 1u;

SRT_HD uint32_t pop3(uint32_t bits) {
  return (bits & 1u) + ((bits >> 1) & 1u) + ((bits >> 2) & 1u);
}
}  // namespace paxos

template <int C>
struct Paxos {
  static constexpr int K = 7 * C;
  static constexpr int NA = 6 + C;
  static constexpr int S = NA + K;
  static constexpr int P = 4;

  SRT_HD int actions() const { return K; }
  static SRT_HD Expect expect(int p) { return p == 1 ? SOMETIMES : ALWAYS; }
  SRT_HD bool in_boundary(const uint32_t*) const { return true; }

  SRT_HD void checks(const uint32_t* row, bool* out) const {
    using namespace paxos;
    out[0] = register_linearizable<C>(row + 6);
    bool chosen = false;
    SRT_UNROLL
    for (int m = 0; m < K; ++m) {
      const uint32_t env = row[NA + m];
      chosen = chosen || ((env >> 28) == GETOK && (env & 15u) != 1u);
    }
    out[1] = chosen;
    out[2] = row[NA] == 0u;
    bool rounds = true;
    SRT_UNROLL
    for (int j = 0; j < 3; ++j) {
      const uint32_t a = row[2 * j];
      rounds = rounds && ((a & 31u) >> 2) < 7u && (((a >> 12) & 31u) >> 2) < 7u;
    }
    out[3] = rounds;
  }

  // Server J's handler for a nonzero envelope addressed to it
  // (paxos.py:134-300): new lanes into out[2J], out[2J + 1].
  template <int J>
  static SRT_HD void server(const uint32_t* row, uint32_t env, uint32_t* out, uint32_t* send,
                            bool* changed) {
    using namespace paxos;
    constexpr uint32_t p0 = J == 0 ? 1u : 0u;
    constexpr uint32_t p1 = J == 2 ? 1u : 2u;
    const uint32_t typ = env >> 28, src = (env >> 24) & 15u, pay = env & kPayMask;
    const uint32_t a = row[2 * J], pl = row[2 * J + 1];
    const uint32_t ballot = a & 31u, prop = (a >> 5) & 7u, accepts = (a >> 8) & 7u;
    const uint32_t acc_pres = (a >> 11) & 1u, acc_ballot = (a >> 12) & 31u;
    const uint32_t acc_prop = (a >> 17) & 7u;
    const bool decided = ((a >> 20) & 1u) == 1u;
    const uint32_t mb = pay & 31u;

    // Get on a decided server: reply with the accepted value.
    const bool b_dget = decided && typ == GET;
    const bool live = !decided;

    // Put on a proposal-less server: start a term.
    const bool b_put = live && typ == PUT && prop == 0u;
    const uint32_t nb_ballot = (((ballot >> 2) + 1u) << 2) | (uint32_t)J;
    const uint32_t put_a = nb_ballot | ((1u + src - 3u) << 5) | (acc_pres << 11) |
                           (acc_ballot << 12) | (acc_prop << 17);
    const uint32_t put_pl = (1u | (acc_pres << 1) | (acc_ballot << 2) | (acc_prop << 7))
                            << (10 * J);

    // Prepare with a higher ballot: adopt and reply Prepared.
    const bool b_prep = live && typ == PREPARE && ballot < mb;
    const uint32_t prep_a = (a & ~31u) | mb;
    const uint32_t prep_pay = mb | (acc_pres << 5) | (acc_ballot << 6) | (acc_prop << 11);

    // Prepared for the current ballot: record; on quorum pick the best
    // accepted proposal and broadcast Accept.
    const bool b_prd = live && typ == PREPARED && mb == ballot;
    const uint32_t entry = 1u | (((pay >> 5) & 1u) << 1) | (((pay >> 6) & 31u) << 2) |
                           (((pay >> 11) & 7u) << 7);
    uint32_t npl = pl;
    SRT_UNROLL
    for (int s = 0; s < 3; ++s)
      if (b_prd && src == (uint32_t)s) npl = (npl & ~(0x3FFu << (10 * s))) | (entry << (10 * s));
    const uint32_t inmap = (npl & 1u) + ((npl >> 10) & 1u) + ((npl >> 20) & 1u);
    const bool quorum_p = inmap == 2u;
    uint32_t best = 0;
    SRT_UNROLL
    for (int s = 0; s < 3; ++s) {
      const int sl = 10 * s;
      const uint32_t key = ((npl >> sl) & 1u) == 1u
                               ? 1u + ((((npl >> (sl + 1)) & 1u) << 8) |
                                       (((npl >> (sl + 2)) & 31u) << 3) | ((npl >> (sl + 7)) & 7u))
                               : 0u;
      best = key > best ? key : best;
    }
    const uint32_t best_vp = ((best - 1u) >> 8) & 1u;  // best = 0 gives 1, as in JAX
    const uint32_t q_prop = best_vp == 1u ? (best - 1u) & 7u : prop;
    const uint32_t prd_a = (b_prd && quorum_p)
                               ? ballot | (q_prop << 5) | ((1u << J) << 8) | (1u << 11) |
                                     (ballot << 12) | (q_prop << 17)
                               : a;
    const uint32_t acc_pay = ballot | (q_prop << 5);

    // Accept with a ballot >= ours: adopt and reply Accepted.
    const bool b_acc = live && typ == ACCEPT && ballot <= mb;
    const uint32_t acc_a = mb | (prop << 5) | (accepts << 8) | (1u << 11) | (mb << 12) |
                           (((pay >> 5) & 7u) << 17);

    // Accepted for the current ballot: count; on quorum decide, broadcast
    // Decided and ack the requester.
    const bool b_acd = live && typ == ACCEPTED && mb == ballot;
    const uint32_t nacc = accepts | (1u << src);
    const bool quorum_a = pop3(nacc) == 2u;
    const uint32_t acd_base = (a & ~(7u << 8)) | (nacc << 8);
    const uint32_t acd_a = b_acd && quorum_a ? acd_base | (1u << 20) : acd_base;
    const uint32_t dec_pay = ballot | (prop << 5);
    const uint32_t requester = 3u + prop - 1u;

    // Decided: adopt unconditionally.
    const bool b_dec = live && typ == DECIDED;
    const uint32_t dec_a = mb | (prop << 5) | (accepts << 8) | (1u << 11) | (mb << 12) |
                           (((pay >> 5) & 7u) << 17) | (1u << 20);

    uint32_t na = a;
    na = b_put ? put_a : na;
    na = b_prep ? prep_a : na;
    na = b_prd ? prd_a : na;
    na = b_acc ? acc_a : na;
    na = b_acd ? acd_a : na;
    na = b_dec ? dec_a : na;
    out[2 * J] = na;
    out[2 * J + 1] = b_put ? put_pl : (b_prd ? npl : pl);
    *changed = b_put || b_prep || b_prd || b_acc || b_acd || b_dec;

    uint32_t s1 = 0, s2 = 0, s3 = 0;
    if (b_dget) s1 = env_word(GETOK, J, src, 1u + acc_prop);
    if (b_put) s1 = env_word(PREPARE, J, p0, nb_ballot), s2 = env_word(PREPARE, J, p1, nb_ballot);
    if (b_prep) s1 = env_word(PREPARED, J, src, prep_pay);
    if (b_prd && quorum_p)
      s1 = env_word(ACCEPT, J, p0, acc_pay), s2 = env_word(ACCEPT, J, p1, acc_pay);
    if (b_acc) s1 = env_word(ACCEPTED, J, src, mb);
    if (b_acd && quorum_a) {
      s1 = env_word(DECIDED, J, p0, dec_pay);
      s2 = env_word(DECIDED, J, p1, dec_pay);
      s3 = env_word(PUTOK, J, requester, 0u);
    }
    send[0] = s1, send[1] = s2, send[2] = s3;
  }

  // Client I's handler for a nonzero envelope addressed to it
  // (paxos.py:302-324, the toolkit's RegisterClient).
  template <int I>
  static SRT_HD void client(const uint32_t* row, uint32_t env, uint32_t* out, uint32_t* send,
                            bool* changed) {
    using namespace paxos;
    constexpr uint32_t cid = 3 + I;
    const uint32_t typ = env >> 28;
    send[0] = register_client_deliver<C, I>(row + 6, typ == PUTOK, typ == GETOK, env & kPayMask,
                                            env_word(GET, cid, (cid + 1) % 3, 0u), &out[6 + I],
                                            changed);
    send[1] = send[2] = 0u;
  }

  template <int I>
  static SRT_HD void clients(const uint32_t* row, uint32_t env, uint32_t dst, uint32_t* out,
                             uint32_t* send, bool* changed) {
    if constexpr (I < C) {
      if (dst == 3u + I)
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
      uint32_t send[3] = {0u, 0u, 0u};
      bool changed = false;
      if (env != 0u) {
        const uint32_t dst = (env >> 20) & 15u;
        if (dst == 0u)
          server<0>(row, env, out, send, &changed);
        else if (dst == 1u)
          server<1>(row, env, out, send, &changed);
        else if (dst == 2u)
          server<2>(row, env, out, send, &changed);
        else
          clients<0>(row, env, dst, out, send, &changed);
      }
      uint32_t* cur = out + NA;
      net_remove<K>(net, k, cur);
      net_insert<K>(cur, send[0]);
      net_insert<K>(cur, send[1]);
      net_insert<K>(cur, send[2]);
      const bool mask = env != 0u && (changed || send[0] != 0u || send[1] != 0u || send[2] != 0u);
      sink.put(k, out, mask);
    }
  }
};

}  // namespace srt
