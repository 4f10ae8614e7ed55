"""Single Decree Paxos as a TensorModel (the port's copy of
`stateright_tpu/models/paxos.py`).

The device twin of `examples/paxos.py` (reference: examples/paxos.rs): the
whole actor system — three Paxos servers, `c` register clients, the
unordered non-duplicating network, AND the linearizability tester carried
as the model's history variable — is encoded into fixed uint32 lanes, and
one `step_lanes` evaluates every Deliver action as pure elementwise lane
arithmetic (no reductions, no gathers: quorum counts are 3-bit popcounts,
ballot comparison is integer comparison on a (round<<2|proposer) packing,
and the sorted network multiset is maintained with shift/insert passes).

State identity matches the host `ActorModel` exactly — including the
tester: each client's thread history is determined by its phase
(write-in-flight / read-in-flight / done), the value its read returned,
and the per-peer completed-op counts snapshotted when its read was
invoked (the tester's real-time edges, linearizability.rs:55-66). All of
those are lanes here, so unique-state counts agree with the host model
(16,668 at 2 clients / 3 servers, examples/paxos.rs:327).

BOTH properties run on device: "value chosen" (sometimes) scans the net
for a value-carrying GetOk, and "linearizable" (always) evaluates the
register-linearizability verdict per state as a closed-form lane program
(write-precedence digraph acyclicity — see `linearizable_lanes`), matching
the host model's backtracking-tester verdict (examples/paxos.rs:282-284
parity; oracle-validated in tests/test_paxos_linearizable.py).

Lane layout (S = 6 + c + K lanes, K = 7*c network slots):
  lanes 0..5   server j: [2j] packed core, [2j+1] prepares map
  lanes 6..6+c-1 client i: phase | read value | real-time counters
  remaining K  network: sorted envelope words, 0 = empty (zeros first)
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..lanes import (
    ActorNetModel,
    decode_register_clients,
    register_client_deliver,
    register_linearizable_lanes,
)
from ..tensor import TensorProperty

# Message types (nonzero so an envelope word is never 0).
PUT, GET, PUTOK, GETOK, PREPARE, PREPARED, ACCEPT, ACCEPTED, DECIDED = range(1, 10)

_PAY_MASK = (1 << 20) - 1

# 4-bit actor ids support 3 servers + up to 7 clients (the round-3 3-bit
# packing capped clients at 5, below the reference bench's `paxos check 6`
# workload — bench.sh:31). The widest payload is Prepared's 14 bits,
# comfortably inside the shared 20-bit field (lanes.env_word layout).
from ..lanes import env_word as _env


def _pop3(xp, bits):
    u = xp.uint32
    return (bits & u(1)) + ((bits >> u(1)) & u(1)) + ((bits >> u(2)) & u(1))


class PaxosTensor(ActorNetModel):
    """Device twin of paxos_model(client_count, 3). See module docstring."""

    def __init__(self, client_count: int, server_count: int = 3):
        if server_count != 3:
            raise ValueError("PaxosTensor supports exactly 3 servers")
        if client_count > 7:
            # 4-bit actor ids and 3-bit term rounds both cap out at 7
            # clients — enough for the reference bench's `paxos check 6`.
            raise ValueError("PaxosTensor supports at most 7 clients")
        self.c = client_count
        self.n_servers = 3
        # Bound on simultaneously in-flight messages. Each client keeps at
        # most ONE client-protocol message outstanding (Put/PutOk/Get/GetOk
        # are strict request-response), and term-protocol messages proceed
        # in rounds with at most two broadcast copies plus superseded-term
        # stragglers in flight. Measured maxima over the FULL reachable
        # space: 5 at c=1, 10 at c=2 (5 per client); K = 7c adds a 40%
        # margin, and the "network within capacity" always-property turns
        # any violation into a loud counterexample (rounds 1-3 used 14c:
        # ~1.7x the state width and 4x the net-update arithmetic for
        # nothing).
        self.K = 7 * client_count
        self.n_actor_lanes = 6 + client_count
        self._net_base = self.n_actor_lanes

    # -- init ---------------------------------------------------------------

    def init_states_array(self) -> np.ndarray:
        # on_start: client 3+i sends Put to server (3+i) % 3; the tester's
        # write invocations all carry empty completed-maps (nothing has
        # completed yet), so they need no lanes.
        return self.pack_init_row(
            [],
            [
                (PUT << 28) | ((3 + i) << 24) | ((i % 3) << 20)
                for i in range(self.c)
            ],
        )

    # -- the batched deliver step -------------------------------------------
    #
    # step_lanes is inherited from ActorNetModel: one [K*B]-wide delivery
    # handler + batched sorted-multiset network update (O(K) ops a step).

    def deliver(self, xp, actor_lanes, env):
        new_lanes, m1, m2, m3, changed = self._deliver(xp, actor_lanes, env)
        return new_lanes, [m1, m2, m3], changed

    def _deliver(self, xp, lanes, env):
        """One batched delivery: `lanes` are the NA actor lanes (any width),
        `env` the envelope words. Returns (new actor lanes, send1..3,
        changed)."""
        u = xp.uint32
        c = self.c
        occ = env != u(0)
        typ = env >> u(28)
        src = (env >> u(24)) & u(15)
        dst = (env >> u(20)) & u(15)
        pay = env & u(_PAY_MASK)

        new_lanes = list(lanes)
        changed = occ & False
        sends = []  # per handler: up to 3 envelope words (0 = no send)

        # --- server handlers -------------------------------------
        for j in range(3):
            cond = occ & (dst == u(j))
            a = lanes[2 * j]
            pl = lanes[2 * j + 1]
            ballot = a & u(31)
            prop = (a >> u(5)) & u(7)
            accepts = (a >> u(8)) & u(7)
            acc_pres = (a >> u(11)) & u(1)
            acc_ballot = (a >> u(12)) & u(31)
            acc_prop = (a >> u(17)) & u(7)
            decided = ((a >> u(20)) & u(1)) == u(1)
            mb = pay & u(31)
            peers = [s for s in range(3) if s != j]

            # Get on a decided server: reply with the accepted value
            # (paxos.rs:146-151). No state change.
            b_dget = cond & decided & (typ == u(GET))
            dget_send = _env(
                xp, GETOK, u(j) + (src & u(0)), src, u(1) + acc_prop
            )

            live = cond & ~decided

            # Put on a proposal-less server: start a term
            # (paxos.rs:160-174).
            b_put = live & (typ == u(PUT)) & (prop == u(0))
            nb_ballot = (((ballot >> u(2)) + u(1)) << u(2)) | u(j)
            put_a = (
                nb_ballot
                | ((u(1) + src - u(3)) << u(5))  # proposal = client code
                | (acc_pres << u(11))
                | (acc_ballot << u(12))
                | (acc_prop << u(17))
            )
            # prepares := {(self, accepted)}: only slot j populated.
            put_pl = (
                u(1) | (acc_pres << u(1)) | (acc_ballot << u(2))
                | (acc_prop << u(7))
            ) << u(10 * j)
            put_sends = [
                _env(xp, PREPARE, u(j) + (src & u(0)), u(p) + (src & u(0)), nb_ballot)
                for p in peers
            ]

            # Prepare with a higher ballot: adopt + reply Prepared
            # (paxos.rs:141-145).
            b_prep = live & (typ == u(PREPARE)) & (ballot < mb)
            prep_a = (a & ~u(31)) | mb
            prep_pay = (
                mb | (acc_pres << u(5)) | (acc_ballot << u(6))
                | (acc_prop << u(11))
            )
            prep_send = _env(xp, PREPARED, u(j) + (src & u(0)), src, prep_pay)

            # Prepared for the current ballot: record; on quorum pick the
            # best accepted proposal and broadcast Accept
            # (paxos.rs:147-166).
            b_prd = live & (typ == u(PREPARED)) & (mb == ballot)
            la_pres = (pay >> u(5)) & u(1)
            la_ballot = (pay >> u(6)) & u(31)
            la_prop = (pay >> u(11)) & u(7)
            entry = (
                u(1) | (la_pres << u(1)) | (la_ballot << u(2))
                | (la_prop << u(7))
            )
            # Insert into the src slot of the prepares map.
            npl = pl
            for s in range(3):
                sl = u(10 * s)
                npl = xp.where(
                    b_prd & (src == u(s)),
                    (npl & ~(u(0x3FF) << sl)) | (entry << sl),
                    npl,
                )
            inmap = (
                ((npl >> u(0)) & u(1))
                + ((npl >> u(10)) & u(1))
                + ((npl >> u(20)) & u(1))
            )
            quorum_p = inmap == u(2)  # majority(3) = 2
            # Best accepted entry across in-map slots: key packs
            # (value-present, ballot, proposal) so integer max ==
            # the host's lexicographic max (None sorts lowest).
            best = u(0) * a
            for s in range(3):
                sl = u(10 * s)
                s_in = (npl >> sl) & u(1)
                s_vp = (npl >> (sl + u(1))) & u(1)
                s_b = (npl >> (sl + u(2))) & u(31)
                s_pr = (npl >> (sl + u(7))) & u(7)
                key = xp.where(
                    s_in == u(1),
                    u(1) + ((s_vp << u(8)) | (s_b << u(3)) | s_pr),
                    u(0) * a,
                )
                best = xp.where(key > best, key, best)
            best_vp = ((best - u(1)) >> u(8)) & u(1)
            best_prop = (best - u(1)) & u(7)
            q_prop = xp.where(best_vp == u(1), best_prop, prop)
            prd_a_quorum = (
                ballot
                | (q_prop << u(5))
                | (u(1 << j) << u(8))  # accepts = {self}
                | (u(1) << u(11))  # accepted = (ballot, q_prop)
                | (ballot << u(12))
                | (q_prop << u(17))
            )
            prd_a = xp.where(b_prd & quorum_p, prd_a_quorum, a)
            acc_pay = ballot | (q_prop << u(5))
            prd_sends = [
                _env(
                    xp, ACCEPT, u(j) + (src & u(0)), u(p) + (src & u(0)),
                    acc_pay,
                )
                for p in peers
            ]

            # Accept with ballot >= ours: adopt + reply Accepted
            # (paxos.rs:168-174).
            b_acc = live & (typ == u(ACCEPT)) & (ballot <= mb)
            acc_prop_in = (pay >> u(5)) & u(7)
            acc_a = (
                mb
                | (prop << u(5))
                | (accepts << u(8))
                | (u(1) << u(11))
                | (mb << u(12))
                | (acc_prop_in << u(17))
            )
            acc_send = _env(xp, ACCEPTED, u(j) + (src & u(0)), src, mb)

            # Accepted for the current ballot: count; on quorum decide,
            # broadcast Decided, and ack the requester
            # (paxos.rs:176-187).
            b_acd = live & (typ == u(ACCEPTED)) & (mb == ballot)
            nacc = accepts | (u(1) << src)
            quorum_a = _pop3(xp, nacc) == u(2)
            acd_a = xp.where(
                b_acd & quorum_a,
                (a & ~(u(7) << u(8))) | (nacc << u(8)) | (u(1) << u(20)),
                (a & ~(u(7) << u(8))) | (nacc << u(8)),
            )
            dec_pay = ballot | (prop << u(5))
            requester = u(3) + prop - u(1)
            acd_sends = [
                _env(
                    xp, DECIDED, u(j) + (src & u(0)), u(p) + (src & u(0)),
                    dec_pay,
                )
                for p in peers
            ] + [_env(xp, PUTOK, u(j) + (src & u(0)), requester, u(0) * a)]

            # Decided: adopt unconditionally (paxos.rs:189-195).
            b_dec = live & (typ == u(DECIDED))
            dec_prop_in = (pay >> u(5)) & u(7)
            dec_a = (
                mb
                | (prop << u(5))
                | (accepts << u(8))
                | (u(1) << u(11))
                | (mb << u(12))
                | (dec_prop_in << u(17))
                | (u(1) << u(20))
            )

            # Merge this server's branches into the successor lanes.
            na = a
            na = xp.where(b_put, put_a, na)
            na = xp.where(b_prep, prep_a, na)
            na = xp.where(b_prd, prd_a, na)
            na = xp.where(b_acc, acc_a, na)
            na = xp.where(b_acd, acd_a, na)
            na = xp.where(b_dec, dec_a, na)
            npl_out = xp.where(b_put, put_pl, xp.where(b_prd, npl, pl))
            new_lanes[2 * j] = na
            new_lanes[2 * j + 1] = npl_out
            chg = b_put | b_prep | b_prd | b_acc | b_acd | b_dec
            changed = changed | chg

            zero = u(0) * a
            s1 = zero
            s2 = zero
            s3 = zero
            s1 = xp.where(b_dget, dget_send, s1)
            s1 = xp.where(b_put, put_sends[0], s1)
            s2 = xp.where(b_put, put_sends[1], s2)
            s1 = xp.where(b_prep, prep_send, s1)
            s1 = xp.where(b_prd & quorum_p, prd_sends[0], s1)
            s2 = xp.where(b_prd & quorum_p, prd_sends[1], s2)
            s1 = xp.where(b_acc, acc_send, s1)
            s1 = xp.where(b_acd & quorum_a, acd_sends[0], s1)
            s2 = xp.where(b_acd & quorum_a, acd_sends[1], s2)
            s3 = xp.where(b_acd & quorum_a, acd_sends[2], s3)
            sends.append((s1, s2, s3))

        # --- client handlers (toolkit RegisterClient lane program) ----
        client_lanes = [lanes[6 + j] for j in range(c)]
        for i in range(c):
            cid = 3 + i
            cond = occ & (dst == u(cid))
            get_send = _env(
                xp, GET, u(cid) + (src & u(0)),
                u((cid + 1) % 3) + (src & u(0)), u(0) * env,
            )
            ncl, send, chg = register_client_deliver(
                xp,
                client_lanes,
                i,
                cond & (typ == u(PUTOK)),
                cond & (typ == u(GETOK)),
                pay,
                get_send,
            )
            new_lanes[6 + i] = ncl
            changed = changed | chg
            zero = u(0) * env
            sends.append((send, zero, zero))

        # Exactly one handler fires per delivery (dst is unique), so the
        # per-handler send words OR together.
        m1 = sends[0][0]
        m2 = sends[0][1]
        m3 = sends[0][2]
        for s1, s2, s3 in sends[1:]:
            m1 = m1 | s1
            m2 = m2 | s2
            m3 = m3 | s3
        return new_lanes, m1, m2, m3, changed

    # -- properties ---------------------------------------------------------

    def linearizable_lanes(self, xp, lanes):
        """Register-linearizability verdict — the shared closed-form lane
        program (see lanes.register_linearizable_lanes for the reduction
        and its oracle validation)."""
        return register_linearizable_lanes(
            xp, [lanes[6 + i] for i in range(self.c)]
        )

    def tensor_properties(self) -> List[TensorProperty]:
        NB = self._net_base
        K = self.K

        def value_chosen(xp, lanes):
            u = xp.uint32
            acc = lanes[NB] != lanes[NB]  # all-false, varying
            for m in range(K):
                env = lanes[NB + m]
                is_gok = (env >> u(28)) == u(GETOK)
                val = env & u(15)  # GetOk payload: 1 = None, 2+k = value k
                acc = acc | (is_gok & (val != u(1)))
            return acc

        def ballot_rounds_in_range(xp, lanes):
            # The 3-bit term-round packing caps rounds at 7; a server
            # incrementing past that would silently wrap and MERGE
            # distinct states. Like the net-capacity guard, this turns an
            # encoding-bound violation into a loud counterexample instead
            # of a silently wrong unique count (relevant from c=4 up,
            # where deeper election races could push rounds higher).
            u = xp.uint32
            acc = lanes[0] == lanes[0]  # all-true, varying
            for j in range(3):
                a = lanes[2 * j]
                acc = acc & (((a & u(31)) >> u(2)) < u(7))
                acc = acc & ((((a >> u(12)) & u(31)) >> u(2)) < u(7))
            return acc

        return [
            TensorProperty.always("linearizable", self.linearizable_lanes),
            TensorProperty.sometimes("value chosen", value_chosen),
            self.net_capacity_property(),
            TensorProperty.always(
                "ballot rounds within range", ballot_rounds_in_range
            ),
        ]

    # -- display ------------------------------------------------------------

    def decode_state(self, row) -> dict:
        names = dict(
            zip(
                range(1, 10),
                "Put Get PutOk GetOk Prepare Prepared Accept Accepted Decided".split(),
            )
        )
        net = []
        for m in range(self.K):
            env = int(row[self._net_base + m])
            if env:
                net.append(
                    f"{names[env >> 28]}({(env >> 24) & 15}->{(env >> 20) & 15},"
                    f" pay={env & _PAY_MASK:#x})"
                )
        servers = []
        for j in range(3):
            a = int(row[2 * j])
            servers.append(
                {
                    "ballot": (a & 31) >> 2,
                    "proposer": a & 3,
                    "proposal": (a >> 5) & 7,
                    "accepts": (a >> 8) & 7,
                    "accepted": ((a >> 12) & 31, (a >> 17) & 7)
                    if (a >> 11) & 1
                    else None,
                    "decided": bool((a >> 20) & 1),
                }
            )
        clients = decode_register_clients(row, 6, self.c)
        return {"servers": servers, "clients": clients, "net": net}


class PaxosTensorExhaustive(PaxosTensor):
    """Compatibility alias from rounds 1-3.

    Historically PaxosTensor lacked the "linearizable" always-property on
    device, so exhaustive runs needed an extra never-satisfied blocker
    here. Now that "linearizable" is evaluated on device (never violated,
    so the default finish_when=ALL explores to exhaustion exactly like the
    host model), the base class already has the right behavior.
    """
