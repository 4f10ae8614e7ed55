"""ABD linearizable register as a TensorModel (the port's copy of
`stateright_tpu/models/abd.py`).

The device twin of `examples/linearizable_register.py` (reference:
examples/linearizable-register.rs:60-255): two ABD servers, `c` register
clients, the unordered non-duplicating network, and the linearizability
tester carried as state — all encoded on the `lanes.ActorNetModel`
toolkit, proving the toolkit generalizes beyond the paxos twin it was
extracted from.

Protocol (Attiya-Bar-Noy-Dolev): phase 1 queries a quorum for the highest
(logical-clock, server-id) sequencer; phase 2 records the chosen
value/sequencer at a quorum before replying. With s=2 servers the quorum
is both servers, which simplifies the lane program: the self-response
means ONE AckQuery reaches quorum and ONE AckRecord completes phase 2.

State identity matches the host `ActorModel` exactly (544 unique states
at 2 clients / 2 servers, linearizable-register.rs:287), including the
tester lanes (client phases, read values, real-time counters — the shared
register-client packing in stateright_tpu.lanes).

In-flight bound K = c + 2: each client has at most one client-protocol
message outstanding (Put/PutOk/Get/GetOk are strict request-response),
and each server at most one internal message per active phase (Query ->
AckQuery -> Record -> AckRecord are sequential, and with s=2 every ack is
consumed before the phase advances). Golden-validated against the actor
model.

Lane layout (S = 4 + c + K):
  lanes 0..3    server j: [2j] core (seq|val|ptag|rid|requester|wval),
                [2j+1] phase detail (P1 response map / P2 read+acks)
  lanes 4..4+c-1 client i: shared register-client tester packing
  remaining K   network: sorted envelope words, 0 = empty
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..lanes import (
    ActorNetModel,
    decode_net,
    decode_register_clients,
    env_word,
    register_client_deliver,
    register_family_properties,
    register_linearizable_lanes,
)
from ..tensor import TensorProperty

# Message types (nonzero so an envelope word is never 0).
PUT, GET, PUTOK, GETOK, QUERY, ACKQUERY, RECORD, ACKRECORD = range(1, 9)

# Server core-lane field offsets.
_SEQ = 0  # 5 bits: clock(4) << 1 | server_id(1); lex order == int order
_VAL = 5  # 3 bits: 0 = None, 1..c = client (id-2)'s value
_PTAG = 8  # 2 bits: 0 = idle, 1 = phase 1, 2 = phase 2
_RID = 10  # 4 bits
_REQ = 14  # 4 bits: requester actor id
_WVAL = 18  # 3 bits: phase-1 pending write value; 0 = read

# Phase-detail lane (overlaid; _PTAG disambiguates, idle == 0).
# P1: per-server response slot t: present(1) | seq(5) | val(3) at 9*t.
# P2: is_read(1) @0 | read code(4) @1 | acks set(2) @5.


class AbdTensor(ActorNetModel):
    """Device twin of abd_model(client_count, 2). See module docstring."""

    max_sends = 1  # s=2: every delivery sends at most one message

    def __init__(self, client_count: int, server_count: int = 2):
        if server_count != 2:
            raise ValueError("AbdTensor supports exactly 2 servers")
        if client_count > 5:
            raise ValueError(
                "AbdTensor supports at most 5 clients (4-bit request ids)"
            )
        self.c = client_count
        self.n_servers = 2
        self.K = client_count + 2
        self.n_actor_lanes = 4 + client_count

    # -- init ---------------------------------------------------------------

    def init_states_array(self) -> np.ndarray:
        # Server j starts as AbdState(seq=(0, j), val=None, phase=None):
        # seq packs to j, everything else zero. Client m (= 2 + i) sends
        # Put(request_id=m, value=i+1) to server m % 2 on start.
        servers = [0, 0, 1, 0]  # [seq lane j=0, detail, seq lane j=1, detail]
        puts = [
            (PUT << 28) | ((2 + i) << 24) | (((2 + i) % 2) << 20)
            | (2 + i) | ((i + 1) << 4)
            for i in range(self.c)
        ]
        return self.pack_init_row(servers, puts)

    # -- the batched delivery handler ---------------------------------------

    def deliver(self, xp, lanes, env):
        u = xp.uint32
        c = self.c
        occ = env != u(0)
        typ = env >> u(28)
        src = (env >> u(24)) & u(15)
        dst = (env >> u(20)) & u(15)
        pay = env & u((1 << 20) - 1)
        rid = pay & u(15)
        mseq = (pay >> u(4)) & u(31)
        mval = (pay >> u(9)) & u(7)

        new_lanes = list(lanes)
        changed = occ & False
        send = u(0) * env

        for j in range(2):
            cond = occ & (dst == u(j))
            a = lanes[2 * j]
            b = lanes[2 * j + 1]
            seq = (a >> u(_SEQ)) & u(31)
            val = (a >> u(_VAL)) & u(7)
            ptag = (a >> u(_PTAG)) & u(3)
            my_rid = (a >> u(_RID)) & u(15)
            req = (a >> u(_REQ)) & u(15)
            wval = (a >> u(_WVAL)) & u(7)
            peer = 1 - j

            # Put/Get on an idle server: open phase 1 with the self
            # response recorded, query the peer
            # (linearizable-register.rs:107-127).
            is_start = (typ == u(PUT)) | (typ == u(GET))
            b_start = cond & is_start & (ptag == u(0))
            start_wval = xp.where(typ == u(PUT), (pay >> u(4)) & u(7), u(0) * env)
            start_a = (
                (seq << u(_SEQ))
                | (val << u(_VAL))
                | (u(1) << u(_PTAG))
                | (rid << u(_RID))
                | (src << u(_REQ))
                | (start_wval << u(_WVAL))
            )
            # P1 detail: self slot j present with (seq, val).
            start_b = (u(1) | (seq << u(1)) | (val << u(6))) << u(9 * j)
            start_send = env_word(
                xp, QUERY, u(j) + (src & u(0)), u(peer) + (src & u(0)), rid
            )

            # Query: reply with our (seq, val) — unconditional, stateless
            # (linearizable-register.rs:129-131).
            b_query = cond & (typ == u(QUERY))
            query_send = env_word(
                xp, ACKQUERY, u(j) + (src & u(0)), src,
                rid | (seq << u(4)) | (val << u(9)),
            )

            # AckQuery for the open phase 1: with s=2 the peer's response
            # completes the quorum immediately (self response counts).
            # Choose max-seq (seqs are globally distinct), then move to
            # phase 2 and Record at the peer
            # (linearizable-register.rs:133-165).
            b_ackq = cond & (typ == u(ACKQUERY)) & (ptag == u(1)) & (rid == my_rid)
            self_seq = (b >> u(9 * j + 1)) & u(31)
            self_val = (b >> u(9 * j + 6)) & u(7)
            peer_better = mseq > self_seq
            best_seq = xp.where(peer_better, mseq, self_seq)
            best_val = xp.where(peer_better, mval, self_val)
            is_read = wval == u(0)
            # Write: bump the clock, tag with our id. Read: keep best.
            chosen_seq = xp.where(
                is_read, best_seq, (((best_seq >> u(1)) + u(1)) << u(1)) | u(j)
            )
            chosen_val = xp.where(is_read, best_val, wval)
            read_code = best_val + u(1)  # 0->1 (None), v -> 2+(v-1)
            # Self-record: adopt (chosen_seq, chosen_val) if greater.
            adopt = chosen_seq > seq
            ackq_a = (
                (xp.where(adopt, chosen_seq, seq) << u(_SEQ))
                | (xp.where(adopt, chosen_val, val) << u(_VAL))
                | (u(2) << u(_PTAG))
                | (my_rid << u(_RID))
                | (req << u(_REQ))
            )
            ackq_b = (
                xp.where(is_read, u(1), u(0))
                | (xp.where(is_read, read_code, u(0) * env) << u(1))
                | (u(1 << j) << u(5))  # acks = {self}
            )
            ackq_send = env_word(
                xp, RECORD, u(j) + (src & u(0)), u(peer) + (src & u(0)),
                my_rid | (chosen_seq << u(4)) | (chosen_val << u(9)),
            )

            # Record: ack, and adopt the recorded (seq, val) if greater
            # (linearizable-register.rs:167-172).
            b_rec = cond & (typ == u(RECORD))
            rec_adopt = mseq > seq
            rec_a = (
                (xp.where(rec_adopt, mseq, seq) << u(_SEQ))
                | (xp.where(rec_adopt, mval, val) << u(_VAL))
                | (a & ~u((31 << _SEQ) | (7 << _VAL)))
            )
            rec_send = env_word(
                xp, ACKRECORD, u(j) + (src & u(0)), src, rid
            )

            # AckRecord for the open phase 2: with s=2 the peer's ack
            # completes the quorum; reply to the requester and go idle
            # (linearizable-register.rs:174-189).
            acks = (b >> u(5)) & u(3)
            src_bit = u(1) << src  # src is 0 or 1 here (a server id)
            b_ackr = (
                cond
                & (typ == u(ACKRECORD))
                & (ptag == u(2))
                & (rid == my_rid)
                & ((acks & src_bit) == u(0))
            )
            p2_is_read = (b & u(1)) == u(1)
            p2_code = (b >> u(1)) & u(15)
            ackr_a = (seq << u(_SEQ)) | (val << u(_VAL))  # idle: clears phase
            done_send = xp.where(
                p2_is_read,
                env_word(xp, GETOK, u(j) + (src & u(0)), req, my_rid | (p2_code << u(4))),
                env_word(xp, PUTOK, u(j) + (src & u(0)), req, my_rid),
            )

            na = a
            nb = b
            na = xp.where(b_start, start_a, na)
            nb = xp.where(b_start, start_b, nb)
            na = xp.where(b_ackq, ackq_a, na)
            nb = xp.where(b_ackq, ackq_b, nb)
            na = xp.where(b_rec, rec_a, na)
            na = xp.where(b_ackr, ackr_a, na)
            nb = xp.where(b_ackr, u(0) * env, nb)
            new_lanes[2 * j] = na
            new_lanes[2 * j + 1] = nb
            changed = changed | b_start | b_ackq | (b_rec & rec_adopt) | b_ackr

            s = u(0) * env
            s = xp.where(b_start, start_send, s)
            s = xp.where(b_query, query_send, s)
            s = xp.where(b_ackq, ackq_send, s)
            s = xp.where(b_rec, rec_send, s)
            s = xp.where(b_ackr, done_send, s)
            send = send | s

        # Clients: the shared RegisterClient lane program.
        client_lanes = [lanes[4 + i] for i in range(c)]
        for i in range(c):
            cid = 2 + i
            cond = occ & (dst == u(cid))
            get_send = env_word(
                xp, GET, u(cid) + (src & u(0)),
                u((cid + 1) % 2) + (src & u(0)), u(2 * cid),
            )
            ncl, csend, chg = register_client_deliver(
                xp,
                client_lanes,
                i,
                cond & (typ == u(PUTOK)),
                cond & (typ == u(GETOK)),
                (pay >> u(4)) & u(15),
                get_send,
            )
            new_lanes[4 + i] = ncl
            changed = changed | chg
            send = send | csend

        return new_lanes, [send], changed

    # -- properties ---------------------------------------------------------

    def linearizable_lanes(self, xp, lanes):
        return register_linearizable_lanes(
            xp, [lanes[4 + i] for i in range(self.c)]
        )

    def tensor_properties(self) -> List[TensorProperty]:
        return register_family_properties(self, GETOK, val_shift=4)

    # -- display ------------------------------------------------------------

    def decode_state(self, row) -> dict:
        names = dict(
            zip(
                range(1, 9),
                "Put Get PutOk GetOk Query AckQuery Record AckRecord".split(),
            )
        )
        servers = []
        for j in range(2):
            a = int(row[2 * j])
            servers.append(
                {
                    "seq": ((a >> 1) & 15, a & 1),
                    "val": (a >> _VAL) & 7,
                    "phase": (a >> _PTAG) & 3,
                    "rid": (a >> _RID) & 15,
                }
            )
        clients = decode_register_clients(row, 4, self.c)
        return {
            "servers": servers,
            "clients": clients,
            "net": decode_net(row, self.n_actor_lanes, self.K, names),
        }


class AbdOrderedTensor(AbdTensor):
    """ABD over the ORDERED network: per-flow FIFO, head-only delivery.

    Device twin of `abd_model(c, 2, Network.new_ordered())` — the
    reference's `linearizable-register check N ordered` workload
    (bench.sh:33; Ordered semantics network.rs:62-68, head-of-flow rule
    model.rs:269-275). The toolkit's ordered mode (lanes.net_step_ordered)
    supplies the flow-rank encoding; the delivery handler is inherited
    unchanged (ABD payloads fit the 16-bit ordered payload field).

    Host-oracle goldens (exhaustive actor-model runs): 620 uniques at
    c=2, 46,516 at c=3; linearizable HOLDS on both.
    """

    ordered = True
