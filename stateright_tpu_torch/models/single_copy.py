"""Single-copy register as a TensorModel (the port's copy of
`stateright_tpu/models/single_copy.py`).

The device twin of `examples/single_copy_register.py` (reference:
examples/single-copy-register.rs): `s` independent register servers (no
consensus — a server stores whatever it was last told and answers reads
from its own copy) plus `c` toolkit register clients. With one server the
system is linearizable; with two, a client that writes to server 0 and
reads from server 1 gets None back — a completed read that cannot
linearize past the client's own completed write. The shared
`register_linearizable_lanes` program finds that counterexample on the card,
which makes this twin the toolkit's only register-family member whose
linearizability property actually FIRES on a real (un-mutated) protocol.

Server state is one lane: the stored value (0 = None, 1..c = client i's
value). In-flight bound: exactly c (every client keeps one request-
response message outstanding and servers reply in the same delivery) —
and the protocol SITS at that bound, so the ring carries one slack slot
(K = c + 1) to keep the `net_capacity_property` guard meaningful: slot 0
nonzero then really means the bound was exceeded, not merely reached.

Lane layout (S = s + c + K):
  lanes 0..s-1     server j: stored value
  lanes s..s+c-1   client i: shared register-client tester packing
  remaining K      network: sorted envelope words, 0 = empty
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

PUT, GET, PUTOK, GETOK = range(1, 5)


class SingleCopyTensor(ActorNetModel):
    """Device twin of single_copy_model(client_count, server_count)."""

    max_sends = 1

    def __init__(self, client_count: int, server_count: int = 1):
        if not 1 <= server_count <= 4:
            raise ValueError("SingleCopyTensor supports 1-4 servers")
        if client_count > 5:
            raise ValueError("SingleCopyTensor supports at most 5 clients")
        self.c = client_count
        self.s = server_count
        self.K = client_count + 1
        self.n_actor_lanes = server_count + client_count

    # -- init ---------------------------------------------------------------

    def init_states_array(self) -> np.ndarray:
        s, c = self.s, self.c
        # Client m (= s + i) sends Put(request_id=m, value=i+1) to m % s.
        puts = [
            (PUT << 28) | ((s + i) << 24) | (((s + i) % s) << 20)
            | (s + i) | ((i + 1) << 4)
            for i in range(c)
        ]
        return self.pack_init_row([0] * s, puts)

    # -- the batched delivery handler ---------------------------------------

    def deliver(self, xp, lanes, env):
        u = xp.uint32
        s, c = self.s, self.c
        occ = env != u(0)
        typ = env >> u(28)
        src = (env >> u(24)) & u(15)
        dst = (env >> u(20)) & u(15)
        pay = env & u((1 << 20) - 1)
        rid = pay & u(15)

        new_lanes = list(lanes)
        changed = occ & False
        send = u(0) * env

        for j in range(s):
            cond = occ & (dst == u(j))
            val = lanes[j]
            b_put = cond & (typ == u(PUT))
            b_get = cond & (typ == u(GET))
            # Put: store, ack (single-copy-register.rs:27-33).
            new_lanes[j] = xp.where(b_put, (pay >> u(4)) & u(7), val)
            put_send = env_word(xp, PUTOK, u(j) + (src & u(0)), src, rid)
            # Get: answer from the local copy; tester code 1+val maps the
            # empty register to None (single-copy-register.rs:35-41).
            get_send = env_word(
                xp, GETOK, u(j) + (src & u(0)), src,
                rid | ((val + u(1)) << u(4)),
            )
            send = send | xp.where(b_put, put_send, u(0) * env)
            send = send | xp.where(b_get, get_send, u(0) * env)
            changed = changed | b_put

        client_lanes = [lanes[s + i] for i in range(c)]
        for i in range(c):
            cid = s + i
            cond = occ & (dst == u(cid))
            get_env = env_word(
                xp, GET, u(cid) + (src & u(0)),
                u((cid + 1) % s) + (src & u(0)), u(2 * cid),
            )
            ncl, csend, chg = register_client_deliver(
                xp,
                client_lanes,
                i,
                cond & (typ == u(PUTOK)),
                cond & (typ == u(GETOK)),
                (pay >> u(4)) & u(15),
                get_env,
            )
            new_lanes[s + i] = ncl
            changed = changed | chg
            send = send | csend

        return new_lanes, [send], changed

    # -- properties ---------------------------------------------------------

    def linearizable_lanes(self, xp, lanes):
        return register_linearizable_lanes(
            xp, [lanes[self.s + i] for i in range(self.c)]
        )

    def tensor_properties(self) -> List[TensorProperty]:
        return register_family_properties(self, GETOK, val_shift=4)

    # -- display ------------------------------------------------------------

    def decode_state(self, row) -> dict:
        names = dict(zip(range(1, 5), "Put Get PutOk GetOk".split()))
        return {
            "servers": [int(row[j]) for j in range(self.s)],
            "clients": decode_register_clients(row, self.s, self.c),
            "net": decode_net(row, self.n_actor_lanes, self.K, names),
        }
