"""The actor-system encoding toolkit: reusable lane programs for building
TensorModel twins of ActorModels (the port's copy of
`stateright_tpu/lanes.py`; its bool-to-lane casts are written
``xp.where(mask, u(1), u(0))``, see `xp.py`).

This generalizes what `models/paxos.py` originally hand-rolled (SURVEY.md
§7 step 3's "hard part" — mapping an actor system onto fixed uint32
lanes), so new twins write ONE batched delivery handler and inherit the
rest:

  - `ActorNetModel`: a TensorModel base that owns the network encoding —
    an ascending-sorted bounded multiset of envelope words (zeros-first,
    so equal multisets have equal lanes and the stream fingerprint is
    order-insensitive by construction), with the whole step evaluated at
    [K*B] width: ONE delivery-handler instance and ONE removal + M
    sorted-insert network update instead of K unrolled copies (the op
    count stays O(K)).
  - envelope packing helpers (`env_word`, `env_fields`): the shared
    typ(4b) | src(4b) | dst(4b) | payload(20b) word layout.
  - `register_client_deliver`: the reference's reusable `RegisterClient`
    (actor/register.rs:93-275) as a lane program — put_count=1 protocol
    phases, read values, and the per-peer completed-op counters that
    carry the linearizability tester's real-time edges as state.
  - `register_linearizable_lanes`: the closed-form register
    linearizability verdict (write-precedence digraph acyclicity) shared
    by every register-family twin; oracle-validated against the
    backtracking `LinearizabilityTester` in
    tests/test_paxos_linearizable.py.

Everything here is pure elementwise array code valid under both numpy and
the port's torch `xp` — the host adapter runs the same programs
row-at-a-time for path reconstruction.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .tensor import TensorModel, TensorProperty

_PAY_BITS = 20
PAY_MASK = (1 << _PAY_BITS) - 1


def env_word(xp, typ, src, dst, pay):
    """Envelope word: typ(4b)<<28 | src(4b)<<24 | dst(4b)<<20 | payload.

    4-bit actor ids address up to 16 actors; message types are 1-based so
    an envelope word is never zero (zero = empty network slot).
    """
    u = xp.uint32
    return (u(typ) << u(28)) | (src << u(24)) | (dst << u(20)) | pay


def env_fields(xp, env):
    """(typ, src, dst, pay) field views of an envelope word array."""
    u = xp.uint32
    return (
        env >> u(28),
        (env >> u(24)) & u(15),
        (env >> u(20)) & u(15),
        env & u(PAY_MASK),
    )


# Ordered-network rank field: per-flow FIFO position, stored in the top
# nibble of the payload area (typ|src|dst|rank(4)|pay(16)). Handlers see
# rank-stripped envelopes and emit rank-less sends; the ordered network
# update assigns and maintains ranks. 4 bits suffice: a flow can hold at
# most K <= 16 messages.
RANK_SHIFT = 16
RANK_FIELD = 0xF << RANK_SHIFT
ORDERED_PAY_MASK = (1 << RANK_SHIFT) - 1


def _flow_id(xp, env):
    """(src, dst) flow key of an envelope word (bits 20-27)."""
    return (env >> xp.uint32(20)) & xp.uint32(0xFF)


def net_step_ordered(xp, net, slot_id, sends):
    """One batched ORDERED network update over the [K*B] delivery batch.

    The reference's Ordered semantics (src/actor/network.rs:62-68: per
    directed (src, dst) flow FIFO; only heads deliverable, enforced at
    model.rs:269-275) encoded on the same sorted K-slot ring: every
    envelope carries its per-flow rank in the word (see RANK_SHIFT), so
    per-flow SEQUENCES — not just multisets — determine state identity,
    and "deliverable" is the elementwise test rank == 0.

    Steps, all elementwise: remove the delivered slot (callers only
    deliver rank-0 envelopes); decrement the rank of every other envelope
    in the delivered flow; restore sortedness (the decrements can reorder
    words) with an odd-even transposition pass; then insert each send
    with rank = its flow's current depth.
    """
    u = xp.uint32
    K = len(net)
    env_all = xp.concatenate(net)
    delivered_occ = env_all != u(0)
    dflow = _flow_id(xp, env_all)
    bignet = [xp.concatenate([net[m]] * K) for m in range(K)]
    # Remove the delivered slot: entries below it shift up one.
    cur = [
        xp.where(
            slot_id >= u(m),
            bignet[m - 1] if m > 0 else u(0) * env_all,
            bignet[m],
        )
        for m in range(K)
    ]
    # Decrement ranks within the delivered flow.
    cur = [
        xp.where(
            delivered_occ & (c != u(0)) & (_flow_id(xp, c) == dflow),
            c - u(1 << RANK_SHIFT),
            c,
        )
        for c in cur
    ]
    # Odd-even transposition restores ascending order (zeros first: 0 is
    # the minimum word). K passes guarantee a full sort.
    for p in range(K):
        start = p & 1
        for m in range(start, K - 1, 2):
            lo = xp.minimum(cur[m], cur[m + 1])
            hi = xp.maximum(cur[m], cur[m + 1])
            cur[m] = lo
            cur[m + 1] = hi
    # Insert sends at their flow tails (rank = current flow depth).
    for v in sends:
        # Handlers must emit rank-less envelopes (payloads limited to the
        # ORDERED_PAY_MASK 16 bits); mask the rank nibble regardless, so a
        # handler payload that strays into bits 16-19 cannot pre-load a
        # bogus rank and corrupt per-flow FIFO ordering when the real rank
        # is OR'd in below.
        v = v & ~u(RANK_FIELD)
        has = v != u(0)
        vflow = _flow_id(xp, v)
        depth = u(0) * v
        for m in range(K):
            depth = depth + xp.where(
                (cur[m] != u(0)) & (_flow_id(xp, cur[m]) == vflow), u(1), u(0)
            )
        vr = v | (depth << u(RANK_SHIFT))
        rank = u(0) * v
        for m in range(1, K):
            rank = rank + xp.where(cur[m] < vr, u(1), u(0))
        nxt = []
        for m in range(K):
            shifted = cur[m + 1] if m + 1 < K else vr
            placed = xp.where(
                u(m) < rank,
                shifted,
                xp.where(u(m) == rank, vr, cur[m]),
            )
            nxt.append(xp.where(has, placed, cur[m]))
        cur = nxt
    return cur


def net_step(xp, net, slot_id, sends):
    """One batched network update over the [K*B] delivery batch.

    `net` is the K per-slot lane list (each [B]); `slot_id[j]` names the
    slot the j-th batch segment delivers; `sends` are up-to-M envelope
    word arrays at [K*B] width (0 = no send). Returns the K updated net
    lanes at [K*B] width: the delivered slot removed from the ascending
    zeros-first ring, then each send inserted in sorted position. All
    elementwise — insertion ranks are lane-wise popcounts, not
    reductions.
    """
    u = xp.uint32
    K = len(net)
    env_all = xp.concatenate(net)
    bignet = [xp.concatenate([net[m]] * K) for m in range(K)]
    # Remove the delivered slot: entries below it shift up one.
    cur = [
        xp.where(
            slot_id >= u(m),
            bignet[m - 1] if m > 0 else u(0) * env_all,
            bignet[m],
        )
        for m in range(K)
    ]
    for v in sends:
        has = v != u(0)
        rank = u(0) * v
        for m in range(1, K):
            rank = rank + xp.where(cur[m] < v, u(1), u(0))
        nxt = []
        for m in range(K):
            shifted = cur[m + 1] if m + 1 < K else v
            placed = xp.where(
                u(m) < rank,
                shifted,
                xp.where(u(m) == rank, v, cur[m]),
            )
            nxt.append(xp.where(has, placed, cur[m]))
        cur = nxt
    return cur


class ActorNetModel(TensorModel):
    """TensorModel base for actor systems over the bounded multiset network.

    State layout: `n_actor_lanes` actor lanes followed by `K` network
    lanes (ascending-sorted envelope words, zeros first). Subclasses
    define:

      - `n_actor_lanes`, `K` (net capacity = max simultaneously in-flight
        messages; derive it from the protocol and validate against the
        actor-model goldens), and optionally `max_sends` (<= 4),
      - `deliver(xp, actor_lanes, env) -> (new_actor_lanes, sends,
        changed)`: the batched delivery handler — `env` may be zero
        (empty slot; the result is masked out), `sends` is a list of
        up-to-max_sends envelope word arrays (0 = no send),
      - `init_states_array()` (use `pack_init_row` for the common
        single-init case).

    `step_lanes` then evaluates every Deliver action as one [K*B]-wide
    handler + network update. A successor is valid iff its slot held a
    message AND the delivery changed something (actor state or a send) —
    the reference ActorModel's no-op delivery pruning (model.rs parity
    via `examples/paxos.py`).
    """

    max_sends = 3
    # Ordered mode (reference Network::Ordered, network.rs:62-68): per-flow
    # FIFO with head-only delivery. Envelope words carry a per-flow rank
    # nibble (see net_step_ordered); handlers still see rank-less words
    # and payloads are limited to 16 bits instead of 20.
    ordered = False

    @property
    def state_width(self) -> int:  # type: ignore[override]
        return self.n_actor_lanes + self.K

    @property
    def max_actions(self) -> int:  # type: ignore[override]
        return self.K

    # -- subclass interface --------------------------------------------------

    n_actor_lanes: int
    K: int

    def deliver(self, xp, actor_lanes, env):
        raise NotImplementedError

    # -- shared machinery ----------------------------------------------------

    def pack_init_row(self, actor_values, envelopes) -> np.ndarray:
        """One init row from per-actor lane ints + initial envelope words.

        In ordered mode, envelope list order is send order: each envelope
        gets its per-flow FIFO rank before the canonical sort.
        """
        row = np.zeros(self.state_width, dtype=np.uint32)
        row[: len(actor_values)] = actor_values
        if self.ordered:
            depth: dict = {}
            ranked = []
            for env in envelopes:
                flow = (env >> 20) & 0xFF
                r = depth.get(flow, 0)
                depth[flow] = r + 1
                ranked.append(env | (r << RANK_SHIFT))
            envelopes = ranked
        env_sorted = sorted(envelopes)
        base = self.n_actor_lanes + self.K - len(env_sorted)
        for k, env in enumerate(env_sorted):
            row[base + k] = env
        return row[None, :]

    def net_lanes(self, lanes):
        return list(lanes[self.n_actor_lanes : self.n_actor_lanes + self.K])

    def net_scan(self, xp, lanes, fn):
        """OR of `fn(env)` over every (possibly empty) net slot."""
        acc = lanes[0] != lanes[0]
        for m in range(self.K):
            acc = acc | fn(lanes[self.n_actor_lanes + m])
        return acc

    def net_capacity_property(self):
        """An always-property guarding the in-flight bound K.

        The sorted ring keeps zeros (empty slots) first, so slot 0 being
        nonzero means all K slots are occupied — one more send would
        silently drop the smallest envelope. Size K with at least ONE slot
        of slack above the protocol's derived in-flight bound: a strict
        request-response protocol legitimately SITS at its bound (e.g. the
        single-copy register holds exactly c messages from the initial
        state on), and a slack-free ring would trip this guard on every
        reachable state. K bounds are derived from the
        protocol and validated against actor-model goldens; this property
        turns a bound violation into a LOUD counterexample instead of a
        silent state-space corruption, which is what makes empirically
        tightened bounds (state width and step arithmetic scale with K and
        K^2) safe to use. Include it in `tensor_properties()`.

        Detection-lag caveat (for protocols with max_sends > 1, e.g.
        paxos): one slot of slack guarantees drop-BEFORE-detection cannot
        happen only for single-send transitions. A delivery from a passing
        state at occupancy K-1 that inserts multiple sends drops the
        smallest envelope in the same transition that first trips this
        guard, so the flagged counterexample state may already have lost
        one envelope. The VERDICT is still sound (the violation is
        detected loudly and the run never continues past it); only the
        flagged state's network contents may be one drop stale. Sizing K
        with max_sends slots of slack removes the lag at the cost of a
        wider state."""
        NB = self.n_actor_lanes

        def within_capacity(xp, lanes):
            return lanes[NB] == xp.uint32(0)

        return TensorProperty.always("network within capacity", within_capacity)

    def step_lanes(self, xp, lanes):
        u = xp.uint32
        K = self.K
        NA = self.n_actor_lanes
        net = self.net_lanes(lanes)
        B = lanes[0].shape[0]

        env_all = xp.concatenate(net)
        if self.ordered:
            # Handlers see rank-stripped envelopes; only flow heads
            # (rank 0) are deliverable (model.rs:269-275).
            deliverable = (env_all != u(0)) & (
                (env_all & u(RANK_FIELD)) == u(0)
            )
            env_h = env_all & ~u(RANK_FIELD)
        else:
            env_h = env_all
        big = [xp.concatenate([lanes[t]] * K) for t in range(NA)]
        new_actor, sends, changed = self.deliver(xp, big, env_h)
        assert len(sends) <= self.max_sends

        slot_id = xp.concatenate(
            [xp.full(B, k, dtype=xp.uint32) for k in range(K)]
        )
        if self.ordered:
            cur = net_step_ordered(xp, net, slot_id, sends)
            # No-op deliveries are NOT pruned on the ordered network — the
            # delivery itself mutates the flow (model.rs:345-347).
            mask_all = deliverable
        else:
            cur = net_step(xp, net, slot_id, sends)
            sent_any = env_all != env_all  # all-false, varying
            for v in sends:
                sent_any = sent_any | (v != u(0))
            mask_all = (env_all != u(0)) & (changed | sent_any)

        succs = []
        masks = []
        for k in range(K):
            seg = slice(k * B, (k + 1) * B)
            new_lanes = list(lanes)
            for t in range(NA):
                new_lanes[t] = new_actor[t][seg]
            for m in range(K):
                new_lanes[NA + m] = cur[m][seg]
            succs.append(tuple(new_lanes))
            masks.append(mask_all[seg])
        return succs, masks

    def format_action(self, k: int) -> str:
        return f"Deliver[net slot {k}]"


# -- the register-client tester as lanes -------------------------------------
#
# Client lane packing (identical across register-family twins, so the
# linearizability program below is shared):
#   bits 0-1   phase: 0 = write in flight, 1 = read in flight, 2 = done
#   bits 2-5   read value: 0 = n/a, 1 = None, 2+k = writer k's value
#   bits 6+2p  peer p's phase snapshotted when this client's read was
#              invoked (the tester's real-time edges,
#              linearizability.rs:55-66) — skipping p == self.


def register_client_deliver(
    xp, client_lanes, i, cond_putok, cond_getok, getok_val, get_env
):
    """The put_count=1 RegisterClient's delivery handler for client i.

    `cond_putok`/`cond_getok`: this delivery completes the client's
    write/read; `getok_val`: the 4-bit read value payload; `get_env`: the
    Get envelope to send when the write completes (the read is invoked in
    the same atomic step, register.rs:131-146). Returns (new client lane,
    send word, changed).
    """
    u = xp.uint32
    c = len(client_lanes)
    cl = client_lanes[i]
    phase = cl & u(3)

    b_pok = cond_putok & (phase == u(0))
    ncl = (cl & ~u(3)) | u(1)
    for p in range(c):
        if p == i:
            continue
        peer_phase = client_lanes[p] & u(3)
        ncl = (ncl & ~(u(3) << u(6 + 2 * p))) | (peer_phase << u(6 + 2 * p))

    b_gok = cond_getok & (phase == u(1))
    gok_cl = (cl & ~u(0x3F)) | u(2) | ((getok_val & u(15)) << u(2))

    out = cl
    out = xp.where(b_pok, ncl, out)
    out = xp.where(b_gok, gok_cl, out)
    send = xp.where(b_pok, get_env, u(0) * cl)
    return out, send, b_pok | b_gok


def register_linearizable_lanes(xp, client_lanes):
    """Batched register-linearizability verdict from client lanes.

    For the register workload (every client invokes its unique-valued
    write at time zero and reads only after its own write completes) a
    linearization exists iff an ordering σ of the c writes satisfies, for
    every COMPLETED read_j returning value k_j:

      - gap placement: read_j sits immediately after write_{k_j} in σ,
      - its own write precedes it:                     j   <σ k_j,
      - every write completed before read_j invoked:   i   <σ k_j,
      - every read completed before read_j invoked:    k_i <σ k_j.

    All constraints are binary precedences over c nodes, so existence is
    ACYCLICITY of the induced digraph — adjacency bitmask rows plus a
    log-depth transitive closure, pure elementwise. A completed read
    returning None fails directly (its own write precedes it). Oracle-
    validated against the backtracking tester in
    tests/test_paxos_linearizable.py.
    """
    u = xp.uint32
    c = len(client_lanes)
    cl = client_lanes
    phase = [cl[i] & u(3) for i in range(c)]
    val = [(cl[i] >> u(2)) & u(15) for i in range(c)]
    done = [phase[i] == u(2) for i in range(c)]
    kk = [(val[i] - u(2)) & u(15) for i in range(c)]

    false_ = cl[0] != cl[0]
    none_read = false_
    zero = u(0) * cl[0]
    adj = [zero for _ in range(c)]  # bit t of adj[r]: edge r -> t

    def set_edge(row_static, tgt, cond):
        e = xp.where(cond & (tgt != u(row_static)), u(1) << tgt, zero)
        adj[row_static] = adj[row_static] | e

    for j in range(c):
        rj = done[j]
        none_read = none_read | (rj & (val[j] == u(1)))
        set_edge(j, kk[j], rj)  # own write precedes own read
        for i in range(c):
            if i == j:
                continue
            cij = (cl[j] >> u(6 + 2 * i)) & u(3)
            set_edge(i, kk[j], rj & (cij >= u(1)))
            rr = rj & (cij == u(2))
            for r in range(c):
                set_edge(r, kk[j], rr & (kk[i] == u(r)))

    rounds = max(1, (c - 1).bit_length())
    for _ in range(rounds):
        nxt = list(adj)
        for i in range(c):
            acc = nxt[i]
            for k in range(c):
                acc = acc | xp.where(
                    ((adj[i] >> u(k)) & u(1)) == u(1), adj[k], zero
                )
            nxt[i] = acc
        adj = nxt

    cyclic = false_
    for i in range(c):
        cyclic = cyclic | (((adj[i] >> u(i)) & u(1)) == u(1))
    return ~(cyclic | none_read)


def register_family_properties(model, getok_type: int = 4, val_shift: int = 4):
    """The standard register-twin property list: the shared linearizable
    lane program (always), a value-chosen scan over GetOk envelopes
    (sometimes), and the network capacity guard. `val_shift` is the bit
    offset of the 4-bit tester value code inside the GetOk payload
    (1 = None, 2+k = writer k's value)."""

    def value_chosen(xp, lanes):
        u = xp.uint32

        def is_value_getok(env):
            return (
                ((env >> u(28)) == u(getok_type))
                & (((env >> u(val_shift)) & u(15)) != u(1))
                & (env != u(0))
            )

        return model.net_scan(xp, lanes, is_value_getok)

    return [
        TensorProperty.always("linearizable", model.linearizable_lanes),
        TensorProperty.sometimes("value chosen", value_chosen),
        model.net_capacity_property(),
    ]


def decode_net(row, n_actor_base: int, K: int, type_names) -> List[str]:
    """Human-readable network view (Explorer / error messages)."""
    out = []
    for m in range(K):
        env = int(row[n_actor_base + m])
        if env:
            out.append(
                f"{type_names[env >> 28]}({(env >> 24) & 15}->"
                f"{(env >> 20) & 15}, pay={env & 0xFFFFF:#x})"
            )
    return out


def decode_register_clients(row, n_actor_base: int, c: int) -> List[dict]:
    """Human-readable client tester view (Explorer / error messages)."""
    out = []
    for i in range(c):
        cl = int(row[n_actor_base + i])
        out.append(
            {
                "phase": cl & 3,
                "read_value": (cl >> 2) & 15,
            }
        )
    return out
