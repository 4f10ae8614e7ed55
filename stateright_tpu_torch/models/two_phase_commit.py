"""Two-phase commit, after Gray & Lamport's "Consensus on Transaction Commit"
(the port's copy of `TwoPhaseTensor` from
`stateright_tpu/models/two_phase_commit.py`).

Golden unique-state counts: 288 at 3 RMs, 8,832 at 5 RMs, 296,448 at 7
RMs and 61,515,776 at 10 RMs. The whole system state packs into 3 uint32
lanes and all 2+5N actions are evaluated as one masked batch; the same
code runs under numpy and under the port's torch `xp`.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..tensor import TensorModel, TensorProperty

# RM states
WORKING, PREPARED, COMMITTED, ABORTED = 0, 1, 2, 3
# TM states
TM_INIT, TM_COMMITTED, TM_ABORTED = 0, 1, 2


class TwoPhaseTensor(TensorModel):
    """Dense lane encoding of two-phase commit.

    State layout (3 uint32 lanes, N RMs <= 16):
      lane 0: tm_state (2 bits)
      lane 1: bits [2i, 2i+1] = rm_state[i]; bits 16+i not used
      lane 2: bit i = Prepared{i} in msgs; bit 29 = tm_prepared bitmask is
              folded into lane 0 bits [2+i]; bit 30 = Commit, bit 31 = Abort

    Concretely: lane0 = tm_state | (tm_prepared_mask << 2);
                lane1 = packed 2-bit rm states;
                lane2 = prepared_msgs_mask | commit_bit<<30 | abort_bit<<31.

    Actions (A = 2 + 5N): slot 0 TmCommit, slot 1 TmAbort, then for each rm:
    TmRcvPrepared, RmPrepare, RmChooseToAbort, RmRcvCommitMsg, RmRcvAbortMsg.
    """

    state_width = 3

    def __init__(self, rm_count: int):
        if rm_count > 16:
            raise ValueError("TwoPhaseTensor supports up to 16 RMs")
        self.n = rm_count
        self.max_actions = 2 + 5 * rm_count

    def init_states_array(self) -> np.ndarray:
        return np.zeros((1, 3), dtype=np.uint32)

    # -- lane helpers (work under numpy and the torch xp) -------------------

    @staticmethod
    def _tm_state(xp, lane0):
        return lane0 & xp.uint32(3)

    def _prepared_mask(self, xp, lane0):
        return (lane0 >> xp.uint32(2)) & xp.uint32((1 << self.n) - 1)

    @staticmethod
    def _rm_state(xp, lane1, rm: int):
        return (lane1 >> xp.uint32(2 * rm)) & xp.uint32(3)

    def step_lanes(self, xp, lanes):
        n = self.n
        u = xp.uint32
        lane0, lane1, lane2 = lanes
        tm = self._tm_state(xp, lane0)
        prep_mask = self._prepared_mask(xp, lane0)
        all_prepared = prep_mask == u((1 << n) - 1)
        tm_init = tm == u(TM_INIT)
        has_commit = (lane2 >> u(30)) & u(1)
        has_abort = (lane2 >> u(31)) & u(1)

        succs = []
        masks = []

        # slot 0: TmCommit
        succs.append(
            (
                (lane0 & ~u(3)) | u(TM_COMMITTED),
                lane1,
                lane2 | (u(1) << u(30)),
            )
        )
        masks.append(tm_init & all_prepared)

        # slot 1: TmAbort
        succs.append(
            (
                (lane0 & ~u(3)) | u(TM_ABORTED),
                lane1,
                lane2 | (u(1) << u(31)),
            )
        )
        masks.append(tm_init)

        for rm in range(n):
            rm_working = self._rm_state(xp, lane1, rm) == u(WORKING)
            prepared_msg = ((lane2 >> u(rm)) & u(1)) == u(1)
            rm_shift = u(2 * rm)
            rm_clear = ~(u(3) << rm_shift)

            # TmRcvPrepared(rm)
            succs.append((lane0 | (u(1) << u(2 + rm)), lane1, lane2))
            masks.append(tm_init & prepared_msg)

            # RmPrepare(rm)
            succs.append(
                (
                    lane0,
                    (lane1 & rm_clear) | (u(PREPARED) << rm_shift),
                    lane2 | (u(1) << u(rm)),
                )
            )
            masks.append(rm_working)

            # RmChooseToAbort(rm)
            succs.append(
                (
                    lane0,
                    (lane1 & rm_clear) | (u(ABORTED) << rm_shift),
                    lane2,
                )
            )
            masks.append(rm_working)

            # RmRcvCommitMsg(rm)
            succs.append(
                (
                    lane0,
                    (lane1 & rm_clear) | (u(COMMITTED) << rm_shift),
                    lane2,
                )
            )
            masks.append(has_commit == u(1))

            # RmRcvAbortMsg(rm)
            succs.append(
                (
                    lane0,
                    (lane1 & rm_clear) | (u(ABORTED) << rm_shift),
                    lane2,
                )
            )
            masks.append(has_abort == u(1))

        return succs, masks

    def representative_lanes(self, xp, lanes):
        """Batched RM-permutation canonicalization (examples/2pc.rs:203-229;
        device analogue of TwoPhaseState.representative).

        Each RM i is one descriptor word rm_state(2b) | i(4b) | prep(1b) |
        msg(1b); an odd-even transposition network sorts the N descriptors
        per state. The original index sits directly below the sort key, so
        ties between equal rm_states preserve original order — exactly the
        host's stable sort — and the carried prep/msg bits never influence
        the order. All elementwise min/max: no gathers, no argsort.

        Count semantics (measured, 2pc-5): this canonicalizer is IMPERFECT
        (the reference's own rule — ties between equal rm_states are not
        canonicalized over prep/msg), so the symmetry-reduced unique count
        is traversal-defined: reference DFS = 665 (expand-original,
        dedup-by-rep, DFS order; examples/2pc.rs:168, matched by our host
        DFS), an expand-original BFS = 508, and the device engine's
        canonical CLOSURE (expand representatives — the only
        order-independent definition a batched BFS admits) = 1,092.
        Every variant soundly covers the same equivalence classes and
        yields identical property verdicts.
        """
        n = self.n
        u = xp.uint32
        lane0, lane1, lane2 = lanes
        descs = []
        for i in range(n):
            rm = (lane1 >> u(2 * i)) & u(3)
            prep = (lane0 >> u(2 + i)) & u(1)
            msg = (lane2 >> u(i)) & u(1)
            descs.append((rm << u(6)) | u(i << 2) | (prep << u(1)) | msg)
        for p in range(n):
            for m in range(p & 1, n - 1, 2):
                lo = xp.minimum(descs[m], descs[m + 1])
                hi = xp.maximum(descs[m], descs[m + 1])
                descs[m] = lo
                descs[m + 1] = hi
        new0 = lane0 & u(3)  # tm_state
        new1 = lane1 & ~u((1 << (2 * n)) - 1)
        new2 = lane2 & ~u((1 << n) - 1)  # keep Commit/Abort bits
        for j, d in enumerate(descs):
            rm = (d >> u(6)) & u(3)
            prep = (d >> u(1)) & u(1)
            msg = d & u(1)
            new0 = new0 | (prep << u(2 + j))
            new1 = new1 | (rm << u(2 * j))
            new2 = new2 | (msg << u(j))
        return (new0, new1, new2)

    def tensor_properties(self) -> List[TensorProperty]:
        n = self.n

        def rm_states(xp, lanes):
            lane1 = lanes[1]
            return [
                (lane1 >> xp.uint32(2 * rm)) & xp.uint32(3) for rm in range(n)
            ]

        def abort_agreement(xp, lanes):
            rs = rm_states(xp, lanes)
            acc = rs[0] == xp.uint32(ABORTED)
            for r in rs[1:]:
                acc = acc & (r == xp.uint32(ABORTED))
            return acc

        def commit_agreement(xp, lanes):
            rs = rm_states(xp, lanes)
            acc = rs[0] == xp.uint32(COMMITTED)
            for r in rs[1:]:
                acc = acc & (r == xp.uint32(COMMITTED))
            return acc

        def consistent(xp, lanes):
            rs = rm_states(xp, lanes)
            any_abort = rs[0] == xp.uint32(ABORTED)
            any_commit = rs[0] == xp.uint32(COMMITTED)
            for r in rs[1:]:
                any_abort = any_abort | (r == xp.uint32(ABORTED))
                any_commit = any_commit | (r == xp.uint32(COMMITTED))
            return ~(any_abort & any_commit)

        return [
            TensorProperty.sometimes("abort agreement", abort_agreement),
            TensorProperty.sometimes("commit agreement", commit_agreement),
            TensorProperty.always("consistent", consistent),
        ]

    def format_action(self, a: int) -> str:
        if a == 0:
            return "TmCommit"
        if a == 1:
            return "TmAbort"
        rm, kind = divmod(a - 2, 5)
        return [
            f"TmRcvPrepared({rm})",
            f"RmPrepare({rm})",
            f"RmChooseToAbort({rm})",
            f"RmRcvCommitMsg({rm})",
            f"RmRcvAbortMsg({rm})",
        ][kind]

    def decode_state(self, row) -> dict:
        lane0, lane1, lane2 = (int(v) for v in row)
        names = {0: "Working", 1: "Prepared", 2: "Committed", 3: "Aborted"}
        return {
            "tm_state": {0: "Init", 1: "Committed", 2: "Aborted"}[lane0 & 3],
            "tm_prepared": [(lane0 >> (2 + i)) & 1 == 1 for i in range(self.n)],
            "rm_state": [names[(lane1 >> (2 * i)) & 3] for i in range(self.n)],
            "msgs": sorted(
                [f"Prepared({i})" for i in range(self.n) if (lane2 >> i) & 1]
                + (["Commit"] if (lane2 >> 30) & 1 else [])
                + (["Abort"] if (lane2 >> 31) & 1 else [])
            ),
        }
