"""Unsynchronized shared-memory counter: the classic lost-update race (the
port's copy of `IncrementTensor` from `stateright_tpu/models/increment.py`).

Reference: examples/increment.rs — N threads each read the shared counter
then write back the increment; interleavings break the invariant that the
counter equals the number of finished threads (13 unique states at N=2;
the "fin" always-property has a counterexample).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..tensor import TensorModel, TensorProperty


class IncrementTensor(TensorModel):
    """Dense encoding: lane 0 = shared counter; lanes 1+2k / 2+2k = thread k's
    local value and program counter. Actions: slot 2k = Read(k), 2k+1 = Write(k).
    """

    def __init__(self, thread_count: int):
        self.n = thread_count
        self.state_width = 1 + 2 * thread_count
        self.max_actions = 2 * thread_count

    def init_states_array(self) -> np.ndarray:
        row = np.zeros(self.state_width, dtype=np.uint32)
        for k in range(self.n):
            row[2 + 2 * k] = 1  # pc = 1
        return row[None, :]

    def step_lanes(self, xp, lanes):
        u = xp.uint32
        succs = []
        masks = []
        shared = lanes[0]
        for k in range(self.n):
            t = lanes[1 + 2 * k]
            pc = lanes[2 + 2 * k]

            # Read(k): t <- shared, pc <- 2
            cols = list(lanes)
            cols[1 + 2 * k] = shared
            cols[2 + 2 * k] = xp.full_like(pc, 2)
            succs.append(tuple(cols))
            masks.append(pc == u(1))

            # Write(k): shared <- t + 1, pc <- 3
            cols = list(lanes)
            cols[0] = (t + u(1)) & u(0xFF)
            cols[2 + 2 * k] = xp.full_like(pc, 3)
            succs.append(tuple(cols))
            masks.append(pc == u(2))

        return succs, masks

    def tensor_properties(self) -> List[TensorProperty]:
        n = self.n

        def fin(xp, lanes):
            u = xp.uint32
            count = xp.where(lanes[2] == u(3), u(1), u(0))
            for k in range(1, n):
                count = count + xp.where(lanes[2 + 2 * k] == u(3), u(1), u(0))
            return (count & u(0xFF)) == lanes[0]

        return [TensorProperty.always("fin", fin)]

    def format_action(self, a: int) -> str:
        tid, kind = divmod(a, 2)
        return f"{'Read' if kind == 0 else 'Write'}({tid})"
