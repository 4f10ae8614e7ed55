"""Lock-protected shared-memory counter: the increment race fixed (the
port's copy of `IncrementLockTensor` from
`stateright_tpu/models/increment_lock.py`).

Reference: examples/increment_lock.rs — each thread Lock, Read, Write,
Release; the "fin" invariant now holds, and a "mutex" invariant asserts
that at most one thread is inside the critical section.

Lane 0 is the counter, lane 1 the lock bit, lanes 2+2k and 3+2k thread
k's local value and program counter; action slots 4k..4k+3 are Lock,
Read, Write and Release for thread k.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..tensor import TensorModel, TensorProperty


class IncrementLockTensor(TensorModel):
    """Dense encoding of the lock-protected increment for the engines."""

    def __init__(self, thread_count: int):
        self.n = thread_count
        self.state_width = 2 + 2 * thread_count
        self.max_actions = 4 * thread_count

    def init_states_array(self) -> np.ndarray:
        return np.zeros((1, self.state_width), dtype=np.uint32)

    def step_lanes(self, xp, lanes):
        u = xp.uint32
        succs = []
        masks = []
        shared = lanes[0]
        lock = lanes[1]
        for k in range(self.n):
            t = lanes[2 + 2 * k]
            pc = lanes[3 + 2 * k]

            # Lock(k): lock <- 1, pc <- 1 (enabled iff pc == 0 and !lock)
            cols = list(lanes)
            cols[1] = xp.ones_like(lock)
            cols[3 + 2 * k] = xp.full_like(pc, 1)
            succs.append(tuple(cols))
            masks.append((pc == u(0)) & (lock == u(0)))

            # Read(k): t <- shared, pc <- 2
            cols = list(lanes)
            cols[2 + 2 * k] = shared
            cols[3 + 2 * k] = xp.full_like(pc, 2)
            succs.append(tuple(cols))
            masks.append(pc == u(1))

            # Write(k): shared <- t + 1, pc <- 3
            cols = list(lanes)
            cols[0] = (t + u(1)) & u(0xFF)
            cols[3 + 2 * k] = xp.full_like(pc, 3)
            succs.append(tuple(cols))
            masks.append(pc == u(2))

            # Release(k): lock <- 0, pc <- 4
            cols = list(lanes)
            cols[1] = xp.zeros_like(lock)
            cols[3 + 2 * k] = xp.full_like(pc, 4)
            succs.append(tuple(cols))
            masks.append((pc == u(3)) & (lock == u(1)))

        return succs, masks

    def tensor_properties(self) -> List[TensorProperty]:
        n = self.n

        def fin(xp, lanes):
            u = xp.uint32
            count = xp.where(lanes[3] >= u(3), u(1), u(0))
            for k in range(1, n):
                count = count + xp.where(lanes[3 + 2 * k] >= u(3), u(1), u(0))
            return (count & u(0xFF)) == lanes[0]

        def mutex(xp, lanes):
            u = xp.uint32
            count = xp.where((lanes[3] >= u(1)) & (lanes[3] < u(4)), u(1), u(0))
            for k in range(1, n):
                pc = lanes[3 + 2 * k]
                count = count + xp.where((pc >= u(1)) & (pc < u(4)), u(1), u(0))
            return count <= u(1)

        return [
            TensorProperty.always("fin", fin),
            TensorProperty.always("mutex", mutex),
        ]

    def format_action(self, a: int) -> str:
        tid, kind = divmod(a, 4)
        return f"{('Lock', 'Read', 'Write', 'Release')[kind]}({tid})"
