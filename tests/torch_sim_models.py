"""The small models of `tests/test_tpu_simulation.py`, once for each
package: `TinyClock` (every walk cycles after two states) and `ChainFork`
(a sometimes-property that freezes walks, an eventually-property that
every terminal satisfies). Each pair shares its code; only the base
classes differ, so the JAX and the port engines see the same model."""

import numpy as np

import stateright_tpu.tensor as jt
import stateright_tpu_torch.tensor as tt


class _TinyClock:
    """1-lane 2-state cycle: 0 -> 1 -> 0 -> ..."""

    state_width = 1
    max_actions = 1

    def init_states_array(self):
        return np.zeros((1, 1), dtype=np.uint32)

    def step_lanes(self, xp, lanes):
        (v,) = lanes
        return [(xp.uint32(1) - v,)], [v == v]

    def tensor_properties(self):
        return [self.TP.sometimes("is one", lambda xp, lanes: lanes[0] == xp.uint32(1))]


class _ChainFork:
    """0 -(+1|+2)-> ... until v >= N (terminal)."""

    state_width = 1
    max_actions = 2
    N = 6

    def init_states_array(self):
        return np.zeros((1, 1), dtype=np.uint32)

    def step_lanes(self, xp, lanes):
        (v,) = lanes
        ok = v < xp.uint32(self.N)
        return [(v + xp.uint32(1),), (v + xp.uint32(2),)], [ok, ok]

    def tensor_properties(self):
        return [
            self.TP.sometimes("at one", lambda xp, l: l[0] == xp.uint32(1)),
            self.TP.eventually("reaches end", lambda xp, l: l[0] >= xp.uint32(self.N)),
        ]


class JaxTinyClock(_TinyClock, jt.TensorModel):
    TP = jt.TensorProperty


class TinyClock(_TinyClock, tt.TensorModel):
    TP = tt.TensorProperty


class JaxChainFork(_ChainFork, jt.TensorModel):
    TP = jt.TensorProperty


class ChainFork(_ChainFork, tt.TensorModel):
    TP = tt.TensorProperty
