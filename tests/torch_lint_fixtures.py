"""Broken models for the port's speclint (stateright_tpu_torch.analysis):
the port's copies of the JAX package's fixtures (tests/test_speclint.py),
one per rule, and fixtures that diverge only on the port's int64 lanes.

The module imports torch's side only, so `chip_smoke.py` holds the same
fixtures on the card. Where a JAX fixture calls `.astype`, which the
port's `xp` does not have, the copy writes the same bug in the port's
idiom. A fixture whose lane code must also run under the JAX package
(the port-only divergences) keeps it in a mixin (`*Body`) that the tests
put on either package's `TensorModel`.
"""

from __future__ import annotations

import random
from typing import List

import numpy as np

from stateright_tpu_torch.core import Model, Property
from stateright_tpu_torch.tensor import TensorModel, TensorProperty


def _always_true():
    return [TensorProperty.always("true", lambda xp, l: l[0] == l[0])]


# -- host fixtures (copies) -------------------------------------------------


class RngActionsModel(Model):
    """STR101: hidden RNG in `actions`."""

    def init_states(self):
        return [0]

    def actions(self, state, actions: List) -> None:
        actions.append(random.randint(0, 1 << 30))

    def next_state(self, state, action):
        return (state + action) % 97 if state < 50 else None

    def properties(self):
        return [Property.always("true", lambda _m, _s: True)]


class MutatingModel(Model):
    """STR103: `next_state` edits its input state in place."""

    def init_states(self):
        return [[0, 0]]

    def actions(self, state, actions: List) -> None:
        if state[0] < 3:
            actions.append(1)

    def next_state(self, state, action):
        state[0] += action
        return [state[0], state[1]]

    def properties(self):
        return [Property.always("true", lambda _m, _s: True)]


class RngNextStateModel(Model):
    """STR102: `next_state` flips a hidden coin."""

    def init_states(self):
        return [0]

    def actions(self, state, actions: List) -> None:
        if state < 5:
            actions.append("go")

    def next_state(self, state, action):
        return state + random.choice([1, 2])

    def properties(self):
        return []


class UnfingerprintableModel(Model):
    """STR104: states the canonical serializer cannot encode."""

    class Opaque:
        pass

    def init_states(self):
        return [self.Opaque()]

    def actions(self, state, actions: List) -> None:
        pass

    def next_state(self, state, action):
        return None


class DupPropsModel(Model):
    """STR301: two properties sharing one name."""

    def init_states(self):
        return [0]

    def actions(self, state, actions: List) -> None:
        if state < 3:
            actions.append(1)

    def next_state(self, state, action):
        return state + action

    def properties(self):
        return [
            Property.always("safe", lambda _m, s: s < 10),
            Property.sometimes("safe", lambda _m, s: s > 1),
        ]


class RaisingPropModel(Model):
    """STR302: a predicate that raises mid-search."""

    def init_states(self):
        return [0]

    def actions(self, state, actions: List) -> None:
        if state < 5:
            actions.append(1)

    def next_state(self, state, action):
        return state + action

    def properties(self):
        return [Property.always("broken", lambda _m, s: 1 // max(0, 2 - s) >= 0)]


class NonIdempotentRepState:
    """rep() rotates instead of sorting: rep(rep(s)) != rep(s)."""

    def __init__(self, items):
        self.items = tuple(items)

    def representative(self) -> "NonIdempotentRepState":
        return NonIdempotentRepState(self.items[1:] + self.items[:1])

    def fingerprint_key(self):
        return self.items

    def __repr__(self):
        return f"S{self.items}"


class NonIdempotentRepModel(Model):
    """STR402: canonicalization that never reaches a fixed point."""

    def init_states(self):
        return [NonIdempotentRepState((2, 0, 1))]

    def actions(self, state, actions: List) -> None:
        pass

    def next_state(self, state, action):
        return None

    def properties(self):
        return [Property.always("true", lambda _m, _s: True)]


class PropChangingRepState:
    def __init__(self, x):
        self.x = x

    def representative(self):
        return PropChangingRepState(0)

    def fingerprint_key(self):
        return self.x

    def __repr__(self):
        return f"P({self.x})"


class PropChangingRepModel(Model):
    """STR403: the 'representative' changes property verdicts."""

    def init_states(self):
        return [PropChangingRepState(1)]

    def actions(self, state, actions: List) -> None:
        if state.x < 4:
            actions.append(1)

    def next_state(self, state, action):
        return PropChangingRepState(state.x + action)

    def properties(self):
        return [Property.always("positive", lambda _m, s: s.x > 0)]


# -- tensor fixtures (copies, in the port's idiom) --------------------------


class OverflowPackTensor(TensorModel):
    """STR207: successor values overflow the uint32 lane packing. The
    JAX copy computes in `lanes[0].astype(xp.int64)`; here the wide
    operand is a constant array made without `dtype=xp.uint32`, which
    numpy makes int64 (and torch int64 lanes are wide anyway): the engine
    cuts the values to 32 bits and distinct states would merge."""

    state_width = 1
    max_actions = 1

    def init_states_array(self) -> np.ndarray:
        return np.asarray([[0x90000000]], dtype=np.uint32)

    def step_lanes(self, xp, lanes):
        nxt = lanes[0] * xp.full(lanes[0].shape, 3) + xp.uint32(1)
        return [(nxt,)], [lanes[0] >= xp.uint32(0)]

    def tensor_properties(self):
        return _always_true()


class UntraceableTensor(TensorModel):
    """STR201: data-dependent Python control flow in `step_lanes` (the
    JAX fixture's code as it is)."""

    state_width = 1
    max_actions = 1

    def init_states_array(self) -> np.ndarray:
        return np.zeros((1, 1), dtype=np.uint32)

    def step_lanes(self, xp, lanes):
        u = xp.uint32
        if lanes[0][0] > 5:
            nxt = lanes[0] - u(1)
        else:
            nxt = lanes[0] + u(1)
        return [(nxt,)], [lanes[0] < u(10)]

    def tensor_properties(self):
        return _always_true()


class BadMaskTensor(TensorModel):
    """STR202: validity masks that are lanes, not bools (the JAX copy
    writes `.astype(xp.uint32)`)."""

    state_width = 1
    max_actions = 1

    def init_states_array(self) -> np.ndarray:
        return np.zeros((1, 1), dtype=np.uint32)

    def step_lanes(self, xp, lanes):
        u = xp.uint32
        nxt = (lanes[0] + u(1)) & u(7)
        return [(nxt,)], [xp.where(lanes[0] < u(8), u(1), u(0))]

    def tensor_properties(self):
        return []


class BadDecodeTensor(TensorModel):
    """STR204: `decode_state` crashes on reachable rows."""

    state_width = 1
    max_actions = 1

    def init_states_array(self) -> np.ndarray:
        return np.zeros((1, 1), dtype=np.uint32)

    def step_lanes(self, xp, lanes):
        u = xp.uint32
        return [((lanes[0] + u(1)) & u(3),)], [lanes[0] == lanes[0]]

    def tensor_properties(self):
        return []

    def decode_state(self, row):
        return {0: "zero"}[int(row[0])]


class DivergentRepTensor(TensorModel):
    """STR404: the JAX fixture's int64 product cannot diverge here (numpy
    int64 and the port's int64 lanes agree), so the port's copy diverges
    on the port's own lane type: numpy's uint32 product wraps, the int64
    lane keeps the bit it pushes past 32 (0xF0000000 -> 0x70000000 under
    numpy, 0xF0000000 here). Idempotent under numpy, so the host rules
    pass and the agreement table finds it."""

    state_width = 1
    max_actions = 1

    def init_states_array(self) -> np.ndarray:
        return np.asarray([[0xF0000000]], dtype=np.uint32)

    def step_lanes(self, xp, lanes):
        u = xp.uint32
        return [((lanes[0] ^ u(1)),)], [lanes[0] == lanes[0]]

    def tensor_properties(self):
        return []

    def representative_lanes(self, xp, lanes):
        u = xp.uint32
        return ((lanes[0] * u(2)) >> u(1),)


class UntraceableRepTensor(TensorModel):
    """STR401: data-dependent Python control flow in
    `representative_lanes` (the canonicalizer the engine captures)."""

    state_width = 1
    max_actions = 1

    def init_states_array(self) -> np.ndarray:
        return np.zeros((1, 1), dtype=np.uint32)

    def step_lanes(self, xp, lanes):
        u = xp.uint32
        return [((lanes[0] + u(1)) & u(3),)], [lanes[0] == lanes[0]]

    def tensor_properties(self):
        return _always_true()

    def representative_lanes(self, xp, lanes):
        u = xp.uint32
        if lanes[0][0] > 5:
            return (lanes[0],)
        return (lanes[0] & u(0xFFFFFFFF),)


# -- divergences of the port's int64 lanes alone ------------------------------


class WrapShiftBody:
    """STR205 on the port only: `(lane - 1) >> 1` on a zero lane is
    0x7FFFFFFF under numpy's (and jax's) uint32 and 0xFFFFFFFF on the
    port's int64 lanes (-1 >> 1 = -1, then cut to 32 bits). A 33-state
    cycle 0 -> 2^31 - 1 -> 2^30 - 1 -> ... -> 1 -> 0 under numpy."""

    state_width = 1
    max_actions = 1

    def init_states_array(self) -> np.ndarray:
        return np.zeros((1, 1), dtype=np.uint32)

    def step_lanes(self, xp, lanes):
        u = xp.uint32
        return [((lanes[0] - u(1)) >> u(1),)], [lanes[0] == lanes[0]]

    def tensor_properties(self):
        return _always_true()


class WrapRepBody:
    """STR404 on the port only: the canonicalizer compares `(lane - 1) >>
    1` with the lane. On a zero lane numpy's uint32 says 0x7FFFFFFF > 0
    and maps 0 to 7; the port's int64 lane says -1 > 0 is false and keeps
    0. Idempotent under numpy (7 and every nonzero lane are fixed)."""

    state_width = 1
    max_actions = 1

    def init_states_array(self) -> np.ndarray:
        return np.zeros((1, 1), dtype=np.uint32)

    def step_lanes(self, xp, lanes):
        u = xp.uint32
        return [((lanes[0] + u(1)) & u(3),)], [lanes[0] == lanes[0]]

    def tensor_properties(self):
        return _always_true()

    def representative_lanes(self, xp, lanes):
        u = xp.uint32
        return (xp.where(((lanes[0] - u(1)) >> u(1)) > lanes[0], u(7), lanes[0]),)


class WrapShiftTensor(WrapShiftBody, TensorModel):
    pass


class WrapRepTensor(WrapRepBody, TensorModel):
    pass


# The fixtures whose error code comes from the device (a capture, the
# lane types, the agreement table): (fixture, its error code).
CARD_FIXTURES = (
    (UntraceableTensor, "STR201"),
    (BadMaskTensor, "STR202"),
    (WrapShiftTensor, "STR205"),
    (UntraceableRepTensor, "STR401"),
    (DivergentRepTensor, "STR404"),
    (WrapRepTensor, "STR404"),
)


class NoPropsModel(Model):
    """STR305 alone: a warning, no error."""

    def init_states(self):
        return [0]

    def actions(self, state, actions: List) -> None:
        pass

    def next_state(self, state, action):
        return None
