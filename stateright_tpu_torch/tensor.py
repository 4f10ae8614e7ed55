"""The tensor encoding layer (the port's copy of `stateright_tpu/tensor.py`).

A `TensorModel` describes a transition system as array programs in
structure-of-arrays (lanes) form: a state is `state_width` uint32 lanes,
a batch of B states is a tuple of `state_width` [B] arrays,
`step_lanes(xp, lanes)` returns every one of the `max_actions` successor
slots plus a validity mask, and properties are batched predicates
`check(xp, lanes) -> [B] bool`.

The same model code runs under numpy (the host adapter below, used for
path reconstruction) and under torch through `xp.TorchXP` (the device
engine), so host and device execute one transition function.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from .core import Expectation, Model, Property
from .fingerprint import combine64, hash_words_np


@dataclass
class TensorProperty:
    """A batched property predicate: check(xp, lanes) -> bool[B]."""

    expectation: Expectation
    name: str
    check: Callable[[Any, Any], Any]

    @staticmethod
    def always(name: str, check) -> "TensorProperty":
        return TensorProperty(Expectation.ALWAYS, name, check)

    @staticmethod
    def eventually(name: str, check) -> "TensorProperty":
        return TensorProperty(Expectation.EVENTUALLY, name, check)

    @staticmethod
    def sometimes(name: str, check) -> "TensorProperty":
        return TensorProperty(Expectation.SOMETIMES, name, check)


class TensorModel:
    """A transition system over fixed-width uint32 state lanes.

    Subclasses define `state_width`, `max_actions`, `init_states_array`,
    `step_lanes` and `tensor_properties`; optionally
    `within_boundary_lanes`, `decode_state` and `format_action`.
    """

    state_width: int
    max_actions: int

    def init_states_array(self) -> np.ndarray:
        """[N0, S] uint32 initial states."""
        raise NotImplementedError

    def step_lanes(self, xp, lanes):
        """lanes (tuple of S [B] lanes) -> (succs: list over A of S-lane
        tuples, valid: list over A of [B] bool masks). A pure array
        program: no data-dependent Python control flow."""
        raise NotImplementedError

    def tensor_properties(self) -> List[TensorProperty]:
        return []

    def within_boundary_lanes(self, xp, lanes):
        """lanes -> bool[B]; default: everything is in bounds."""
        return xp.ones(lanes[0].shape, dtype=bool)

    # Symmetry reduction hook: lanes -> canonicalized lanes, a pure
    # batched array program valid under numpy and the torch `xp`. `None`
    # means the model has no symmetry canonicalization; engines asked for
    # `.symmetry()` over such a model raise instead of ignoring it.
    representative_lanes = None

    def decode_state(self, row: np.ndarray) -> Any:
        return tuple(int(v) for v in row)

    def format_action(self, action_index: int) -> str:
        return f"action[{action_index}]"

    def config_digest(self) -> str:
        """Stable digest of this instance's constructor-derived parameters:
        every scalar/tuple attribute in sorted order (models holding richer
        config may override). Two instances of one class with equal
        digests run the identical step (engines/compiled.py
        `model_signature`)."""
        items = sorted(
            (k, v)
            for k, v in vars(self).items()
            if isinstance(v, (bool, int, float, str, tuple))
        )
        return repr(items)

    def fingerprint_row(self, row: np.ndarray) -> int:
        h1, h2 = hash_words_np(np.asarray(row, dtype=np.uint32)[None, :])
        return combine64(h1[0], h2[0])

    def checker(self):
        return TensorModelAdapter(self).checker()


class _AdapterProperty:
    """Bridges a TensorProperty to a host (model, state) predicate."""

    def __init__(self, tensor_prop: TensorProperty):
        self._tp = tensor_prop

    def __call__(self, model: "TensorModelAdapter", state: Tuple[int, ...]) -> bool:
        lanes = tuple(np.asarray([v], dtype=np.uint32) for v in state)
        return bool(np.asarray(self._tp.check(np, lanes))[0])


class TensorModelAdapter(Model):
    """Presents a TensorModel through the host `Model` interface: states
    are tuples of ints (one per lane), actions are action indices, and
    every step runs the model's own `step_lanes` under numpy."""

    def __init__(self, tensor_model: TensorModel):
        self.tm = tensor_model
        # Single-entry step memo: actions(s) then next_state(s, a) per
        # action would otherwise recompute the full step A+1 times.
        self._memo_key: Optional[Tuple[int, ...]] = None
        self._memo_val: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def init_states(self) -> List[Tuple[int, ...]]:
        arr = np.asarray(self.tm.init_states_array(), dtype=np.uint32)
        return [tuple(int(v) for v in row) for row in arr]

    def actions(self, state, actions: List[int]) -> None:
        _succs, mask = self._step_row(state)
        for a in range(self.tm.max_actions):
            if mask[a]:
                actions.append(a)

    def next_state(self, last_state, action: int) -> Optional[Tuple[int, ...]]:
        succs, mask = self._step_row(last_state)
        if not mask[action]:
            return None
        return tuple(int(v) for v in succs[action])

    def properties(self) -> List[Property]:
        return [
            Property(tp.expectation, tp.name, _AdapterProperty(tp))
            for tp in self.tm.tensor_properties()
        ]

    def within_boundary(self, state) -> bool:
        lanes = tuple(np.asarray([v], dtype=np.uint32) for v in state)
        return bool(np.asarray(self.tm.within_boundary_lanes(np, lanes))[0])

    def format_action(self, action: int) -> str:
        return self.tm.format_action(action)

    def fingerprint_state(self, state) -> int:
        return self.tm.fingerprint_row(np.asarray(state, dtype=np.uint32))

    def representative_state(self, state) -> Tuple[int, ...]:
        """Canonical representative of a state via the model's batched
        canonicalizer (single-row numpy evaluation). Raises if the model
        defines no symmetry."""
        if self.tm.representative_lanes is None:
            raise ValueError(
                f"{type(self.tm).__name__} defines no representative_lanes"
            )
        lanes = tuple(np.asarray([v], dtype=np.uint32) for v in state)
        canon = self.tm.representative_lanes(np, lanes)
        return tuple(int(np.asarray(l)[0]) for l in canon)

    def _step_row(self, state) -> Tuple[np.ndarray, np.ndarray]:
        key = tuple(state)
        if key == self._memo_key and self._memo_val is not None:
            return self._memo_val
        lanes = tuple(np.asarray([v], dtype=np.uint32) for v in state)
        succs, valid = self.tm.step_lanes(np, lanes)
        A = self.tm.max_actions
        S = self.tm.state_width
        succ_rows = np.zeros((A, S), dtype=np.uint32)
        mask = np.zeros(A, dtype=bool)
        for a in range(A):
            mask[a] = bool(np.asarray(valid[a])[0])
            for s in range(S):
                succ_rows[a, s] = np.asarray(succs[a][s], dtype=np.uint32)[0]
        val = (succ_rows, mask)
        self._memo_key, self._memo_val = key, val
        return val


class CanonicalTensorAdapter(TensorModelAdapter):
    """Adapter view living entirely in CANONICAL (representative) space,
    for path reconstruction of symmetry-reduced runs: the engine explores
    rep(init) and rep(step(rep_state)), so the chain walker does exactly
    the same — init states and successors are canonicalized before
    matching. (Walking raw states and matching by canonical fingerprint
    is not enough: with an imperfect canonicalizer, the reference's own,
    equivalent states may map to different representatives.) The path is
    a sequence of representative states, each one explored by the engine.
    """

    def init_states(self):
        return [self.representative_state(s) for s in super().init_states()]

    def next_state(self, last_state, action: int):
        nxt = super().next_state(last_state, action)
        if nxt is None:
            return None
        return self.representative_state(nxt)

    def fingerprint_state(self, state) -> int:
        return self.tm.fingerprint_row(
            np.asarray(self.representative_state(state), dtype=np.uint32)
        )
