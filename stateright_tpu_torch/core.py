"""Core model-checking abstractions: Model, Property, Expectation.

Reference parity: the `Model` trait (src/lib.rs:158-257), `Property`
(src/lib.rs:264-317), and `Expectation` (src/lib.rs:319-338).

A `Model` describes a nondeterministic transition system:
  - `init_states()` returns the initial states,
  - `actions(state, actions)` appends the enabled actions,
  - `next_state(state, action)` returns the successor (or None for no-ops),
  - `properties()` declares always/sometimes/eventually predicates,
  - `within_boundary(state)` prunes the explored space.

States may be any Python values with canonical fingerprints (see
`stateright_tpu_torch.fingerprint`); they do not need to be Python-hashable.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

from . import fingerprint as _fp_mod

fingerprint = _fp_mod.fingerprint


class Expectation(enum.Enum):
    """Whether a property must hold always, eventually, or sometimes.

    Reference: src/lib.rs:319-328.
    """

    ALWAYS = "always"
    EVENTUALLY = "eventually"
    SOMETIMES = "sometimes"

    @property
    def discovery_is_failure(self) -> bool:
        """Reference: src/lib.rs:330-338."""
        return self in (Expectation.ALWAYS, Expectation.EVENTUALLY)


@dataclass
class Property:
    """A named predicate over (model, state). Reference: src/lib.rs:264-317."""

    expectation: Expectation
    name: str
    condition: Callable[["Model", Any], bool]

    @staticmethod
    def always(name: str, condition: Callable[["Model", Any], bool]) -> "Property":
        """A safety property; the checker looks for a counterexample."""
        return Property(Expectation.ALWAYS, name, condition)

    @staticmethod
    def eventually(name: str, condition: Callable[["Model", Any], bool]) -> "Property":
        """A liveness property; the checker looks for a counterexample path
        from an initial state to a terminal state that never satisfies it.

        Like the reference (src/lib.rs:286-290), this only works correctly on
        acyclic paths: a path ending in a cycle is not seen as terminating, a
        documented false-negative.
        """
        return Property(Expectation.EVENTUALLY, name, condition)

    @staticmethod
    def sometimes(name: str, condition: Callable[["Model", Any], bool]) -> "Property":
        """A reachability property; the checker looks for an example."""
        return Property(Expectation.SOMETIMES, name, condition)


class Model:
    """The primary abstraction: a nondeterministic transition system.

    Reference: the `Model` trait, src/lib.rs:158-257. Subclasses implement
    `init_states`, `actions`, and `next_state`; optionally `properties`,
    `within_boundary`, formatting hooks, and `fingerprint_state`.
    """

    # -- required interface -------------------------------------------------

    def init_states(self) -> List[Any]:
        raise NotImplementedError

    def actions(self, state: Any, actions: List[Any]) -> None:
        """Append the actions enabled in `state` to `actions`."""
        raise NotImplementedError

    def next_state(self, last_state: Any, action: Any) -> Optional[Any]:
        """Successor of `last_state` under `action`; None means no-op."""
        raise NotImplementedError

    # -- optional interface -------------------------------------------------

    def properties(self) -> List[Property]:
        return []

    def within_boundary(self, state: Any) -> bool:
        return True

    def format_action(self, action: Any) -> str:
        return repr(action)

    def format_step(self, last_state: Any, action: Any) -> Optional[str]:
        next_state = self.next_state(last_state, action)
        return None if next_state is None else repr(next_state)

    def as_svg(self, path) -> Optional[str]:
        """SVG rendering of a Path (used by the Explorer); None by default."""
        return None

    def fingerprint_state(self, state: Any) -> int:
        """Stable nonzero 64-bit fingerprint of `state`.

        Engines call this instead of hashing directly so that models backed
        by tensor encodings can guarantee host/device hash agreement.
        """
        return fingerprint(state)

    # -- derived helpers ----------------------------------------------------

    def next_steps(self, last_state: Any) -> List[Tuple[Any, Any]]:
        """(action, next_state) pairs that follow `last_state`.

        Reference: src/lib.rs:199-213.
        """
        actions: List[Any] = []
        self.actions(last_state, actions)
        steps = []
        for action in actions:
            nxt = self.next_state(last_state, action)
            if nxt is not None:
                steps.append((action, nxt))
        return steps

    def next_states(self, last_state: Any) -> List[Any]:
        actions: List[Any] = []
        self.actions(last_state, actions)
        out = []
        for action in actions:
            nxt = self.next_state(last_state, action)
            if nxt is not None:
                out.append(nxt)
        return out

    def property(self, name: str) -> Property:
        """Look up a property by name; raises if absent (src/lib.rs:232-242)."""
        for p in self.properties():
            if p.name == name:
                return p
        available = [p.name for p in self.properties()]
        raise KeyError(f"Unknown property. requested={name}, available={available}")

    def checker(self) -> "CheckerBuilder":
        from .checker import CheckerBuilder

        return CheckerBuilder(self)
