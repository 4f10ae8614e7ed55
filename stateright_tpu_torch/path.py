"""Counterexample and example traces (the port's copy of the parts of
`stateright_tpu/path.py` the BFS engine needs).

A path is `state --action--> state ... --action--> state`. Engines keep
only fingerprints; `Path.from_fingerprints` re-executes the model along a
fingerprint chain to recover the states and actions (the TLC technique
the reference cites at src/checker/bfs.rs:389-393).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple


class PathReconstructionError(RuntimeError):
    pass


_NONDETERMINISM_HINT = (
    "This usually happens when the model varies across calls given identical "
    "inputs — e.g. it reads untracked external state or iterates a container "
    "with nondeterministic order."
)


def _state_fields(model, state) -> dict:
    """Named-field view of a state (values repr'd, so records stay
    JSON-serializable). Tensor-backed states decode through the model's
    `decode_state`; tuples and lists report by position."""
    tm = getattr(model, "tm", None)
    if tm is not None and hasattr(tm, "decode_state"):
        import numpy as np

        state = tm.decode_state(np.asarray(state, dtype=np.uint32))
    if isinstance(state, dict):
        return {str(k): repr(v) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return {f"[{i}]": repr(v) for i, v in enumerate(state)}
    return {"state": repr(state)}


class Path:
    """A list of (state, Optional[action]) pairs; the final pair has action None."""

    def __init__(self, pairs: List[Tuple[Any, Optional[Any]]]):
        if not pairs:
            raise ValueError("empty path is invalid")
        self._pairs = pairs

    @staticmethod
    def from_fingerprints(model, fingerprints: Sequence[int]) -> "Path":
        """Re-execute `model` along a fingerprint chain (reference path.rs:20-97)."""
        fps = list(fingerprints)
        if not fps:
            raise PathReconstructionError("empty path is invalid")
        last_state = None
        for s in model.init_states():
            if model.fingerprint_state(s) == fps[0]:
                last_state = s
                break
        if last_state is None:
            avail = [model.fingerprint_state(s) for s in model.init_states()]
            raise PathReconstructionError(
                f"No init state has the expected fingerprint ({fps[0]}). "
                f"{_NONDETERMINISM_HINT} Available init fingerprints: {avail}"
            )
        pairs: List[Tuple[Any, Optional[Any]]] = []
        for next_fp in fps[1:]:
            found = None
            for action, next_state in model.next_steps(last_state):
                if model.fingerprint_state(next_state) == next_fp:
                    found = (action, next_state)
                    break
            if found is None:
                avail = [
                    model.fingerprint_state(s) for s in model.next_states(last_state)
                ]
                raise PathReconstructionError(
                    f"{1 + len(pairs)} previous state(s) reconstructed, but no "
                    f"successor has the next fingerprint ({next_fp}). "
                    f"{_NONDETERMINISM_HINT} Available next fingerprints: {avail}"
                )
            action, next_state = found
            pairs.append((last_state, action))
            last_state = next_state
        pairs.append((last_state, None))
        return Path(pairs)

    @staticmethod
    def from_actions(model, init_state, actions) -> Optional["Path"]:
        """Build a path from an init state and an action sequence; None
        if unreachable (reference path.rs:101-131)."""
        if not any(s == init_state for s in model.init_states()):
            return None
        pairs: List[Tuple[Any, Optional[Any]]] = []
        prev_state = init_state
        for action in actions:
            found = None
            for a, next_state in model.next_steps(prev_state):
                if a == action:
                    found = (a, next_state)
                    break
            if found is None:
                return None
            pairs.append((prev_state, found[0]))
            prev_state = found[1]
        pairs.append((prev_state, None))
        return Path(pairs)

    def last_state(self) -> Any:
        return self._pairs[-1][0]

    def into_states(self) -> List[Any]:
        return [s for s, _a in self._pairs]

    def into_actions(self) -> List[Any]:
        return [a for _s, a in self._pairs if a is not None]

    def into_vec(self) -> List[Tuple[Any, Optional[Any]]]:
        return list(self._pairs)

    def encode(self, model) -> str:
        """Fingerprint-path string "fp/fp/fp" (reference path.rs:189-198)."""
        return "/".join(str(model.fingerprint_state(s)) for s, _a in self._pairs)

    def __len__(self) -> int:
        return len(self._pairs) - 1

    def __repr__(self) -> str:
        return f"Path(steps={len(self)}, last_state={self._pairs[-1][0]!r})"

    def __str__(self) -> str:
        lines = [f"Path[{len(self)}]:"]
        for _state, action in self._pairs:
            if action is not None:
                lines.append(f"- {action!r}")
        return "\n".join(lines) + "\n"
