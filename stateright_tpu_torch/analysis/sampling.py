"""Bounded state sampling for speclint (the port's copy of
`stateright_tpu/analysis/sampling.py`).

The rules need concrete states to replay model callbacks on. A bounded
breadth-first walk from the initial states gives a depth-stratified sample
(shallow states are exactly where most spec bugs bite first — they are on
every path) and, as a free byproduct, knows whether the WHOLE reachable
space fit inside the budget (`exhausted`), which upgrades several
sample-relative findings from "within the sample" to facts.

Sampling is defensive: a model whose callbacks raise mid-walk yields a
truncated sample plus the exception (the rule families report it with a
stable code) instead of crashing the lint pass.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from ..core import Model
from .diagnostics import SampleInfo


@dataclass
class Sample:
    """States gathered by the bounded BFS, plus coverage facts."""

    states: List[Any] = field(default_factory=list)
    depths: List[int] = field(default_factory=list)
    init_count: int = 0
    terminal_states: List[Any] = field(default_factory=list)
    exhausted: bool = False
    max_depth: int = 0
    # First exception hit while walking (the walk stops there).
    error: Optional[BaseException] = None
    error_site: str = ""  # "init_states" / "actions" / "next_state"

    def info(self) -> SampleInfo:
        return SampleInfo(
            states=len(self.states),
            max_depth=self.max_depth,
            exhausted=self.exhausted,
            terminal_states=len(self.terminal_states),
        )


def sample_states(model: Model, budget: int) -> Sample:
    """Breadth-first sample of up to `budget` distinct reachable states.

    Dedup keys on the model's own fingerprints when they work and falls
    back to object identity when they do not (an unfingerprintable state
    is itself a finding — the determinism family reports it; sampling
    must still make progress to feed the other rules).
    """
    out = Sample()
    try:
        inits = list(model.init_states())
    except BaseException as e:  # noqa: BLE001 - lint pass must not crash
        out.error = e
        out.error_site = "init_states"
        return out
    out.init_count = len(inits)

    seen = set()
    frontier: List[Tuple[Any, int]] = []
    fingerprintable = True
    for s in inits:
        key = _key(model, s, fingerprintable)
        if key is None:
            fingerprintable = False
            key = id(s)
        if key not in seen:
            seen.add(key)
            frontier.append((s, 0))
    out.states = [s for s, _ in frontier]
    out.depths = [0] * len(frontier)

    while frontier and len(out.states) < budget:
        next_frontier: List[Tuple[Any, int]] = []
        for state, depth in frontier:
            try:
                actions: List[Any] = []
                model.actions(state, actions)
                succs = []
                for a in actions:
                    nxt = model.next_state(state, a)
                    if nxt is not None:
                        succs.append(nxt)
            except BaseException as e:  # noqa: BLE001
                out.error = e
                out.error_site = "actions" if not actions else "next_state"
                out.max_depth = max(out.depths, default=0)
                return out
            if not succs:
                out.terminal_states.append(state)
                continue
            for nxt in succs:
                if not model.within_boundary(nxt):
                    continue
                key = _key(model, nxt, fingerprintable)
                if key is None:
                    fingerprintable = False
                    key = id(nxt)
                if key in seen:
                    continue
                seen.add(key)
                next_frontier.append((nxt, depth + 1))
                if len(out.states) + len(next_frontier) >= budget:
                    break
            if len(out.states) + len(next_frontier) >= budget:
                break
        for s, d in next_frontier:
            out.states.append(s)
            out.depths.append(d)
        frontier = next_frontier
        if not next_frontier:
            out.exhausted = len(out.states) < budget
            break
    out.max_depth = max(out.depths, default=0)
    return out


def _key(model: Model, state: Any, fingerprintable: bool):
    if not fingerprintable:
        return None
    try:
        return model.fingerprint_state(state)
    except BaseException:  # noqa: BLE001 - reported by the determinism rules
        return None
