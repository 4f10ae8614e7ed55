"""Coverage accumulator: what the search actually exercised.

TLC's coverage statistics (Kuppe, Lamport & Ricketts, "The TLA+ Toolbox",
2019) are the canonical answer to a question no pass/fail verdict
answers: which actions ever fired, how deep the explored space is, and
which properties were evaluated and where they hit. A dead transition —
an action whose guard is never true on any reachable state — produces a
green run that silently checked a smaller system than the one modeled.

One `Coverage` per checker run (created by the engine base class) is
filled by the port's device engine once per era, from the counts its
step loop keeps on the card. This is a copy of
`stateright_tpu/obs/coverage.py`.

Count semantics (what makes host/device parity exact):

  ``actions``     label -> number of VALID in-boundary successor states
                  generated by that action, duplicates included — the
                  per-action decomposition of ``states_generated``. On
                  exhaustive BFS runs the host and device engines agree
                  exactly (each unique state is expanded exactly once).
                  Simulation engines count the action actually taken per
                  walk step instead (their ``states_generated`` twin).
  ``depths``      depth -> unique states first inserted at that depth
                  (initial states at depth 1); sums to the run's
                  unique_state_count for the deduplicating engines.
                  Device loops clamp depth into ``DEPTH_CAP`` buckets —
                  the last bucket is an overflow bin for deeper states.
  ``properties``  name -> {evaluations, hits}: how many states the
                  predicate was evaluated on and how many of those
                  triggered its discovery condition (violated always /
                  satisfied sometimes / terminal pending-eventually).
                  Host engines skip already-discovered properties
                  (reference parity) while device loops evaluate every
                  property every step, so these are engine-relative.
  ``dead_actions``  registered actions with a zero fire count — only
                  models whose action universe is statically known
                  (TensorModels: ``max_actions`` slots) can report them;
                  rich host models report observed actions only. The
                  static twin of this check is speclint STR306
                  (analysis/README.md), which flags never-enabled action
                  slots BEFORE the run.

Everything is thread-safe: host engines mutate from worker threads while
`Checker.coverage()` polls from the caller's.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Optional

# Device-side depth-histogram width. The era loops scatter unique-state
# inserts into this many depth buckets (index = min(depth, DEPTH_CAP-1),
# so the last bucket bins everything deeper); the deepest bundled
# workload (paxos-6) sits well inside it.
DEPTH_CAP = 128


class Coverage:
    """Thread-safe per-run coverage tallies (actions, depths, properties)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._actions: Dict[str, int] = {}
        self._labels: Optional[List[str]] = None  # registered universe
        self._depths: Dict[int, int] = {}
        self._prop_evals: Dict[str, int] = {}
        self._prop_hits: Dict[str, int] = {}

    # -- registration ---------------------------------------------------------

    def register_actions(self, labels: Iterable[str]) -> None:
        """Declare the full action universe (index order preserved): zero
        counts for registered-but-never-fired actions are what makes
        dead-action detection possible."""
        with self._lock:
            self._labels = list(labels)
            for label in self._labels:
                self._actions.setdefault(label, 0)

    def register_properties(self, names: Iterable[str]) -> None:
        with self._lock:
            for name in names:
                self._prop_evals.setdefault(name, 0)
                self._prop_hits.setdefault(name, 0)

    # -- recording -------------------------------------------------------------

    def record_depth(self, depth: int, n: int = 1) -> None:
        if not self.enabled or not n:
            return
        with self._lock:
            self._depths[int(depth)] = self._depths.get(int(depth), 0) + int(n)

    def record_property_eval(self, name: str, n: int = 1) -> None:
        if not self.enabled or not n:
            return
        with self._lock:
            self._prop_evals[name] = self._prop_evals.get(name, 0) + int(n)

    def record_property_hit(self, name: str, n: int = 1) -> None:
        if not self.enabled or not n:
            return
        with self._lock:
            self._prop_hits[name] = self._prop_hits.get(name, 0) + int(n)

    def record_action_counts(self, counts) -> None:
        """Add a per-slot count vector aligned with the registered label
        order (the device engines' once-per-era histogram sync)."""
        if not self.enabled:
            return
        labels = self._labels
        if labels is None:
            raise ValueError(
                "record_action_counts needs register_actions first (the "
                "count vector is positional)"
            )
        with self._lock:
            for i, c in enumerate(counts):
                c = int(c)
                if c:
                    self._actions[labels[i]] = self._actions.get(labels[i], 0) + c

    def record_depth_counts(self, hist, base_depth: int = 0) -> None:
        """Add a depth histogram vector: hist[i] states at depth base_depth+i."""
        if not self.enabled:
            return
        with self._lock:
            for i, c in enumerate(hist):
                c = int(c)
                if c:
                    d = base_depth + i
                    self._depths[d] = self._depths.get(d, 0) + c

    # -- queries --------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The full coverage view backing `Checker.coverage()`."""
        with self._lock:
            labels = self._labels
            dead = (
                [label for label in labels if not self._actions.get(label)]
                if labels is not None
                else []
            )
            return {
                "enabled": self.enabled,
                "actions": dict(self._actions),
                "dead_actions": dead,
                "depths": dict(sorted(self._depths.items())),
                "max_depth": max(self._depths, default=0),
                "properties": {
                    name: {
                        "evaluations": self._prop_evals.get(name, 0),
                        "hits": self._prop_hits.get(name, 0),
                    }
                    for name in sorted(
                        set(self._prop_evals) | set(self._prop_hits)
                    )
                },
            }
