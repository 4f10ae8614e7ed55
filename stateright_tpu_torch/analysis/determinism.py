"""STR1xx — determinism and purity of the host model interface (the
port's copy of `stateright_tpu/analysis/determinism.py`; host-only).

The checker's core assumption is that a `Model` is a pure description of
a transition system: `actions` and `next_state` are functions of their
arguments, states are immutable values with stable fingerprints, and
`init_states` yields the same set every call. Violations (a hidden RNG,
set-iteration-order leakage, in-place mutation of the input state) do not
crash — they silently corrupt the search: the visited set dedups against
fingerprints that no longer mean anything, and the verdict hours later is
garbage. These rules REPLAY the callbacks on sampled states and compare.

Codes:
  STR101  `actions` is nondeterministic (replays disagree as sets)
  STR102  `next_state` is nondeterministic (replay fingerprints disagree)
  STR103  `actions`/`next_state` mutates its input state
  STR104  a reachable state cannot be fingerprinted
  STR105  fingerprinting the same state twice gives different values
  STR106  `init_states` is nondeterministic across calls
  STR108  `actions` replays agree as sets but disagree in ORDER (warning)
"""

from __future__ import annotations

from typing import Any, List

from ..core import Model
from .diagnostics import AnalysisReport, Severity
from .sampling import Sample

REPLAYS = 3  # replay count per callback (2 detects, 3 resists luck)


def _loc(model: Model, member: str) -> str:
    return f"{type(model).__name__}.{member}"


def _fp_or_none(model: Model, state: Any):
    try:
        return model.fingerprint_state(state)
    except BaseException:  # noqa: BLE001
        return None


def run(model: Model, sample: Sample, report: AnalysisReport) -> None:
    report.families_run.append("determinism")
    if sample.error is not None and not sample.states:
        report.add(
            "STR104",
            Severity.ERROR,
            f"model raised {type(sample.error).__name__} in "
            f"{sample.error_site} before any state could be sampled: "
            f"{sample.error}",
            _loc(model, sample.error_site or "init_states"),
            "make the model callbacks total over reachable states",
        )
        return

    _check_init_states(model, report)
    mutation_reported = False
    act_nondet_reported = False
    order_reported = False
    next_nondet_reported = False
    fp_bad_reported = False

    for state in sample.states:
        fp_before = _fp_or_none(model, state)
        if fp_before is None and not fp_bad_reported:
            report.add(
                "STR104",
                Severity.ERROR,
                f"state {state!r} cannot be fingerprinted (fingerprint_state "
                "raised); the visited set cannot dedup it",
                _loc(model, "fingerprint_state"),
                "use dataclasses/builtin containers for state, or define "
                "fingerprint_key()",
            )
            fp_bad_reported = True
        elif fp_before is not None and not fp_bad_reported:
            fp_again = _fp_or_none(model, state)
            if fp_again != fp_before:
                report.add(
                    "STR105",
                    Severity.ERROR,
                    f"fingerprinting state {state!r} twice gave "
                    f"{fp_before} then {fp_again}; dedup and path "
                    "reconstruction require stable fingerprints",
                    _loc(model, "fingerprint_state"),
                    "remove identity/address-dependent data (object ids, "
                    "unhashed memo fields) from the state encoding",
                )
                fp_bad_reported = True

        # Replay `actions` REPLAYS times; compare as sequences AND sets.
        runs: List[List[Any]] = []
        try:
            for _ in range(REPLAYS):
                acts: List[Any] = []
                model.actions(state, acts)
                runs.append(acts)
        except BaseException as e:  # noqa: BLE001
            report.add(
                "STR104",
                Severity.ERROR,
                f"actions raised {type(e).__name__} on sampled state "
                f"{state!r}: {e}",
                _loc(model, "actions"),
                "make actions total over reachable states",
            )
            return
        if not act_nondet_reported:
            reprs = [sorted(repr(a) for a in r) for r in runs]
            if any(r != reprs[0] for r in reprs[1:]):
                report.add(
                    "STR101",
                    Severity.ERROR,
                    f"actions returned different action SETS across "
                    f"{REPLAYS} replays on state {state!r} "
                    f"(e.g. {runs[0]!r} vs {runs[1]!r}); hidden randomness "
                    "or iteration over an unordered container",
                    _loc(model, "actions"),
                    "derive actions only from the state argument; sort any "
                    "set/dict iteration",
                )
                act_nondet_reported = True
            elif not order_reported and any(
                [repr(a) for a in r] != [repr(a) for a in runs[0]]
                for r in runs[1:]
            ):
                report.add(
                    "STR108",
                    Severity.WARNING,
                    f"actions returned the same set in different ORDER "
                    f"across replays on state {state!r}; golden traces and "
                    "path reconstruction depend on a stable order",
                    _loc(model, "actions"),
                    "iterate deterministically (sorted) when appending "
                    "actions",
                )
                order_reported = True

        # Mutation + next_state determinism, per action.
        if fp_before is not None:
            fp_after_actions = _fp_or_none(model, state)
            if (
                fp_after_actions != fp_before
                and not mutation_reported
            ):
                report.add(
                    "STR103",
                    Severity.ERROR,
                    f"calling actions mutated its input state {state!r} "
                    f"(fingerprint changed {fp_before} -> {fp_after_actions})",
                    _loc(model, "actions"),
                    "treat the state argument as read-only",
                )
                mutation_reported = True
        for action in runs[0]:
            try:
                n1 = model.next_state(state, action)
                n2 = model.next_state(state, action)
            except BaseException as e:  # noqa: BLE001
                report.add(
                    "STR104",
                    Severity.ERROR,
                    f"next_state raised {type(e).__name__} on sampled "
                    f"state {state!r}, action {action!r}: {e}",
                    _loc(model, "next_state"),
                    "make next_state total over (reachable state, enabled "
                    "action) pairs",
                )
                return
            if not next_nondet_reported:
                f1 = None if n1 is None else _fp_or_none(model, n1)
                f2 = None if n2 is None else _fp_or_none(model, n2)
                if f1 != f2:
                    report.add(
                        "STR102",
                        Severity.ERROR,
                        f"next_state({state!r}, {action!r}) gave different "
                        f"successors across replays ({n1!r} vs {n2!r}); "
                        "hidden randomness corrupts the search",
                        _loc(model, "next_state"),
                        "derive the successor only from (state, action)",
                    )
                    next_nondet_reported = True
            if fp_before is not None and not mutation_reported:
                fp_after = _fp_or_none(model, state)
                if fp_after != fp_before:
                    report.add(
                        "STR103",
                        Severity.ERROR,
                        f"next_state({state!r}, {action!r}) mutated its "
                        f"input state (fingerprint changed {fp_before} -> "
                        f"{fp_after}); every sibling expansion after it "
                        "sees a corrupted parent",
                        _loc(model, "next_state"),
                        "build the successor from copies "
                        "(dataclasses.replace, tuple rebuilds) instead of "
                        "editing the input in place",
                    )
                    mutation_reported = True

    if sample.error is not None:
        report.add(
            "STR104",
            Severity.ERROR,
            f"sampling stopped early: {sample.error_site} raised "
            f"{type(sample.error).__name__}: {sample.error}",
            _loc(model, sample.error_site),
            "make the model callbacks total over reachable states",
        )


def _check_init_states(model: Model, report: AnalysisReport) -> None:
    try:
        runs = [list(model.init_states()) for _ in range(REPLAYS)]
    except BaseException:  # noqa: BLE001 - sampling already reported it
        return
    keys = []
    for r in runs:
        try:
            keys.append(sorted(str(model.fingerprint_state(s)) for s in r))
        except BaseException:  # noqa: BLE001
            keys.append(sorted(repr(s) for s in r))
    if any(k != keys[0] for k in keys[1:]):
        report.add(
            "STR106",
            Severity.ERROR,
            f"init_states returned different state sets across {REPLAYS} "
            f"calls (e.g. {runs[0]!r} vs {runs[1]!r})",
            _loc(model, "init_states"),
            "construct initial states deterministically",
        )
