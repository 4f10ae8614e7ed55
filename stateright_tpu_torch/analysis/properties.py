"""STR3xx — property well-formedness (the port's copy of
`stateright_tpu/analysis/properties.py`).

Properties are the point of a checking run; a malformed one wastes the
whole search. Duplicate names shadow each other in the discovery map, a
predicate that raises kills the engine mid-run (or worse, at depth
10^7), and an `eventually` property over a space with no reachable
terminal states can never produce a counterexample (the checker's
documented acyclic-path semantics) — the run silently proves nothing.

Codes:
  STR301  duplicate property names
  STR302  a predicate raises on a sampled state
  STR303  a predicate is constant over the entire sample (info; a
          `sometimes` that is never satisfied, or an `always` that is
          false on EVERY sampled state, usually means a typo)
  STR304  `eventually` property, but no terminal state is reachable
          (warning when the sample exhausted the space: counterexamples
          are impossible by construction)
  STR305  the model declares no properties at all (warning)
  STR306  an action slot is never enabled on any sampled state (warning
          when the sample exhausted the space: the action is DEAD — a
          mis-modeled guard or unreachable transition; the run verifies
          a smaller system than the one modeled). Static twin of the
          runtime dead-action detection in obs/coverage.py; only models
          with a statically known action universe (TensorModels) are
          checked.
"""

from __future__ import annotations

from typing import List

from ..core import Expectation, Model, Property
from .diagnostics import AnalysisReport, Severity
from .sampling import Sample


def _loc(model: Model, prop: Property) -> str:
    return f"{type(model).__name__}.properties[{prop.name!r}]"


def run(model: Model, sample: Sample, report: AnalysisReport) -> None:
    report.families_run.append("properties")
    _check_dead_actions(model, sample, report)
    try:
        props = list(model.properties())
    except BaseException as e:  # noqa: BLE001
        report.add(
            "STR302",
            Severity.ERROR,
            f"properties() raised {type(e).__name__}: {e}",
            f"{type(model).__name__}.properties",
            "property declaration must not depend on run state",
        )
        return

    if not props:
        report.add(
            "STR305",
            Severity.WARNING,
            "the model declares no properties; the checker would only "
            "count states",
            f"{type(model).__name__}.properties",
            "declare at least one always/sometimes/eventually property",
        )
        return

    seen = {}
    for p in props:
        if p.name in seen:
            report.add(
                "STR301",
                Severity.ERROR,
                f"duplicate property name {p.name!r} "
                f"({seen[p.name].expectation.value} and "
                f"{p.expectation.value}); discoveries key on the name, so "
                "one silently shadows the other",
                _loc(model, p),
                "give every property a unique name",
            )
        else:
            seen[p.name] = p

    has_eventually = any(
        p.expectation == Expectation.EVENTUALLY for p in props
    )
    if has_eventually and not sample.terminal_states:
        sev = Severity.WARNING if sample.exhausted else Severity.INFO
        report.add(
            "STR304",
            sev,
            "eventually-properties only produce counterexamples at "
            "TERMINAL states, and "
            + (
                "the reachable space has none (it is exhausted and every "
                "state has successors): counterexamples are impossible by "
                "construction"
                if sample.exhausted
                else f"none were reachable within the {sample.info().states}"
                "-state sample"
            ),
            f"{type(model).__name__}.properties",
            "add a within_boundary / target_max_depth so paths terminate, "
            "or model explicit completion states",
        )

    for p in seen.values():
        _check_predicate(model, p, sample, report)


def _check_dead_actions(
    model: Model, sample: Sample, report: AnalysisReport
) -> None:
    """STR306: action slots never enabled across the sampled space.

    Only models with a statically known action universe (TensorModels,
    whose actions are the `max_actions` index slots) can be checked —
    a rich model's action space is not enumerable without running it.
    """
    from ..tensor import TensorModelAdapter

    if not isinstance(model, TensorModelAdapter) or not sample.states:
        return
    tm = model.tm
    n_actions = tm.max_actions
    fired: set = set()
    for state in sample.states:
        try:
            acts: List[int] = []
            model.actions(state, acts)
        except BaseException:  # noqa: BLE001 - reported by STR1xx rules
            return
        fired.update(acts)
        if len(fired) == n_actions:
            return
    dead = [a for a in range(n_actions) if a not in fired]
    if not dead:
        return
    labels = ", ".join(tm.format_action(a) for a in dead)
    if sample.exhausted:
        report.add(
            "STR306",
            Severity.WARNING,
            f"action slot(s) {labels} are never enabled on ANY reachable "
            "state (the sample exhausted the space): dead transitions or "
            "mis-modeled guards — the checker verifies a smaller system "
            "than the one modeled",
            f"{type(tm).__name__}.step_lanes",
            "fix the guard, or remove the action slot if the transition "
            "is intentionally impossible",
            dead_actions=[int(a) for a in dead],
        )
    else:
        report.add(
            "STR306",
            Severity.INFO,
            f"action slot(s) {labels} never enabled within the "
            f"{len(sample.states)}-state sample (may still fire deeper); "
            "run-time coverage (Checker.coverage) settles it",
            f"{type(tm).__name__}.step_lanes",
            "",
            dead_actions=[int(a) for a in dead],
        )


def _check_predicate(
    model: Model, p: Property, sample: Sample, report: AnalysisReport
) -> None:
    values: List[bool] = []
    for state in sample.states:
        try:
            values.append(bool(p.condition(model, state)))
        except BaseException as e:  # noqa: BLE001
            report.add(
                "STR302",
                Severity.ERROR,
                f"predicate raised {type(e).__name__} on sampled state "
                f"{state!r}: {e}",
                _loc(model, p),
                "predicates must be total over reachable states "
                "(initial states included)",
            )
            return
    if len(values) < 2:
        return
    if all(values) and p.expectation == Expectation.SOMETIMES:
        report.add(
            "STR303",
            Severity.INFO,
            f"sometimes-property is satisfied by EVERY one of the "
            f"{len(values)} sampled states; it can only ever produce a "
            "trivial example",
            _loc(model, p),
            "a reachability property should start unsatisfied",
        )
    elif not any(values):
        if p.expectation == Expectation.ALWAYS:
            report.add(
                "STR303",
                Severity.WARNING,
                f"always-property is FALSE on every one of the "
                f"{len(values)} sampled states, including the initial "
                "states; the first processed state is a counterexample",
                _loc(model, p),
                "the predicate is likely inverted or over a wrong field",
            )
        elif sample.exhausted and p.expectation == Expectation.SOMETIMES:
            report.add(
                "STR303",
                Severity.WARNING,
                "sometimes-property is unsatisfiable: the reachable space "
                "is exhausted and no state satisfies it",
                _loc(model, p),
                "the checker will report a missing example; fix the "
                "predicate or the model",
            )
        elif p.expectation == Expectation.SOMETIMES:
            report.add(
                "STR303",
                Severity.INFO,
                f"sometimes-property unsatisfied within the "
                f"{len(values)}-state sample (may still be reachable "
                "deeper)",
                _loc(model, p),
                "",
            )
