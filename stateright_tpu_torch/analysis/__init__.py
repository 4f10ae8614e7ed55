"""speclint: pre-flight static analysis of models, properties and symmetry
(the port's counterpart of `stateright_tpu/analysis`).

`analyze(model)` replays the model's callbacks over a bounded
breadth-first sample of its own state space and runs the rule families:

  1. determinism/purity  (STR1xx, analysis/determinism.py) — hidden RNG,
     set-iteration-order nondeterminism, in-place mutation of the input
     state, unhashable or unstable fingerprints;
  2. device compatibility (STR2xx, analysis/device.py; TensorModels) —
     `step_lanes` and `within_boundary_lanes` captured as the era
     captures them (on the card a CUDA graph, on the CPU meta lanes),
     shape/dtype of the port's lanes, uint32 packing overflow, numpy
     against the device through the agreement table (K16a),
     `decode_state` round-trips;
  3. property well-formedness (STR3xx, analysis/properties.py) —
     duplicate names, raising predicates, constant-on-sample predicates,
     `eventually` without reachable terminal states, dead actions;
  4. symmetry soundness (STR4xx, analysis/symmetry.py) —
     `representative()` idempotence, property preservation, and
     numpy/device agreement of `representative_lanes`;
  5. spawnability (STR5xx): ActorModels only, which the port has not
     copied yet, so the family runs nothing, as the JAX package's skips
     tensor models.

The compiled-program lint (STR6xx, the JAX package's `program` family)
comes with slice 6c (the program lint over the port's CUDA graphs);
asking for it raises.

Wire-in points:

  - ``model.checker().lint()`` runs it over a builder's model + options;
  - ``model.checker().strict()`` runs it before every engine spawn
    (`spawn_gpu_bfs`, `spawn_gpu_simulation`, `spawn_sharded_bfs`) and
    refuses to launch on error-severity findings (`SpecLintError`);
  - ``python -m stateright_tpu_torch.analysis MODEL`` lints from the shell;
  - diagnostic counts land in those engines' telemetry as ``lint_<code>``
    counters, with the ``lint_errors`` and ``lint_warnings`` gauges.

The code -> meaning -> fix catalog lives in `analysis/README.md`.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional

import numpy as np

from ..checker import SLICE_PROGLINT, not_ported
from ..core import Model
from ..tensor import TensorModel, TensorModelAdapter
from . import determinism, properties, symmetry
from . import device as device_rules
from .diagnostics import (
    AnalysisReport,
    Diagnostic,
    SampleInfo,
    Severity,
    SpecLintError,
)
from .sampling import Sample, sample_states

__all__ = [
    "AnalysisReport",
    "Diagnostic",
    "Sample",
    "SampleInfo",
    "Severity",
    "SpecLintError",
    "analyze",
    "sample_states",
]

ALL_FAMILIES = ("determinism", "device", "properties", "symmetry", "spawn")
# The JAX package's sixth family; its port comes with slice 6c.
NOT_PORTED_FAMILIES = ("program",)

# Device-rule batch width: running step_lanes on more rows buys no
# additional coverage for shape/dtype/divergence findings, and keeps the
# pre-flight cheap enough for strict mode.
_DEVICE_BATCH = 128


def analyze(
    model: Any,
    *,
    samples: int = 256,
    families: Iterable[str] = ALL_FAMILIES,
    symmetry_fn: Optional[Callable[[Any], Any]] = None,
    orbit_fn: Optional[Callable[[Any], List[Any]]] = None,
    device=None,
) -> AnalysisReport:
    """Statically analyze `model` before spending a checking run on it.

    `model` may be a host `Model`, a `TensorModel`, or a
    `TensorModelAdapter`; tensor models additionally get the device rule
    family over their lane programs, run on `device` (the card unless the
    caller passes ``device="cpu"``; no card and no CPU request raises).
    `samples` bounds the breadth-first state sample the rules replay on.
    `symmetry_fn` lints an explicit canonicalizer (e.g. the one handed to
    `CheckerBuilder.symmetry_fn`); `orbit_fn(state) -> [equivalent
    states]` additionally cross-checks representative agreement across a
    known symmetry orbit.

    Returns an `AnalysisReport`; `report.ok` is False iff any finding is
    error-severity (those mean the checker's verdicts cannot be trusted).
    """
    families = tuple(families)
    if set(families) & set(NOT_PORTED_FAMILIES):
        raise not_ported("the program lint (the STR6xx family)", SLICE_PROGLINT)
    unknown = set(families) - set(ALL_FAMILIES)
    if unknown:
        raise ValueError(
            f"unknown rule families {sorted(unknown)}; "
            f"available: {ALL_FAMILIES}"
        )

    tm: Optional[TensorModel] = None
    if isinstance(model, TensorModel):
        tm = model
        host: Model = TensorModelAdapter(model)
    elif isinstance(model, TensorModelAdapter):
        tm = model.tm
        host = model
    elif isinstance(model, Model):
        host = model
    else:
        raise TypeError(
            f"analyze() wants a Model, TensorModel, or TensorModelAdapter; "
            f"got {type(model).__name__}"
        )
    dev = None
    if tm is not None and ({"device", "symmetry"} & set(families)):
        from ..engines.gpu_bfs import resolve_device

        dev = resolve_device(device)

    name = type(tm).__name__ if tm is not None else type(host).__name__
    report = AnalysisReport(name)
    sample = sample_states(host, samples)
    report.sample = sample.info()

    rows: Optional[np.ndarray] = None
    if tm is not None and sample.states:
        take = sample.states[:_DEVICE_BATCH]
        try:
            rows = np.asarray(take, dtype=np.uint32)
        except (TypeError, ValueError, OverflowError):
            rows = np.zeros((0, tm.state_width), dtype=np.uint32)

    if "determinism" in families:
        determinism.run(host, sample, report)
    if "device" in families and tm is not None:
        device_rules.run(tm, rows if rows is not None else np.zeros((0, 0)), report, dev)
    if "properties" in families:
        properties.run(host, sample, report)
    if "symmetry" in families:
        symmetry.run(
            host,
            sample,
            report,
            symmetry_fn=symmetry_fn,
            tm=tm,
            rows=rows,
            orbit_fn=orbit_fn,
            device=dev,
        )
    # "spawn" (STR5xx) applies to ActorModels only; the port has none yet.
    return report
