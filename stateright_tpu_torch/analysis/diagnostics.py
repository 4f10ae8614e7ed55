"""Diagnostic records for the speclint static-analysis pass (the port's
copy of `stateright_tpu/analysis/diagnostics.py`).

Every finding is a `Diagnostic` with a STABLE code (grep-able, pinnable in
CI, and counted into the obs metrics registry as ``lint_<code>``), a
severity, a location (model class + member), and a suggested fix. Codes
group by rule family:

  ``STR1xx``  determinism / purity of the host model interface
  ``STR2xx``  device (jit/vmap/encoding) compatibility of TensorModels
  ``STR3xx``  property well-formedness
  ``STR4xx``  symmetry-reduction soundness
  ``STR5xx``  spawnability (wire round-trip) of ActorModel messages
  ``STR6xx``  compiled-program lint ("proglint"); not ported yet (it
              comes with slice 6c, the program lint over the port's
              CUDA graphs)

The full code -> meaning -> fix catalog lives in `analysis/README.md`.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List


class Severity(enum.Enum):
    """How bad a finding is.

    ERROR findings mean the checker's verdicts cannot be trusted (hidden
    nondeterminism, state mutation, host/device divergence, unsound
    symmetry); strict mode refuses to launch engines over them. WARNING
    findings are probable spec mistakes that do not by themselves corrupt
    the search. INFO findings are observations (e.g. a `sometimes`
    property never satisfied within the sample).
    """

    ERROR = "error"
    WARNING = "warning"
    INFO = "info"


@dataclass
class Diagnostic:
    """One speclint finding."""

    code: str  # stable id, e.g. "STR103"
    severity: Severity
    message: str  # what was observed, with concrete evidence
    location: str  # "ModelClass.member" the finding anchors to
    suggestion: str = ""  # how to fix it
    details: Dict[str, Any] = field(default_factory=dict)

    def format(self) -> str:
        head = f"{self.code} {self.severity.value:<7} {self.location}: {self.message}"
        if self.suggestion:
            head += f"\n    fix: {self.suggestion}"
        return head


@dataclass
class SampleInfo:
    """What the state sampler actually covered (findings are only as good
    as the sample; exhausted=True means the WHOLE reachable space was
    examined)."""

    states: int = 0
    max_depth: int = 0
    exhausted: bool = False
    terminal_states: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "states": self.states,
            "max_depth": self.max_depth,
            "exhausted": self.exhausted,
            "terminal_states": self.terminal_states,
        }


class AnalysisReport:
    """The result of one `analyze()` run: diagnostics plus sample coverage."""

    def __init__(self, model_name: str):
        self.model_name = model_name
        self.diagnostics: List[Diagnostic] = []
        self.sample = SampleInfo()
        self.families_run: List[str] = []
        # The device probes' CUDA graphs (analysis/probe.py): captures,
        # their seconds and replays. The port's own; not in `to_dict`.
        self.probes: Dict[str, Any] = {"captures": 0, "capture_secs": 0.0, "graph_launches": 0}

    # -- accumulation (rule modules call this) -------------------------------

    def add(
        self,
        code: str,
        severity: Severity,
        message: str,
        location: str,
        suggestion: str = "",
        **details: Any,
    ) -> Diagnostic:
        d = Diagnostic(code, severity, message, location, suggestion, details)
        self.diagnostics.append(d)
        return d

    def note_probe(self, probe) -> None:
        self.probes["captures"] += int(probe.graph is not None)
        self.probes["capture_secs"] += probe.capture_secs
        self.probes["graph_launches"] += probe.launches

    # -- queries -------------------------------------------------------------

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity is Severity.ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity is Severity.WARNING]

    @property
    def ok(self) -> bool:
        """True when no error-severity findings exist."""
        return not self.errors

    def by_code(self, code: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    def counts_by_code(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for d in self.diagnostics:
            out[d.code] = out.get(d.code, 0) + 1
        return dict(sorted(out.items()))

    # -- export --------------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {
            "model": self.model_name,
            "ok": self.ok,
            "errors": len(self.errors),
            "warnings": len(self.warnings),
            "counts_by_code": self.counts_by_code(),
            "sample": self.sample.to_dict(),
            "families_run": list(self.families_run),
            "diagnostics": [
                {
                    "code": d.code,
                    "severity": d.severity.value,
                    "location": d.location,
                    "message": d.message,
                    "suggestion": d.suggestion,
                }
                for d in self.diagnostics
            ],
        }

    def format(self) -> str:
        lines = [
            f"speclint: {self.model_name} — "
            f"{len(self.errors)} error(s), {len(self.warnings)} warning(s), "
            f"{len(self.diagnostics) - len(self.errors) - len(self.warnings)} "
            f"note(s) over {self.sample.states} sampled state(s)"
            + (" [space exhausted]" if self.sample.exhausted else "")
        ]
        order = {Severity.ERROR: 0, Severity.WARNING: 1, Severity.INFO: 2}
        for d in sorted(self.diagnostics, key=lambda d: (order[d.severity], d.code)):
            lines.append("  " + d.format().replace("\n", "\n  "))
        if not self.diagnostics:
            lines.append("  clean: no findings")
        return "\n".join(lines)

    def raise_on_errors(self) -> "AnalysisReport":
        if self.errors:
            raise SpecLintError(self)
        return self


class SpecLintError(Exception):
    """Raised when strict mode refuses to launch over error findings."""

    def __init__(self, report: AnalysisReport):
        self.report = report
        codes = ", ".join(sorted({d.code for d in report.errors}))
        super().__init__(
            f"speclint found {len(report.errors)} error-severity finding(s) "
            f"({codes}) on {report.model_name}; fix the model or launch "
            f"without strict mode.\n{report.format()}"
        )
