"""Phase timers and gauges of a run: the part of
`stateright_tpu/obs/metrics.py MetricsRegistry` that the port's engines
use (`phase`, `add_phase`, `phase_ms`, `set_gauge`).

Phases are cumulative wall seconds by name (the engines' `device_era`:
each era's dispatch through its completed readback; the stage profiler's
`profiler_overhead` and `stage_*`), reported in milliseconds; gauges are
values that are not running counts. `Checker.telemetry()` carries the
gauges at its top level and the phases under `phase_ms`.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict


class _PhaseTimer:
    def __init__(self, registry: "MetricsRegistry", name: str):
        self._registry = registry
        self._name = name
        self._t0 = 0.0

    def __enter__(self) -> "_PhaseTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._registry.add_phase(self._name, time.perf_counter() - self._t0)


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._phase_secs: Dict[str, float] = {}
        self._gauges: Dict[str, Any] = {}

    def set_gauge(self, name: str, value: Any) -> None:
        with self._lock:
            self._gauges[name] = value

    def gauges(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._gauges)

    def phase(self, name: str) -> _PhaseTimer:
        """`with registry.phase("profiler_overhead"): ...` accumulates wall
        time."""
        return _PhaseTimer(self, name)

    def add_phase(self, name: str, secs: float) -> None:
        with self._lock:
            self._phase_secs[name] = self._phase_secs.get(name, 0.0) + secs

    def phase_ms(self) -> Dict[str, float]:
        """Cumulative milliseconds per phase (sorted by name)."""
        with self._lock:
            return {k: round(v * 1000.0, 3) for k, v in sorted(self._phase_secs.items())}
