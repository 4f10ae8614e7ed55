"""The lean part of `stateright_tpu/engines/common.py HostEngineBase`: the
run thread, join, counters, phase timers, coverage, sampling, the run
deadline, discovery bookkeeping, the speclint pre-flight and the stage
profiler's hook that the port's device engines need.
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import Any, Dict, Optional

from ..checker import Checker, CheckerBuilder
from ..obs import stageprof
from ..obs.coverage import Coverage
from ..obs.metrics import MetricsRegistry
from ..obs.sample import SpaceSampler, build_space_profile


class HostEngineBase(Checker):
    """Runs `_run` on a background thread; exceptions surface at join()."""

    def __init__(self, builder: CheckerBuilder, model=None, device=None):
        self._model = model if model is not None else builder.model
        self._properties = self._model.properties()
        self._target_state_count = builder.target_state_count_
        self._target_max_depth = builder.target_max_depth_
        self._finish_when = builder.finish_when_
        self._timeout = builder.timeout_
        self._deadline = (
            time.monotonic() + self._timeout if self._timeout is not None else None
        )
        self._symmetry = builder.symmetry_fn_
        self._sampler: Optional[SpaceSampler] = (
            SpaceSampler(k=builder.sample_k_) if builder.sample_ else None
        )
        self._space_profile_cache: Optional[Dict[str, Any]] = None

        self._state_count = 0
        self._max_depth = 0
        # Run counters (eras, steps, table growths, ...) and gauges,
        # read by telemetry().
        self._counters: Dict[str, int] = {}
        # Phase timers (device_era, the stage profiler's) and its gauges.
        self._metrics = MetricsRegistry()
        # Speclint pre-flight (analysis/) on the engine's own device, before
        # any kernel launch: in strict mode the engine refuses to launch
        # over error-severity findings; whenever a report exists (strict
        # or an explicit builder.lint()), its counts ride into telemetry.
        self._lint_preflight(builder, device)
        self._stage_profile = builder.stage_profile_
        self._stage_iters = builder.stage_profile_iters_
        self._coverage = Coverage(enabled=builder.coverage_)
        self._coverage.register_properties(p.name for p in self._properties)
        tm = getattr(self._model, "tm", None)
        if tm is not None:
            self._coverage.register_actions(
                tm.format_action(a) for a in range(tm.max_actions)
            )
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    def _lint_preflight(self, builder: CheckerBuilder, device) -> None:
        report = builder.lint_report_
        if builder.strict_ and report is None:
            report = builder.lint(samples=builder.strict_samples_, device=device)
        if report is None:
            return
        for code, n in report.counts_by_code().items():
            self._inc(f"lint_{code}", n)
        self._metrics.set_gauge("lint_errors", len(report.errors))
        self._metrics.set_gauge("lint_warnings", len(report.warnings))
        if builder.strict_ and not report.ok:
            from ..analysis import SpecLintError

            raise SpecLintError(report)

    def _start(self) -> None:
        self._thread = threading.Thread(target=self._run_guarded, daemon=True)
        self._thread.start()

    def _run_guarded(self) -> None:
        try:
            self._run()
        except BaseException as e:  # surfaces at join(), like a Rust panic
            self._error = e
        finally:
            self._done.set()

    def _run(self) -> None:
        raise NotImplementedError

    def join(self) -> "HostEngineBase":
        if self._thread is not None:
            self._thread.join()
        if self._error is not None:
            raise self._error
        return self

    def is_done(self) -> bool:
        return self._done.is_set()

    def state_count(self) -> int:
        return self._state_count

    def max_depth(self) -> int:
        return self._max_depth

    def coverage(self) -> Dict[str, Any]:
        return self._coverage.snapshot()

    def telemetry(self) -> Dict[str, Any]:
        tel: Dict[str, Any] = dict(self._counters)
        tel.update(self._metrics.gauges())
        phases = self._metrics.phase_ms()
        if phases:
            tel["phase_ms"] = phases
        if self._sampler is not None and self._sampler.size():
            tel["space"] = self._sampler.snapshot()
        return tel

    def _sample_resolver(self):
        """fp64 -> {"state", "pred", "action", "depth"} backfill for samples
        drained fingerprint-only; None when rows came with the offer."""
        return None

    def space_profile(self) -> Dict[str, Any]:
        """Built on demand, cached once the run is done (the device
        engine resolves sample rows by path reconstruction)."""
        if self._sampler is None or not self._sampler.size():
            return {}
        if self._space_profile_cache is not None:
            return self._space_profile_cache
        profile = build_space_profile(
            self._model, self._sampler, resolver=self._sample_resolver()
        )
        if self.is_done():
            self._space_profile_cache = profile
        return profile

    def _inc(self, name: str, n: int = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + int(n)

    def _gauge(self, name: str, value) -> None:
        """Set a telemetry value that is not a running count."""
        self._counters[name] = value

    def _profile_stages(self, build, steps: int) -> None:
        """Post-run per-stage attribution of the device_era time
        (CheckerBuilder.stage_profile(); obs/stageprof.py): `build()`
        returns the run's stage programs (engines/stages.py, cached and
        shared between runs: held under their lock) and the run's final
        state for their `load`. Never fatal: a finished run's results
        survive a profiler failure, which sets the `stage_profile_error`
        gauge."""
        if not self._stage_profile:
            return
        try:
            era_secs = self._metrics.phase_ms().get("device_era", 0.0) / 1e3
            if steps <= 0 or era_secs <= 0.0:
                return
            with self._metrics.phase("profiler_overhead"):
                progs, state = build()
                with progs.lock:
                    try:
                        progs.load(*state)
                        stages, null = progs.programs()
                        timed = stageprof.measure_stage_programs(stages, null, self._stage_iters)
                    finally:
                        progs.release()
            stageprof.attribute_stages(self._metrics, timed, era_secs, steps, self._stage_iters)
        except Exception as exc:
            self._metrics.set_gauge("stage_profile_error", repr(exc)[:200])
            warnings.warn(f"stage profiling failed (run results unaffected): {exc!r}",
                          RuntimeWarning, stacklevel=2)

    def _timed_out(self) -> bool:
        return self._deadline is not None and time.monotonic() >= self._deadline

    def _finish_matched(self, discoveries: Dict[str, Any]) -> bool:
        return self._finish_when.matches(set(discoveries), self._properties)
