"""The lean part of `stateright_tpu/engines/common.py HostEngineBase`: the
run thread, join, counters, phase timers, coverage, sampling, the run
deadline, discovery bookkeeping, the speclint pre-flight, the stage
profiler's hook and the graceful-stop request that the port's device
engines need; and a copy of its checkpoint IO (:708-1221), host code in
the reference's file format, so a checkpoint written by either package
resumes on the other: the identity meta, the crash-safe generations, the
delta chain and the SIGTERM/SIGINT flush.
"""

from __future__ import annotations

import logging
import threading
import time
import warnings
from typing import Any, Dict, Optional

from ..checker import Checker, CheckerBuilder
from ..obs import stageprof
from ..obs.coverage import Coverage
from ..obs.metrics import MetricsRegistry
from ..obs.sample import SpaceSampler, build_space_profile

_log = logging.getLogger(__name__)


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
        # Set by request_checkpoint_stop() (and the SIGTERM/SIGINT flush):
        # the checkpointing engines poll it at era boundaries.
        self._ckpt_stop = threading.Event()
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

    def request_checkpoint_stop(self) -> None:
        """Ask the run to stop at its next era boundary, flushing a final
        checkpoint first (checkpointing engines poll this; the others
        finish their run). Thread- and signal-safe: only sets an event."""
        self._ckpt_stop.set()

    def interrupted(self) -> bool:
        """True when the run stopped early on a graceful-stop request
        (SIGTERM/SIGINT flush or an explicit request_checkpoint_stop)."""
        return self._ckpt_stop.is_set() and self._done.is_set()

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

    def _counted(self) -> "EngineCounters":
        """The engine's counters and phase timers as the `metrics` the
        checkpoint IO below takes."""
        return EngineCounters(self)

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


class EngineCounters:
    """`inc` on an engine's counters and `add_phase` on its phase timers:
    the `metrics` argument of the checkpoint IO."""

    def __init__(self, engine: HostEngineBase):
        self.inc = engine._inc
        self.add_phase = engine._metrics.add_phase


# -- checkpoint metadata (shared by the device engines) ----------------------

FP_VER = 2  # the decorrelated hash pair (fingerprint.py)
_PORT_PKG = "stateright_tpu_torch"
_JAX_PKG = "stateright_tpu"


def _model_name(name):
    """A checkpoint's model name without its package: the JAX package's
    and the port's copies of one model are one model."""
    if isinstance(name, str):
        for pkg in (_PORT_PKG, _JAX_PKG):
            if name.startswith(pkg + "."):
                return name[len(pkg):]
    return name


def _warn(msg: str, **fields) -> None:
    _log.warning("%s %s", msg, fields)


def checkpoint_meta(tm, tprops, **fields) -> dict:
    """Common identity header for engine checkpoints: fingerprint version,
    model class + parameter digest, and property set — a resumed table is
    only meaningful for the exact model, properties, and hash that wrote
    it. Engine-specific fields are passed through."""
    meta = {
        "fp_ver": FP_VER,
        "model": f"{type(tm).__module__}.{type(tm).__qualname__}",
        "model_config": tm.config_digest(),
        "prop_names": [p.name for p in tprops],
        "state_width": tm.state_width,
    }
    meta.update(fields)
    return meta


def validate_checkpoint_meta(meta: dict, tm, tprops, exact: dict) -> None:
    """Reject a checkpoint whose identity or layout does not match this
    checker. `exact` maps field name -> required value (qcap, n_shards,
    chunk, quota, ...); every listed field must match exactly. A model
    written by the JAX package (`stateright_tpu.` in place of
    `stateright_tpu_torch.`) with the same qualname and config digest is
    the same model: the two packages share the file format."""
    if meta.get("fp_ver") != FP_VER:
        raise ValueError(
            "checkpoint was written with a different fingerprint hash "
            f"version ({meta.get('fp_ver')!r} != {FP_VER}); its table keys "
            "are incompatible"
        )
    this_model = f"{type(tm).__module__}.{type(tm).__qualname__}"
    if _model_name(meta.get("model")) != _model_name(this_model):
        raise ValueError(
            f"checkpoint was written by model {meta.get('model')!r}; "
            f"resuming it with {this_model!r} would silently produce wrong "
            "results"
        )
    if meta.get("model_config") != tm.config_digest():
        raise ValueError(
            f"checkpoint was written with model config "
            f"{meta.get('model_config')!r}; this instance has "
            f"{tm.config_digest()!r} — same-width different-parameter "
            "models must not share a visited table"
        )
    this_props = [p.name for p in tprops]
    if meta.get("prop_names") != this_props:
        raise ValueError(
            f"checkpoint property set {meta.get('prop_names')} does not "
            f"match this checker's {this_props}; rec_fp/rec_bits would "
            "misalign"
        )
    for field, want in exact.items():
        if meta.get(field) != want:
            raise ValueError(
                f"checkpoint {field}={meta.get(field)!r} does not match "
                f"this checker's {want!r}; resume with matching engine "
                "options"
            )


# -- crash-safe checkpoint IO (shared by the device engines) ------------------
#
# The write protocol: serialize to `<path>.tmp.npz`, fsync the file, rotate
# the previous generations (`<path>` -> `<path>.1` -> ... -> `<path>.N-1`),
# rename the tmp over `<path>`, and fsync the directory so the rename itself
# survives a crash. Every checkpoint carries a sha256 content digest in its
# meta; the loader recomputes it and rejects truncated/corrupt files with
# CheckpointCorruptError, falling back to the previous good generation.


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file is unreadable, truncated, or fails its digest."""


def validate_checkpoint_cadence(checkpoint_every, checkpoint_path,
                                keep_checkpoints) -> None:
    """Builder-time validation of the checkpoint knobs, shared by the
    device engines. `checkpoint_every` is wall-clock SECONDS between
    periodic checkpoints (polled at era boundaries); non-positive values
    are a configuration error, not "checkpoint constantly"."""
    if checkpoint_every is not None:
        if checkpoint_path is None:
            raise ValueError(
                "checkpoint_every requires checkpoint_path (nothing would "
                "be written otherwise)"
            )
        if not float(checkpoint_every) > 0.0:
            raise ValueError(
                "checkpoint_every is wall-clock seconds between periodic "
                f"checkpoints and must be positive (got {checkpoint_every!r}); "
                "omit it to checkpoint only at run end"
            )
    if keep_checkpoints < 1:
        raise ValueError(
            f"keep_checkpoints must be >= 1 (got {keep_checkpoints})"
        )


def _checkpoint_digest(arrays: dict) -> str:
    """sha256 over every payload array's name, dtype, shape, and bytes
    (sorted by name; the meta array itself is excluded — it carries the
    digest)."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for name in sorted(arrays):
        if name == "meta":
            continue
        a = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def checkpoint_generations(path: str) -> list:
    """All on-disk generations for `path`, newest first (`path`, then
    `path.1`, `path.2`, ...)."""
    import os

    out = [path] if os.path.exists(path) else []
    g = 1
    while os.path.exists(f"{path}.{g}"):
        out.append(f"{path}.{g}")
        g += 1
    return out


def _write_npz_atomic(path: str, meta: dict, arrays: dict) -> dict:
    """Digest + serialize one npz to ``path + ".tmp.npz"``, fsynced.
    Returns the final meta (with the digest); the caller finishes the
    rename so it can interleave generation rotation."""
    import json
    import os

    import numpy as np

    meta = dict(meta)
    meta["digest"] = _checkpoint_digest(arrays)
    payload = dict(arrays)
    payload["meta"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    ).copy()
    tmp = path + ".tmp.npz"  # savez appends .npz to bare paths otherwise
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    return meta


def _fsync_dir(path: str) -> None:
    import os

    try:
        dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # platforms without directory fsync still get the file fsync


def save_checkpoint_atomic(path: str, meta: dict, arrays: dict, *,
                           keep: int = 1, metrics=None) -> dict:
    """Write one checkpoint crash-safely: tmp + fsync + generation rotation
    + rename + directory fsync, with the content digest in the manifest.
    Returns the final meta — the delta layer pins its chain to the
    returned ``digest``."""
    import os

    t0 = time.monotonic()
    meta = _write_npz_atomic(path, meta, arrays)
    tmp = path + ".tmp.npz"
    # Rotate the survivors BEFORE the rename lands: the previous good
    # checkpoint must exist (as `.1`) at every instant a crash could hit.
    if keep > 1 and os.path.exists(path):
        for g in range(keep - 1, 1, -1):
            older = f"{path}.{g - 1}"
            if os.path.exists(older):
                os.replace(older, f"{path}.{g}")
        os.replace(path, f"{path}.1")
    os.replace(tmp, path)
    _fsync_dir(path)
    if metrics is not None:
        metrics.inc("checkpoint_saves")
        metrics.inc("checkpoint_bytes", os.path.getsize(path))
        metrics.add_phase("checkpoint_save", time.monotonic() - t0)
    return meta


def load_checkpoint_verified(path: str):
    """Load one checkpoint file and verify its content digest. Returns
    ``(arrays, meta)``; raises CheckpointCorruptError on an unreadable
    zip, missing/garbled meta, or digest mismatch."""
    import json

    import numpy as np

    try:
        data = np.load(path)
        meta = json.loads(bytes(data["meta"]).decode())
        arrays = {k: data[k] for k in data.files if k != "meta"}
    except Exception as exc:
        raise CheckpointCorruptError(
            f"checkpoint {path!r} is unreadable (truncated or corrupt): "
            f"{type(exc).__name__}: {exc}"
        ) from exc
    want = meta.get("digest")
    if want is None:
        raise CheckpointCorruptError(
            f"checkpoint {path!r} carries no content digest (pre-durability "
            "layout); re-create it with the current engine"
        )
    got = _checkpoint_digest(arrays)
    if got != want:
        raise CheckpointCorruptError(
            f"checkpoint {path!r} fails its content digest "
            f"({got[:12]}... != recorded {want[:12]}...); the file is corrupt"
        )
    return arrays, meta


def load_checkpoint_with_fallback(path: str, metrics=None):
    """Load the newest verifiable checkpoint generation. A corrupt or
    truncated `path` falls back to `path.1`, `path.2`, ... (written by
    `save_checkpoint_atomic(keep=N)`); only when every generation fails
    does the error propagate, carrying each failure."""
    candidates = checkpoint_generations(path)
    if not candidates:
        raise FileNotFoundError(f"no checkpoint at {path!r}")
    failures = []
    for cand in candidates:
        try:
            arrays, meta = load_checkpoint_verified(cand)
        except CheckpointCorruptError as exc:
            failures.append(str(exc))
            if metrics is not None:
                metrics.inc("checkpoint_corrupt_rejected")
            continue
        if cand != path:
            if metrics is not None:
                metrics.inc("checkpoint_fallbacks")
            _warn(
                "checkpoint rejected; resuming from previous generation",
                path=path,
                reason=failures[-1] if failures else "missing",
                fallback=cand,
            )
        return arrays, meta
    raise CheckpointCorruptError(
        "no loadable checkpoint generation:\n  " + "\n  ".join(failures)
    )


# -- incremental delta checkpoints (on top of the generational protocol
# above) -----------------------------------------------------------------
#
# A large visited table rewrites gigabytes every cadence tick under the
# full-save protocol, yet between ticks only newly claimed slots change
# (slots never move absent a rehash, and a rehash doubles tcap — which
# forces a fresh base). A delta checkpoint therefore carries: every
# non-table array verbatim (ring, heads/counts, rec fps, spill blocks —
# all small next to the table) plus ONLY the table slots occupied since
# the BASE generation was written (cumulative-vs-base, so a single
# delta + the base reconstructs the newest state and every older delta
# is disposable). The meta manifest pins the chain to the base's content
# digest and records per-region occupancy watermarks; the fold validates
# both, and any failure falls back delta-by-delta to the plain base
# (then the base's own generation fallback). Rolling compaction: once
# the chain reaches DELTA_CHAIN_MAX the next save is a fresh full base
# and the old chain is cleared.

DELTA_CHAIN_MAX = 4
# Occupancy watermarks are recorded per probe region (equal flat-index
# stripes of the table): a fold that silently dropped or duplicated
# rows shows up as a region-count mismatch even when digests agree.
TABLE_DELTA_REGIONS = 64


def delta_chain_paths(path: str) -> list:
    """On-disk delta chain for base `path`, oldest first
    (`path.d1`, `path.d2`, ...)."""
    import os

    out = []
    g = 1
    while os.path.exists(f"{path}.d{g}"):
        out.append(f"{path}.d{g}")
        g += 1
    return out


def clear_delta_chain(path: str) -> None:
    """Remove every delta of base `path` (after a compacting full save;
    a crash in between leaves stale deltas whose base-digest check
    rejects them on load — safe either way)."""
    import os

    for dpath in delta_chain_paths(path):
        try:
            os.unlink(dpath)
        except OSError:
            pass


def table_region_occupancy(occ_flat) -> list:
    """Per-region occupied-slot counts over the flattened table
    occupancy mask (the delta manifest's insert watermarks)."""
    import numpy as np

    occ_flat = np.asarray(occ_flat).reshape(-1)
    n = occ_flat.shape[0]
    r = min(TABLE_DELTA_REGIONS, max(1, n))
    edges = (np.arange(r, dtype=np.int64) * n) // r
    return [int(v) for v in np.add.reduceat(occ_flat.astype(np.int64), edges)]


def save_checkpoint_tiered(path: str, meta: dict, arrays: dict, *,
                           state, tcap: int, keep: int = 1, metrics=None,
                           chain_max: int = DELTA_CHAIN_MAX):
    """Save either a full base generation or a delta against the current
    base, whichever the chain state calls for. ``state`` is the opaque
    per-engine chain state (``None`` initially and after any resume);
    returns the new state. A tcap change (growth/reshard rehashed every
    slot) or a chain at ``chain_max`` forces a compacting full save."""
    import numpy as np

    occ = (
        (np.asarray(arrays["table0"]) != 0)
        | (np.asarray(arrays["table1"]) != 0)
    ).reshape(-1)
    if (
        state is None
        or state.get("tcap") != tcap
        or state.get("seq", 0) >= chain_max
    ):
        full_meta = save_checkpoint_atomic(
            path, meta, arrays, keep=keep, metrics=metrics
        )
        clear_delta_chain(path)
        return {
            "occ": occ,
            "tcap": int(tcap),
            "seq": 0,
            "base_digest": full_meta["digest"],
        }
    seq = state["seq"] + 1
    idx = np.flatnonzero(occ & ~state["occ"])
    darrays = {
        k: v for k, v in arrays.items() if not k.startswith("table")
    }
    darrays["delta_idx"] = idx.astype(np.int64)
    for t in range(4):
        darrays[f"delta_t{t}"] = (
            np.asarray(arrays[f"table{t}"]).reshape(-1)[idx]
        )
    meta = dict(meta)
    meta["delta"] = {
        "base_digest": state["base_digest"],
        "seq": int(seq),
        "base_tcap": int(tcap),
        "regions": table_region_occupancy(occ),
    }
    save_checkpoint_delta(f"{path}.d{seq}", meta, darrays, metrics=metrics)
    state = dict(state)
    state["seq"] = seq
    return state


def save_checkpoint_delta(dpath: str, meta: dict, arrays: dict, *,
                          metrics=None) -> dict:
    """Crash-safe write of one delta file (tmp + fsync + rename + dir
    fsync; no generation rotation — the chain IS the history)."""
    import os

    t0 = time.monotonic()
    meta = _write_npz_atomic(dpath, meta, arrays)
    os.replace(dpath + ".tmp.npz", dpath)
    _fsync_dir(dpath)
    if metrics is not None:
        metrics.inc("checkpoint_delta_saves")
        metrics.inc("checkpoint_delta_bytes", os.path.getsize(dpath))
        metrics.inc("checkpoint_delta_rows", int(len(arrays["delta_idx"])))
        metrics.add_phase("checkpoint_save", time.monotonic() - t0)
    return meta


def _fold_table_delta(base_data: dict, ddata: dict) -> dict:
    """Newest engine state = the delta's non-table arrays + the base's
    table lanes with the delta rows scattered in."""
    import numpy as np

    folded = {
        k: v for k, v in ddata.items() if not k.startswith("delta_")
    }
    idx = np.asarray(ddata["delta_idx"]).reshape(-1)
    for t in range(4):
        lane = np.array(base_data[f"table{t}"])  # copy; base stays pristine
        lane.reshape(-1)[idx] = ddata[f"delta_t{t}"]
        folded[f"table{t}"] = lane
    return folded


def load_checkpoint_folded(path: str, metrics=None):
    """Load the newest recoverable engine state: the newest verifiable
    base generation with the newest verifiable delta (pinned to that
    base's digest, region watermarks revalidated post-fold) folded on.
    Falls back delta-by-delta to the plain base; base-generation
    fallback itself is `load_checkpoint_with_fallback`."""
    import numpy as np

    base_data, base_meta = load_checkpoint_with_fallback(
        path, metrics=metrics
    )
    base_digest = base_meta.get("digest")
    for dpath in reversed(delta_chain_paths(path)):
        try:
            ddata, dmeta = load_checkpoint_verified(dpath)
            man = dmeta.get("delta") or {}
            if man.get("base_digest") != base_digest:
                # STALE, not corrupt: the base itself fell back a
                # generation (or the chain outlived a compaction), so a
                # digest-mismatched delta is the EXPECTED leftover of the
                # newer base — skip it without the corruption counters
                # (the base-fallback counter already told that story).
                if metrics is not None:
                    metrics.inc("checkpoint_delta_stale")
                _warn(
                    "delta checkpoint stale for the loaded base; skipped",
                    path=dpath,
                )
                continue
            folded = _fold_table_delta(base_data, ddata)
            occ = (
                (np.asarray(folded["table0"]) != 0)
                | (np.asarray(folded["table1"]) != 0)
            )
            if table_region_occupancy(occ) != list(man.get("regions", [])):
                raise CheckpointCorruptError(
                    f"delta checkpoint {dpath!r} fails its per-region "
                    "insert watermarks after folding"
                )
        except CheckpointCorruptError as exc:
            if metrics is not None:
                metrics.inc("checkpoint_corrupt_rejected")
                metrics.inc("checkpoint_fallbacks")
            _warn(
                "delta checkpoint rejected; falling back",
                path=dpath,
                reason=str(exc),
            )
            continue
        if metrics is not None:
            metrics.inc("checkpoint_delta_folds")
        return folded, dmeta
    return base_data, base_meta


# -- SIGTERM/SIGINT final-checkpoint flush ------------------------------------
#
# Preempted runs should resume, not restart: the FIRST signal asks every
# live checkpointing engine to stop at its next era boundary (each flushes
# a final checkpoint on the way out; the caller's join() then returns
# normally with partial results). The previous handler is restored after
# that first delivery, so a second signal behaves as before (force-kill /
# KeyboardInterrupt).

_signal_engines = None  # lazy WeakSet; module import must not cost anything
_signal_installed: Dict[int, Any] = {}


def register_signal_checkpoint_flush(engine) -> None:
    """Enroll a checkpointing engine in the graceful-flush set and install
    the SIGTERM/SIGINT handlers (first call only; no-op off the main
    thread, where CPython forbids signal.signal)."""
    global _signal_engines
    import signal
    import weakref

    if _signal_engines is None:
        _signal_engines = weakref.WeakSet()
    _signal_engines.add(engine)
    if _signal_installed:
        return
    for signum in (signal.SIGTERM, signal.SIGINT):
        try:
            _signal_installed[signum] = signal.signal(
                signum, _flush_signal_handler
            )
        except ValueError:
            # Not the main thread (e.g. an engine constructed inside a serve
            # worker): graceful flush still works via an explicit
            # request_checkpoint_stop(); only the OS hook is unavailable.
            _signal_installed.clear()
            return


def _flush_signal_handler(signum, frame) -> None:
    import signal

    for engine in list(_signal_engines or ()):
        engine.request_checkpoint_stop()
    # One graceful chance: restore the previous handlers so the next
    # signal is forceful.
    for num, prev in _signal_installed.items():
        try:
            signal.signal(num, prev if prev is not None else signal.SIG_DFL)
        except (ValueError, TypeError):
            pass
    _signal_installed.clear()
