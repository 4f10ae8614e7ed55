"""The build/run split: warm checking executables reused across runs (the
port of `stateright_tpu/engines/compiled.py`).

A service receives a fresh model instance a request, though two
`IncrementTensor(2)` instances run the identical step. Three layers make
the warm state of one serve the other:

  1. `model_signature(tm)` — a stable shape signature: class identity +
     `config_digest()` + the property set. Equal signatures run the
     identical step.
  2. the intern pool — `intern_model()` maps a signature to one
     canonical instance.
  3. `CompiledCheck` + `ExecutableCache` — an LRU of warm executables
     keyed by (engine, signature, shape options; a lane shape as
     `multiplex.lane_options` resolves it). On the card a warm executable
     is the kernels built (`kernels.build_all`) and, for the lane engine,
     the lane program it owns: the expand closure at lane width and the
     lane workspace (tables, rings) allocated once and reused by every
     batch, freed when the cache evicts the entry.

Engines: ``"gpu_bfs"`` (the solo engine, engines/gpu_bfs.py) and
``"multiplex"`` (the lane engine). The run service built on this cache
is slice 4b of the port.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

from .. import kernels
from ..tensor import TensorModel, TensorModelAdapter

__all__ = [
    "CompiledCheck",
    "ExecutableCache",
    "era_geometry",
    "intern_model",
    "model_signature",
]


def _tm_of(model: Any) -> TensorModel:
    if isinstance(model, TensorModelAdapter):
        return model.tm
    if isinstance(model, TensorModel):
        return model
    raise TypeError(
        "compiled checks require a TensorModel (or its adapter); "
        f"got {type(model).__name__}"
    )


def model_signature(model: Any) -> str:
    """Stable shape signature of a tensor model: two models with equal
    signatures run the identical step. Covers class identity (the
    `step_lanes` code), `config_digest()` (its constants) and the property
    set (names + expectations). Deliberately not ``id()``-based."""
    tm = _tm_of(model)
    cls = type(tm)
    props = ",".join(
        f"{p.name}:{p.expectation.value}" for p in tm.tensor_properties()
    )
    return f"{cls.__module__}.{cls.__qualname__}|{tm.config_digest()}|{props}"


# Signature -> canonical instance, bounded.
_INTERN_CAP = 64
_INTERN: "OrderedDict[str, TensorModel]" = OrderedDict()
_INTERN_LOCK = threading.Lock()


def intern_model(model: Any) -> Tuple[TensorModel, str]:
    """Map `model` to the canonical instance for its shape signature:
    ``(tm, signature)``, `tm` the first instance seen with this signature
    (possibly `model` itself)."""
    tm = _tm_of(model)
    sig = model_signature(tm)
    with _INTERN_LOCK:
        cached = _INTERN.get(sig)
        if cached is not None:
            _INTERN.move_to_end(sig)
            return cached, sig
        while len(_INTERN) >= _INTERN_CAP:
            _INTERN.popitem(last=False)
        _INTERN[sig] = tm
    return tm, sig


def era_geometry(model: Any, options: Optional[Dict[str, Any]] = None) -> Dict[str, int]:
    """The solo engine shape a default run takes, resolved from `options`
    as `spawn_gpu_bfs` resolves them: the chunk clamp, the coverage and
    sample defaults, the era fusion factor (``fuse_eras``, as the JAX
    loop cache keys it: tpu_bfs.py:1461-1468) and the table's pre-growth
    to hold the inits and one insert batch."""
    from ..ops import visited_set as vs
    from .gpu_bfs import widths

    tm = _tm_of(model)
    options = options or {}
    qcap = int(options.get("queue_capacity", 1 << 20))
    tcap = int(options.get("table_capacity", 1 << 22))
    chunk = min(
        int(options.get("chunk_size", 8192)),
        qcap // (2 * max(1, tm.max_actions)),
    )
    n_init = len(tm.init_states_array())
    vcap = widths(tm.max_actions, chunk)[0]
    while n_init + vcap > vs.MAX_LOAD * tcap:
        tcap *= 2
    return {
        "chunk": chunk,
        "qcap": qcap,
        "tcap": tcap,
        "cov": bool(options.get("coverage", True)),
        "sample_k": int(options.get("sample_k", 64)),
        "fuse": max(1, int(options.get("fuse_eras", 1))),
        "n_init": n_init,
    }


class CompiledCheck:
    """One warm checking executable: an interned model + engine shape.

    ``engine`` is ``"gpu_bfs"`` (the solo engine) or ``"multiplex"``
    (the lane engine). `options` are that engine's keyword options
    (``device`` included). `warm()` builds what the runs reuse; for the
    lane engine that is `program`, the warm lane program.
    """

    def __init__(self, engine: str, model: Any, options: Dict[str, Any]):
        self.tm, self.signature = intern_model(model)
        self.engine = engine
        self.options = dict(options)
        self.uses = 0
        self.program = None
        self._warmed = False

    def builder(self):
        """A fresh `CheckerBuilder` over the interned model."""
        return TensorModelAdapter(self.tm).checker()

    def warm(self) -> "CompiledCheck":
        """Build the kernels (on the card) and, for the lane engine, the
        lane program with its workspace, outside any request's latency
        budget. Idempotent."""
        if self._warmed:
            return self
        if self.engine == "gpu_bfs":
            from .gpu_bfs import resolve_device

            if resolve_device(self.options.get("device")).type == "cuda":
                kernels.build_all(kernels.BFS_KERNELS)
        elif self.engine == "multiplex":
            from .multiplex import warm_lane_program

            self.program = warm_lane_program(self.tm, **self.options)
        else:
            raise ValueError(f"unknown compiled-check engine {self.engine!r}")
        self._warmed = True
        return self

    def spawn(self, builder=None, **kw):
        """Spawn a solo run over this executable. Only for
        ``engine="gpu_bfs"`` (lane batches go through
        `multiplex.run_multiplexed`)."""
        if self.engine != "gpu_bfs":
            raise ValueError(
                f"spawn() is for gpu_bfs compiled checks, not {self.engine!r}"
            )
        if builder is None:
            builder = self.builder()
        opts = {
            k: self.options[k]
            for k in ("chunk_size", "queue_capacity", "table_capacity", "device")
            if k in self.options
        }
        opts.update(kw)
        if "fuse_eras" in self.options:
            # The fusion factor is part of this executable's shape.
            builder.pipeline(builder.pipeline_, builder.pipeline_depth_, self.options["fuse_eras"])
        self.uses += 1
        return builder.spawn_gpu_bfs(compiled=self, **opts)


class ExecutableCache:
    """Thread-safe LRU of `CompiledCheck`s keyed by (engine, signature,
    shape options). It owns what its entries warmed: evicting a
    "multiplex" entry releases its lane workspace."""

    def __init__(self, capacity: int = 8):
        self.capacity = max(1, int(capacity))
        self.hits = 0
        self.misses = 0
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple, CompiledCheck]" = OrderedDict()

    def get(self, model: Any, engine: str, **options) -> Tuple[CompiledCheck, bool]:
        """Return ``(compiled, hit)`` for this model shape + engine shape,
        building (and warming) a new executable on a miss."""
        sig = model_signature(model)
        if engine == "multiplex":
            from .multiplex import lane_options

            options = lane_options(_tm_of(model), **options)
        key = (engine, sig, tuple(sorted(options.items())))
        with self._lock:
            cached = self._entries.get(key)
            if cached is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return cached, True
            self.misses += 1
        # Warm outside the lock: a build takes seconds.
        compiled = CompiledCheck(engine, model, options).warm()
        with self._lock:
            existing = self._entries.get(key)
            if existing is not None:
                return existing, False
            self._entries[key] = compiled
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
        return compiled, False

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "size": len(self._entries),
                "capacity": self.capacity,
            }
