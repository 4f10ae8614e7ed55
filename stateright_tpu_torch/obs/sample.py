"""Space profiler: deterministic bottom-k state sampling + field sketches
(the port's copy of `stateright_tpu/obs/sample.py`, pure numpy).

The sampler keeps a small uniform sample of the explored state space and
renders it into a `SpaceProfile`: per-field value-distribution sketches,
per-depth exemplar states, per-action exemplar transitions, and a
packing-saturation detector.

Determinism is the load-bearing property. The sampler is **bottom-k over
the 64-bit state fingerprints**: a state is sampled iff its fingerprint is
among the k smallest seen — equivalently, iff it falls below an adaptive
threshold (the current kth-smallest fingerprint). The fingerprints are
bit-identical in both packages and on host and device, so the sample set
is a pure function of the EXPLORED SET: independent of visitation order,
engine and package. Because fingerprints are uniform in [0, 2^64), the
kth-smallest fingerprint doubles as a distinct-count estimator (KMV):
``est ≈ (k-1) * 2^64 / kth_fp``.

The BFS engine captures candidates in a small fixed on-device slab
(kernel K9a, `kernels/csrc/sample_capture.cu`) and drains it once per era
(K9b, `slab_bottomk.cu`); the simulation engine does the same through
K13c and K13d (`walk_capture.cu`, `walk_slab.cu`), whose slab holds
revisited states and drains with ``exact=False``. The per-era drain keeps only the bottom-k'' of
that era's candidates, which is exact for the global bottom-k: any global
bottom-k member has fewer than k candidates below it *anywhere*, hence
fewer than k below it within its own era. The device ranks by the high
fingerprint word only, so the drain carries ``SLAB_PAD`` extra entries and
`SpaceSampler.drain_slab` applies a *tie cut*: when an era had more
candidates than drained entries, the entries at the boundary h1 value are
discarded (the set strictly below the cut is exact). Losing a true
bottom-k member that way would need more than SLAB_PAD states sharing one
32-bit fingerprint prefix inside one era — the sampler flags ``degraded``
if that ever happens, rather than silently lying.

`detect_saturation` flags a state lane whose sampled maximum sits exactly
at a natural packing boundary (2^b - 1 for b in 8/16/24/32): one increment
away from silently wrapping its uint32 packing.
"""

from __future__ import annotations

import heapq
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..path import _state_fields

# Default sample size: small enough that host-side profile building and
# the device slab stay trivial, large enough for meaningful field sketches.
DEFAULT_SAMPLE_K = 64
# Extra drained entries per era beyond k: slack for h1-only device ranking
# (ties at the 32-bit boundary are resolved host-side by the tie cut).
SLAB_PAD = 64
# Device per-step candidate compaction width (the BFS step): candidates
# per loop step are compacted to this many slots before the slab scatter.
# Pre-threshold floods clamp `take` so a step never produces more.
DEVICE_STEP_CAP = 512
# Action sentinel for samples whose generating action is unknown
# (simulation walks, sharded receives — the action is not exchanged).
NO_ACTION = 0xFFFFFFFF

_MAX64 = (1 << 64) - 1
_U32 = 0xFFFFFFFF


def slab_entries(k: int) -> int:
    """Entries drained per era: k plus the h1-tie slack."""
    return int(k) + SLAB_PAD


def slab_high_water(k: int) -> int:
    """Era-exit occupancy gate: the loop exits (and re-enters after the
    host drain) once this many candidates accumulated, so a slab is never
    asked to hold an unbounded flood."""
    return max(2 * slab_entries(k), 512)


def slab_capacity(k: int, step_cap: int) -> int:
    """On-device slab rows: the high-water mark plus one full step's
    worth of captures (the gate is checked BEFORE the step that may
    overshoot it, so every write is guaranteed to fit)."""
    return slab_high_water(k) + int(step_cap)


# -- saturation ---------------------------------------------------------------

# Natural packing boundaries: a sampled lane maxing out at 2^b - 1 for one
# of these widths is presumed packed in b bits and one step from wrapping.
SATURATION_BITS = (8, 16, 24, 32)


def detect_saturation(rows) -> List[Dict[str, int]]:
    """Lanes of ``rows`` ([N, S] uint32 state rows) whose observed maximum
    sits exactly at a packing boundary ``2^b - 1`` (b in SATURATION_BITS).

    Returns ``[{"lane", "bits", "max", "hits"}]`` — ``hits`` counts the
    sampled states AT the boundary value. Used by the runtime space
    profile (`build_space_profile`).
    """
    rows = np.asarray(rows)
    if rows.ndim != 2 or rows.size == 0:
        return []
    out: List[Dict[str, int]] = []
    for lane in range(rows.shape[1]):
        col = rows[:, lane]
        mx = int(col.max())
        for bits in SATURATION_BITS:
            if mx == (1 << bits) - 1:
                out.append(
                    {
                        "lane": lane,
                        "bits": bits,
                        "max": mx,
                        "hits": int((col == mx).sum()),
                    }
                )
                break
    return out


# -- the sampler --------------------------------------------------------------


class SpaceSampler:
    """Thread-safe exact bottom-k fingerprint sampler.

    Keeps the k smallest 64-bit fingerprints offered, with one record per
    sample: depth at first insertion, the generating action (when known),
    and the state row / predecessor row (when the offering engine has
    them in hand; device bottom-k drains carry fingerprints only and the
    rows are resolved lazily at profile-build time).
    """

    def __init__(self, k: int = DEFAULT_SAMPLE_K):
        self.k = max(1, int(k))
        self._lock = threading.Lock()
        self._samples: Dict[int, Dict[str, Any]] = {}
        self._heap: List[int] = []  # max-heap of kept fps (negated)
        self.offered = 0  # states seen by the offering engines
        self.candidates = 0  # offers below the then-current threshold
        self.device_drops = 0  # device slab overflow drops (sdrop)
        self.degraded = False  # tie-cut retained < k (see module doc)

    # -- threshold ----------------------------------------------------------

    def threshold(self) -> int:
        """Exclusive upper bound: a fingerprint is a candidate iff
        ``fp < threshold()``. 2^64 - 1 until the sample is full, then the
        current kth-smallest (= largest kept) fingerprint. Monotonically
        non-increasing, so a stale (looser) threshold only ever admits a
        superset of candidates — the basis of pipelined-era soundness."""
        with self._lock:
            return self._threshold_locked()

    def _threshold_locked(self) -> int:
        if len(self._samples) < self.k:
            return _MAX64
        return -self._heap[0]

    def threshold_parts(self) -> tuple:
        """(high, low) uint32 words of `threshold()` for device upload."""
        t = self.threshold()
        return (t >> 32) & _U32, t & _U32

    # -- offering -----------------------------------------------------------

    def offer(
        self,
        fp: int,
        depth: int = 0,
        action: Any = None,
        state: Any = None,
        pred: Any = None,
    ) -> bool:
        """Offer one inserted state. Returns True iff it (currently)
        entered the sample. `state`/`pred` are whatever the engine has in
        hand — uint32 row tuples for tensor engines, rich state objects
        for host models, or None (resolved later)."""
        fp = int(fp)
        with self._lock:
            self.offered += 1
            if len(self._samples) >= self.k and fp >= -self._heap[0]:
                return False
            self.candidates += 1
            if fp in self._samples:
                # Same state re-offered (simulation revisits, device
                # re-drains): first record wins, richer fields backfill.
                rec = self._samples[fp]
                if rec.get("state") is None and state is not None:
                    rec["state"] = state
                    rec["pred"] = pred
                    rec["action"] = action
                return False
            self._samples[fp] = {
                "fp": fp,
                "depth": int(depth),
                "action": action,
                "state": state,
                "pred": pred,
            }
            heapq.heappush(self._heap, -fp)
            if len(self._samples) > self.k:
                evicted = -heapq.heappop(self._heap)
                del self._samples[evicted]
            return True

    def offer_array(self, fps, depths=None, states=None) -> None:
        """Vectorized offer (the seeded init rows): pre-filters by
        threshold with one array compare, then offers survivors
        individually."""
        fps = np.asarray(fps, dtype=np.uint64)
        n = int(fps.size)
        if not n:
            return
        t = self.threshold()
        if t >= _MAX64:
            idx = np.arange(n)
        else:
            idx = np.flatnonzero(fps < np.uint64(t))
        with self._lock:
            self.offered += n - int(idx.size)
        for i in idx:
            i = int(i)
            self.offer(
                int(fps[i]),
                depth=int(depths[i]) if depths is not None else 0,
                state=(
                    tuple(int(v) for v in states[i])
                    if states is not None
                    else None
                ),
            )

    def drain_slab(
        self,
        fp1,
        fp2,
        depths,
        ok,
        occupied: int,
        dropped: int = 0,
        actions=None,
        states=None,
        exact: bool = True,
    ) -> None:
        """Consume one era's device slab drain.

        ``fp1``/``fp2``/``depths`` (+ optional ``actions`` / ``states``
        [n, S] rows) are the drained entry lanes, ``ok`` the validity
        mask (1 for written slab slots, 0 for padding), ``occupied`` the
        era's true candidate count and ``dropped`` its slab-overflow
        drop count. Applies the h1 tie cut (module doc) before offering:
        when the era produced more candidates than were drained, entries
        AT the boundary h1 value may be an incomplete tie group, so only
        the exact set strictly below the cut is kept.

        ``exact=False`` skips the tie cut: for engines whose slab can
        hold DUPLICATE fingerprints (the simulation engine — walks
        revisit states, and there is no visited table to make captures
        once-only), ``occupied > n_valid`` usually means duplicates, not
        truncation, and the cut would starve the sample by forever
        discarding the boundary group.
        """
        fp1 = np.asarray(fp1, dtype=np.uint64)
        fp2 = np.asarray(fp2, dtype=np.uint64)
        valid = np.asarray(ok).astype(bool)
        occupied = int(occupied)
        if dropped:
            with self._lock:
                self.device_drops += int(dropped)
        n_valid = int(valid.sum())
        if not n_valid:
            return
        if exact and occupied > n_valid:
            cut = int(fp1[valid].max())
            keep = valid & (fp1 < np.uint64(cut))
            if int(keep.sum()) < self.k:
                self.degraded = True
            valid = keep
        for i in np.flatnonzero(valid):
            i = int(i)
            fp = (int(fp1[i]) << 32) | int(fp2[i])
            act = int(actions[i]) if actions is not None else NO_ACTION
            self.offer(
                fp,
                depth=int(depths[i]),
                action=None if act == NO_ACTION else act,
                state=(
                    tuple(int(v) for v in states[i])
                    if states is not None
                    else None
                ),
            )

    # -- queries ------------------------------------------------------------

    def size(self) -> int:
        with self._lock:
            return len(self._samples)

    def fingerprints(self) -> List[int]:
        """The sampled fingerprints, ascending — THE deterministic object
        (equal across engines/shards/pipelining on the same explored
        set; what the parity tests compare)."""
        with self._lock:
            return sorted(self._samples)

    def records(self) -> List[Dict[str, Any]]:
        """Sample records ordered by fingerprint (deterministic)."""
        with self._lock:
            return [dict(self._samples[fp]) for fp in sorted(self._samples)]

    def estimated_states(self) -> int:
        """KMV distinct-count estimate of the explored space: exact below
        k, else ``(k-1) * 2^64 / kth_smallest_fp``."""
        with self._lock:
            n = len(self._samples)
            if n < self.k:
                return n
            kth = -self._heap[0]
            return int((self.k - 1) * float(2**64) / float(max(kth, 1)))

    def snapshot(self) -> Dict[str, Any]:
        """Light summary backing ``telemetry()["space"]`` (no state
        decode — safe to poll mid-run)."""
        with self._lock:
            n = len(self._samples)
            t = self._threshold_locked()
        return {
            "k": self.k,
            "samples": n,
            # str: 64-bit values stay exact through JSON round-trips.
            "threshold": str(t),
            "est_states": self.estimated_states(),
            "offered": self.offered,
            "candidates": self.candidates,
            "device_drops": self.device_drops,
            "degraded": self.degraded,
        }

    # -- checkpointing ------------------------------------------------------

    def export_state(self) -> Dict[str, Any]:
        """JSON-safe sampler state for checkpoint meta: kill -> resume
        must restore the threshold and kept set exactly, or the resumed
        run's sample set would diverge from an uninterrupted one."""
        recs = []
        for rec in self.records():
            recs.append(
                {
                    "fp": str(rec["fp"]),
                    "depth": int(rec["depth"]),
                    "action": (
                        int(rec["action"])
                        if isinstance(rec["action"], (int, np.integer))
                        else None
                    ),
                    "state": (
                        [int(v) for v in rec["state"]]
                        if isinstance(rec["state"], (tuple, list))
                        else None
                    ),
                }
            )
        return {
            "k": self.k,
            "records": recs,
            "offered": self.offered,
            "candidates": self.candidates,
            "device_drops": self.device_drops,
            "degraded": bool(self.degraded),
        }

    def restore_state(self, st: Dict[str, Any]) -> None:
        if not st:
            return
        with self._lock:
            self._samples.clear()
            self._heap = []
        for rec in st.get("records", ()):
            self.offer(
                int(rec["fp"]),
                depth=rec.get("depth", 0),
                action=rec.get("action"),
                state=(
                    tuple(rec["state"]) if rec.get("state") is not None else None
                ),
            )
        with self._lock:
            self.offered = int(st.get("offered", 0))
            self.candidates = int(st.get("candidates", 0))
            self.device_drops = int(st.get("device_drops", 0))
            self.degraded = bool(st.get("degraded", False))


# -- profile building ---------------------------------------------------------

# Field-flattening caps: a pathological decode_state cannot balloon the
# profile (leaves beyond the cap are dropped, counted in "fields_dropped").
_MAX_FIELDS = 64
_MAX_FLATTEN_DEPTH = 3


def _flatten_fields(value, prefix: str, out: Dict[str, Any], depth: int) -> None:
    """Decompose a decoded state into named scalar leaves, mirroring the
    precedence of path._state_fields (dataclass -> namedtuple -> dict ->
    sequence -> scalar) but keeping RAW values for sketching."""
    import dataclasses

    if len(out) >= _MAX_FIELDS:
        return
    if depth < _MAX_FLATTEN_DEPTH:
        if dataclasses.is_dataclass(value) and not isinstance(value, type):
            for k, v in vars(value).items():
                name = f"{prefix}{k}"
                if _is_composite(v):
                    _flatten_fields(v, name + ".", out, depth + 1)
                else:
                    _leaf(out, name, v)
            return
        if hasattr(value, "_asdict"):  # namedtuple
            for k, v in value._asdict().items():
                name = f"{prefix}{k}"
                if _is_composite(v):
                    _flatten_fields(v, name + ".", out, depth + 1)
                else:
                    _leaf(out, name, v)
            return
        if isinstance(value, dict):
            for k, v in value.items():
                name = f"{prefix}{k}"
                if _is_composite(v):
                    _flatten_fields(v, name + ".", out, depth + 1)
                else:
                    _leaf(out, name, v)
            return
        if isinstance(value, (tuple, list)) or (
            isinstance(value, np.ndarray) and value.ndim == 1
        ):
            for i, v in enumerate(value):
                name = f"{prefix}[{i}]" if prefix else f"[{i}]"
                if _is_composite(v):
                    _flatten_fields(v, name + ".", out, depth + 1)
                else:
                    _leaf(out, name, v)
            return
    _leaf(out, prefix or "state", value)


def _is_composite(v) -> bool:
    import dataclasses

    return (
        (dataclasses.is_dataclass(v) and not isinstance(v, type))
        or hasattr(v, "_asdict")
        or isinstance(v, (dict, tuple, list))
        or (isinstance(v, np.ndarray) and v.ndim >= 1)
    )


def _leaf(out: Dict[str, Any], name: str, v: Any) -> None:
    if len(out) >= _MAX_FIELDS:
        return
    # Strip trailing "." left by dataclass recursion on scalar members.
    out[name.rstrip(".")] = v


def _decoded(model, rec) -> Any:
    """Human view of a sample's state: decode_state for tensor-backed
    rows (the same view the Explorer uses), the raw object otherwise."""
    state = rec.get("state")
    if state is None:
        return None
    tm = getattr(model, "tm", None)
    if tm is not None and hasattr(tm, "decode_state"):
        try:
            return tm.decode_state(np.asarray(state, dtype=np.uint32))
        except Exception:
            return state
    return state


class _FieldSketch:
    """Distribution sketch of one decoded field over the sample: exact
    below k samples (the sample IS the population for tiny spaces —
    locked by the sketch-exactness test), a uniform-sample sketch above."""

    __slots__ = ("kind", "count", "vmin", "vmax", "values", "true", "false")

    def __init__(self):
        self.kind = None  # "int" | "bool" | "other"
        self.count = 0
        self.vmin = None
        self.vmax = None
        self.values: set = set()
        self.true = 0
        self.false = 0

    def add(self, v: Any) -> None:
        self.count += 1
        if isinstance(v, (bool, np.bool_)):
            self.kind = self.kind or "bool"
            if v:
                self.true += 1
            else:
                self.false += 1
            if len(self.values) < 4096:
                self.values.add(bool(v))
            return
        if isinstance(v, (int, np.integer)):
            self.kind = "int" if self.kind in (None, "int", "bool") else self.kind
            v = int(v)
            self.vmin = v if self.vmin is None else min(self.vmin, v)
            self.vmax = v if self.vmax is None else max(self.vmax, v)
            if len(self.values) < 4096:
                self.values.add(v)
            return
        self.kind = "other"
        if len(self.values) < 4096:
            self.values.add(repr(v))

    def render(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "kind": self.kind or "other",
            "count": self.count,
            "distinct": len(self.values),
        }
        if self.kind == "bool":
            out["true"] = self.true
            out["false"] = self.false
        elif self.kind == "int":
            out["min"] = self.vmin
            out["max"] = self.vmax
            # Log2-bucketed histogram: bucket b holds values with
            # bit_length b (0 -> bucket 0, 1 -> 1, 2..3 -> 2, ...).
            hist: Dict[str, int] = {}
            for v in sorted(self.values):
                b = str(int(v).bit_length() if v > 0 else 0)
                hist[b] = hist.get(b, 0) + 1
            out["log2_hist"] = hist
        return out


def build_space_profile(
    model,
    sampler: SpaceSampler,
    resolver: Optional[Callable[[int], Optional[Dict[str, Any]]]] = None,
) -> Dict[str, Any]:
    """Render a sampler's kept set into the SpaceProfile document behind
    `Checker.space_profile()` / the Explorer's ``GET /space``.

    ``resolver(fp) -> {"state":..., "pred":..., "action":...} | None``
    backfills rows for samples captured fingerprint-only (device bottom-k
    drains); the device engines pass their path reconstructor.
    """
    if sampler is None:
        return {}
    recs = sampler.records()
    profile: Dict[str, Any] = dict(sampler.snapshot())
    profile["fingerprints"] = [str(r["fp"]) for r in recs]
    if not recs:
        profile.update(fields={}, depths={}, actions={}, saturated=[])
        return profile

    unresolved = 0
    for rec in recs:
        if rec.get("state") is None and resolver is not None:
            try:
                extra = resolver(rec["fp"])
            except Exception:
                extra = None
            if extra:
                rec.update(
                    {k: v for k, v in extra.items() if v is not None}
                )
        if rec.get("state") is None:
            unresolved += 1
    profile["unresolved"] = unresolved

    # -- field sketches over the decoded sample ----------------------------
    sketches: Dict[str, _FieldSketch] = {}
    rows: List[Any] = []
    for rec in recs:
        decoded = _decoded(model, rec)
        if decoded is None:
            continue
        state = rec.get("state")
        if isinstance(state, (tuple, list)) and all(
            isinstance(v, (int, np.integer)) for v in state
        ):
            rows.append(state)
        leaves: Dict[str, Any] = {}
        _flatten_fields(decoded, "", leaves, 0)
        rec["_fields"] = leaves
        for name, v in leaves.items():
            sketches.setdefault(name, _FieldSketch()).add(v)
    profile["fields"] = {
        name: sk.render() for name, sk in sorted(sketches.items())
    }

    # -- packing saturation (raw uint32 lanes) ------------------------------
    saturated = detect_saturation(np.asarray(rows, dtype=np.uint64)) if rows else []
    # Best-effort lane -> decoded-field naming: when the decode flattens
    # positionally (one leaf per lane), the lane index maps to its name.
    names = list(sketches)
    width = len(rows[0]) if rows else 0
    for ent in saturated:
        if len(names) == width:
            ent["field"] = names[ent["lane"]]
    profile["saturated"] = saturated

    # -- per-depth exemplars (min-fp state at each depth: deterministic) ---
    depths: Dict[int, Dict[str, Any]] = {}
    for rec in recs:  # recs are fp-ascending, so first-seen is min-fp
        d = int(rec["depth"])
        ent = depths.setdefault(d, {"count": 0})
        ent["count"] += 1
        if "exemplar_fp" not in ent and rec.get("_fields"):
            ent["exemplar_fp"] = str(rec["fp"])
            ent["exemplar"] = {
                k: repr(v) for k, v in rec["_fields"].items()
            }
    profile["depths"] = {str(d): depths[d] for d in sorted(depths)}

    # -- per-action exemplar transitions -----------------------------------
    actions: Dict[str, Dict[str, Any]] = {}
    for rec in recs:
        act = rec.get("action")
        if act is None:
            continue
        try:
            label = model.format_action(act)
        except Exception:
            label = repr(act)
        ent = actions.setdefault(label, {"count": 0})
        ent["count"] += 1
        if "exemplar" in ent or rec.get("pred") is None:
            continue
        exemplar: Dict[str, Any] = {
            "fp": str(rec["fp"]),
            "action": label,
        }
        exemplar["pred"] = _state_fields(model, rec["pred"])
        exemplar["succ"] = _state_fields(model, rec["state"])
        ent["exemplar"] = exemplar
    profile["actions"] = dict(sorted(actions.items()))
    return profile
