"""STR4xx — symmetry-reduction soundness (the port's counterpart of
`stateright_tpu/analysis/symmetry.py`: the host rules are copies; the
lane rules run `representative_lanes` as the engines run it).

Symmetry reduction replaces states by canonical representatives before
dedup. Three contracts make that sound, and breaking any of them is
invisible at runtime (the run just quietly explores the wrong quotient):

  - idempotence: rep(rep(s)) == rep(s). A non-idempotent canonicalizer
    makes the visited set treat a representative as unvisited, re-deriving
    different "canonical" forms forever (or until the table fills).
  - property preservation: every declared property must agree on s and
    rep(s) — otherwise the quotient search proves facts about states
    nobody asked about.
  - host/device agreement (tensor models): `representative_lanes` must
    give bit-identical results under numpy and on the device, or the host
    oracle and device engine canonicalize into different quotients. On
    the card it is captured into a CUDA graph and compared through the
    agreement table (K16a, ops/agree.py); on the CPU it runs on meta
    lanes, then eagerly (analysis/probe.py).

Codes:
  STR401  representative() raises on a sampled state, or
          representative_lanes fails to capture (or to run) on the device
  STR402  representative is not idempotent
  STR403  a property value changes under canonicalization
  STR404  representative_lanes disagrees between numpy and the device
          (the low 32 bits of the port's int64 lanes against numpy's uint32);
          where the BFS engine runs the model's canon kernel (K11c, 2PC on
          the card), that kernel is held against numpy on the same rows as
          well, and a finding names its source
  STR405  orbit states map to different representatives (warning —
          an IMPERFECT canonicalizer is allowed, the reference's own 2pc
          rule is imperfect; it weakens reduction but stays sound)
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ..core import Model
from ..ops.agree import M32, agree, read_table
from .diagnostics import AnalysisReport, Severity
from .probe import LaneProbe, ProbeFailed, canon_probe, failure_message, run_kernel
from .sampling import Sample


def _loc(model: Model, member: str) -> str:
    return f"{type(model).__name__}.{member}"


def resolve_symmetry_fn(model: Model, symmetry_fn=None):
    """The canonicalizer to lint: an explicit builder fn, the adapter's
    representative_state, or the states' own representative() method.
    Returns None when the model has no symmetry story (rules skip)."""
    if symmetry_fn is not None:
        return symmetry_fn
    rep_state = getattr(model, "representative_state", None)
    if rep_state is not None:
        tm = getattr(model, "tm", None)
        if tm is not None and tm.representative_lanes is None:
            return None
        return rep_state
    try:
        inits = model.init_states()
    except BaseException:  # noqa: BLE001 - determinism rules report this
        return None
    if inits and hasattr(inits[0], "representative"):
        return lambda s: s.representative()
    return None


def run(
    model: Model,
    sample: Sample,
    report: AnalysisReport,
    symmetry_fn: Optional[Callable[[Any], Any]] = None,
    tm=None,
    rows: Optional[np.ndarray] = None,
    orbit_fn: Optional[Callable[[Any], List[Any]]] = None,
    device="cpu",
) -> None:
    fn = resolve_symmetry_fn(model, symmetry_fn)
    if fn is None and (tm is None or tm.representative_lanes is None):
        return  # no symmetry declared anywhere: nothing to lint
    report.families_run.append("symmetry")

    if fn is not None:
        _check_host(model, sample, report, fn, orbit_fn)
    if tm is not None and tm.representative_lanes is not None and rows is not None:
        _check_lanes(tm, rows, report, device)


def _check_host(model, sample, report, fn, orbit_fn) -> None:
    try:
        props = list(model.properties())
    except BaseException:  # noqa: BLE001
        props = []
    idem_reported = False
    prop_reported = False
    orbit_reported = False
    for state in sample.states:
        try:
            rep = fn(state)
            rep2 = fn(rep)
        except BaseException as e:  # noqa: BLE001
            report.add(
                "STR401",
                Severity.ERROR,
                f"representative raised {type(e).__name__} on sampled "
                f"state {state!r}: {e}",
                _loc(model, "representative"),
                "canonicalization must be total over reachable states",
            )
            return
        try:
            fp_rep = model.fingerprint_state(rep)
            fp_rep2 = model.fingerprint_state(rep2)
        except BaseException:  # noqa: BLE001 - STR104 territory
            continue
        if fp_rep != fp_rep2 and not idem_reported:
            report.add(
                "STR402",
                Severity.ERROR,
                f"representative is not idempotent: rep(s)={rep!r} but "
                f"rep(rep(s))={rep2!r} for sampled s={state!r}; the "
                "visited set never converges on a canonical form",
                _loc(model, "representative"),
                "canonicalize to a fixed point (e.g. a full sort, not one "
                "bubble pass)",
            )
            idem_reported = True
        if not prop_reported:
            for p in props:
                try:
                    v_raw = bool(p.condition(model, state))
                    v_rep = bool(p.condition(model, rep))
                except BaseException:  # noqa: BLE001 - STR302 territory
                    continue
                if v_raw != v_rep:
                    report.add(
                        "STR403",
                        Severity.ERROR,
                        f"property {p.name!r} is {v_raw} on state "
                        f"{state!r} but {v_rep} on its representative "
                        f"{rep!r}; the symmetry-reduced run would check a "
                        "DIFFERENT property than the full run",
                        _loc(model, "representative"),
                        "only permute identities the properties are "
                        "invariant under",
                    )
                    prop_reported = True
                    break
        if orbit_fn is not None and not orbit_reported:
            try:
                orbit = list(orbit_fn(state))
                fps = {
                    int(model.fingerprint_state(fn(o))) for o in orbit
                } | {int(fp_rep)}
            except BaseException:  # noqa: BLE001
                continue
            if len(fps) > 1:
                report.add(
                    "STR405",
                    Severity.WARNING,
                    f"{len(fps)} distinct representatives across one "
                    f"symmetry orbit of {state!r}; the canonicalizer is "
                    "imperfect (sound, but the reduction is weaker than "
                    "the orbit count suggests)",
                    _loc(model, "representative"),
                    "break canonicalization ties on ALL state components, "
                    "not just the sort key",
                )
                orbit_reported = True


def _check_lanes(tm, rows: np.ndarray, report: AnalysisReport, device="cpu") -> None:
    S = tm.state_width
    lanes = tuple(np.ascontiguousarray(rows[:, i]) for i in range(S))
    try:
        rep_np = tuple(
            np.asarray(l, dtype=np.uint32)
            for l in tm.representative_lanes(np, lanes)
        )
        rep2_np = tuple(
            np.asarray(l, dtype=np.uint32)
            for l in tm.representative_lanes(np, rep_np)
        )
    except BaseException as e:  # noqa: BLE001
        report.add(
            "STR401",
            Severity.ERROR,
            f"representative_lanes raised under numpy: "
            f"{type(e).__name__}: {e}",
            f"{type(tm).__name__}.representative_lanes",
            "the canonicalizer must be a pure batched array program",
        )
        return
    for s in range(S):
        if not np.array_equal(rep_np[s], rep2_np[s]):
            i = int(np.nonzero(rep_np[s] != rep2_np[s])[0][0])
            report.add(
                "STR402",
                Severity.ERROR,
                f"representative_lanes is not idempotent on lane {s} "
                f"(batch row {i}: rep={int(rep_np[s][i])} vs "
                f"rep(rep)={int(rep2_np[s][i])}); the canonical closure "
                "never converges",
                f"{type(tm).__name__}.representative_lanes",
                "run the sorting network to a full fixed point",
            )
            return

    B = rows.shape[0]
    probe = LaneProbe(tm.representative_lanes, lanes, device)
    try:
        _compare_lanes(tm, probe, rep_np, report, S, B, device)
    finally:
        report.note_probe(probe)
        probe.release()
    kern = canon_probe(tm, device)
    if kern is not None:
        from ..ops.canon import build_canon
        from ..xp import TorchXP

        out = run_kernel(device, build_canon(tm, TorchXP(device)), rows)
        report.probes.setdefault("kernels", []).append(kern.name)
        canon_agreement(tm, kern, out, rep_np, report)


def _lane_error(out, S: int, B: int):
    """What is wrong with the device outputs of representative_lanes
    against the engines' int64 [B] lanes, or None."""
    try:
        if len(out) != S:
            return f"returned {len(out)} lanes; expected state_width={S}"
    except TypeError:
        return f"returned {type(out).__name__}; expected a tuple of lanes"
    for s, lane in enumerate(out):
        if not isinstance(lane, torch.Tensor) or tuple(lane.shape) != (B,) or lane.dtype != torch.int64:
            shape = tuple(lane.shape) if isinstance(lane, torch.Tensor) else type(lane).__name__
            dtype = lane.dtype if isinstance(lane, torch.Tensor) else None
            return f"lane {s} has shape {shape} dtype {dtype}; expected int64[{B}]"
    return None


def _compare_lanes(tm, probe: LaneProbe, rep_np, report: AnalysisReport, S: int, B: int,
                   device) -> None:
    loc = f"{type(tm).__name__}.representative_lanes"

    def pack(out):
        return None if _lane_error(out, S, B) else torch.stack(tuple(out))[None]

    try:
        out = probe.structure(pack)
        err = _lane_error(out, S, B)
        dev = None if err else probe.values()
    except ProbeFailed as f:
        report.add(
            "STR401",
            Severity.ERROR,
            failure_message("representative_lanes", f, device),
            loc,
            "remove data-dependent Python control flow; use elementwise "
            "min/max networks",
        )
        return
    if err is not None:
        report.add(
            "STR404",
            Severity.ERROR,
            f"representative_lanes on the device: {err}; host and device "
            "would canonicalize into different quotients",
            loc,
            "keep every operation in the shared uint32 xp subset",
        )
        return
    _report_agreement(tm, dev[0], rep_np, report, "the device",
                      "keep every operation in the shared uint32 xp subset (the port's "
                      "lanes are int64: a product or a lane below zero keeps bits numpy "
                      "wraps)")


def canon_agreement(tm, kern, out, rep_np, report: AnalysisReport) -> None:
    """STR404 from the canon kernel's output `out` (int64 [S, B]) against
    numpy's `representative_lanes` `rep_np` on the same rows; a finding
    names the kernel's source file."""
    _report_agreement(tm, out, rep_np, report,
                      f"the canon kernel (kernels/csrc/{kern.source}, {kern.name})",
                      "the kernel must compute the model's own representative_lanes")


def _report_agreement(tm, out, rep_np, report: AnalysisReport, against: str, fix: str) -> None:
    """STR404 at the first lane and row where `out` (int64 [S, B]) and
    numpy's `rep_np` differ, through the agreement table (one action, every
    row valid)."""
    S, B = out.shape
    host = np.stack(rep_np)[None]
    ones = torch.ones((1, B), dtype=torch.bool, device=out.device)
    table = agree(out[None], ones, torch.from_numpy(host).to(out.device), ones)
    found = read_table(table.cpu().numpy(), 1, S, B)
    if found is None:
        return
    s, i = found.lane, found.row
    report.add(
        "STR404",
        Severity.ERROR,
        f"representative_lanes disagrees between numpy and {against} on "
        f"lane {s} (batch row {i}: {int(host[0, s, i])} vs "
        f"{int(out[s, i]) & M32}); host and device would canonicalize "
        "into different quotients",
        f"{type(tm).__name__}.representative_lanes",
        fix,
    )
