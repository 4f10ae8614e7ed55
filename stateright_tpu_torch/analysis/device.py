"""STR2xx — device compatibility of TensorModels (the port's counterpart
of `stateright_tpu/analysis/device.py`, with the checks in its order).

A `TensorModel` that breaks these rules fails late — inside a CUDA graph
the era captured, where the error names a torch op and nothing of the
user's code — or silently: lane values past the uint32 packing are cut to
32 bits by the engine, and distinct states merge. These rules run
`step_lanes` outside the engines on a small batch, where failures are
attributable. The lane programs run as the engines run them
(analysis/probe.py): captured once into a CUDA graph on the card, on
`meta` lanes on the CPU.

Codes (the JAX package's codes, severities and locations):
  STR201  step_lanes / within_boundary_lanes fails to capture (or to run)
          on the device: data-dependent Python control flow on a lane
  STR202  step_lanes output structure is wrong: not max_actions slots of
          state_width int64 [B] lanes (the port's lane type, xp.py) with
          bool [B] masks
  STR203  init_states_array is malformed (shape/dtype/value range)
  STR204  decode_state raises on reachable rows
  STR205  the numpy and device evaluations of step_lanes disagree: the
          masks, or a valid successor lane's low 32 bits against numpy's
          uint32 (the agreement table, K16a, ops/agree.py). On the port
          this also catches int64 lanes that leave numpy's uint32
          arithmetic: `(lane - 1) >> 1` on a zero lane is 0xFFFFFFFF here
          and 0x7FFFFFFF under numpy. Where the engines run the model's
          K11 kernel (a kernel-route model on the card), its WALK entry is
          held against numpy on the same rows as well, and a finding names
          the kernel's source
  STR206  within_boundary_lanes output is not a bool[B]
  STR207  step_lanes output dtype drifts off uint32 under numpy
          (promotion), or lane values overflow the uint32 packing
  STR209  a state lane's sampled maximum sits exactly at a packing
          boundary (2^b - 1 for b in 8/16/24/32); one detector with the
          runtime space profile (obs/sample.py detect_saturation)

STR208 (the default-geometry footprint against the device's memory) is
not ported: it needs the port's footprint planner, which comes with
slice 4b's `obs/memory.py`. The port skips it, as the JAX package does
wherever no device limit is known.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from ..ops.agree import M32, agree, read_table
from .diagnostics import AnalysisReport, Severity
from .probe import LaneProbe, ProbeFailed, failure_message, kernel_probe, run_kernel

_U32_MAX = 0xFFFFFFFF


def _loc(tm, member: str) -> str:
    return f"{type(tm).__name__}.{member}"


def run(tm, rows: np.ndarray, report: AnalysisReport, device="cpu") -> None:
    """Run the device rules over `rows` ([B, S] sampled states; row 0..n
    include the init states) on `device` (a CUDA device: the lane programs
    are captured there and compared through K16a; "cpu": meta lanes and
    an eager CPU call)."""
    report.families_run.append("device")
    S = getattr(tm, "state_width", None)
    A = getattr(tm, "max_actions", None)
    if not isinstance(S, int) or not isinstance(A, int) or S <= 0 or A <= 0:
        report.add(
            "STR203",
            Severity.ERROR,
            f"state_width/max_actions must be positive ints "
            f"(got {S!r}/{A!r})",
            _loc(tm, "state_width"),
            "declare both as class or instance attributes",
        )
        return

    if not _check_init_array(tm, report, S):
        return
    if rows.size == 0:
        return
    lanes = tuple(np.ascontiguousarray(rows[:, i]) for i in range(S))

    np_out = _check_numpy_step(tm, lanes, report, S, A)
    probe = LaneProbe(tm.step_lanes, lanes, device)
    try:
        if _check_capture(tm, probe, rows.shape[0], report, S, A, device) and np_out is not None:
            _check_host_device_agreement(tm, probe, np_out, report, S, A, device)
    finally:
        report.note_probe(probe)
        probe.release()
    kern = kernel_probe(tm, device)
    if kern is not None and np_out is not None:
        _check_kernel(tm, kern, rows, np_out, report, S, A, device)
    _check_boundary(tm, lanes, report, device)
    _check_decode(tm, rows, report)
    _check_saturation(tm, rows, report)


def _check_saturation(tm, rows: np.ndarray, report: AnalysisReport) -> None:
    """STR209: sampled lane maxima sitting exactly at a packing boundary
    (one detector with the runtime space profile, obs/sample.py)."""
    from ..obs.sample import detect_saturation

    for ent in detect_saturation(rows.astype(np.uint64)):
        report.add(
            "STR209",
            Severity.WARNING,
            f"state lane {ent['lane']} saturates its {ent['bits']}-bit "
            f"packing: {ent['hits']} of {rows.shape[0]} sampled states "
            f"hold the boundary value {ent['max']} (= 2^{ent['bits']}-1); "
            "larger values would wrap or clamp and distinct states would "
            "merge",
            _loc(tm, "step_lanes"),
            "widen the field across lanes or verify the domain really "
            f"tops out below 2^{ent['bits']}",
        )


def _check_init_array(tm, report: AnalysisReport, S: int) -> bool:
    try:
        arr = np.asarray(tm.init_states_array())
    except BaseException as e:  # noqa: BLE001
        report.add(
            "STR203",
            Severity.ERROR,
            f"init_states_array raised {type(e).__name__}: {e}",
            _loc(tm, "init_states_array"),
            "return a [N, state_width] uint32 array",
        )
        return False
    if arr.ndim != 2 or arr.shape[1] != S:
        report.add(
            "STR203",
            Severity.ERROR,
            f"init_states_array has shape {arr.shape}; expected "
            f"[N, state_width={S}]",
            _loc(tm, "init_states_array"),
            "return a 2-D row matrix, one row per initial state",
        )
        return False
    if arr.shape[0] == 0:
        report.add(
            "STR203",
            Severity.WARNING,
            "init_states_array is empty; the checker will explore nothing",
            _loc(tm, "init_states_array"),
            "provide at least one initial state",
        )
        return False
    if not np.issubdtype(arr.dtype, np.integer):
        report.add(
            "STR203",
            Severity.ERROR,
            f"init_states_array dtype is {arr.dtype}; lane packing and "
            "the fingerprint word stream require integers",
            _loc(tm, "init_states_array"),
            "encode state fields into uint32 lanes",
        )
        return False
    lo = int(arr.min())
    hi = int(arr.max())
    if lo < 0 or hi > _U32_MAX:
        report.add(
            "STR207",
            Severity.ERROR,
            f"init_states_array values span [{lo}, {hi}], outside the "
            "uint32 lane packing; the cast truncates silently and distinct "
            "states would share fingerprints",
            _loc(tm, "init_states_array"),
            "split wide fields across multiple lanes or shrink the domain",
        )
        return False
    return True


def _check_numpy_step(tm, lanes, report: AnalysisReport, S: int, A: int):
    try:
        succs, masks = tm.step_lanes(np, lanes)
    except BaseException as e:  # noqa: BLE001
        report.add(
            "STR202",
            Severity.ERROR,
            f"step_lanes raised under numpy on sampled rows: "
            f"{type(e).__name__}: {e}",
            _loc(tm, "step_lanes"),
            "step_lanes must be a pure array program valid for xp=numpy",
        )
        return None
    B = lanes[0].shape[0]
    if len(succs) != A or len(masks) != A:
        report.add(
            "STR202",
            Severity.ERROR,
            f"step_lanes returned {len(succs)} successor slots and "
            f"{len(masks)} masks; expected max_actions={A} of each",
            _loc(tm, "step_lanes"),
            "emit one (successor lanes, validity mask) pair per static "
            "action slot",
        )
        return None
    dtype_reported = False
    for a in range(A):
        slot = succs[a]
        if len(slot) != S:
            report.add(
                "STR202",
                Severity.ERROR,
                f"action slot {a} has {len(slot)} lanes; expected "
                f"state_width={S}",
                _loc(tm, "step_lanes"),
                "every successor must carry all state lanes",
            )
            return None
        mask = np.asarray(masks[a])
        if mask.shape != (B,) or mask.dtype != np.bool_:
            report.add(
                "STR202",
                Severity.ERROR,
                f"action slot {a} validity mask has shape {mask.shape} "
                f"dtype {mask.dtype}; expected bool[{B}]",
                _loc(tm, "step_lanes"),
                "masks must be elementwise boolean over the batch",
            )
            return None
        for s in range(S):
            lane = np.asarray(slot[s])
            if lane.shape != (B,):
                report.add(
                    "STR202",
                    Severity.ERROR,
                    f"action {a} lane {s} has shape {lane.shape}; expected "
                    f"[{B}] (batch-shape-stable)",
                    _loc(tm, "step_lanes"),
                    "lane programs must stay elementwise over the batch "
                    "axis",
                )
                return None
            if lane.dtype != np.uint32 and not dtype_reported:
                vals = lane[mask] if mask.any() else lane[:0]
                overflow = vals.size and (
                    (vals.min() < 0) or (vals.max() > _U32_MAX)
                )
                report.add(
                    "STR207",
                    Severity.ERROR if overflow else Severity.WARNING,
                    f"action {a} lane {s} has dtype {lane.dtype} under "
                    "numpy (promotion off uint32)"
                    + (
                        "; VALID successor values overflow the uint32 "
                        "packing — fingerprints would silently truncate"
                        if overflow
                        else "; values still fit but the promotion usually "
                        "signals an unwrapped Python-int constant"
                    ),
                    _loc(tm, "step_lanes"),
                    "wrap constants as xp.uint32(...) so arithmetic stays "
                    "in-lane",
                )
                dtype_reported = True
    return succs, masks


def _structure_error(out, A: int, S: int, B: int) -> Optional[str]:
    """What is wrong with the device outputs of step_lanes against the
    lane type the engines carry (int64 [B] lanes, bool [B] masks), or
    None."""
    try:
        succs, masks = out
        if len(succs) != A or len(masks) != A or any(len(succs[a]) != S for a in range(A)):
            return (f"returned {len(succs)} successor slots and {len(masks)} masks; "
                    f"expected max_actions={A} slots of state_width={S} lanes")
    except (TypeError, ValueError):
        return f"returned {type(out).__name__}; expected (successor slots, masks)"
    for a in range(A):
        for s in range(S):
            sd = succs[a][s]
            if not isinstance(sd, torch.Tensor) or tuple(sd.shape) != (B,) or sd.dtype != torch.int64:
                shape = tuple(sd.shape) if isinstance(sd, torch.Tensor) else type(sd).__name__
                dtype = sd.dtype if isinstance(sd, torch.Tensor) else None
                return (f"action {a} lane {s} has shape {shape} dtype {dtype}; the era "
                        f"carries int64[{B}] lanes (uint32 values) and captures static shapes")
        md = masks[a]
        if not isinstance(md, torch.Tensor) or tuple(md.shape) != (B,) or md.dtype != torch.bool:
            shape = tuple(md.shape) if isinstance(md, torch.Tensor) else type(md).__name__
            dtype = md.dtype if isinstance(md, torch.Tensor) else None
            return f"action {a} mask has shape {shape} dtype {dtype}; expected bool[{B}]"
    return None


def _pack_step(A: int, S: int, B: int):
    def pack(out):
        if _structure_error(out, A, S, B) is not None:
            return None
        succs, masks = out
        return (torch.stack([torch.stack(tuple(succs[a])) for a in range(A)]),
                torch.stack(tuple(masks)))

    return pack


def _check_capture(tm, probe: LaneProbe, B: int, report: AnalysisReport, S: int, A: int,
                   device) -> bool:
    """STR201/STR202: step_lanes runs, and captures, with the engines'
    lane types (the JAX package's trace check, device.py:286)."""
    try:
        out = probe.structure(_pack_step(A, S, B))
    except ProbeFailed as f:
        report.add(
            "STR201",
            Severity.ERROR,
            failure_message("step_lanes", f, device),
            _loc(tm, "step_lanes"),
            "remove data-dependent Python control flow (if/while on lane "
            "values); express branches as xp.where masks",
        )
        return False
    err = _structure_error(out, A, S, B)
    if err is not None:
        report.add(
            "STR202",
            Severity.ERROR,
            f"captured step_lanes: {err}",
            _loc(tm, "step_lanes"),
            "keep lane programs elementwise, int64 lanes and bool masks "
            "end to end",
        )
        return False
    return True


def _check_host_device_agreement(tm, probe: LaneProbe, np_out, report: AnalysisReport,
                                 S: int, A: int, device) -> None:
    """STR205: the device run on the sampled rows against numpy, through
    the agreement table (K16a on the card, its plain version on the CPU)."""
    try:
        dev, dmask = probe.values()
    except ProbeFailed as f:
        report.add(
            "STR201",
            Severity.ERROR,
            failure_message("step_lanes", f, device),
            _loc(tm, "step_lanes"),
            "check gather indices and dynamic slices stay in bounds",
        )
        return
    _report_agreement(tm, dev, dmask, np_out, report, S, A, "the device")


def _check_kernel(tm, kern, rows: np.ndarray, np_out, report: AnalysisReport, S: int, A: int,
                  device) -> None:
    """STR205 against the program the engines run: the model's K11 WALK
    kernel `kern` launched once on the sampled rows (`probe.run_kernel`),
    its masks and successors against numpy's through the agreement table.
    Its masks are `step_lanes`' own: the kernel route is taken only for the
    exact bundled classes, whose boundary is the default."""
    from ..ops.expand import build_walk_step
    from ..xp import TorchXP

    walk = build_walk_step(tm, tm.tensor_properties(), TorchXP(device))
    _checks, valid, succ = run_kernel(device, walk, rows)
    report.probes.setdefault("kernels", []).append(kern.name)
    kernel_agreement(tm, kern, valid, succ, np_out, report, S, A)


def kernel_agreement(tm, kern, valid, succ, np_out, report: AnalysisReport, S: int,
                     A: int) -> None:
    """STR205 from a K11 WALK output (`valid` bool [A, B], `succ` int64
    [A, S, B]) against numpy's `step_lanes` output `np_out` on the same
    rows; a finding names the kernel's source file."""
    _report_agreement(tm, succ, valid, np_out, report, S, A,
                      f"the K11 kernel (kernels/csrc/{kern.source}, {kern.name})")


def _report_agreement(tm, dev, dmask, np_out, report: AnalysisReport, S: int, A: int,
                      against: str) -> None:
    np_succs, np_masks = np_out
    B = dmask.shape[1]
    host = np.stack([np.stack([np.asarray(np_succs[a][s]).astype(np.uint32) for s in range(S)])
                     for a in range(A)])
    hmask = np.stack([np.asarray(m) for m in np_masks])
    table = agree(dev, dmask, torch.from_numpy(host).to(dev.device),
                  torch.from_numpy(hmask).to(dev.device))
    found = read_table(table.cpu().numpy(), A, S, B)
    if found is None:
        return
    if found.lane is None:
        report.add(
            "STR205",
            Severity.ERROR,
            f"action {found.action} validity mask differs between numpy and "
            f"{against} ({found.host_valid} vs {found.card_valid} valid, first at batch "
            f"row {found.row}); the host oracle and the device engine would explore "
            "different transition systems",
            _loc(tm, "step_lanes"),
            "avoid numpy-only semantics (value-dependent dtypes, "
            "Python bool casts); keep the program in the shared "
            "xp subset",
        )
        return
    a, s, i = found.action, found.lane, found.row
    got = int(dev[a, s, i]) & M32
    report.add(
        "STR205",
        Severity.ERROR,
        f"action {a} lane {s} differs between numpy and {against} on a VALID "
        f"successor (first mismatch at batch row {i}: {int(host[a, s, i])} vs {got}); "
        "host/device fingerprints would diverge",
        _loc(tm, "step_lanes"),
        "uint32 wraparound and shift semantics differ off the shared subset "
        "(the port's lanes are int64: a lane that goes below zero shifts in "
        "ones); keep all arithmetic in xp.uint32 and mask before shifting",
    )


def _check_boundary(tm, lanes, report: AnalysisReport, device) -> None:
    B = lanes[0].shape[0]
    try:
        nb = np.asarray(tm.within_boundary_lanes(np, lanes))
    except BaseException as e:  # noqa: BLE001
        report.add(
            "STR206",
            Severity.ERROR,
            f"within_boundary_lanes raised under numpy: "
            f"{type(e).__name__}: {e}",
            _loc(tm, "within_boundary_lanes"),
            "return xp.ones(B, bool) when every state is in bounds",
        )
        return
    if nb.shape != (B,) or nb.dtype != np.bool_:
        report.add(
            "STR206",
            Severity.ERROR,
            f"within_boundary_lanes returned shape {nb.shape} dtype "
            f"{nb.dtype}; expected bool[{B}]",
            _loc(tm, "within_boundary_lanes"),
            "return one boolean per batch row",
        )
        return
    probe = LaneProbe(tm.within_boundary_lanes, lanes, device)
    try:
        probe.structure(lambda out: None)
    except ProbeFailed as f:
        report.add(
            "STR201",
            Severity.ERROR,
            failure_message("within_boundary_lanes", f, device),
            _loc(tm, "within_boundary_lanes"),
            "express the boundary as mask arithmetic over lanes",
        )
    finally:
        report.note_probe(probe)
        probe.release()


def _check_decode(tm, rows: np.ndarray, report: AnalysisReport) -> None:
    bad: List[Any] = []
    for row in rows:
        try:
            tm.decode_state(np.asarray(row, dtype=np.uint32))
        except BaseException as e:  # noqa: BLE001
            bad.append((row, e))
            break
    if bad:
        row, e = bad[0]
        report.add(
            "STR204",
            Severity.ERROR,
            f"decode_state raised {type(e).__name__} on reachable row "
            f"{row.tolist()}: {e}; the Explorer and counterexample "
            "rendering would crash on it",
            _loc(tm, "decode_state"),
            "decode every encodable lane combination reachable from the "
            "initial states",
        )
