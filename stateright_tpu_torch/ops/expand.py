"""Evaluate-and-expand for one popped chunk (K11): the port's counterpart
of `stateright_tpu/ops/expand.py:54 build_expand_lean`, and the
simulation's model step (`stateright_tpu/engines/tpu_simulation.py:
268-300`).

Semantics are the reference hot loop's (bfs.rs:196-334): property
evaluation with eventually-bit clearing, the depth limit, successor
generation with the boundary filter, the terminal rule, and terminal
eventually-bit discoveries. The candidate batch is action-major:
candidate a*W + c is action a applied to popped row c.

Two routes, picked once, when the function is built:

- **kernel**: on a CUDA device, for a model whose K11 kernel is
  hand-written (`kernels/csrc/expand_2pc.cu`, `expand_paxos.cu`,
  `expand_abd.cu`, `expand_increment.cu`; the model arithmetic in
  `kernels/csrc/models/`), one launch a call. Taken only when `type(tm)`
  is exactly `TwoPhaseTensor` (n <= 16), `PaxosTensor` or
  `PaxosTensorExhaustive` (c <= 7), `AbdTensor` or `AbdOrderedTensor`
  (2 servers, c <= 5) or `IncrementTensor` (n <= 8), with exactly that
  model's `tensor_properties()`: a subclass, an instance that overrides
  the model code, or other properties get the plain route. A kernel that
  fails to build or launch raises; nothing falls back.
- **plain**: the model's own `step_lanes` and properties through the
  torch `xp`, a few hundred to a few thousand torch launches a call. It
  runs on the CPU, and on the card for a model with no kernel.

`expand_route(tm, props, device)` names the route; every engine reports
it in `telemetry()["expand_route"]`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import kernels
from ..core import Expectation

M32 = 0xFFFFFFFF
EXPAND_THREADS = 128  # rows a block of EXPAND (csrc/models/expand_launch.cuh kExpandThreads)


class ExpandedLean(NamedTuple):
    ebits: torch.Tensor  # [C] int64, after property evaluation
    flat: torch.Tensor  # [S, C*A] int64 successor lanes (action-major)
    valid: torch.Tensor  # [C*A] bool: action valid & in boundary & parent live
    generated: torch.Tensor  # 0-d int64: number of valid candidates
    prop_hits: list  # P masks, each [C] bool: rows that discover property i


# Attributes whose override on an instance changes the model code.
_MODEL_CODE = ("step_lanes", "within_boundary_lanes", "tensor_properties", "deliver", "_deliver",
               "linearizable_lanes", "ordered", "representative_lanes")
INCREMENT_MAX_THREADS = 8  # the thread counts csrc/expand_increment{,_lock}.cu instantiate


def _code_id(f, tm):
    """What identifies a property check: its code, and its closure's
    values (functions by their own code, the model by identity)."""
    owner = getattr(f, "__self__", None)
    if owner is not None:
        return _code_id(f.__func__, tm), owner is tm
    code = getattr(f, "__code__", None)
    if code is None:
        return id(f)
    cells = []
    for cell in f.__closure__ or ():
        v = cell.cell_contents
        cells.append(_code_id(v, tm) if callable(v) else ("tm" if v is tm else v))
    return code, tuple(cells)


def _same_props(tm, props) -> bool:
    ref = tm.tensor_properties()
    return len(props) == len(ref) and all(
        p.name == q.name and p.expectation == q.expectation
        and _code_id(p.check, tm) == _code_id(q.check, tm)
        for p, q in zip(props, ref)
    )


def kernel_of(tm, props) -> Optional[Tuple[kernels.Kernel, kernels.Kernel, tuple]]:
    """(EXPAND kernel, WALK kernel, its leading size arguments) when `tm`
    with `props` has a hand-written K11, else None."""
    from ..models.abd import AbdOrderedTensor, AbdTensor
    from ..models.increment import IncrementTensor
    from ..models.increment_lock import IncrementLockTensor
    from ..models.paxos import PaxosTensor, PaxosTensorExhaustive
    from ..models.single_copy import SingleCopyTensor
    from ..models.two_phase_commit import TwoPhaseTensor

    if any(name in vars(tm) for name in _MODEL_CODE):
        return None
    if type(tm) is TwoPhaseTensor and 1 <= tm.n <= 16:
        found = kernels.EXPAND_2PC, kernels.WALK_2PC, (tm.n,)
    elif (type(tm) in (PaxosTensor, PaxosTensorExhaustive) and 1 <= tm.c <= 7
          and tm.K == 7 * tm.c and tm.n_actor_lanes == 6 + tm.c):
        found = kernels.EXPAND_PAXOS, kernels.WALK_PAXOS, (tm.c,)
    elif (type(tm) in (AbdTensor, AbdOrderedTensor) and tm.n_servers == 2 and 1 <= tm.c <= 5
          and tm.K == tm.c + 2 and tm.n_actor_lanes == 4 + tm.c):
        found = kernels.EXPAND_ABD, kernels.WALK_ABD, (tm.c, int(bool(tm.ordered)))
    elif (type(tm) is IncrementTensor and 1 <= tm.n <= INCREMENT_MAX_THREADS
          and tm.state_width == 1 + 2 * tm.n and tm.max_actions == 2 * tm.n):
        found = kernels.EXPAND_INCREMENT, kernels.WALK_INCREMENT, (tm.n,)
    elif (type(tm) is IncrementLockTensor and 1 <= tm.n <= INCREMENT_MAX_THREADS
          and tm.state_width == 2 + 2 * tm.n and tm.max_actions == 4 * tm.n):
        found = kernels.EXPAND_INCREMENT_LOCK, kernels.WALK_INCREMENT_LOCK, (tm.n,)
    elif (type(tm) is SingleCopyTensor and 1 <= tm.s <= 4 and 1 <= tm.c <= 5
          and tm.K == tm.c + 1 and tm.n_actor_lanes == tm.s + tm.c):
        found = kernels.EXPAND_SINGLE_COPY, kernels.WALK_SINGLE_COPY, (tm.s, tm.c)
    else:
        return None
    return found if _same_props(tm, list(props)) else None


def _on_card_or_raise(*tensors) -> None:
    if not kernels.on_card(*tensors):
        raise ValueError("the K11 kernel route takes tensors on the card it was built for")


def expand_route(tm, props, device) -> str:
    """"kernel" or "plain": the route `build_expand_lean` and
    `build_walk_step` take for this model, properties and device."""
    on_card = torch.device(device).type == "cuda"
    return "kernel" if on_card and kernel_of(tm, props) is not None else "plain"


def build_expand_lean(tm, props, chunk: int, xp):
    """Returns f(rows [S, W], ebits [W], depth [W], active [W] bool,
    depth_limit) -> ExpandedLean on the route `expand_route` names, with
    `f.route` set to it. depth_limit is an int, a 0-d int64 tensor on the
    rows' device (read there), or one int64 limit a row ([W]). `chunk`
    is the width W the callers give it."""
    props = list(props)
    if expand_route(tm, props, xp.device) == "plain":
        f = build_expand_lean_plain(tm, props, chunk, xp)
        f.route = "plain"
        return f
    expand, _walk, size = kernel_of(tm, props)
    kernels.build_all((expand,))
    S, A, P = tm.state_width, tm.max_actions, len(props)
    dev = xp.device
    # The last-block ticket: zeroed once here, reset by the kernel's last
    # block, so a call (and a graph replay) writes no memset.
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)

    def expand_lean(rows, ebits, depth, active, depth_limit):
        W = rows.shape[1]
        if rows.shape != (S, W) or rows.dtype != torch.int64:
            raise ValueError(f"rows must be int64 [{S}, W], got {rows.dtype} {tuple(rows.shape)}")
        for name, t, dtype in (("ebits", ebits, torch.int64), ("depth", depth, torch.int64),
                               ("active", active, torch.bool)):
            if t.shape != (W,) or t.dtype != dtype:
                raise ValueError(f"{name} must be {dtype} [{W}], got {t.dtype} {tuple(t.shape)}")
        dl, dl_value, dl_stride = None, 0, 0
        if isinstance(depth_limit, torch.Tensor):
            if depth_limit.dtype != torch.int64 or depth_limit.shape not in ((), (W,)):
                raise ValueError(f"depth_limit must be int64 [] or [{W}], got {tuple(depth_limit.shape)}")
            dl, dl_stride = kernels.ptr(depth_limit), (1 if depth_limit.dim() else 0)
        else:
            dl_value = int(depth_limit)
        _on_card_or_raise(rows, ebits, depth, active,
                          *([depth_limit] if isinstance(depth_limit, torch.Tensor) else []))
        ebits_out = torch.empty(W, dtype=torch.int64, device=dev)
        flat = torch.empty((S, A * W), dtype=torch.int64, device=dev)
        valid = torch.empty(A * W, dtype=torch.bool, device=dev)
        hits = torch.empty((P, W), dtype=torch.bool, device=dev)
        generated = torch.empty((), dtype=torch.int64, device=dev)
        partials = torch.empty(max(1, -(-W // EXPAND_THREADS)), dtype=torch.int64, device=dev)
        p = kernels.ptr
        expand.launch(*size, p(rows), p(ebits), p(depth), p(active), dl, dl_value, dl_stride, W,
                      p(ebits_out), p(flat), p(valid), p(hits), p(partials), p(ticket),
                      p(generated))
        return ExpandedLean(ebits=ebits_out, flat=flat, valid=valid, generated=generated,
                            prop_hits=list(hits.unbind(0)))

    expand_lean.route = "kernel"
    return expand_lean


def build_expand_lean_plain(tm, props, chunk: int, xp):
    """The plain version: f(rows [S, C], ebits [C], depth [C], active [C]
    bool, depth_limit) -> ExpandedLean, evaluating `tm` through `xp`."""
    S = tm.state_width
    A = tm.max_actions

    def expand_lean(rows, ebits, depth, active, depth_limit):
        lanes = tuple(rows[s] for s in range(S))
        live = active & (depth < depth_limit)

        prop_hits = []
        e_idx = 0
        e_slot = {}
        for i, p in enumerate(props):
            if p.expectation == Expectation.EVENTUALLY:
                vals = p.check(xp, lanes) & live
                ebits = torch.where(vals, ebits & ~(1 << e_idx), ebits)
                e_slot[i] = e_idx
                e_idx += 1
                prop_hits.append(None)
                continue
            if p.expectation == Expectation.ALWAYS:
                prop_hits.append(live & ~p.check(xp, lanes))
            else:  # SOMETIMES
                prop_hits.append(live & p.check(xp, lanes))

        succs, amask = tm.step_lanes(xp, lanes)
        valid_per_a = []
        any_valid = None
        for a in range(A):
            v = amask[a] & live & tm.within_boundary_lanes(xp, succs[a])
            valid_per_a.append(v)
            any_valid = v if any_valid is None else (any_valid | v)
        valid = torch.cat(valid_per_a)
        generated = valid.sum(dtype=torch.int64)

        terminal = live & ~any_valid
        for i, p in enumerate(props):
            if p.expectation != Expectation.EVENTUALLY:
                continue
            prop_hits[i] = terminal & ((ebits & (1 << e_slot[i])) != 0)

        flat = torch.stack(
            [torch.cat([succs[a][s] for a in range(A)]) for s in range(S)]
        ) & M32
        return ExpandedLean(
            ebits=ebits, flat=flat, valid=valid, generated=generated,
            prop_hits=prop_hits,
        )

    return expand_lean


def build_walk_step(tm, props, xp):
    """The simulation's model step (tpu_simulation.py:268-300): f(rows
    [S, B]) -> (checks [P, B] bool, the raw predicates; valid [A, B] bool,
    enabled and in boundary; succ [A, S, B] int64, the successor lanes),
    on the route `expand_route` names (`f.route`)."""
    props = list(props)
    if expand_route(tm, props, xp.device) == "plain":
        f = build_walk_step_plain(tm, props, xp)
        f.route = "plain"
        return f
    _expand, walk, size = kernel_of(tm, props)
    kernels.build_all((walk,))
    S, A, P = tm.state_width, tm.max_actions, len(props)
    dev = xp.device

    def walk_step(rows):
        B = rows.shape[1]
        if rows.shape != (S, B) or rows.dtype != torch.int64:
            raise ValueError(f"rows must be int64 [{S}, B], got {rows.dtype} {tuple(rows.shape)}")
        _on_card_or_raise(rows)
        checks = torch.empty((P, B), dtype=torch.bool, device=dev)
        valid = torch.empty((A, B), dtype=torch.bool, device=dev)
        succ = torch.empty((A, S, B), dtype=torch.int64, device=dev)
        p = kernels.ptr
        walk.launch(*size, p(rows), B, p(checks), p(valid), p(succ))
        return checks, valid, succ

    walk_step.route = "kernel"
    return walk_step


def build_walk_step_plain(tm, props, xp):
    """The plain version of `build_walk_step`: the model's checks,
    `step_lanes` and boundary through `xp`."""
    S, A = tm.state_width, tm.max_actions

    def walk_step(rows):
        B = rows.shape[1]
        lanes = tuple(rows[s] for s in range(S))
        if props:
            checks = torch.stack([p.check(xp, lanes) for p in props])
        else:
            checks = torch.zeros((0, B), dtype=torch.bool, device=rows.device)
        succs, amask = tm.step_lanes(xp, lanes)
        valid = torch.stack(
            [amask[a] & tm.within_boundary_lanes(xp, succs[a]) for a in range(A)]
        )
        # One copy of the A*S successor lanes, taken before the caller
        # rewrites the rows some of them are views of.
        succ = torch.stack([lane for a in range(A) for lane in succs[a]]).view(A, S, B)
        return checks, valid, succ

    return walk_step
