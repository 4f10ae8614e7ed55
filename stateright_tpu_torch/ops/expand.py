"""Evaluate-and-expand for one popped chunk (K11): the port's counterpart
of `stateright_tpu/ops/expand.py:54 build_expand_lean`.

It is built from the model's own code run through the torch `xp`, not a
hand-written kernel. Semantics are the reference hot loop's (bfs.rs:
196-334): property evaluation with eventually-bit clearing, the depth
limit, successor generation with the boundary filter, the terminal rule,
and terminal eventually-bit discoveries. The candidate batch is
action-major: candidate a*C + c is action a applied to popped row c.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import Expectation

M32 = 0xFFFFFFFF


class ExpandedLean(NamedTuple):
    ebits: torch.Tensor  # [C] int64, after property evaluation
    flat: torch.Tensor  # [S, C*A] int64 successor lanes (action-major)
    valid: torch.Tensor  # [C*A] bool: action valid & in boundary & parent live
    generated: torch.Tensor  # 0-d int64: number of valid candidates
    prop_hits: list  # P masks, each [C] bool: rows that discover property i


def build_expand_lean(tm, props, chunk: int, xp):
    """Returns f(rows [S, C], ebits [C], depth [C], active [C] bool,
    depth_limit int) -> ExpandedLean, evaluating `tm` through `xp`."""
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
