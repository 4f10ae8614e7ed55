"""The symmetry canon of the BFS step's candidates (K11c): the port's
counterpart of the model's `representative_lanes` as the JAX BFS step
runs it (`stateright_tpu/engines/tpu_bfs.py:478-482`), on the compacted
candidates, before they are hashed.

Two routes, picked once, when the function is built, as `ops/expand.py`
picks K11's:

- **kernel**: on a CUDA device, for `type(tm)` exactly `TwoPhaseTensor`
  with 1 <= n <= 16 whose instance overrides none of the model code
  (`expand._MODEL_CODE`, `representative_lanes` among it): one launch of
  `kernels/csrc/canon_2pc.cu` a call (the semantics in
  `kernels/csrc/models/two_phase.cuh`). A kernel that fails to build or
  launch raises; nothing falls back.
- **plain**: the model's own `representative_lanes` through the torch
  `xp`, masked to 32 bits; on the CPU, and on the card for a model with
  no kernel.

`canon_route(tm, device)` names the route; the BFS engine reports it in
`telemetry()["canon_route"]` ("kernel", "plain", or None without
symmetry).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .expand import _MODEL_CODE

M32 = 0xFFFFFFFF


def kernel_of(tm) -> Optional[tuple]:
    """(the canon kernel, its size arguments) when `tm` has a hand-written
    canon, else None."""
    from ..models.two_phase_commit import TwoPhaseTensor

    if any(name in vars(tm) for name in _MODEL_CODE):
        return None
    if type(tm) is TwoPhaseTensor and 1 <= tm.n <= 16:
        return kernels.CANON_2PC, (tm.n,)
    return None


def canon_route(tm, device) -> str:
    """"kernel" or "plain": the route `build_canon` takes for this model
    and device."""
    on_card = torch.device(device).type == "cuda"
    return "kernel" if on_card and kernel_of(tm) is not None else "plain"


def build_canon(tm, xp):
    """Returns f(rows [S, W] int64) -> [S, W] int64, each column's
    representative (uint32 values), on the route `canon_route` names, with
    `f.route` set to it."""
    if canon_route(tm, xp.device) == "plain":
        f = build_canon_plain(tm, xp)
        f.route = "plain"
        return f
    kern, size = kernel_of(tm)
    kernels.build_all((kern,))
    S, dev = tm.state_width, xp.device

    def canon(rows):
        W = rows.shape[1]
        if rows.shape != (S, W) or rows.dtype != torch.int64:
            raise ValueError(f"rows must be int64 [{S}, W], got {rows.dtype} {tuple(rows.shape)}")
        if not kernels.on_card(rows):
            raise ValueError("the canon kernel route takes tensors on the card it was built for")
        out = torch.empty((S, W), dtype=torch.int64, device=dev)
        kern.launch(*size, kernels.ptr(rows), kernels.ptr(out), W)
        return out

    canon.route = "kernel"
    return canon


def build_canon_plain(tm, xp):
    """The plain version: the model's `representative_lanes` through `xp`."""
    S = tm.state_width

    def canon(rows):
        return torch.stack(tm.representative_lanes(xp, tuple(rows[s] for s in range(S)))) & M32

    return canon
