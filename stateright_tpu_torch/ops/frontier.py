"""Frontier programs: in-batch dedup (K3) and the ring queue (K7), each
with a hand-written kernel (kernels/csrc) and its plain torch version.

The port's counterpart of `stateright_tpu/ops/frontier.py`. The ring is
one int64 tensor [W, qcap + 1]: W lanes (the S state lanes, the
eventually-bits, the depth), a power-of-two capacity qcap, and one trash
column at index qcap that absorbs the writes of dropped rows.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..fingerprint import mul32
from .visited_set import compact_ids

DEDUP_MUL = 0x9E3779B9


def claim_dedup_plain(h1, h2, valid, scratch_cap: int):
    n = h1.shape[0]
    dev = h1.device
    slot = (h1 ^ mul32(h2, DEDUP_MUL)) & (scratch_cap - 1)
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    claim = torch.full((scratch_cap + 1,), -1, dtype=torch.int64, device=dev)
    trash = torch.full_like(slot, scratch_cap)
    # Highest index wins its slot: scatter_reduce amax, a defined winner.
    claim.scatter_reduce_(0, torch.where(valid, slot, trash), ids, reduce="amax")
    win = claim.index_select(0, slot).clamp(min=0)
    same_key = (h1.index_select(0, win) == h1) & (h2.index_select(0, win) == h2)
    return valid & ((win == ids) | ~same_key)


def claim_dedup(h1, h2, valid, scratch_cap: int):
    """Approximate in-batch dedup: each valid candidate claims the scratch
    slot (h1 ^ h2*0x9E3779B9) & (scratch_cap-1), the highest index wins,
    and a candidate is kept if it won or if the winner's key differs. Two
    keys on one slot both survive; the visited-set insert arbitrates them
    exactly. Returns keep [n] bool."""
    if scratch_cap & (scratch_cap - 1):
        raise ValueError("dedup scratch capacity must be a power of two")
    if not kernels.on_card(h1, h2, valid):
        return claim_dedup_plain(h1, h2, valid, scratch_cap)
    n = h1.shape[0]
    if valid.dtype != torch.bool or n >= 0xFFFFFFFF:
        raise ValueError("claim_dedup takes a bool mask and n < 2^32 - 1")
    h1, h2, valid = h1.contiguous(), h2.contiguous(), valid.contiguous()
    scratch = torch.empty(scratch_cap, dtype=torch.int32, device=h1.device)
    keep = torch.empty(n, dtype=torch.bool, device=h1.device)
    kernels.CLAIM_DEDUP.launch(
        kernels.ptr(h1), kernels.ptr(h2), kernels.ptr(valid), n,
        kernels.ptr(scratch), scratch_cap, kernels.ptr(keep),
    )
    return keep


def empty_ring(width: int, qcap: int, device) -> torch.Tensor:
    if qcap & (qcap - 1):
        raise ValueError("queue_capacity must be a power of two")
    return torch.zeros((width, qcap + 1), dtype=torch.int64, device=device)


def ring_capacity(ring: torch.Tensor) -> int:
    return ring.shape[1] - 1


def ring_indices(head: int, n: int, qcap: int, device) -> torch.Tensor:
    return (head + torch.arange(n, dtype=torch.int64, device=device)) & (qcap - 1)


def ring_pop_plain(ring: torch.Tensor, head: int, n: int) -> torch.Tensor:
    idx = ring_indices(head, n, ring_capacity(ring), ring.device)
    return ring.index_select(1, idx)


def ring_pop(ring: torch.Tensor, head: int, n: int) -> torch.Tensor:
    """The n consecutive ring rows from `head`, wrapping: [W, n] (K7 pop,
    the counterpart of `ring_gather`)."""
    if not kernels.on_card(ring):
        return ring_pop_plain(ring, head, n)
    if not ring.is_contiguous():
        raise ValueError("the ring must be contiguous")
    W = ring.shape[0]
    out = torch.empty((W, n), dtype=torch.int64, device=ring.device)
    kernels.RING.launch(
        kernels.ptr(ring), W, ring.stride(0), ring_capacity(ring) - 1, head,
        kernels.ptr(out), n, n, None, None,
    )
    return out


def ring_gather(ring: torch.Tensor, head: int, n: int):
    """The n consecutive ring rows from `head`: ([W, n] rows, indices)."""
    return ring_pop(ring, head, n), ring_indices(head, n, ring_capacity(ring), ring.device)


def ring_scatter_plain(ring, tail: int, cand, valid) -> None:
    m = valid.shape[0]
    qcap = ring_capacity(ring)
    ids, ok, _n = compact_ids(valid, m)
    pos = torch.where(
        ok, ring_indices(tail, m, qcap, ring.device),
        torch.full((m,), qcap, dtype=torch.int64, device=ring.device),
    )
    ring.index_copy_(1, pos, cand.index_select(1, ids))


def ring_scatter(ring: torch.Tensor, tail: int, cand: torch.Tensor, valid: torch.Tensor) -> None:
    """Append the `valid` columns of cand [W, m] at tail, tail+1, ... in
    candidate order, in place (K7 append, the counterpart of
    `ring_scatter`): K2 compacts the mask and the ring kernel writes the
    r-th valid column at tail + r. Other ring positions are untouched
    (the plain version sends unused id slots to the trash column)."""
    if not kernels.on_card(ring, cand, valid):
        return ring_scatter_plain(ring, tail, cand, valid)
    if not (ring.is_contiguous() and cand.is_contiguous()):
        raise ValueError("the ring and the candidates must be contiguous")
    W, m = cand.shape
    if W != ring.shape[0] or valid.shape[0] != m:
        raise ValueError("candidate lanes do not match the ring")
    ids, _ok, n_set = compact_ids(valid, m)
    kernels.RING.launch(
        kernels.ptr(ring), W, ring.stride(0), ring_capacity(ring) - 1, tail,
        kernels.ptr(cand), cand.stride(0), m, kernels.ptr(ids), kernels.ptr(n_set),
    )
