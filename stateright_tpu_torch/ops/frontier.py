"""Frontier programs: in-batch dedup (K3) and the ring queue (K7), each
with a hand-written kernel (kernels/csrc) and its plain torch version.

The port's counterpart of `stateright_tpu/ops/frontier.py`. The ring is
one int64 tensor [W, qcap + 1]: W state-row lanes (the S state lanes,
the eventually-bits, the depth), a power-of-two capacity qcap, and one
trash column at index qcap that absorbs the writes of dropped rows.

Each op has a lane form (`claim_dedup_lanes`, `ring_pop_lanes`,
`ring_scatter_lanes`): the JAX op under `jax.vmap`, over the checks that
the multiplexed engine (engines/multiplex.py) runs side by side, with
one ring a lane stacked as [lanes, W, qcap + 1]. A lane there is one
check; the ring's W rows stay its state-row lanes. The solo functions
are the one-lane case: one kernel source serves both.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..fingerprint import mul32
from .visited_set import _compact_ids

DEDUP_MUL = 0x9E3779B9


def claim_dedup_lanes_plain(h1, h2, valid, scratch_cap: int):
    N, n = h1.shape
    dev = h1.device
    row = (torch.arange(N, dtype=torch.int64, device=dev) * scratch_cap)[:, None]
    slot = (row + ((h1 ^ mul32(h2, DEDUP_MUL)) & (scratch_cap - 1))).reshape(-1)
    ids = torch.arange(N * n, dtype=torch.int64, device=dev)
    trash = N * scratch_cap
    claim = torch.full((trash + 1,), -1, dtype=torch.int64, device=dev)
    # Highest index wins its slot: scatter_reduce amax, a defined winner
    # (a slot's contenders share a lane, so the index orders as the lane's).
    claim.scatter_reduce_(
        0, torch.where(valid.reshape(-1), slot, torch.full_like(slot, trash)), ids, reduce="amax"
    )
    win = claim.index_select(0, slot).clamp(min=0)
    f1, f2 = h1.reshape(-1), h2.reshape(-1)
    same_key = (f1.index_select(0, win) == f1) & (f2.index_select(0, win) == f2)
    return valid & ((win == ids) | ~same_key).view(N, n)


def _claim_dedup(h1, h2, valid, scratch_cap: int, kernel):
    if scratch_cap & (scratch_cap - 1):
        raise ValueError("dedup scratch capacity must be a power of two")
    if not kernels.on_card(h1, h2, valid):
        return claim_dedup_lanes_plain(h1, h2, valid, scratch_cap)
    N, n = h1.shape
    if valid.dtype != torch.bool or n >= 0xFFFFFFFF:
        raise ValueError("claim_dedup takes a bool mask and n < 2^32 - 1")
    h1, h2, valid = h1.contiguous(), h2.contiguous(), valid.contiguous()
    scratch = torch.empty((N, scratch_cap), dtype=torch.int32, device=h1.device)
    keep = torch.empty((N, n), dtype=torch.bool, device=h1.device)
    kernel.launch(
        kernels.ptr(h1), kernels.ptr(h2), kernels.ptr(valid), N, n,
        kernels.ptr(scratch), scratch_cap, kernels.ptr(keep),
    )
    return keep


def claim_dedup_lanes(h1, h2, valid, scratch_cap: int):
    """`claim_dedup` in each lane (the vmapped JAX op): candidates [N, n],
    one scratch_cap-slot scratch a lane, the highest index within a lane
    wins its slot. Returns keep [N, n] bool."""
    return _claim_dedup(h1, h2, valid, scratch_cap, kernels.CLAIM_DEDUP_LANES)


def claim_dedup_plain(h1, h2, valid, scratch_cap: int):
    return claim_dedup_lanes_plain(h1[None], h2[None], valid[None], scratch_cap)[0]


def claim_dedup(h1, h2, valid, scratch_cap: int):
    """Approximate in-batch dedup: each valid candidate claims the scratch
    slot (h1 ^ h2*0x9E3779B9) & (scratch_cap-1), the highest index wins,
    and a candidate is kept if it won or if the winner's key differs. Two
    keys on one slot both survive; the visited-set insert arbitrates them
    exactly. Returns keep [n] bool. The one-lane case of
    `claim_dedup_lanes`."""
    return _claim_dedup(h1[None], h2[None], valid[None], scratch_cap, kernels.CLAIM_DEDUP)[0]


def empty_ring(width: int, qcap: int, device, lanes=None) -> torch.Tensor:
    """A ring [width, qcap + 1], or with `lanes` one ring a lane
    [lanes, width, qcap + 1] (the multiplexed engine's)."""
    if qcap & (qcap - 1):
        raise ValueError("queue_capacity must be a power of two")
    shape = (width, qcap + 1) if lanes is None else (lanes, width, qcap + 1)
    return torch.zeros(shape, dtype=torch.int64, device=device)


def ring_capacity(ring: torch.Tensor) -> int:
    return ring.shape[-1] - 1


def ring_indices(head: int, n: int, qcap: int, device) -> torch.Tensor:
    return (head + torch.arange(n, dtype=torch.int64, device=device)) & (qcap - 1)


def _positions(rings, base: int, bases, n: int) -> torch.Tensor:
    """[N, n] ring positions from each ring's head (base + bases[l])."""
    start = base if bases is None else (base + bases)[:, None]
    return (start + torch.arange(n, dtype=torch.int64, device=rings.device)) & (
        ring_capacity(rings) - 1
    )


def _pop_plain(rings, base: int, bases, n: int) -> torch.Tensor:
    N, W, _q1 = rings.shape
    idx = _positions(rings, base, bases, n).expand(N, n)
    out = rings.gather(2, idx[:, None, :].expand(N, W, n))
    return out.transpose(0, 1).reshape(W, N * n)


def _pop(rings, base: int, bases, n: int, kernel) -> torch.Tensor:
    if not kernels.on_card(rings, *(() if bases is None else (bases,))):
        return _pop_plain(rings, base, bases, n)
    if not rings.is_contiguous():
        raise ValueError("the ring must be contiguous")
    N, W, q1 = rings.shape
    out = torch.empty((W, N * n), dtype=torch.int64, device=rings.device)
    kernel.launch(
        kernels.ptr(rings), N, W, q1, W * q1, q1 - 2, base,
        None if bases is None else kernels.ptr(bases),
        kernels.ptr(out), N * n, n, None, None,
    )
    return out


def ring_pop_lanes_plain(rings: torch.Tensor, heads: torch.Tensor, n: int) -> torch.Tensor:
    return _pop_plain(rings, 0, heads, n)


def ring_pop_lanes(rings: torch.Tensor, heads: torch.Tensor, n: int) -> torch.Tensor:
    """From each lane's ring [N, W, qcap + 1] the n consecutive rows from
    heads[l] (int64 [N]), wrapping, side by side: [W, N*n], lane l's rows
    at columns l*n .. l*n + n - 1 (the vmapped `ring_gather`)."""
    return _pop(rings, 0, heads, n, kernels.RING_LANES)


def _solo_position(head):
    """(base, bases) of a solo ring position: a Python int, or an int64
    tensor of one element on the ring's device (the era's state vector
    holds the head, so a captured step pops where each step left it)."""
    if isinstance(head, torch.Tensor):
        return 0, head.reshape(1)
    return int(head), None


def ring_pop_plain(ring: torch.Tensor, head, n: int) -> torch.Tensor:
    return _pop_plain(ring[None], *_solo_position(head), n)


def ring_pop(ring: torch.Tensor, head, n: int) -> torch.Tensor:
    """The n consecutive ring rows from `head` (an int, or an int64 [1]
    tensor on the ring's device), wrapping: [W, n] (K7 pop, the
    counterpart of `ring_gather`; the one-lane case of
    `ring_pop_lanes`)."""
    return _pop(ring[None], *_solo_position(head), n, kernels.RING)


def ring_gather(ring: torch.Tensor, head: int, n: int):
    """The n consecutive ring rows from `head`: ([W, n] rows, indices)."""
    return ring_pop(ring, head, n), ring_indices(head, n, ring_capacity(ring), ring.device)


def _append_plain(rings, base: int, bases, cand, valid) -> None:
    N, W, q1 = rings.shape
    m = valid.shape[1]
    qcap = q1 - 1
    ids, ok, _n = _compact_ids(valid[:, None, :], m, kernels.COMPACT_IDS_LANES)
    pos = torch.where(ok, _positions(rings, base, bases, m), qcap)
    src = cand.view(W, N, m).gather(2, ids[None].expand(W, N, m))
    lane_w = (
        torch.arange(N, device=rings.device)[None, :, None] * (W * q1)
        + torch.arange(W, device=rings.device)[:, None, None] * q1
    )
    rings.view(-1).index_copy_(0, (lane_w + pos[None]).reshape(-1), src.reshape(-1))


def _append(rings, base: int, bases, cand, valid, compact_kernel, kernel) -> None:
    tensors = (rings, cand, valid) + (() if bases is None else (bases,))
    if not kernels.on_card(*tensors):
        return _append_plain(rings, base, bases, cand, valid)
    if not (rings.is_contiguous() and cand.is_contiguous()):
        raise ValueError("the ring and the candidates must be contiguous")
    N, W, q1 = rings.shape
    m = valid.shape[1]
    if cand.shape != (W, N * m) or valid.shape[0] != N:
        raise ValueError("candidate lanes do not match the ring")
    ids, _ok, n_set = _compact_ids(valid[:, None, :], m, compact_kernel)
    kernel.launch(
        kernels.ptr(rings), N, W, q1, W * q1, q1 - 2, base,
        None if bases is None else kernels.ptr(bases),
        kernels.ptr(cand), cand.stride(0), m, kernels.ptr(ids), kernels.ptr(n_set),
    )


def ring_scatter_lanes_plain(rings, tails: torch.Tensor, cand, valid) -> None:
    _append_plain(rings, 0, tails, cand, valid)


def ring_scatter_lanes(rings: torch.Tensor, tails: torch.Tensor, cand: torch.Tensor,
                       valid: torch.Tensor) -> None:
    """Append, in each lane's ring [N, W, qcap + 1], the `valid` [N, m]
    columns of its candidates (cand [W, N*m], lane l's at columns
    l*m ..) at tails[l], tails[l]+1, ... in candidate order, in place (the
    vmapped `ring_scatter`): K2 compacts each lane's mask and one ring
    launch writes every lane's rows."""
    _append(rings, 0, tails, cand, valid, kernels.COMPACT_IDS_LANES, kernels.RING_LANES)


def ring_scatter_plain(ring, tail, cand, valid) -> None:
    _append_plain(ring[None], *_solo_position(tail), cand, valid[None])


def ring_scatter(ring: torch.Tensor, tail, cand: torch.Tensor, valid: torch.Tensor) -> None:
    """Append the `valid` columns of cand [W, m] at tail, tail+1, ... in
    candidate order, in place (K7 append, the counterpart of
    `ring_scatter`; `tail` an int or an int64 [1] tensor on the ring's
    device): K2 compacts the mask and the ring kernel writes the r-th
    valid column at tail + r. Other ring positions are untouched (the
    plain version sends unused id slots to the trash column). The
    one-lane case of `ring_scatter_lanes`."""
    _append(ring[None], *_solo_position(tail), cand, valid[None], kernels.COMPACT_IDS, kernels.RING)
