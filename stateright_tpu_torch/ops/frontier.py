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

The host spill (K7s, `ring_drain` and `ring_refill`, with the lane forms
the sharded engine runs over its shards) moves ring rows to and from
row-major uint32 blocks [k, W], the JAX engines' spill layout, held in
torch as int32 bits; `SpillStaging` carries them through one pinned host
buffer a run.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import kernels
from ..fingerprint import mul32

DEDUP_MUL = 0x9E3779B9


def _prefix_mask(valid, n_val):
    """valid & (index < n_val), lane by lane: the candidates K3 reads."""
    if n_val is None:
        return valid
    N, n = valid.shape
    return valid & (torch.arange(n, device=valid.device)[None, :] < n_val.reshape(N, 1))


def claim_dedup_lanes_plain(h1, h2, valid, scratch_cap: int, n_val=None):
    N, n = h1.shape
    dev = h1.device
    valid = _prefix_mask(valid, n_val)
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


def dedup_scratch(lanes: int, scratch_cap: int, device) -> torch.Tensor:
    """K3's workspace (claim_dedup.cu): a 64-bit slot a lane's scratch
    position, tagged with the call's epoch, then the epoch word; zero
    when made. Each call leaves it as the next expects it, so a program
    makes it once and every call (and a CUDA-graph replay) reuses it."""
    return torch.zeros(lanes * scratch_cap + 1, dtype=torch.int64, device=device)


def _claim_dedup(h1, h2, valid, scratch_cap: int, n_val, scratch, kernel):
    if scratch_cap & (scratch_cap - 1):
        raise ValueError("dedup scratch capacity must be a power of two")
    if not kernels.on_card(h1, h2, valid, *(() if n_val is None else (n_val,))):
        return claim_dedup_lanes_plain(h1, h2, valid, scratch_cap, n_val)
    N, n = h1.shape
    if valid.dtype != torch.bool or n >= 0xFFFFFFFF:
        raise ValueError("claim_dedup takes a bool mask and n < 2^32 - 1")
    if scratch is None:
        scratch = dedup_scratch(N, scratch_cap, h1.device)
    elif scratch.numel() != N * scratch_cap + 1 or scratch.dtype != torch.int64:
        raise ValueError(f"the dedup scratch must be dedup_scratch({N}, {scratch_cap})")
    h1, h2, valid = h1.contiguous(), h2.contiguous(), valid.contiguous()
    keep = torch.empty((N, n), dtype=torch.bool, device=h1.device)
    kernel.launch(
        kernels.ptr(h1), kernels.ptr(h2), kernels.ptr(valid),
        None if n_val is None else kernels.ptr(n_val.reshape(N)), N, n,
        kernels.ptr(scratch), scratch_cap, kernels.ptr(keep),
    )
    return keep


def claim_dedup_lanes(h1, h2, valid, scratch_cap: int, n_val=None, scratch=None):
    """`claim_dedup` in each lane (the vmapped JAX op): candidates [N, n],
    one scratch_cap-slot scratch a lane, the highest index within a lane
    wins its slot. `n_val` [N] (or None: the whole width): lane l's
    candidates past n_val[l] count as invalid, and the kernel does not
    read them. `scratch`: the caller's `dedup_scratch(N, scratch_cap)`
    (None: a fresh one). Returns keep [N, n] bool."""
    return _claim_dedup(h1, h2, valid, scratch_cap, n_val, scratch, kernels.CLAIM_DEDUP_LANES)


def claim_dedup_plain(h1, h2, valid, scratch_cap: int, n_val=None):
    nv = None if n_val is None else n_val.reshape(1)
    return claim_dedup_lanes_plain(h1[None], h2[None], valid[None], scratch_cap, nv)[0]


def claim_dedup(h1, h2, valid, scratch_cap: int, n_val=None, scratch=None):
    """Approximate in-batch dedup: each valid candidate claims the scratch
    slot (h1 ^ h2*0x9E3779B9) & (scratch_cap-1), the highest index wins,
    and a candidate is kept if it won or if the winner's key differs. Two
    keys on one slot both survive; the visited-set insert arbitrates them
    exactly. `n_val` (a 0-d count, or None): candidates past it count as
    invalid. Returns keep [n] bool. The one-lane case of
    `claim_dedup_lanes`."""
    nv = None if n_val is None else n_val.reshape(1)
    return _claim_dedup(h1[None], h2[None], valid[None], scratch_cap, nv, scratch, kernels.CLAIM_DEDUP)[0]


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
        kernels.ptr(out), N * n, n,
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
    rank = torch.cumsum(valid.to(torch.int64), 1) - 1
    start = base if bases is None else (base + bases)[:, None]
    # Invalid columns go to the trash column, valid ones to tail + rank.
    pos = torch.where(valid, (start + rank) & (qcap - 1), qcap)
    lane_w = (
        torch.arange(N, device=rings.device)[None, :, None] * (W * q1)
        + torch.arange(W, device=rings.device)[:, None, None] * q1
    )
    rings.view(-1).index_copy_(0, (lane_w + pos[None]).reshape(-1), cand.reshape(-1))


def _append(rings, base: int, bases, cand, valid, kernel) -> None:
    tensors = (rings, cand, valid) + (() if bases is None else (bases,))
    if not kernels.on_card(*tensors):
        return _append_plain(rings, base, bases, cand, valid)
    if not (rings.is_contiguous() and cand.is_contiguous()):
        raise ValueError("the ring and the candidates must be contiguous")
    N, W, q1 = rings.shape
    m = valid.shape[1]
    if cand.shape != (W, N * m) or valid.shape[0] != N or valid.dtype != torch.bool:
        raise ValueError("candidate lanes do not match the ring")
    if N > 65535 or W > 65535:
        raise ValueError("at most 65,535 rings and 65,535 state-row lanes a launch")
    valid = valid.contiguous()
    # One count a (lane, tile), rewritten by COUNT before WRITE reads it.
    scratch = torch.empty((N, -(-m // kernels.APPEND_TILE)), dtype=torch.int32, device=rings.device)
    for stage in (0, 1):  # COUNT, WRITE
        kernel.launch(
            stage, kernels.ptr(rings), N, W, q1, W * q1, q1 - 2, base,
            None if bases is None else kernels.ptr(bases),
            kernels.ptr(cand), cand.stride(0), kernels.ptr(valid), m, m, kernels.ptr(scratch),
        )


def ring_scatter_lanes_plain(rings, tails: torch.Tensor, cand, valid) -> None:
    _append_plain(rings, 0, tails, cand, valid)


def ring_scatter_lanes(rings: torch.Tensor, tails: torch.Tensor, cand: torch.Tensor,
                       valid: torch.Tensor) -> None:
    """Append, in each lane's ring [N, W, qcap + 1], the `valid` [N, m]
    columns of its candidates (cand [W, N*m], lane l's at columns
    l*m ..) at tails[l], tails[l]+1, ... in candidate order, in place (the
    vmapped `ring_scatter`): two launches of K7's append (COUNT, WRITE)
    rank and write every lane's rows, with no compaction between."""
    _append(rings, 0, tails, cand, valid, kernels.RING_APPEND_LANES)


def ring_scatter_plain(ring, tail, cand, valid) -> None:
    _append_plain(ring[None], *_solo_position(tail), cand, valid[None])


def ring_scatter(ring: torch.Tensor, tail, cand: torch.Tensor, valid: torch.Tensor) -> None:
    """Append the `valid` columns of cand [W, m] at tail, tail+1, ... in
    candidate order, in place (K7 append, the counterpart of
    `ring_scatter`; `tail` an int or an int64 [1] tensor on the ring's
    device): the append's COUNT and WRITE launches write the r-th valid
    column at tail + r. Other ring positions are untouched (the plain
    version sends invalid columns to the trash column). The one-lane case
    of `ring_scatter_lanes`."""
    _append(ring[None], *_solo_position(tail), cand, valid[None], kernels.RING_APPEND)


# ---------------------------------------------------------------------------
# K7s: the host spill's drain and refill.
# ---------------------------------------------------------------------------

U32_SIGN = 1 << 31


def to_u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 lanes holding uint32 values as int32 tensors of the same bits."""
    return torch.where(x >= U32_SIGN, x - (1 << 32), x).to(torch.int32)


def from_u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 bits back to int64 lanes holding the uint32 values."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _spans(positions: Sequence[int], ks: Sequence[int]):
    """(off, k, pos) per ring as Python ints, off the exclusive sum of k."""
    ks = [int(k) for k in ks]
    if len(ks) != len(positions) or min(ks, default=0) < 0:
        raise ValueError("one non-negative row count a ring")
    off = np.concatenate([[0], np.cumsum(ks)[:-1]]).astype(np.int64).tolist() if ks else []
    return off, ks, [int(p) for p in positions]


def _flat_rows(rings: torch.Tensor, positions, ks) -> torch.Tensor:
    """The flat ring index of every (row, lane w) of the spans: [K, W]."""
    L, W, q1 = rings.shape
    off, ks, pos = _spans(positions, ks)
    dev = rings.device
    K = sum(ks)
    lane = torch.repeat_interleave(torch.arange(L, device=dev), torch.tensor(ks, device=dev), output_size=K)
    i = torch.arange(K, device=dev) - torch.tensor(off, dtype=torch.int64, device=dev).index_select(0, lane)
    at = (torch.tensor(pos, dtype=torch.int64, device=dev).index_select(0, lane) + i) & (q1 - 2)
    return (lane * (W * q1) + at)[:, None] + torch.arange(W, device=dev)[None, :] * q1


def ring_drain_lanes_plain(rings: torch.Tensor, starts: Sequence[int], ks: Sequence[int]) -> torch.Tensor:
    flat = _flat_rows(rings, starts, ks)
    return to_u32_bits(rings.reshape(-1).index_select(0, flat.reshape(-1)).view(flat.shape))


def ring_refill_lanes_plain(rings: torch.Tensor, tails: Sequence[int], ks: Sequence[int],
                            rows: torch.Tensor) -> None:
    flat = _flat_rows(rings, tails, ks)
    rings.view(-1).index_copy_(0, flat.reshape(-1), from_u32_bits(rows).reshape(-1))


# K7s's blocks (kernels/csrc/ring_spill.cu): at most SPILL_BLOCK_WORDS
# block-side words a block, and fewer where that would leave the card
# under SPILL_MIN_BLOCKS blocks (two an SM), down to SPILL_MIN_ROWS rows.
SPILL_BLOCK_WORDS = 4096
SPILL_MIN_BLOCKS = 264
SPILL_MIN_ROWS = 512


def spill_plan(positions: Sequence[int], ks: Sequence[int], width: int):
    """K7s's work, planned on the host: (runs, rows a block). One run
    (ring, off, k, pos) a ring with rows, as int64 [n, 4]; the kernel
    cuts each into blocks of `rows a block` rows (a ring's last block
    takes what is left), so no block waits on a short ring."""
    if width > SPILL_BLOCK_WORDS:
        raise ValueError(f"K7s takes rows of at most {SPILL_BLOCK_WORDS} words")
    off, ks, pos = _spans(positions, ks)
    runs = np.array([(l, o, k, p) for l, (o, k, p) in enumerate(zip(off, ks, pos)) if k],
                    dtype=np.int64).reshape(-1, 4)
    most = SPILL_BLOCK_WORDS // width
    return runs, min(most, max(SPILL_MIN_ROWS, -(-sum(ks) // SPILL_MIN_BLOCKS)))


def _spill_launch(kernel, rings, positions, ks, rows, specialise: bool = True) -> None:
    """One K7s call. `specialise=False` runs the runtime-W kernel at a
    width that has its own (W = 5), to time one against the other."""
    L, W, q1 = rings.shape
    if not rings.is_contiguous() or not rows.is_contiguous():
        raise ValueError("the rings and the rows must be contiguous")
    runs, per_block = spill_plan(positions, ks, W)
    # The plan goes in the kernel's parameters (host memory read by the
    # launch itself): no copy to the card a call.
    kernel.launch(
        kernels.ptr(rings), W, q1, W * q1, q1 - 2, runs.ctypes.data, runs.shape[0], per_block,
        int(specialise), kernels.ptr(rows),
    )


def ring_drain_lanes(rings: torch.Tensor, starts: Sequence[int], ks: Sequence[int],
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The newest rows of each ring [L, W, qcap + 1]: ring l's k_l rows
    from position starts[l] (its head + count - k_l), wrapping, stacked
    row-major as uint32 bits [sum k, W] int32, ring after ring (K7s
    DRAIN, the S1/S3 gather). `out`: a device staging buffer with room
    for the rows (the result is its first sum(k) rows)."""
    K = sum(int(k) for k in ks)
    if not kernels.on_card(rings):
        return ring_drain_lanes_plain(rings, starts, ks)
    W = rings.shape[1]
    if K == 0:
        return torch.empty((0, W), dtype=torch.int32, device=rings.device)
    if out is None:
        out = torch.empty((K, W), dtype=torch.int32, device=rings.device)
    elif out.dtype != torch.int32 or out.shape[1:] != (W,) or out.shape[0] < K:
        raise ValueError("the staging buffer is too small for the drain")
    out = out[:K]
    _spill_launch(kernels.RING_DRAIN, rings, starts, ks, out)
    return out


def ring_refill_lanes(rings: torch.Tensor, tails: Sequence[int], ks: Sequence[int],
                      rows: torch.Tensor) -> None:
    """Write each ring's block of `rows` ([sum k, W] int32 uint32 bits,
    ring after ring) at its tail: ring l's rows at tails[l], tails[l] +
    1, ... wrapping, in place (K7s REFILL, the S2/S4 scatter)."""
    K = sum(int(k) for k in ks)
    if rows.dtype != torch.int32 or rows.shape != (K, rings.shape[1]):
        raise ValueError("refill rows must be int32 [sum k, W]")
    if not kernels.on_card(rings, rows):
        return ring_refill_lanes_plain(rings, tails, ks, rows)
    if K == 0:
        return
    _spill_launch(kernels.RING_REFILL, rings, tails, ks, rows)


def ring_drain_plain(ring: torch.Tensor, start: int, k: int) -> torch.Tensor:
    return ring_drain_lanes_plain(ring[None], [start], [k])


def ring_drain(ring: torch.Tensor, start: int, k: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The k ring rows from `start` (head + count - k), wrapping, as
    uint32 bits [k, W] int32: the one-ring case of `ring_drain_lanes`."""
    return ring_drain_lanes(ring[None], [start], [k], out)


def ring_refill_plain(ring: torch.Tensor, tail: int, rows: torch.Tensor) -> None:
    ring_refill_lanes_plain(ring[None], [tail], [rows.shape[0]], rows)


def ring_refill(ring: torch.Tensor, tail: int, rows: torch.Tensor) -> None:
    """Write `rows` [k, W] at the ring's tail: the one-ring case of
    `ring_refill_lanes`."""
    ring_refill_lanes(ring[None], [tail], [rows.shape[0]], rows)


class SpillStaging:
    """A run's spill transfers (the JAX engines' one stacked download a
    drain and one upload a refill): on the card one pinned host buffer
    and one device buffer of `rows` rows (the run's largest drain),
    allocated at the first spill, each drain one K7s launch and one copy
    into pinned memory, each refill one copy out of it and one K7s
    launch a buffer's worth of rows; on the CPU the plain versions.
    Blocks are numpy uint32 [k, W], the JAX layout."""

    def __init__(self, width: int, device, rows: int = 0):
        self.width = width
        self.device = torch.device(device)
        self.rows = rows
        self._host: Optional[torch.Tensor] = None
        self._dev: Optional[torch.Tensor] = None

    def _room(self, rows: int) -> None:
        if self._host is None or self._host.shape[0] < rows:
            rows = max(rows, self.rows)
            self._host = torch.empty((rows, self.width), dtype=torch.int32, pin_memory=True)
            self._dev = torch.empty((rows, self.width), dtype=torch.int32, device=self.device)

    def drain(self, rings: torch.Tensor, starts: Sequence[int], ks: Sequence[int]) -> np.ndarray:
        """Ring l's newest ks[l] rows from starts[l], ring after ring."""
        K = sum(int(k) for k in ks)
        if self.device.type != "cuda":
            return ring_drain_lanes(rings, starts, ks).numpy().view(np.uint32).copy()
        self._room(K)
        rows = ring_drain_lanes(rings, starts, ks, self._dev)
        host = self._host[:K]
        host.copy_(rows, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return host.numpy().view(np.uint32).copy()

    def refill(self, rings: torch.Tensor, tails: Sequence[int], ks: Sequence[int], blocks: np.ndarray) -> None:
        """Write `blocks` (uint32 [sum k, W], ring after ring) at each
        ring's tail, in pieces of at most `rows` rows (all at once when
        `rows` is 0)."""
        rows = torch.from_numpy(np.ascontiguousarray(blocks, dtype=np.uint32).view(np.int32))
        on_card = self.device.type == "cuda"
        tails, left = [int(t) for t in tails], [int(k) for k in ks]
        cap = self.rows or rows.shape[0]
        pos = 0
        while pos < rows.shape[0]:
            # A piece takes the rings in order, so its rows are contiguous.
            take, n = [], 0
            for k in left:
                take.append(min(k, cap - n))
                n += take[-1]
            piece = rows[pos:pos + n]
            if on_card:
                self._room(n)
                # The previous transfer's copy out of the pinned buffer is
                # done: every drain and refill waits for its stream before
                # the host moves on.
                self._host[:n].copy_(piece)
                piece = self._dev[:n]
                piece.copy_(self._host[:n], non_blocking=True)
            ring_refill_lanes(rings, tails, take, piece)
            if on_card:
                torch.cuda.current_stream(self.device).synchronize()
            tails = [t + k for t, k in zip(tails, take)]
            left = [k - t for k, t in zip(left, take)]
            pos += n
