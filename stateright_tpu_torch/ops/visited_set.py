"""Device-resident visited set: a batched open-addressing hash table.

The port's counterpart of `stateright_tpu/ops/visited_set.py`. One slot
per state fingerprint (h1, h2), each with the parent fingerprint that
path reconstruction walks (reference bfs.rs:380-409). The layout is the
card's, not the TPU's:

  keys[cap]     int64 = (h1 << 32) | h2 as 64 bits; 0 = empty slot
  parents[cap]  int64 = (p1 << 32) | p2; 0 = no parent (initial state)
  stamps[cap]   int64, the insert kernel's winner-rule scratch

24 bytes a slot (2^28 slots = 6 GiB). A key is placed with one 64-bit
CAS, which the TPU could not do (its PALLAS NOTE); the probe sequence and
its limit are the JAX table's exactly — slot h1 & mask, stride h2 | 1, at
most MAX_PROBES positions — so a table built by either package answers
`lookup_parent_np` on the other (`table_from_lanes` / `table_to_lanes`
convert between the layouts; the checkpoint format is the four flat
uint32 lanes table0..3 = k1, k2, v1, v2).

Three functions here carry hand-written kernels (kernels/csrc): `insert`
(K4), `compact_ids` (K2) and `lookup_parent` (K6). Each runs its kernel
on a CUDA tensor and its plain torch version on a CPU tensor. `insert` updates the table in
place, where the JAX function returns a new one.

Each also has a lane form (`insert_lanes`, `compact_ids_lanes`,
`lookup_parent_lanes`): the JAX op under `jax.vmap`, as the multiplexed
engine runs it (engines/multiplex.py), with one table a lane stacked as
[lanes, capacity]. The solo functions are their one-lane case: one
kernel source serves both.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels

M32 = 0xFFFFFFFF

# Same values as the JAX package: every key sits within MAX_PROBES
# positions of its probe sequence, and growth keeps the load under
# MAX_LOAD so that this limit is never reached in practice.
MAX_PROBES = 24
MAX_LOAD = 0.25


@dataclass
class VisitedTable:
    keys: torch.Tensor
    parents: torch.Tensor
    stamps: torch.Tensor
    # Insert calls made on this table by the kernel (its stamp epoch).
    epoch: int = 0

    @property
    def capacity(self) -> int:
        """Slots of one lane's table."""
        return self.keys.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.keys.device


def empty_table(capacity: int, device, lanes=None) -> VisitedTable:
    """A table of `capacity` slots, or with `lanes` one such table a lane
    ([lanes, capacity] tensors, the multiplexed engine's)."""
    if capacity <= 0 or capacity & (capacity - 1):
        raise ValueError("visited-set capacity must be a power of two")
    shape = (capacity,) if lanes is None else (lanes, capacity)

    def z():
        return torch.zeros(shape, dtype=torch.int64, device=device)

    return VisitedTable(z(), z(), z())


def pack64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi << 32) | lo as an int64 bit pattern, for uint32 halves held in
    int64, computed without signed overflow."""
    hi_signed = hi - ((hi >> 31) << 32)
    return hi_signed * (1 << 32) + lo


def unpack64(x: torch.Tensor):
    return (x >> 32) & M32, x & M32


def occupied_mask(table: VisitedTable) -> torch.Tensor:
    return table.keys != 0


# ---------------------------------------------------------------------------
# K2: stable compaction of a mask into a fixed-width id buffer, per lane.
# ---------------------------------------------------------------------------

def compact_ids_lanes_plain(mask: torch.Tensor, cap: int):
    """The plain version of `compact_ids_lanes` (any [N, ...] mask, read
    row-major within each lane)."""
    mask = mask.reshape(mask.shape[0], -1)
    N, n = mask.shape
    dev = mask.device
    rank = torch.cumsum(mask.to(torch.int64), 1) - 1
    keep = mask & (rank < cap)
    # Unkept entries go to a trash slot past the end of their lane's row.
    row = (torch.arange(N, device=dev) * (cap + 1))[:, None]
    pos = row + torch.where(keep, rank, torch.full_like(rank, cap))
    ids = torch.zeros(N * (cap + 1), dtype=torch.int64, device=dev)
    ids.index_copy_(
        0, pos.reshape(-1),
        torch.arange(n, dtype=torch.int64, device=dev).repeat(N),
    )
    ids = ids.view(N, cap + 1)[:, :cap].contiguous()
    n_set = mask.sum(1, dtype=torch.int64)
    valid = torch.arange(cap, device=dev) < torch.clamp(n_set, max=cap)[:, None]
    return ids, valid, n_set


# K2's blocks (kernels/csrc/compact_ids.cu): a thread ranks 16 mask bytes,
# a block COMPACT_SUB elements at once, and a lane has at most
# COMPACT_MAX_TILES tiles, since every WRITE block sums its lane's counts.
COMPACT_SUB = 4096
COMPACT_MAX_TILES = 1024


def compact_plan(n: int, cap: int):
    """K2's launch plan for lanes of n mask elements into cap ids: (per,
    tiles, blocks). A tile is `per` sub-tiles of COMPACT_SUB elements, as
    few as keep `tiles` <= COMPACT_MAX_TILES (0 tiles when n is 0, none
    of them empty); COUNT runs a block a tile, WRITE `blocks` a lane (at
    least one, and enough that a block's stripe of [0, cap) is at most
    COMPACT_SUB long). The scratch holds one int32 a (lane, tile)."""
    sub = -(-n // COMPACT_SUB)
    per = max(1, -(-sub // COMPACT_MAX_TILES))
    tiles = -(-sub // per)
    return per, tiles, max(1, tiles, -(-cap // COMPACT_SUB))


def _compact_ids(mask: torch.Tensor, cap: int, kernel):
    """K2 over a [N, nseg, seg] bool view whose runs are contiguous."""
    if mask.dim() != 3 or mask.dtype != torch.bool:
        raise ValueError("compact_ids takes a bool mask")
    if not kernels.on_card(mask):
        return compact_ids_lanes_plain(mask, cap)
    N, nseg, seg = mask.shape
    if seg > 1 and mask.stride(2) != 1:
        mask = mask.contiguous()
    if N > 65535:
        raise ValueError("compact_ids takes at most 65535 lanes")
    n = nseg * seg
    dev = mask.device
    per, tiles, blocks = compact_plan(n, cap)
    ids = torch.empty((N, cap), dtype=torch.int64, device=dev)
    valid = torch.empty((N, cap), dtype=torch.bool, device=dev)
    n_set = torch.empty(N, dtype=torch.int64, device=dev)
    # COUNT writes every entry before WRITE reads it: no reset, so under a
    # graph capture this allocation is made once and replayed as it is.
    scratch = torch.empty(N * max(1, tiles), dtype=torch.int32, device=dev)
    # The view's first element, then the kernel's strides.
    kernel.launch(
        mask.data_ptr(), N, n, seg, mask.stride(1), mask.stride(0), cap, per, tiles, blocks,
        kernels.ptr(ids), kernels.ptr(valid), kernels.ptr(n_set), kernels.ptr(scratch),
    )
    return ids, valid, n_set


def compact_ids_lanes(mask: torch.Tensor, cap: int):
    """Per lane, the indices of the set bits of `mask`, in order, packed
    into [cap] (the vmapped `_compact_ids`).

    `mask` is a bool [N, n] tensor, or a [N, A, C] view (any strides,
    contiguous runs of C) read as each lane's A*C bits in row-major order:
    the multiplexed step passes its action-major validity mask [A, N, C]
    transposed, so lane l's bits come in the solo order a*C + c. Returns
    (ids [N, cap] int64, valid [N, cap] bool, n_set [N] int64), each
    lane's as `compact_ids` returns them.
    """
    if mask.dim() == 2:
        mask = mask[:, None, :]
    return _compact_ids(mask, cap, kernels.COMPACT_IDS_LANES)


def compact_ids_plain(mask: torch.Tensor, cap: int):
    ids, valid, n_set = compact_ids_lanes_plain(mask[None], cap)
    return ids[0], valid[0], n_set[0]


def compact_ids(mask: torch.Tensor, cap: int):
    """Indices of the set bits of `mask`, in order, packed into [cap].

    Returns (ids[cap] int64, valid[cap] bool, n_set 0-d int64). Entries
    past min(n_set, cap) are 0 and invalid; set bits ranked >= cap are
    counted in n_set but not stored. Deterministic: ring order depends on
    it. The one-lane case of `compact_ids_lanes`.
    """
    if mask.dim() != 1:
        raise ValueError("compact_ids takes a 1-D bool mask")
    ids, valid, n_set = _compact_ids(mask[None, None], cap, kernels.COMPACT_IDS)
    return ids[0], valid[0], n_set[0]


# ---------------------------------------------------------------------------
# K4: batched insert, per lane.
# ---------------------------------------------------------------------------

# K4's grid (kernels/csrc/visited_insert.cu) is (tile, lane): at most
# this many lanes a call.
INSERT_MAX_LANES = 65535


def _lane_bases(N: int, m: int, cap: int, device) -> torch.Tensor:
    """Slot offset of each of the N*m candidates' lane table."""
    return (torch.arange(N, dtype=torch.int64, device=device) * cap).repeat_interleave(m)


def insert_lanes_plain(table: VisitedTable, h1, h2, p1, p2, active):
    """Claim rounds, as the JAX table inserts, in each lane's table: every
    pending candidate reads its slot; a match means found, an empty slot
    is claimed by the HIGHEST candidate index among its contenders
    (`scatter_reduce` amax: a defined winner, unlike `index_put_` over
    duplicates; contenders share a lane), a foreign key advances the
    probe. Claim losers re-read the same slot next round."""
    N, m = h1.shape
    keys, parents = table.keys.view(-1), table.parents.view(-1)
    cap = table.capacity
    dev = keys.device
    mask = cap - 1
    n = N * m
    h1, h2, p1, p2 = (t.reshape(-1) for t in (h1, h2, p1, p2))
    key = pack64(h1, h2)
    par = pack64(p1, p2)
    stride = h2 | 1
    base = _lane_bases(N, m, cap, dev)
    pos = h1 & mask
    probe = torch.zeros(n, dtype=torch.int64, device=dev)
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    pending = active.reshape(-1).clone()
    is_new = torch.zeros(n, dtype=torch.bool, device=dev)
    unresolved = torch.zeros(n, dtype=torch.bool, device=dev)
    trash = keys.shape[0]
    while bool(pending.any()):
        slot = base + pos
        cur = keys.index_select(0, slot)
        pending &= cur != key  # found: already visited
        empty = pending & (cur == 0)
        claim = torch.full((trash + 1,), -1, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(
            0, torch.where(empty, slot, torch.full_like(slot, trash)), ids, reduce="amax"
        )
        won = empty & (claim.index_select(0, slot) == ids)
        keys[slot[won]] = key[won]  # winner slots are unique
        parents[slot[won]] = par[won]
        is_new |= won
        pending &= ~won
        foreign = pending & ~empty
        give_up = foreign & (probe >= MAX_PROBES - 1)
        unresolved |= give_up
        pending &= ~give_up
        advance = foreign & ~give_up
        pos = torch.where(advance, (pos + stride) & mask, pos)
        probe = probe + advance.to(torch.int64)
    return is_new.view(N, m), unresolved.view(N, m)


def _insert(table: VisitedTable, h1, h2, p1, p2, active, kernel, epoch=None):
    if not kernels.on_card(table.keys, h1, h2, p1, p2, active):
        return insert_lanes_plain(table, h1, h2, p1, p2, active)
    N, m = h1.shape
    n = N * m
    if active.dtype != torch.bool or m >= M32:
        raise ValueError("insert takes a bool active mask and m < 2^32 - 1 candidates a lane")
    if N > INSERT_MAX_LANES or table.capacity > 1 << 32:
        raise ValueError(f"insert takes at most {INSERT_MAX_LANES} lanes of at most 2^32 slots")
    if table.keys.numel() != N * table.capacity:
        raise ValueError("one table a lane: keys must be [lanes, capacity]")
    args = [t.contiguous() for t in (h1, h2, p1, p2, active)]
    dev = table.device
    # PROBE writes every candidate's state, and a finder's slot, before
    # STAMP or COMMIT reads them: no reset.
    slot = torch.empty((N, m), dtype=torch.int32, device=dev)
    state = torch.empty((N, m), dtype=torch.uint8, device=dev)
    is_new = torch.empty((N, m), dtype=torch.bool, device=dev)
    unresolved = torch.empty((N, m), dtype=torch.bool, device=dev)
    if epoch is None:
        table.epoch += 1
    kernel.launch(
        kernels.ptr(table.keys), kernels.ptr(table.parents),
        kernels.ptr(table.stamps), table.capacity, table.epoch,
        None if epoch is None else kernels.ptr(epoch),
        *(kernels.ptr(t) for t in args), n, m, kernels.ptr(slot), kernels.ptr(state),
        kernels.ptr(is_new), kernels.ptr(unresolved),
    )
    return is_new, unresolved


def insert_lanes(table: VisitedTable, h1, h2, p1, p2, active, epoch=None):
    """`insert` into each lane's table (the vmapped JAX insert): `table`
    holds [N, capacity] keys, parents and stamps, the candidates are
    [N, m], and candidate (l, i) probes only table l. Returns (is_new,
    unresolved), each [N, m]; the winner rule holds within each lane.
    `epoch` as for `insert`."""
    return _insert(table, h1, h2, p1, p2, active, kernels.VISITED_INSERT_LANES, epoch)


def insert_plain(table: VisitedTable, h1, h2, p1, p2, active):
    is_new, unresolved = insert_lanes_plain(
        table, h1[None], h2[None], p1[None], p2[None], active[None]
    )
    return is_new[0], unresolved[0]


def insert(table: VisitedTable, h1, h2, p1, p2, active, epoch=None):
    """Insert fingerprints (h1, h2) with parents (p1, p2) where `active`.

    All int64 [n] holding uint32 values; `active` bool [n]. Updates the
    table in place and returns (is_new, unresolved):
      is_new[i]     — candidate i placed a key that was not in the table.
                      Among candidates carrying one new key exactly one is
                      new: the highest index (the winner rule), whose
                      parent is the one stored.
      unresolved[i] — neither the key nor an empty slot within MAX_PROBES
                      positions; the key was placed nowhere. Callers must
                      grow the table and retry.
    `epoch` (an int64 [1] tensor on the card, optional) is the kernel's
    stamp epoch read on the card, for a call that a CUDA graph replays:
    the caller raises it after every call and keeps it above
    `table.epoch`. The one-lane case of `insert_lanes`.
    """
    is_new, unresolved = _insert(
        table, h1[None], h2[None], p1[None], p2[None], active[None],
        kernels.VISITED_INSERT, epoch,
    )
    return is_new[0], unresolved[0]


# ---------------------------------------------------------------------------
# K5: growth, and the carry-across to the JAX layout.
# ---------------------------------------------------------------------------

def rehash(old: VisitedTable, new: VisitedTable) -> int:
    """Insert every occupied row of `old` (with its parent) into `new`;
    returns the number of rows left unresolved (0 unless `new` is
    pathologically small)."""
    occ = occupied_mask(old)
    k1, k2 = unpack64(old.keys)
    v1, v2 = unpack64(old.parents)
    _is_new, unresolved = insert(new, k1, k2, v1, v2, occ)
    return int(unresolved.sum())


def table_from_lanes(k1, k2, v1, v2, device) -> VisitedTable:
    """Build the port's table from the four uint32 lanes of the JAX layout
    (`unpack_lanes_np` / checkpoint table0..3: key halves, parent halves),
    slot for slot: flat [tcap], or [n, tcap] for n shard or lane tables."""
    def pack_np(hi, lo):
        hi = np.asarray(hi, dtype=np.uint32).astype(np.uint64)
        lo = np.asarray(lo, dtype=np.uint32).astype(np.uint64)
        return torch.from_numpy(((hi << np.uint64(32)) | lo).view(np.int64))

    keys = pack_np(k1, k2).to(device)
    if keys.shape[-1] & (keys.shape[-1] - 1):
        raise ValueError("visited-set capacity must be a power of two")
    return VisitedTable(
        keys, pack_np(v1, v2).to(device), torch.zeros_like(keys)
    )


def table_to_lanes(table: VisitedTable):
    """The table as four flat numpy uint32 lanes (k1, k2, v1, v2)."""
    def split_np(x):
        u = x.cpu().numpy().view(np.uint64)
        return (
            (u >> np.uint64(32)).astype(np.uint32),
            (u & np.uint64(M32)).astype(np.uint32),
        )

    k1, k2 = split_np(table.keys)
    v1, v2 = split_np(table.parents)
    return k1, k2, v1, v2


# ---------------------------------------------------------------------------
# K6: batched parent lookup.
# ---------------------------------------------------------------------------

def lookup_parent_lanes_plain(table: VisitedTable, lane, h1, h2):
    mask = table.capacity - 1
    keys, parents = table.keys.view(-1), table.parents.view(-1)
    key = pack64(h1, h2)
    stride = h2 | 1
    base = lane * table.capacity if lane is not None else torch.zeros_like(h1)
    pos = h1 & mask
    n = h1.shape[0]
    pending = torch.ones(n, dtype=torch.bool, device=h1.device)
    found = torch.zeros(n, dtype=torch.bool, device=h1.device)
    par = torch.zeros(n, dtype=torch.int64, device=h1.device)
    for _ in range(MAX_PROBES):
        cur = keys.index_select(0, base + pos)
        hit = pending & (cur == key)
        par = torch.where(hit, parents.index_select(0, base + pos), par)
        found |= hit
        pending &= (cur != key) & (cur != 0)  # an empty slot ends the walk
        pos = torch.where(pending, (pos + stride) & mask, pos)
    p1, p2 = unpack64(par)
    return found, p1, p2


def _lookup_parent(table: VisitedTable, lane, h1, h2, kernel):
    tensors = (table.keys, h1, h2) + ((lane,) if lane is not None else ())
    if not kernels.on_card(*tensors):
        return lookup_parent_lanes_plain(table, lane, h1, h2)
    h1, h2 = h1.contiguous(), h2.contiguous()
    n = h1.shape[0]
    dev = table.device
    found = torch.empty(n, dtype=torch.bool, device=dev)
    p1 = torch.empty(n, dtype=torch.int64, device=dev)
    p2 = torch.empty(n, dtype=torch.int64, device=dev)
    kernel.launch(
        kernels.ptr(table.keys), kernels.ptr(table.parents), table.capacity,
        kernels.ptr(lane.contiguous()) if lane is not None else None,
        kernels.ptr(h1), kernels.ptr(h2), n, kernels.ptr(found),
        kernels.ptr(p1), kernels.ptr(p2),
    )
    return found, p1, p2


def lookup_parent_lanes(table: VisitedTable, lane, h1, h2):
    """`lookup_parent` in the lanes' stacked tables ([N, capacity]): query
    i probes table lane[i] (int64 [n])."""
    return _lookup_parent(table, lane, h1, h2, kernels.LOOKUP_PARENT_LANES)


def lookup_parent_plain(table: VisitedTable, h1, h2):
    return lookup_parent_lanes_plain(table, None, h1, h2)


def lookup_parent(table: VisitedTable, h1, h2):
    """Probe for fingerprints (int64 [n] holding uint32 halves); returns
    (found [n] bool, parent_h1, parent_h2), parents 0 where not found or
    for an initial state. Same probe sequence and limit as `insert`."""
    return _lookup_parent(table, None, h1, h2, kernels.LOOKUP_PARENT)


def lookup_parent_np(table_np, h1: int, h2: int):
    """Probe a host copy of the table lanes (k1, k2, v1, v2) for one
    fingerprint: (found, parent_h1, parent_h2). Same probe sequence and
    limit as `insert`."""
    k1, k2, v1, v2 = table_np
    cap = len(k1)
    mask = cap - 1
    stride = (h2 | 1) & M32
    idx = h1 & mask
    for _ in range(MAX_PROBES):
        if k1[idx] == h1 and k2[idx] == h2:
            return True, int(v1[idx]), int(v2[idx])
        if k1[idx] == 0 and k2[idx] == 0:
            return False, 0, 0
        idx = (idx + stride) & mask
    return False, 0, 0
