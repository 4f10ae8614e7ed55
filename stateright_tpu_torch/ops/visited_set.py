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
        return self.keys.shape[0]

    @property
    def device(self) -> torch.device:
        return self.keys.device


def empty_table(capacity: int, device) -> VisitedTable:
    if capacity <= 0 or capacity & (capacity - 1):
        raise ValueError("visited-set capacity must be a power of two")

    def z():
        return torch.zeros(capacity, dtype=torch.int64, device=device)

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
# K2: stable compaction of a mask into a fixed-width id buffer.
# ---------------------------------------------------------------------------

def compact_ids_plain(mask: torch.Tensor, cap: int):
    n = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    keep = mask & (rank < cap)
    # Unkept entries go to a trash slot past the end.
    pos = torch.where(keep, rank, torch.full_like(rank, cap))
    ids = torch.zeros(cap + 1, dtype=torch.int64, device=mask.device)
    ids.index_copy_(0, pos, torch.arange(n, dtype=torch.int64, device=mask.device))
    ids = ids[:cap].contiguous()
    n_set = mask.sum(dtype=torch.int64)
    valid = torch.arange(cap, device=mask.device) < torch.clamp(n_set, max=cap)
    return ids, valid, n_set


def compact_ids(mask: torch.Tensor, cap: int):
    """Indices of the set bits of `mask`, in order, packed into [cap].

    Returns (ids[cap] int64, valid[cap] bool, n_set 0-d int64). Entries
    past min(n_set, cap) are 0 and invalid; set bits ranked >= cap are
    counted in n_set but not stored. Deterministic: ring order depends on
    it.
    """
    if mask.dim() != 1 or mask.dtype != torch.bool:
        raise ValueError("compact_ids takes a 1-D bool mask")
    if not kernels.on_card(mask):
        return compact_ids_plain(mask, cap)
    mask = mask.contiguous()
    n = mask.shape[0]
    dev = mask.device
    ids = torch.empty(cap, dtype=torch.int64, device=dev)
    valid = torch.empty(cap, dtype=torch.bool, device=dev)
    n_set = torch.empty((), dtype=torch.int64, device=dev)
    scratch = torch.empty(max(1, -(-n // 4096)), dtype=torch.int64, device=dev)
    kernels.COMPACT_IDS.launch(
        kernels.ptr(mask), n, cap, kernels.ptr(ids), kernels.ptr(valid),
        kernels.ptr(n_set), kernels.ptr(scratch),
    )
    return ids, valid, n_set


# ---------------------------------------------------------------------------
# K4: batched insert.
# ---------------------------------------------------------------------------

def insert_plain(table: VisitedTable, h1, h2, p1, p2, active):
    """Claim rounds, as the JAX table inserts: every pending candidate
    reads its slot; a match means found, an empty slot is claimed by the
    HIGHEST candidate index among its contenders (`scatter_reduce` amax:
    a defined winner, unlike `index_put_` over duplicates), a foreign key
    advances the probe. Claim losers re-read the same slot next round."""
    keys, parents = table.keys, table.parents
    cap = table.capacity
    dev = keys.device
    mask = cap - 1
    n = h1.shape[0]
    key = pack64(h1, h2)
    par = pack64(p1, p2)
    stride = h2 | 1
    pos = h1 & mask
    probe = torch.zeros(n, dtype=torch.int64, device=dev)
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    pending = active.clone()
    is_new = torch.zeros(n, dtype=torch.bool, device=dev)
    unresolved = torch.zeros(n, dtype=torch.bool, device=dev)
    while bool(pending.any()):
        cur = keys.index_select(0, pos)
        pending &= cur != key  # found: already visited
        empty = pending & (cur == 0)
        claim = torch.full((cap + 1,), -1, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(
            0, torch.where(empty, pos, torch.full_like(pos, cap)), ids, reduce="amax"
        )
        won = empty & (claim.index_select(0, pos) == ids)
        keys[pos[won]] = key[won]  # winner slots are unique
        parents[pos[won]] = par[won]
        is_new |= won
        pending &= ~won
        foreign = pending & ~empty
        give_up = foreign & (probe >= MAX_PROBES - 1)
        unresolved |= give_up
        pending &= ~give_up
        advance = foreign & ~give_up
        pos = torch.where(advance, (pos + stride) & mask, pos)
        probe = probe + advance.to(torch.int64)
    return is_new, unresolved


def insert(table: VisitedTable, h1, h2, p1, p2, active):
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
    """
    n = h1.shape[0]
    if not kernels.on_card(table.keys, h1, h2, p1, p2, active):
        return insert_plain(table, h1, h2, p1, p2, active)
    if active.dtype != torch.bool or n >= M32:
        raise ValueError("insert takes a bool active mask and n < 2^32 - 1")
    args = [t.contiguous() for t in (h1, h2, p1, p2, active)]
    dev = table.device
    slot = torch.empty(n, dtype=torch.int64, device=dev)
    is_new = torch.empty(n, dtype=torch.bool, device=dev)
    unresolved = torch.empty(n, dtype=torch.bool, device=dev)
    table.epoch += 1
    kernels.VISITED_INSERT.launch(
        kernels.ptr(table.keys), kernels.ptr(table.parents),
        kernels.ptr(table.stamps), table.capacity, table.epoch,
        *(kernels.ptr(t) for t in args), n, kernels.ptr(slot),
        kernels.ptr(is_new), kernels.ptr(unresolved),
    )
    return is_new, unresolved


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
    """Build the port's table from the four flat uint32 lanes of the JAX
    layout (`unpack_lanes_np` / checkpoint table0..3), slot for slot."""
    def pack_np(hi, lo):
        hi = np.asarray(hi, dtype=np.uint32).astype(np.uint64)
        lo = np.asarray(lo, dtype=np.uint32).astype(np.uint64)
        return torch.from_numpy(((hi << np.uint64(32)) | lo).view(np.int64))

    keys = pack_np(k1, k2).to(device)
    if keys.shape[0] & (keys.shape[0] - 1):
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

def lookup_parent_plain(table: VisitedTable, h1, h2):
    mask = table.capacity - 1
    key = pack64(h1, h2)
    stride = h2 | 1
    pos = h1 & mask
    n = h1.shape[0]
    pending = torch.ones(n, dtype=torch.bool, device=h1.device)
    found = torch.zeros(n, dtype=torch.bool, device=h1.device)
    par = torch.zeros(n, dtype=torch.int64, device=h1.device)
    for _ in range(MAX_PROBES):
        cur = table.keys.index_select(0, pos)
        hit = pending & (cur == key)
        par = torch.where(hit, table.parents.index_select(0, pos), par)
        found |= hit
        pending &= (cur != key) & (cur != 0)  # an empty slot ends the walk
        pos = torch.where(pending, (pos + stride) & mask, pos)
    p1, p2 = unpack64(par)
    return found, p1, p2


def lookup_parent(table: VisitedTable, h1, h2):
    """Probe for fingerprints (int64 [n] holding uint32 halves); returns
    (found [n] bool, parent_h1, parent_h2), parents 0 where not found or
    for an initial state. Same probe sequence and limit as `insert`."""
    if not kernels.on_card(table.keys, h1, h2):
        return lookup_parent_plain(table, h1, h2)
    h1, h2 = h1.contiguous(), h2.contiguous()
    n = h1.shape[0]
    dev = table.device
    found = torch.empty(n, dtype=torch.bool, device=dev)
    p1 = torch.empty(n, dtype=torch.int64, device=dev)
    p2 = torch.empty(n, dtype=torch.int64, device=dev)
    kernels.LOOKUP_PARENT.launch(
        kernels.ptr(table.keys), kernels.ptr(table.parents), table.capacity,
        kernels.ptr(h1), kernels.ptr(h2), n, kernels.ptr(found),
        kernels.ptr(p1), kernels.ptr(p2),
    )
    return found, p1, p2


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
