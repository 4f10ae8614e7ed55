"""Tiered frontier spill: a host-RAM budget with an npz disk tier below.

A copy of `stateright_tpu/ops/tiering.py` (host code: the port imports
nothing of the JAX package), the same budget variable, disk format and
LIFO order, so a spilling run of the port stages exactly the blocks the
JAX engine does.

The device engines stage overflowing frontier rows on the host as a LIFO
stack of refill-sized uint32 blocks (``self._spill``). On billion-state
runs that stack itself outgrows host RAM, so this module bounds it: RAM
holds the newest blocks up to ``host_budget_bytes``; older blocks demote
to npz segment files on disk and promote back (newest segment first)
when the refill path drains the RAM tier. LIFO order is preserved across
tiers — the engines' spill/refill semantics (and therefore exploration
output) are bit-identical to the unbounded in-RAM stack.

Budget source: the ``STPU_SPILL_HOST_BUDGET_BYTES`` environment variable
(unset = unbounded, pure-RAM — the pre-tiering behavior). Tier moves are
reported through an ``on_tier`` callback so each engine can keep its
counters (``spill_tier_rows`` / ``spill_tier_refill_rows``) exact.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Callable, Iterable, Iterator, List, Optional

import numpy as np

__all__ = ["TieredSpillStore", "spill_host_budget_bytes"]


def spill_host_budget_bytes() -> Optional[int]:
    """Host-RAM budget for spill staging, from the environment.

    ``STPU_SPILL_HOST_BUDGET_BYTES`` unset/empty/non-positive means
    unbounded (no disk tier engaged) — mirrors the shape of
    ``obs.memory.device_memory_bytes``.
    """
    raw = os.environ.get("STPU_SPILL_HOST_BUDGET_BYTES", "").strip()
    if not raw:
        return None
    try:
        val = int(raw)
    except ValueError:
        return None
    return val if val > 0 else None


class TieredSpillStore:
    """LIFO stack of spill blocks: budgeted RAM on top, disk below.

    Stack order (oldest -> newest) is ``segments[0] .. segments[-1]``
    then ``ram[0] .. ram[-1]``: demotion moves the OLDEST RAM blocks into
    a new segment file (appended after every existing segment), so the
    relative order of all live blocks never changes. ``pop()`` always
    returns the newest block; an empty RAM tier promotes the newest
    segment wholesale first (one file read amortized over its blocks).

    The store is engine-thread-only (like the list it replaces); the
    ``on_tier(direction, rows, nbytes, disk_bytes)`` callback fires on
    every tier move with direction ``"ram_to_disk"`` or ``"disk_to_ram"``.
    """

    def __init__(
        self,
        *,
        host_budget_bytes: Optional[int] = None,
        spool_dir: Optional[str] = None,
        on_tier: Optional[Callable[[str, int, int, int], None]] = None,
        label: str = "spill",
    ):
        self._budget = (
            int(host_budget_bytes) if host_budget_bytes else None
        )
        self._ram: List[np.ndarray] = []
        # Each segment: {"path": str, "rows": [per-block row counts,
        # oldest first], "nbytes": total payload bytes}.
        self._segments: List[dict] = []
        self._spool = spool_dir
        self._own_spool = spool_dir is None
        self._label = str(label)
        self._on_tier = on_tier
        self._seq = 0

    # -- sizing accessors ---------------------------------------------------

    def __bool__(self) -> bool:
        return bool(self._ram) or bool(self._segments)

    def __len__(self) -> int:
        """Number of live blocks across both tiers."""
        return len(self._ram) + sum(len(s["rows"]) for s in self._segments)

    def rows(self) -> int:
        return sum(len(b) for b in self._ram) + sum(
            sum(s["rows"]) for s in self._segments
        )

    def host_bytes(self) -> int:
        return sum(b.nbytes for b in self._ram)

    def disk_bytes(self) -> int:
        return sum(s["nbytes"] for s in self._segments)

    def total_nbytes(self) -> int:
        return self.host_bytes() + self.disk_bytes()

    def segments(self) -> int:
        return len(self._segments)

    def peek_rows(self) -> int:
        """Row count of the newest block (the next ``pop()``) without
        promoting it — the refill loop's fit check must stay free."""
        if self._ram:
            return len(self._ram[-1])
        if self._segments:
            return int(self._segments[-1]["rows"][-1])
        raise IndexError("peek on empty spill store")

    # -- the stack API the engines drive ------------------------------------

    def append(self, block: np.ndarray) -> None:
        self._ram.append(block)
        self._maybe_demote()

    def pop(self) -> np.ndarray:
        if not self._ram:
            self._promote_newest_segment()
        return self._ram.pop()

    def iter_blocks(self) -> Iterator[np.ndarray]:
        """Every live block, oldest first (the engines' checkpoint
        serialization order). Disk segments are read transiently; the
        store itself is unchanged."""
        for seg in self._segments:
            for blk in self._load_segment(seg):
                yield blk
        for blk in self._ram:
            yield blk

    def reset(self, blocks: Iterable[np.ndarray]) -> None:
        """Replace the whole stack (checkpoint resume), re-applying the
        budget to the restored blocks oldest-first."""
        self.clear()
        for blk in blocks:
            self.append(blk)

    def clear(self) -> None:
        self._ram = []
        for seg in self._segments:
            try:
                os.unlink(seg["path"])
            except OSError:
                pass
        self._segments = []

    def close(self) -> None:
        self.clear()
        if self._own_spool and self._spool is not None:
            shutil.rmtree(self._spool, ignore_errors=True)
            self._spool = None
            self._own_spool = True

    def __del__(self):  # best-effort spool cleanup on abandoned runs
        try:
            self.close()
        except Exception:
            pass

    # -- tier moves ----------------------------------------------------------

    def _spool_dir(self) -> str:
        if self._spool is None:
            self._spool = tempfile.mkdtemp(prefix=f"stpu-{self._label}-")
        return self._spool

    def _maybe_demote(self) -> None:
        """Demote the oldest RAM blocks into ONE new segment until the
        RAM tier fits the budget; the newest block always stays in RAM
        (it is the next pop/peek)."""
        if self._budget is None or len(self._ram) <= 1:
            return
        if self.host_bytes() <= self._budget:
            return
        demote: List[np.ndarray] = []
        freed = 0
        over = self.host_bytes() - self._budget
        while len(self._ram) > 1 and freed < over:
            blk = self._ram.pop(0)
            demote.append(blk)
            freed += blk.nbytes
        if not demote:
            return
        self._seq += 1
        path = os.path.join(
            self._spool_dir(), f"seg{self._seq:06d}.npz"
        )
        with open(path, "wb") as f:
            np.savez(f, **{f"b{i}": blk for i, blk in enumerate(demote)})
        seg = {
            "path": path,
            "rows": [len(b) for b in demote],
            "nbytes": sum(b.nbytes for b in demote),
        }
        self._segments.append(seg)
        if self._on_tier is not None:
            self._on_tier(
                "ram_to_disk", sum(seg["rows"]), seg["nbytes"],
                self.disk_bytes(),
            )

    @staticmethod
    def _load_segment(seg: dict) -> List[np.ndarray]:
        with np.load(seg["path"]) as data:
            return [data[f"b{i}"] for i in range(len(seg["rows"]))]

    def _promote_newest_segment(self) -> None:
        if not self._segments:
            raise IndexError("pop on empty spill store")
        seg = self._segments.pop()
        blocks = self._load_segment(seg)
        try:
            os.unlink(seg["path"])
        except OSError:
            pass
        # RAM is empty here (pop only promotes then) — the segment's
        # blocks ARE the new RAM tier, order preserved. Transiently
        # exceeding the budget is fine: the refill loop is about to
        # consume these newest blocks, and the next append re-demotes
        # any leftovers.
        self._ram = blocks + self._ram
        if self._on_tier is not None:
            self._on_tier(
                "disk_to_ram", sum(seg["rows"]), seg["nbytes"],
                self.disk_bytes(),
            )
