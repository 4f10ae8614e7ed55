"""The agreement table of the speclint probes (K16a): a model's lane
program run on the card against the same program run under numpy, with a
hand-written kernel (kernels/csrc/lane_agree.cu) and its plain torch
version.

The port's counterpart of the comparisons in
`stateright_tpu/analysis/device.py:360-393` (STR205: per action the
validity masks, then each successor lane on the rows valid on both sides)
and `analysis/symmetry.py:221-237` (STR404: `representative_lanes`, one
action whose rows are all valid). The JAX package reads every lane back
and compares on the host; here the card's lanes reduce to one table of
A + 2A + A x S words, read back once, which `read_table` walks in the
reference's order.

Port lanes are int64 holding uint32 values (xp.py); only their low 32
bits are compared with numpy's uint32 lanes, so a lane that carries high
bits (``~lane``) agrees, and one whose low bits differ from numpy's
wraparound does not: `(0 - 1) >> 1` is 0x7FFFFFFF under numpy and
0xFFFFFFFF on int64 lanes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import kernels

M32 = 0xFFFFFFFF
NONE = -1  # a first-row word with no row (0xFFFFFFFF as uint32)
MAX_PAIRS = 65535  # (action, lane) pairs: the kernel's grid.y


def table_words(A: int, S: int) -> int:
    return 3 * A + A * S


def agree_plain(dev, dmask, host, hmask) -> torch.Tensor:
    """The table as int32 words (uint32 bits): valid rows on the card and
    under numpy per action, the first row whose masks differ per action,
    and the first row valid on both sides whose lane differs per (action,
    lane); -1 where there is none."""
    A, S, B = dev.shape
    rows = torch.arange(B, device=dev.device)

    def first(bad):
        if not B:
            return torch.full(bad.shape[:-1], B, dtype=torch.int64, device=bad.device)
        return torch.where(bad, rows, B).amin(-1)

    both = dmask & hmask
    # uint32 -> int64 through int32 bits: torch converts few ops of uint32.
    wide = host.view(torch.int32).to(torch.int64) & M32
    lane_bad = both[:, None, :] & ((dev & M32) != wide)
    firsts = torch.cat([first(dmask != hmask), first(lane_bad).reshape(-1)])
    firsts = torch.where(firsts >= B, NONE, firsts)
    counts = torch.cat([dmask.sum(1), hmask.sum(1)])
    return torch.cat([counts, firsts]).to(torch.int32)


def agree(dev: torch.Tensor, dmask: torch.Tensor, host: torch.Tensor,
          hmask: torch.Tensor) -> torch.Tensor:
    """The agreement table (K16a) of the card's lanes `dev` int64 [A, S, B]
    and masks `dmask` bool [A, B] against numpy's lanes `host` uint32
    [A, S, B] and masks `hmask` bool [A, B]: int32 words [3A + A * S] (see
    `agree_plain`). One launch on the card; on CPU tensors the plain
    version runs."""
    A, S, B = dev.shape
    if host.shape != dev.shape or dmask.shape != (A, B) or hmask.shape != (A, B):
        raise ValueError(
            f"agree takes lanes [A, S, B] and masks [A, B] on both sides; got "
            f"{tuple(dev.shape)}, {tuple(dmask.shape)}, {tuple(host.shape)}, {tuple(hmask.shape)}"
        )
    if not kernels.on_card(dev, dmask, host, hmask):
        return agree_plain(dev, dmask, host, hmask)
    if dev.dtype != torch.int64 or host.dtype != torch.uint32 or dmask.dtype != torch.bool \
            or hmask.dtype != torch.bool:
        raise ValueError("agree takes int64 card lanes, uint32 numpy lanes and bool masks")
    if A * S > MAX_PAIRS or B >= M32:
        raise ValueError(f"the agreement kernel takes at most {MAX_PAIRS} (action, lane) pairs")
    dev, dmask, host, hmask = (t.contiguous() for t in (dev, dmask, host, hmask))
    out = torch.empty(table_words(A, S), dtype=torch.int32, device=dev.device)
    kernels.LANE_AGREE.launch(
        kernels.ptr(dev), kernels.ptr(dmask), kernels.ptr(host), kernels.ptr(hmask), A, S, B,
        kernels.ptr(out),
    )
    return out


class Disagreement(NamedTuple):
    """The first finding in the reference's order: `lane` is None for a
    mask; `row` is the batch row; the counts are the valid rows per side."""

    action: int
    lane: Optional[int]
    row: int
    card_valid: int
    host_valid: int


def read_table(table, A: int, S: int, B: int) -> Optional[Disagreement]:
    """Walk a table read back from `agree` as the JAX loop walks the arrays
    (device.py:360-393): for each action the mask first, then its lanes in
    order; the first finding ends the walk. None when everything agrees."""
    w = np.asarray(table).astype(np.int64) & M32
    d_valid, h_valid = w[:A], w[A:2 * A]
    firsts = np.minimum(w[2 * A:], B)
    for a in range(A):
        if firsts[a] < B:
            return Disagreement(a, None, int(firsts[a]), int(d_valid[a]), int(h_valid[a]))
        for s in range(S):
            row = firsts[A + a * S + s]
            if row < B:
                return Disagreement(a, s, int(row), int(d_valid[a]), int(h_valid[a]))
    return None
