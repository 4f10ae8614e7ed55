"""The stage profiler's kernels (K12a, K12b) and their plain versions.

A stage program (engines/stages.py) repeats one stage of the BFS step or
of the simulation step `iters` times, each round chained to the last
through a uint32 accumulator, as the JAX stage microbenchmarks do
(`stateright_tpu/engines/tpu_bfs.py:1138`, `tpu_simulation.py:569`). The
loop's state is one int64 vector `st` on the program's device:

    st[ST_ACC]    the accumulator (a uint32 value)
    st[ST_COUNT]  rounds run: the round index `i` of the next round
    st[ST_OPEN]   another round runs
    st[3], st[4]  the loop kernel's scratch (0 between launches)

K12a (kernels/csrc/stage_loop.cu):
- `start`, `fold` and `add` are its loop kernel: `fold` ends a round,
  adding the round's anchor terms to the accumulator (mod 2^32), counting
  the round and setting the loop's condition (on the card, a CUDA graph's
  conditional WHILE node);
- `mix_lanes`, `xor_lanes`, `mask_lanes` and `ring_lanes` are its second
  entry point: the lowbias32 synthetic operands of the JAX kernels
  (`_lane`, `_mix`), written into buffers the program allocated, so that
  a captured round holds no host constant.

K12b (kernels/csrc/stage_walk.cu): `cycle`, `record` and `choose`, three
simulation stages the port's era otherwise runs inside K13a and K13b.

Each wrapper launches its kernel on CUDA tensors and runs its plain
torch version on CPU tensors (lanes: int64 holding uint32 values, with
every 32-bit product through `mul32`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from .. import kernels
from ..fingerprint import mul32
from .visited_set import pack64

M32 = 0xFFFFFFFF
ST_ACC, ST_COUNT, ST_OPEN = 0, 1, 2
ST_LEN = 5
START, FOLD, ADD = 0, 1, 2
MIX, XOR, MASK, RING = 0, 1, 2, 3
CYCLE, RECORD, CHOOSE = 0, 1, 2
LANE_MUL = 0x9E3779B1  # `_lane`'s index multiplier
RING_MUL = 2654435761  # the ring stage's row multiplier
CHOOSE_MUL = 0x9E3779B9
# The kernel's LaneArgs, in order (stage_loop.cu).
LANE_FIELDS = ("rows", "n", "salt", "step", "mask", "mod", "xor_rows", "acc_mask", "out_n",
               "head_add", "head_mask")
MAX_TERMS = 8


def new_state(device) -> torch.Tensor:
    return torch.zeros(ST_LEN, dtype=torch.int64, device=device)


def mix(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 over uint32 values held in int64 (`_mix`)."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _rows(t: torch.Tensor):
    return (1, t.shape[0]) if t.dim() == 1 else (t.shape[0], t.shape[1])


def _launch_lanes(mode: int, out, src, st, head, **kw) -> None:
    args = (ctypes.c_longlong * len(LANE_FIELDS))(*(int(kw.get(f, 0)) for f in LANE_FIELDS))
    opt = [None if t is None else kernels.ptr(t) for t in (src, st, head)]
    kernels.STAGE_LANES.launch(mode, kernels.ptr(out), *opt, ctypes.addressof(args))


# -- K12a, the synthetic lanes ---------------------------------------------

def mix_lanes_plain(out, salt: int, step: int = 1, mask: int = M32, mod: int = 0, src=None):
    rows, n = _rows(out)
    r = torch.arange(rows, dtype=torch.int64, device=out.device)[:, None]
    salt_r = (salt + r * step) & M32
    if src is None:
        i = torch.arange(n, dtype=torch.int64, device=out.device)[None, :]
        v = (mul32(i, LANE_MUL) + salt_r) & M32
    else:
        v = src.reshape(rows, n) ^ salt_r
    x = mix(v) & mask
    if mod:
        x = x % mod
    out.copy_(x.reshape(out.shape))


def mix_lanes(out: torch.Tensor, salt: int, step: int = 1, mask: int = M32, mod: int = 0,
              src: Optional[torch.Tensor] = None) -> None:
    """out [rows, n] (or [n]) = (mix(v) & mask) % mod (no modulus at 0),
    v = i * 0x9E3779B1 + salt + r * step for element i of row r — the JAX
    `_lane(n, salt)` — or, with `src`, src[r, i] ^ (salt + r * step)."""
    tensors = [out] + ([src] if src is not None else [])
    if not kernels.on_card(*tensors):
        return mix_lanes_plain(out, salt, step, mask, mod, src)
    rows, n = _rows(out)
    _launch_lanes(MIX, out, src, None, None, rows=rows, n=n, salt=salt, step=step, mask=mask,
                  mod=mod)


def xor_lanes_plain(out, src, st, xor_rows: int = 1, acc_mask: int = 1, mask: int = M32):
    rows, n = _rows(out)
    x = int(st[ST_ACC]) & acc_mask
    flip = torch.zeros((rows, 1), dtype=torch.int64, device=out.device)
    flip[:xor_rows] = x
    out.copy_(((src.reshape(rows, n) ^ flip) & mask).reshape(out.shape))


def xor_lanes(out: torch.Tensor, src: torch.Tensor, st: torch.Tensor, xor_rows: int = 1,
              acc_mask: int = 1, mask: int = M32) -> None:
    """out = (src ^ (acc & acc_mask)) & mask on the first `xor_rows` rows
    and src & mask on the rest (a round's perturbed lanes: `rows0[0] ^
    (acc & 1)`); acc is read from `st` on its device."""
    if not kernels.on_card(out, src, st):
        return xor_lanes_plain(out, src, st, xor_rows, acc_mask, mask)
    rows, n = _rows(out)
    _launch_lanes(XOR, out, src.contiguous(), st, None, rows=rows, n=n, mask=mask,
                  xor_rows=xor_rows, acc_mask=acc_mask)


def mask_lanes_plain(out, src, st, mask: int):
    acc = int(st[ST_ACC]) if st is not None else 0
    out.copy_(((src ^ acc) & mask) == 0)


def mask_lanes(out: torch.Tensor, src: torch.Tensor, st: Optional[torch.Tensor], mask: int) -> None:
    """out (bool) = ((src ^ acc) & mask) == 0, acc from `st` (0 without)."""
    tensors = [out, src] + ([st] if st is not None else [])
    if not kernels.on_card(*tensors):
        return mask_lanes_plain(out, src, st, mask)
    if out.dtype != torch.bool:
        raise ValueError("mask_lanes writes a bool mask")
    rows, n = _rows(out)
    _launch_lanes(MASK, out, src.contiguous(), st, None, rows=rows, n=n, mask=mask)


def ring_lanes_plain(out, popped, head, qmask: int):
    W, m = out.shape
    sums = popped.sum(1) & M32
    j = torch.arange(m, dtype=torch.int64, device=out.device)[None, :]
    w = torch.arange(W, dtype=torch.int64, device=out.device)[:, None]
    out.copy_(mix((mul32(j, RING_MUL) + sums[:, None] + 17 * w) & M32))
    head.copy_((head + popped.shape[1]) & qmask)


def ring_lanes(out: torch.Tensor, popped: torch.Tensor, head: torch.Tensor, qmask: int) -> None:
    """The ring stage's appended rows: out [W, m] with out[w, j] =
    mix(j * 2654435761 + sum(popped[w]) + 17 w) from the popped rows
    [W, C]; then head (int64 [1]) advances by C, masked to the ring."""
    if not kernels.on_card(out, popped, head):
        return ring_lanes_plain(out, popped, head, qmask)
    W, m = out.shape
    _launch_lanes(RING, out, popped.contiguous(), None, head, rows=W, n=popped.shape[1],
                  out_n=m, head_add=popped.shape[1], head_mask=qmask)


# -- K12a, the loop kernel ---------------------------------------------------

def term(t: torch.Tensor, shift: int = 0, mask: int = M32):
    """One anchor term: every element of the 1-D view `t` (a 0-d tensor is
    one element; `x[:1]` is a first element, `x.view(-1)` a full-width
    sum, `x[:, 0]` a strided column), each contributing
    (element >> shift) & mask."""
    if t.dim() == 0:
        t = t.view(1)
    if t.dim() != 1:
        raise ValueError("an anchor term is a 1-D view")
    return t, shift, mask


def start_plain(st, iters: int) -> None:
    st[ST_COUNT] = 0
    st[ST_OPEN] = int(iters > 0)
    st[3:] = 0


def fold_plain(mode: int, st, terms: Sequence, iters: int, add: int = 0, epoch=None) -> None:
    total = add
    for t, shift, mask in terms:
        total += int(((t.to(torch.int64) >> shift) & mask).sum())
    st[ST_ACC] = (int(st[ST_ACC]) + total) & M32
    if mode == FOLD:
        st[ST_COUNT] += 1
        if epoch is not None:
            epoch += 1
        st[ST_OPEN] = int(int(st[ST_COUNT]) < iters)


def _launch_loop(mode: int, st, terms, iters: int, add: int, epoch, handle: int) -> None:
    if len(terms) > MAX_TERMS:
        raise ValueError(f"at most {MAX_TERMS} anchor terms")
    rec = []
    for t, shift, mask in terms:
        if t.dtype not in (torch.int64, torch.bool):
            raise ValueError("anchor terms are int64 lanes or bool masks")
        rec += [t.data_ptr(), t.numel(), t.stride(0), shift, mask, int(t.dtype == torch.bool)]
    arr = (ctypes.c_longlong * max(1, len(rec)))(*rec)
    kernels.STAGE_LOOP.launch(
        mode, kernels.ptr(st), iters, add, None if epoch is None else kernels.ptr(epoch),
        len(terms), ctypes.addressof(arr), int(handle),
    )


def start(st: torch.Tensor, iters: int, handle: int = 0) -> None:
    """Open the loop: count 0, open while iters > 0 (the condition of
    `handle`, a CUDA graph's conditional handle, or 0)."""
    if not kernels.on_card(st):
        return start_plain(st, iters)
    _launch_loop(START, st, [], iters, 0, None, handle)


def fold(st: torch.Tensor, terms: Sequence, iters: int, add: int = 0,
         epoch: Optional[torch.Tensor] = None, handle: int = 0) -> None:
    """End a round: acc = (acc + add + the terms' sum) mod 2^32, count + 1,
    `epoch` (the round's visited-insert epoch, int64 [1]) + 1, and open
    (and the condition of `handle`) while count < iters."""
    if not kernels.on_card(st, *(t for t, _s, _m in terms)):
        return fold_plain(FOLD, st, terms, iters, add, epoch)
    _launch_loop(FOLD, st, terms, iters, add, epoch, handle)


def add(st: torch.Tensor, terms: Sequence) -> None:
    """acc += the terms' sum (mod 2^32), outside the loop."""
    if not kernels.on_card(st, *(t for t, _s, _m in terms)):
        return fold_plain(ADD, st, terms, 0)
    _launch_loop(ADD, st, terms, 0, 0, None, 0)


# -- K12b, the walk stages ----------------------------------------------------

def cycle_plain(st, path, h0, g0, ptr, out):
    B, L = path.shape
    key = pack64(h0 ^ (int(st[ST_ACC]) & 1), g0)
    below = torch.arange(L, device=path.device)[None, :] < ptr[:, None]
    out.copy_(((path == key[:, None]) & below).any(1))


def cycle(st, path, h0, g0, ptr, out) -> None:
    """out[w] (bool): the packed (h0[w] ^ (acc & 1), g0[w]) is in
    path[w, 0:ptr[w]] (the JAX stage's own-path compare)."""
    if not kernels.on_card(st, path, h0, g0, ptr, out):
        return cycle_plain(st, path, h0, g0, ptr, out)
    B, L = path.shape
    kernels.STAGE_WALK.launch(CYCLE, kernels.ptr(st), B, L, 0, 0, kernels.ptr(path),
                              kernels.ptr(h0), kernels.ptr(g0), kernels.ptr(ptr), None, None,
                              kernels.ptr(out))


def record_plain(st, path, h0, restart):
    B, L = path.shape
    acc = int(st[ST_ACC])
    col = ((acc + int(st[ST_COUNT])) & M32) % L
    h1 = h0 ^ (acc & 1)
    path[:, col] = pack64(h1, h1)
    path[restart] = 0


def record(st, path, h0, restart) -> None:
    """Write h0 ^ (acc & 1) into both halves of path[w, (acc + i) % L] (i =
    the round), then zero the rows of the walks in `restart` (bool [B])."""
    if not kernels.on_card(st, path, h0, restart):
        return record_plain(st, path, h0, restart)
    B, L = path.shape
    kernels.STAGE_WALK.launch(RECORD, kernels.ptr(st), B, L, 0, 0, kernels.ptr(path),
                              kernels.ptr(h0), kernels.ptr(restart), None, None, None, None)


def choose_plain(st, rows, succs, valid, ptr, l227, out):
    S, B = rows.shape
    A = valid.shape[0]
    sd = l227 ^ int(st[ST_ACC])
    ne = valid.sum(0)
    r = mix(sd ^ mul32(ptr, CHOOSE_MUL))
    pick = torch.where(ne > 0, r % ne.clamp(min=1), 0)
    vi = valid.to(torch.int64)
    sel = valid & ((vi.cumsum(0) - vi) == pick)
    new = rows.clone()
    for a in range(A):
        new = torch.where(sel[a], succs[a * S:(a + 1) * S], new)
    out.copy_(new)


def choose(st, rows, succs, valid, ptr, l227, out) -> None:
    """The counter-PRNG choice: per walk, the pick-th valid action's
    successor row (succs [A * S, B]), else its row of `rows` [S, B]."""
    if not kernels.on_card(st, rows, succs, valid, ptr, l227, out):
        return choose_plain(st, rows, succs, valid, ptr, l227, out)
    S, B = rows.shape
    A = valid.shape[0]
    if valid.dtype != torch.bool or succs.shape != (A * S, B):
        raise ValueError("choose: valid is bool [A, B], succs int64 [A * S, B]")
    kernels.STAGE_WALK.launch(CHOOSE, kernels.ptr(st), B, 1, S, A, None, kernels.ptr(rows),
                              kernels.ptr(succs), kernels.ptr(valid), kernels.ptr(ptr),
                              kernels.ptr(l227), kernels.ptr(out))
