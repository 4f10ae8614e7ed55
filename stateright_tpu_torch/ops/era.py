"""The BFS era's bookkeeping on the card (K8f): the state-vector layout,
the step kernel (gate, the step's fold and commit) and the epilogue
kernel, each with its plain torch version.

The port's counterpart of the scalar parts of
`stateright_tpu/engines/tpu_bfs.py:361 _build_loop.loop`: the packed
params layout (:106-126, :188 `params_len`, :947-1006), the `cond` gate
(:403-426), the step's coverage counts and first-hit lanes and the
commit at the end of `body` (:585-685), `run_era`'s
epilogue (:781-853) and the fused outer loop's continuation (:896-922).
The era program (engines/era.py) keeps one int64 state vector on the
card: the JAX params, word for word (uint32 values), then the port's
own words (X_*). `era_step` and `era_epilogue` run their kernels
(kernels/csrc/era_step.cu, era_epilogue.cu) on CUDA tensors and their
plain versions on CPU tensors.

Both take a lane axis (K14f, the multiplexed lanes' era: the JAX era
under `jax.vmap`, engines/multiplex.py): a state [N, params_len + X_LEN],
one row a lane, with per-lane step operands. Each lane's row follows the
solo rules alone; a lane whose gate closed keeps every word. The era's
loop runs while any lane's gate is open. A one-dimensional state is the
solo era, the one-lane case.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .. import kernels
from ..obs.coverage import DEPTH_CAP
from ..obs.sample import slab_entries

M32 = 0xFFFFFFFF

# The packed params (tpu_bfs.py:106-126).
P_HEAD = 0
P_COUNT = 1
P_UNIQUE = 2
P_REC = 3
P_DEPTH_LIMIT = 4
P_GROW_LIMIT = 5
P_HIGH_WATER = 6
P_MAX_STEPS = 7  # in: this era's step budget; out: the next era's
P_GEN = 8
P_MAXD = 9
P_STEPS = 10
P_ERR = 11
P_TAKE_CAP = 12
P_FIN_ANY = 13
P_FIN_ALL = 14
P_FIN_ALL_EN = 15
P_BUDGET_CAP = 16  # 0 = the next budget passes through
P_LEN = 17

# The adaptive budget's floor and slow-start seed (tpu_bfs.py:140).
BUDGET_MIN = 64

# The port's words after the params (kernels/csrc/era.cuh): this step's
# take, the gate, this step's ring tail, the era's input discovery bits
# and unique count, its clean steps and generated states, the dispatch's
# step-body runs, partial steps and inner eras, and whether the fused
# loop runs another era.
X_TAKE = 0
X_OPEN = 1
X_TAIL = 2
X_REC0 = 3
X_UNIQ_IN = 4
X_ESTEPS = 5
X_EGEN = 6
X_ITER = 7
X_PARTIAL = 8
X_K = 9
X_MORE = 10
X_LEN = 12

# Step kernel modes (era_step.cu).
START = 0
BEGIN = 1
COMMIT = 2


def cov_len(A: int, P: int) -> int:
    """Words of the coverage tail: act[A] | hits[P] | expanded | depths."""
    return A + P + 1 + DEPTH_CAP


def fuse_tail_len(fuse: int) -> int:
    """Words of the fusion tail (tpu_bfs.py:172): [fuse_lim, n_inner] +
    steps | generated | unique | frontier, one word an inner era; none
    at fuse 1."""
    return 2 + 4 * fuse if fuse > 1 else 0


def params_len(A: int, P: int, cov: bool, sample_k: int, fuse: int = 1) -> int:
    """Length of the packed params (tpu_bfs.py:188)."""
    n = P_LEN + 2 * P
    if cov:
        n += cov_len(A, P)
    if sample_k:
        n += 4 + 5 * slab_entries(sample_k)
    return n + fuse_tail_len(fuse)


# The config vector the kernels read (era.cuh Cfg), in this order.
CFG_FIELDS = (
    "chunk", "qmask", "vcap", "rcap", "P", "A", "cov_base", "s_base",
    "s_high", "s_take", "f_base", "fuse", "x", "regrow", "budget_min",
    "n_cov", "scap",
)


class EraConfig:
    """One era program's layout and widths: attributes named as
    CFG_FIELDS (an absent tail's offset is -1), and the same values as a
    host int64 array the kernels take by pointer."""

    def __init__(self, **values):
        for name in CFG_FIELDS:
            setattr(self, name, int(values[name]))
        self._array = (ctypes.c_longlong * len(CFG_FIELDS))(
            *(getattr(self, n) for n in CFG_FIELDS)
        )

    @property
    def ptr(self) -> int:
        return ctypes.addressof(self._array)


class FirstHits(NamedTuple):
    """The era's first-hit lanes, each [P, N * chunk] (lane l's positions
    at columns l * chunk ..): hseen (bool) and, at each property's first
    hit of the era at each chunk position, the row's hash halves and depth
    (int64). COMMIT sets them, the epilogue reads and zeroes them."""

    hseen: torch.Tensor
    facc1: torch.Tensor
    facc2: torch.Tensor
    faccd: torch.Tensor

    @staticmethod
    def zeros(P: int, width: int, device) -> "FirstHits":
        hseen = torch.zeros((P, width), dtype=torch.bool, device=device)
        return FirstHits(hseen, *(torch.zeros((P, width), dtype=torch.int64, device=device)
                                  for _ in range(3)))


class StepOperands(NamedTuple):
    """What one step hands its COMMIT, which folds it (N lanes of chunk
    C; the solo step is N = 1 with 0-d counts): the valid and distinct
    candidate counts n_val, n_d [N]; the insert's unresolved and new masks
    [N, m]; the generated count [N], or None to count the valid mask (the
    lanes); the P property hit masks, each [N * C]; the valid mask [A * N
    * C] (action-major over the lanes; None without coverage when
    `generated` is given); each distinct candidate's depth [N * m] (the
    depth histogram; None without coverage); the popped rows' (h1, h2,
    depth), each [N * C], and the era's first-hit lanes (None without
    properties)."""

    n_val: torch.Tensor
    n_d: torch.Tensor
    unresolved: torch.Tensor
    c_new: torch.Tensor
    generated: Optional[torch.Tensor]
    hits: Optional[Sequence[torch.Tensor]]
    valid: Optional[torch.Tensor]
    ddepth: Optional[torch.Tensor]
    rows: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    first: Optional[FirstHits]


def step_scratch(lanes: int, P: int, A: int, device) -> torch.Tensor:
    """The step kernel's scratch (era_step.cu): a lane's accumulators
    (unresolved, new, the valid count, its ticket, hs[P], pa[A]) and the
    last ticket, zero; every launch leaves it zero."""
    return torch.zeros(lanes * (4 + P + A) + 1, dtype=torch.int64, device=device)


EPILOGUE_TILE = 256  # chunk positions a block of era_epilogue.cu


def epilogue_scratch(lanes: int, P: int, chunk: int, device) -> torch.Tensor:
    """The epilogue kernel's scratch (era_epilogue.cu): each (lane,
    property) minimum, all bits set; each lane's ticket, zero; each tile's
    minima's fingerprints. Every launch leaves the minima and tickets as
    it found them."""
    tiles = -(-chunk // EPILOGUE_TILE)
    t = torch.zeros(lanes * P + lanes + lanes * tiles * P * 2, dtype=torch.int64, device=device)
    t[:lanes * P] = -1
    return t


def _fin_hit(s, rec: int) -> bool:
    return (rec & s[P_FIN_ANY]) != 0 or (
        s[P_FIN_ALL_EN] != 0 and (rec & s[P_FIN_ALL]) == s[P_FIN_ALL]
    )


def _gate(c: EraConfig, s, occupied: int) -> None:
    x = c.x
    count = s[P_COUNT]
    is_open = (
        0 < count <= s[P_HIGH_WATER]
        and s[P_UNIQUE] <= s[P_GROW_LIMIT]
        and s[x + X_ESTEPS] < s[P_MAX_STEPS]
        and s[P_ERR] == 0
        and not _fin_hit(s, s[P_REC])
        and (c.s_base < 0 or occupied <= c.s_high)
    )
    take = 0
    if is_open:
        take = min(count, c.chunk, s[P_TAKE_CAP])
        if c.s_base >= 0 and s[c.s_base] == M32 and s[c.s_base + 1] == M32:
            take = min(take, c.s_take)
    s[x + X_OPEN] = int(is_open)
    s[x + X_TAKE] = take
    s[x + X_TAIL] = (s[P_HEAD] + count) & c.qmask


def _step_row(mode: int, c: EraConfig, s: list, step, l: int, occupied: int, slab) -> None:
    """One lane's row `s` (a list, in place) under `mode`; `step` holds
    the per-lane operands as lists (COMMIT)."""
    x = c.x
    if mode == START:
        if c.cov_base >= 0:
            s[c.cov_base:c.cov_base + c.n_cov] = [0] * c.n_cov
        if c.f_base >= 0:
            s[c.f_base] = min(max(s[c.f_base], 1), c.fuse)
            s[c.f_base + 1:c.f_base + 2 + 4 * c.fuse] = [0] * (1 + 4 * c.fuse)
        if slab is not None:
            for lane in slab:
                lane.zero_()
        s[P_GEN] = s[P_STEPS] = s[P_MAXD] = 0
        s[x + X_ITER] = s[x + X_PARTIAL] = s[x + X_K] = 0
    elif mode == BEGIN:
        s[x + X_ESTEPS] = s[x + X_EGEN] = 0
        s[x + X_REC0] = s[P_REC]
        s[x + X_UNIQ_IN] = s[P_UNIQUE]
        s[P_TAKE_CAP] = min(max(s[P_TAKE_CAP], 1), c.chunk)
        _gate(c, s, occupied)
    elif mode == COMMIT:
        if not s[x + X_OPEN]:
            return
        n_val, n_d, unres_n, new_n, gen_n, hs_n, pa_n = step
        unres = unres_n[l]
        new_count = new_n[l]
        take = s[x + X_TAKE]
        if take <= 1:
            s[P_ERR] = (s[P_ERR] + unres) & M32
        ovf = n_val[l] > c.vcap or n_d[l] > c.rcap or unres > 0
        consumed = 0 if ovf else take
        s[P_HEAD] = (s[P_HEAD] + consumed) & c.qmask
        s[P_COUNT] = (s[P_COUNT] - consumed + new_count) & M32
        s[P_UNIQUE] = (s[P_UNIQUE] + new_count) & M32
        hs = [row[l] for row in hs_n]
        if not ovf:
            gen = gen_n[l]
            s[x + X_EGEN] = (s[x + X_EGEN] + gen) & M32
            s[P_GEN] = (s[P_GEN] + gen) & M32
            s[x + X_ESTEPS] += 1
            s[P_STEPS] = (s[P_STEPS] + 1) & M32
            s[P_TAKE_CAP] = min(s[P_TAKE_CAP] + c.regrow, c.chunk)
        else:
            s[P_TAKE_CAP] = max(take >> 1, 1)
        if c.cov_base >= 0:
            b = c.cov_base
            if not ovf:
                for a, n in enumerate(pa_n[l]):
                    s[b + a] = (s[b + a] + n) & M32
                for i, n in enumerate(hs):
                    s[b + c.A + i] = (s[b + c.A + i] + n) & M32
            s[b + c.A + c.P] = (s[b + c.A + c.P] + consumed) & M32
        for i, n in enumerate(hs):
            if n > 0:
                s[P_REC] |= 1 << i
        s[x + X_ITER] += 1
        s[x + X_PARTIAL] += int(ovf)
        _gate(c, s, occupied)
    else:
        raise ValueError(f"unknown era step mode {mode}")


def _fold_plain(c: EraConfig, rows: torch.Tensor, step: StepOperands):
    """COMMIT's fold of the step's operands (tpu_bfs.py:621-681), in
    place: the first-hit lanes and the depth histogram (every step, an
    overflowing one too); returns the per-lane hit counts hs [P][N], the
    per-lane action counts pa [N][A] (None without coverage) and the
    generated counts [N]."""
    N, C, P, A = rows.shape[0], c.chunk, c.P, c.A
    hs = []
    if P:
        hits = torch.stack([h.reshape(-1) for h in step.hits])
        f = step.first
        first = hits & ~f.hseen
        for acc, src in zip(f[1:], step.rows):
            acc.copy_(torch.where(first, src.reshape(-1), acc))
        f.hseen.logical_or_(hits)
        hs = hits.view(P, N, C).sum(2).tolist()
    valid = None if step.valid is None else step.valid.reshape(A, N, C)
    pa = None
    if c.cov_base >= 0:
        pa = valid.sum(2).T.tolist()
        dcap = c.n_cov - A - P - 1
        at = torch.arange(N, device=rows.device)[:, None] * rows.shape[1] + (c.cov_base + A + P + 1)
        rows.view(-1).index_add_(
            0, (at + step.ddepth.reshape(N, -1).clamp(max=dcap - 1)).view(-1),
            step.c_new.reshape(-1).to(torch.int64),
        )
    gen = step.generated.reshape(N) if step.generated is not None else valid.sum((0, 2))
    return hs, pa, gen.tolist()


def era_step_plain(mode: int, c: EraConfig, state, step: Optional[StepOperands] = None,
                   slab=None, epoch=None) -> None:
    rows = state.view(-1, state.shape[-1])
    N = rows.shape[0]
    occupied = int(slab.counts[0]) if slab is not None else 0
    ops = None
    if mode == COMMIT:
        hs, pa, gen = _fold_plain(c, rows, step)
        ops = (
            step.n_val.reshape(N).tolist(), step.n_d.reshape(N).tolist(),
            step.unresolved.reshape(N, -1).sum(1).tolist(), step.c_new.reshape(N, -1).sum(1).tolist(),
            gen, hs, pa,
        )
    vals = rows.tolist()
    was_open = [s[c.x + X_OPEN] for s in vals]
    for l, s in enumerate(vals):
        _step_row(mode, c, s, ops, l, occupied, slab)
    if epoch is not None and mode == COMMIT and any(was_open):
        epoch += 1
    rows.copy_(torch.tensor(vals, dtype=torch.int64))


def era_step(mode: int, c: EraConfig, state, step: Optional[StepOperands] = None,
             slab=None, epoch=None, handle: int = 0, scratch=None) -> None:
    """One launch of K8f's step kernel on the era's state vector (int64,
    the JAX params then the X_* words), in place. START opens a dispatch
    (zeroes its outputs and the slab, clamps fuse_lim), BEGIN opens an
    era (then the gate), COMMIT folds `step` (the first-hit lanes, the
    depth histogram, the counts; see StepOperands), commits it if the
    gate was open (raising `epoch`, the visited insert's) and runs the
    gate for the next step: X_OPEN, X_TAKE (0 when closed) and X_TAIL.
    `slab` (the sample slab, or None) is zeroed at START and its
    occupancy gates the era. `handle` (a CUDA graph's conditional handle,
    or 0) receives the gate. With a state [N, L] (N lanes, K14f) each
    lane's row is gated and committed alone, `handle` receives the OR of
    the lanes' gates and `epoch` rises once a step; no slab. `scratch`
    (`step_scratch`, zero; COMMIT and the lanes' BEGIN) carries the
    kernel's accumulators and tickets: a program passes its own, a call
    without one gets a fresh one. On CPU tensors the plain version
    runs."""
    if not kernels.on_card(state):
        return era_step_plain(mode, c, state, step, slab, epoch)
    p = kernels.ptr
    lanes = state.shape[0] if state.dim() == 2 else 1
    if scratch is None and (mode == COMMIT or (lanes > 1 and mode == BEGIN)):
        scratch = step_scratch(lanes, c.P, c.A, state.device)

    def opt(t):
        return None if t is None else p(t)

    hits = None
    if step is None:
        ops = [None, None, None, None, 0, None, None]
        rows = first = [None] * 4
    else:
        if c.P:
            if step.hits is None or len(step.hits) != c.P or step.first is None or step.rows is None:
                raise ValueError("a step with properties needs its hits, rows and first-hit lanes")
            hits = (ctypes.c_void_p * c.P)(*(p(h) for h in step.hits))
        ops = [p(step.n_val), p(step.n_d), p(step.unresolved), p(step.c_new), step.c_new.shape[-1],
               opt(step.ddepth), opt(step.generated)]
        rows = [opt(step.valid)] + ([None] * 3 if step.rows is None else [p(t) for t in step.rows])
        first = [None] * 4 if step.first is None else [p(t) for t in step.first]
    slab_lanes = [None] * 5 if slab is None else [p(t) for t in slab]
    kernel = kernels.ERA_STEP if state.dim() == 1 else kernels.ERA_STEP_LANES
    kernel.launch(mode, c.ptr, p(state), lanes, state.shape[-1], *ops,
                  None if hits is None else ctypes.addressof(hits), *rows, *first,
                  *slab_lanes, opt(epoch), opt(scratch), int(handle))


def _epilogue_row(c: EraConfig, s: list, found, fp1, fp2, maxd_at, occupied: int) -> None:
    x = c.x
    P = c.P
    rec0 = s[x + X_REC0]
    rec = rec0
    for i in range(P):
        if not found[i]:
            continue
        if not (rec0 >> i) & 1:
            s[P_LEN + i] = fp1[i]
            s[P_LEN + P + i] = fp2[i]
        rec |= 1 << i
    s[P_REC] = rec
    steps = s[x + X_ESTEPS]
    count, unique = s[P_COUNT], s[P_UNIQUE]
    maxd = maxd_at((s[P_HEAD] - 1) & c.qmask) if steps > 0 else 0
    s[P_MAXD] = max(s[P_MAXD], maxd)
    max_steps, cap = s[P_MAX_STEPS], s[P_BUDGET_CAP]
    pressure = count > s[P_HIGH_WATER] or unique > s[P_GROW_LIMIT]
    budget_only = (
        steps >= max_steps and count > 0 and not pressure and s[P_ERR] == 0
        and not _fin_hit(s, rec)
    )
    if cap == 0:
        nxt = max_steps
    elif pressure:
        nxt = max(min(max_steps, cap) >> 1, c.budget_min)
    elif budget_only:
        nxt = min(max(max_steps, 1) * 2, cap)
    else:
        nxt = max_steps
    s[P_MAX_STEPS] = nxt & M32
    s[P_ERR] = int(s[P_ERR] != 0)
    k = s[x + X_K]
    more = False
    if c.f_base >= 0:
        lanes = c.f_base + 2
        s[lanes + k] = steps
        s[lanes + c.fuse + k] = s[x + X_EGEN]
        s[lanes + 2 * c.fuse + k] = (unique - s[x + X_UNIQ_IN]) & M32
        s[lanes + 3 * c.fuse + k] = count
        k += 1
        s[c.f_base + 1] = k
        room = c.s_base < 0 or occupied <= c.s_high
        more = budget_only and room and k < s[c.f_base]
    else:
        k = 1
    s[x + X_K] = k
    s[x + X_MORE] = int(more)


def era_epilogue_plain(c: EraConfig, state, hseen, facc1, facc2, faccd, ring_depth,
                       slab_counts=None) -> None:
    rows = state.view(-1, state.shape[-1])
    N, P, C = rows.shape[0], c.P, c.chunk
    depth = ring_depth.reshape(N, -1)
    found = fp1 = fp2 = [[] for _ in range(N)]
    if P:
        seen = hseen.view(P, N, C)
        found = seen.any(2).T.tolist()
        # The shallowest first hit, the lowest position among equals.
        sel = torch.where(seen, faccd.view(P, N, C), M32).argmin(2, keepdim=True)
        fp1 = facc1.view(P, N, C).gather(2, sel)[..., 0].T.tolist()
        fp2 = facc2.view(P, N, C).gather(2, sel)[..., 0].T.tolist()
    occupied = int(slab_counts[0]) if slab_counts is not None else 0
    vals = rows.tolist()
    for l, s in enumerate(vals):
        _epilogue_row(c, s, found[l], fp1[l], fp2[l], lambda i, l=l: int(depth[l, i]), occupied)
    for t in (hseen, facc1, facc2, faccd):
        t.zero_()
    rows.copy_(torch.tensor(vals, dtype=torch.int64))


def era_epilogue(c: EraConfig, state, hseen, facc1, facc2, faccd, ring_depth,
                 slab_counts=None, handle: int = 0, scratch=None) -> None:
    """One launch of K8f's epilogue kernel at an era's end, in place:
    each property's discovery (the shallowest first hit in the era's
    first-hit lanes hseen / facc1 / facc2 / faccd [P, chunk], the lowest
    position among equals) unless already recorded, the max depth at ring
    slot head - 1 (`ring_depth`: the ring's depth lane), the next step
    budget, the fusion lanes and whether another inner era runs
    (X_MORE, and `handle`), the error word as 0/1; the first-hit lanes
    are zeroed for the next era. With a state [N, L] (N lanes, K14f) the
    first-hit lanes are [P, N * chunk] (lane l's at columns l * chunk ..)
    and `ring_depth` is [N, qcap + 1] (each lane's ring depth lane, a
    strided view); no slab, no fusion tail, no handle. `scratch`
    (`epilogue_scratch`) carries the kernel's minima and tickets: a
    program passes its own, a call without one gets a fresh one. On CPU
    tensors the plain version runs."""
    if not kernels.on_card(state, ring_depth):
        return era_epilogue_plain(c, state, hseen, facc1, facc2, faccd, ring_depth, slab_counts)
    p = kernels.ptr
    lanes = state.shape[0] if state.dim() == 2 else 1
    if ring_depth.stride(-1) != 1:
        raise ValueError("the ring's depth lane must be contiguous")
    if scratch is None:
        scratch = epilogue_scratch(lanes, c.P, c.chunk, state.device)
    kernel = kernels.ERA_EPILOGUE if state.dim() == 1 else kernels.ERA_EPILOGUE_LANES
    kernel.launch(
        c.ptr, p(state), lanes, state.shape[-1], p(hseen), p(facc1), p(facc2), p(faccd),
        ring_depth.data_ptr(), ring_depth.stride(0) if ring_depth.dim() == 2 else 0,
        None if slab_counts is None else p(slab_counts), p(scratch), int(handle),
    )
