"""The sharded era's bookkeeping on the card (K15f): the shard params
layout, and the shard-coupled gate, step commit, epilogue and dispatch
tail (kernels/csrc/mesh_era.cu: COMMIT one grid over (tile, shard), the
other phases one block) with its plain torch version.

The port's counterpart of the scalar parts of
`stateright_tpu/parallel/mesh.py:152 _build_block`: the packed per-shard
params (:49-120 `P_*`, `shard_params_len`, `shard_fuse_tail_len`), the
uniform gate `global_gates` (:257-298), the overflow / unresolved veto
and the commit at the end of the step (:445-500), the era epilogue with
its adaptive budget (:580-640), the fused outer loop (:697-760) and the
dispatch's output row (:762-810: the coverage psum, the sample tail's
header, the error word). COMMIT also folds the step's operands as the
JAX step does before its commit (:437-500): the first-hit lanes, the
hit and action counts, the generated count and the owner's depth
histogram.

A rank holds its shards as a leading axis: the state is [N, L] int64,
one row a local shard — the JAX shard's params row, word for word
(uint32 values), then its discovery outputs rec_fp1[P] | rec_fp2[P] |
disc_depth[P] (the JAX program's separate outputs), then the port's own
words (X_*). Per shard the rules are the solo era's (ops/era.py); what
is new is the cross-shard reduction: every gate, the veto and the
epilogue read a SUM over all shards of the mesh, identical on every
shard, written into a small `sums` vector:

    sums[0]               unresolved inserts       (the veto)
    sums[1]               shards with take > 1     (the veto's can-shrink)
    sums[2 .. 6 + P]      work, pressure, error, each property's first
                          hit, slab past high water (the gates, the epilogue)
    sums[6 + P ..]        the coverage tail         (the dispatch tail)

A mode is a short sequence of phases. Each phase reads the totals of the
phase before it and writes this rank's partial sums; on one rank (world
size 1) every phase of a mode runs in ONE launch and a rank's partials
are the totals. Across ranks (`group`) the phases run one launch each,
with an `all_reduce` of `sums` between them, so every rank applies the
same totals: a shard never reads its own partial for a global value.
COMMIT's first phase (C1, with the fold) is the commit grid; across
ranks it leaves its accumulators in the `commit_scratch` for the C2
launch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .. import kernels
from ..obs.coverage import DEPTH_CAP
from ..obs.sample import slab_entries

M32 = 0xFFFFFFFF

# The packed per-shard params (mesh.py:49-67): the solo layout's scalars.
P_HEAD = 0
P_COUNT = 1
P_UNIQUE = 2
P_REC = 3
P_DEPTH_LIMIT = 4
P_GROW_LIMIT = 5
P_HIGH_WATER = 6
P_MAX_STEPS = 7
P_GEN = 8
P_MAXD = 9
P_STEPS = 10
P_ERR = 11
P_TAKE_CAP = 12
P_FIN_ANY = 13
P_FIN_ALL = 14
P_FIN_ALL_EN = 15
P_BUDGET_CAP = 16
P_LEN = 17

# Cross-shard frontier imbalance (max / mean occupancy) above which the
# engine warns once a run (mesh.py:69).
SHARD_IMBALANCE_WARN = 4.0

# The adaptive budget's floor (mesh.py:627).
BUDGET_MIN = 64

# The port's words after the discovery outputs (mesh_era.cu): this step's
# take, the uniform gate, this step's ring tail, the era's input discovery
# bits and unique count, the era's clean steps and generated states, the
# era's lockstep iterations, the dispatch's step runs, partial steps and
# inner eras, whether the fused loop runs another era, and this step's
# new and unresolved inserts.
X_TAKE = 0
X_OPEN = 1
X_TAIL = 2
X_REC0 = 3
X_UNIQ_IN = 4
X_ESTEPS = 5
X_EGEN = 6
X_ITS = 7
X_ITER = 8
X_PARTIAL = 9
X_K = 10
X_MORE = 11
X_NEW = 12
X_UNRES = 13
X_LEN = 14

# The sums vector.
S_UNRES = 0
S_SHRINK = 1
S_GATE = 2  # work, pressure, error, P property bits, slab


def cov_len(A: int, P: int) -> int:
    """Words of the coverage tail: act[A] | hits[P] | expanded | depths."""
    return A + P + 1 + DEPTH_CAP


def shard_fuse_tail_len(fuse: int, n_props: int) -> int:
    """Words of the fusion tail (mesh.py:95): [fuse_lim, n_inner] + steps
    | generated | unique | frontier, one word an inner era, + each
    property's best-discovery inner era; none at fuse 1."""
    return (2 + 4 * fuse + n_props) if fuse > 1 else 0


def sample_tail_len(sample_k: int) -> int:
    """[T1, T2, occupied, 0] + the sk2 smallest slab rows' fp1 | fp2 |
    depth | ok (mesh.py:796-808)."""
    return 4 + 4 * slab_entries(sample_k) if sample_k else 0


def shard_params_len(A: int, P: int, cov: bool, sample_k: int, fuse: int = 1) -> int:
    """Length of one shard's packed params row (mesh.py:105)."""
    n = P_LEN + (cov_len(A, P) if cov else 0) + sample_tail_len(sample_k)
    return n + shard_fuse_tail_len(fuse, P)


def sums_len(A: int, P: int, cov: bool) -> int:
    return S_GATE + 4 + P + (cov_len(A, P) if cov else 0)


# Phases (mesh_era.cu) and the modes built from them.
# PH_CGATE is the gate of a commit: it keeps a closed gate closed (a step
# run with the gate closed, as a graph's warm-up runs it, changes nothing).
PH_START, PH_BEGIN, PH_C1, PH_C2, PH_GATE, PH_E1, PH_E2, PH_T1, PH_T2, PH_CGATE = range(10)
START = (PH_START,)
BEGIN = (PH_BEGIN, PH_GATE)
COMMIT = (PH_C1, PH_C2, PH_CGATE)
EPILOGUE = (PH_E1, PH_E2)
TAIL = (PH_T1, PH_T2)

# The config vector the kernel reads (mesh_era.cu Cfg), in this order.
CFG_FIELDS = (
    "chunk", "qmask", "P", "A", "cov_base", "s_base", "s_high", "f_base", "fuse",
    "d_base", "x", "regrow", "budget_min", "n_cov", "scap", "sum_cov", "vcap",
)


class MeshConfig:
    """One mesh program's layout and widths: attributes named as
    CFG_FIELDS (an absent tail's offset is -1), and the same values as a
    host int64 array the kernel takes by pointer."""

    def __init__(self, **values):
        for name in CFG_FIELDS:
            setattr(self, name, int(values[name]))
        self._array = (ctypes.c_longlong * len(CFG_FIELDS))(
            *(getattr(self, n) for n in CFG_FIELDS)
        )

    @property
    def ptr(self) -> int:
        return ctypes.addressof(self._array)


class MeshOperands(NamedTuple):
    """The tensors a mode reads besides the state and the sums (None where
    a mode does not read them). N local shards, chunk C, receive width R:
    is_new / unresolved [N, R] bool (the owner-side insert), rdepth [N, R]
    (each received row's depth: the owner's depth histogram; None
    without coverage), n_ovf [N] (K15a's overflow past the quota, at the
    sender), n_val [N] (each sender's valid candidates, against vcap),
    hits (P masks, each [N * C]: the popped rows that hit each property),
    valid [A, N, C] bool (each sender's valid candidates, action-major:
    the expand's mask; its counts are the action coverage and the
    generated count), rows (h1, h2, depth), each [N * C] (the popped
    rows': a first hit's fingerprint and depth), hseen [P, N * C] bool and
    facc1 / facc2 / faccd [P, N * C] (the era's first hits; shard l's at
    columns l * C ..), ring_depth [N, qcap + 1] (each shard ring's depth
    lane, a strided view), slab [4, N, scap + 1] (the sample slabs' fp1,
    fp2, depth, action lanes) and slab_counts [N, 2] (occupied,
    dropped)."""

    is_new: Optional[torch.Tensor] = None
    unresolved: Optional[torch.Tensor] = None
    rdepth: Optional[torch.Tensor] = None
    n_ovf: Optional[torch.Tensor] = None
    n_val: Optional[torch.Tensor] = None
    hits: Optional[Sequence[torch.Tensor]] = None
    valid: Optional[torch.Tensor] = None
    rows: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
    hseen: Optional[torch.Tensor] = None
    facc1: Optional[torch.Tensor] = None
    facc2: Optional[torch.Tensor] = None
    faccd: Optional[torch.Tensor] = None
    ring_depth: Optional[torch.Tensor] = None
    slab: Optional[torch.Tensor] = None
    slab_counts: Optional[torch.Tensor] = None


def commit_scratch(N: int, P: int, A: int, device) -> torch.Tensor:
    """The commit grid's scratch (mesh_era.cu): each shard's accumulators
    (unresolved, new, valid, a spare word, hs[P], the hit-or-seen
    counts[P], pa[A]) and the grid's ticket, zero. A launch on one rank
    leaves it zero; across ranks the C2 launch zeroes what the grid left."""
    return torch.zeros(N * (4 + 2 * P + A) + 1, dtype=torch.int64, device=device)


# -- the plain version ---------------------------------------------------------

def _fin_hit(s, rec: int) -> bool:
    return (rec & s[P_FIN_ANY]) != 0 or (
        s[P_FIN_ALL_EN] != 0 and (rec & s[P_FIN_ALL]) == s[P_FIN_ALL]
    )


class _Plain:
    """The phases over Python lists: rows (the state), sums, and the
    operands read back once."""

    def __init__(self, c: MeshConfig, state, sums, ops: MeshOperands):
        self.c, self.state, self.sums_t, self.ops = c, state, sums, ops
        self.rows = state.tolist()
        self.sums = sums.tolist()
        self.N = len(self.rows)
        self.C = c.chunk
        o = ops
        self.occ = o.slab_counts[:, 0].tolist() if o.slab_counts is not None else [0] * self.N
        if o.hseen is not None and c.P:
            self.seen = o.hseen.view(c.P, self.N, self.C)
        else:
            self.seen = None

    def bits(self):
        """[N][P]: whether shard l's first-hit lanes hold a hit of p."""
        if self.seen is None:
            return [[0] * self.c.P for _ in range(self.N)]
        return self.seen.any(2).T.to(torch.int64).tolist()

    def gate_partials(self, epilogue: bool) -> None:
        c = self.c
        g = [0] * (4 + c.P)
        bits = self.bits()
        for l, s in enumerate(self.rows):
            g[0] += int(s[P_COUNT] > 0)
            g[1] += int(s[P_COUNT] > s[P_HIGH_WATER] or s[P_UNIQUE] > s[P_GROW_LIMIT])
            g[2] += int(s[P_ERR] > 0)
            for p in range(c.P):
                g[3 + p] += bits[l][p]
            if c.s_base >= 0 and (not epilogue or c.f_base >= 0):
                g[3 + c.P] += int(self.occ[l] > c.s_high)
        self.sums[S_GATE:S_GATE + 4 + c.P] = g

    def rec_bits(self, rec0: int) -> int:
        rec = rec0
        for p in range(self.c.P):
            if self.sums[S_GATE + 3 + p] > 0:
                rec |= 1 << p
        return rec

    def open_flag(self) -> bool:
        return bool(self.rows[0][self.c.x + X_OPEN])

    def run(self, phase: int) -> None:
        c, x = self.c, self.c.x
        if phase == PH_START:
            for s in self.rows:
                if c.cov_base >= 0:
                    s[c.cov_base:c.cov_base + c.n_cov] = [0] * c.n_cov
                if c.f_base >= 0:
                    s[c.f_base] = min(max(s[c.f_base], 1), c.fuse)
                    s[c.f_base + 1:c.f_base + 2 + 4 * c.fuse + c.P] = [0] * (1 + 4 * c.fuse + c.P)
                d = c.d_base
                s[d:d + 2 * c.P] = [0] * (2 * c.P)
                s[d + 2 * c.P:d + 3 * c.P] = [M32] * c.P
                s[P_GEN] = s[P_STEPS] = s[P_MAXD] = 0
                s[x + X_ITER] = s[x + X_PARTIAL] = s[x + X_K] = 0
            if self.ops.slab is not None:
                self.ops.slab.zero_()
                self.ops.slab_counts.zero_()
                self.occ = [0] * self.N
        elif phase == PH_BEGIN:
            for s in self.rows:
                s[x + X_ESTEPS] = s[x + X_EGEN] = s[x + X_ITS] = 0
                s[x + X_REC0] = s[P_REC]
                s[x + X_UNIQ_IN] = s[P_UNIQUE]
                s[P_TAKE_CAP] = min(max(s[P_TAKE_CAP], 1), c.chunk)
            self.gate_partials(False)
        elif phase == PH_C1:
            self.fold()
            if not self.open_flag():
                return
            unres = self.ops.unresolved.sum(1).tolist()
            new = self.ops.is_new.sum(1).tolist()
            shrink = 0
            for l, s in enumerate(self.rows):
                s[x + X_NEW], s[x + X_UNRES] = new[l], unres[l]
                shrink += int(s[x + X_TAKE] > 1)
            self.sums[S_UNRES] = sum(unres)
            self.sums[S_SHRINK] = shrink
        elif phase == PH_C2:
            if not self.open_flag():
                return
            o = self.ops
            g_unres, g_shrink = self.sums[S_UNRES], self.sums[S_SHRINK]
            n_ovf = o.n_ovf.tolist()
            n_val = o.n_val.tolist()
            valid = o.valid.reshape(c.A, self.N, self.C)
            gen = valid.sum((0, 2)).tolist()
            pa = valid.sum(2).T.tolist()
            hs = self.hit_mask().view(c.P, self.N, self.C).sum(2).tolist()
            for l, s in enumerate(self.rows):
                take, new = s[x + X_TAKE], s[x + X_NEW]
                pred = s[P_COUNT] > 0
                if g_shrink == 0:
                    s[P_ERR] = (s[P_ERR] + g_unres) & M32
                ovf = n_ovf[l] > 0 or n_val[l] > c.vcap or g_unres > 0
                consumed = 0 if ovf else take
                s[P_HEAD] = (s[P_HEAD] + consumed) & c.qmask
                s[P_COUNT] = (s[P_COUNT] - consumed + new) & M32
                s[P_UNIQUE] = (s[P_UNIQUE] + new) & M32
                if not ovf:
                    s[x + X_EGEN] = (s[x + X_EGEN] + gen[l]) & M32
                    s[x + X_ESTEPS] += int(pred)
                    s[P_TAKE_CAP] = min(s[P_TAKE_CAP] + c.regrow, c.chunk)
                else:
                    s[P_TAKE_CAP] = max(take >> 1, 1)
                if c.cov_base >= 0:
                    b = c.cov_base
                    if not ovf:
                        for a in range(c.A):
                            s[b + a] = (s[b + a] + pa[l][a]) & M32
                        for p in range(c.P):
                            s[b + c.A + p] = (s[b + c.A + p] + hs[p][l]) & M32
                    s[b + c.A + c.P] = (s[b + c.A + c.P] + consumed) & M32
                s[x + X_ITS] += 1
                s[x + X_ITER] += 1
                s[x + X_PARTIAL] += int(ovf)
            self.gate_partials(False)
        elif phase in (PH_GATE, PH_CGATE):
            if phase == PH_CGATE and not self.open_flag():
                return
            g = self.sums[S_GATE:]
            for s in self.rows:
                rec = self.rec_bits(s[x + X_REC0])
                is_open = (
                    g[0] > 0 and g[1] == 0 and g[2] == 0 and not _fin_hit(s, rec)
                    and s[x + X_ITS] < s[P_MAX_STEPS]
                    and (c.s_base < 0 or g[3 + c.P] == 0)
                )
                take = 0
                if is_open and s[P_COUNT] > 0:
                    take = min(s[P_COUNT], c.chunk, s[P_TAKE_CAP])
                s[x + X_OPEN] = int(is_open)
                s[x + X_TAKE] = take
                s[x + X_TAIL] = (s[P_HEAD] + s[P_COUNT]) & c.qmask
        elif phase == PH_E1:
            self.gate_partials(True)
        elif phase == PH_E2:
            self.epilogue()
        elif phase == PH_T1:
            if c.cov_base >= 0:
                b = c.cov_base
                self.sums[c.sum_cov:c.sum_cov + c.n_cov] = [
                    sum(s[b + i] for s in self.rows) for i in range(c.n_cov)
                ]
        elif phase == PH_T2:
            for l, s in enumerate(self.rows):
                if c.cov_base >= 0:
                    s[c.cov_base:c.cov_base + c.n_cov] = [
                        v & M32 for v in self.sums[c.sum_cov:c.sum_cov + c.n_cov]
                    ]
                s[P_ERR] = int(s[P_ERR] != 0)
                if c.s_base >= 0:
                    s[c.s_base + 2] = self.occ[l]
                    s[c.s_base + 3] = 0
        else:
            raise ValueError(f"unknown mesh era phase {phase}")

    def hit_mask(self) -> torch.Tensor:
        """[P, N * C]: the popped rows that hit each property."""
        hits = self.ops.hits or ()
        return torch.stack([h.reshape(-1) for h in hits]) if hits else torch.zeros(
            (0, self.N * self.C), dtype=torch.bool)

    def fold(self) -> None:
        """COMMIT's fold, on every step whatever the gate (mesh.py:437-500):
        the first-hit lanes (where a hit was not seen, the row's hashes and
        depth) and, with coverage, each new insert counted at the owner at
        min(its depth, DEPTH_CAP - 1)."""
        c, o = self.c, self.ops
        if c.P:
            hits = self.hit_mask()
            first = hits & ~o.hseen
            for acc, src in zip((o.facc1, o.facc2, o.faccd), o.rows):
                acc.copy_(torch.where(first, src.reshape(-1), acc))
            o.hseen.logical_or_(hits)
        if c.cov_base >= 0:
            at = torch.arange(self.N)[:, None] * DEPTH_CAP + o.rdepth.cpu().clamp(max=DEPTH_CAP - 1)
            hist = torch.zeros(self.N * DEPTH_CAP, dtype=torch.int64).index_add_(
                0, at.view(-1), o.is_new.cpu().view(-1).to(torch.int64)).view(self.N, DEPTH_CAP).tolist()
            base = c.cov_base + c.A + c.P + 1
            for s, h in zip(self.rows, hist):
                s[base:base + DEPTH_CAP] = [a + b for a, b in zip(s[base:base + DEPTH_CAP], h)]

    def epilogue(self) -> None:
        c, x, P, C = self.c, self.c.x, self.c.P, self.C
        g = self.sums[S_GATE:]
        work, pressure, err = g[0] > 0, g[1] > 0, g[2] > 0
        o = self.ops
        if P:
            seen = self.seen
            found = seen.any(2).tolist()  # [P][N]
            # The shallowest hit, the lowest position among equals.
            sel = torch.where(seen, o.faccd.view(P, self.N, C), M32).argmin(2, keepdim=True)
            ef1 = o.facc1.view(P, self.N, C).gather(2, sel)[..., 0].tolist()
            ef2 = o.facc2.view(P, self.N, C).gather(2, sel)[..., 0].tolist()
            edd = o.faccd.view(P, self.N, C).gather(2, sel)[..., 0].tolist()
        depth = o.ring_depth
        for l, s in enumerate(self.rows):
            rec_all = self.rec_bits(s[x + X_REC0])
            fin = _fin_hit(s, rec_all)
            max_steps, cap = s[P_MAX_STEPS], s[P_BUDGET_CAP]
            budget_only = s[x + X_ITS] >= max_steps and work and not pressure and not err and not fin
            if cap == 0:
                nxt = max_steps
            elif pressure:
                nxt = max(min(max_steps, cap) >> 1, c.budget_min)
            elif budget_only:
                nxt = min(max(max_steps, 1) * 2, cap)
            else:
                nxt = max_steps
            steps = s[x + X_ESTEPS]
            maxd = int(depth[l, (s[P_HEAD] - 1) & c.qmask]) if steps > 0 else 0
            k = s[x + X_K]
            d = c.d_base
            for p in range(P):
                if found[p][l]:
                    f1, f2, dd = ef1[p][l], ef2[p][l], edd[p][l]
                else:
                    f1 = f2 = 0
                    dd = M32
                if dd < s[d + 2 * P + p]:
                    s[d + p], s[d + P + p], s[d + 2 * P + p] = f1, f2, dd
                    if c.f_base >= 0:
                        s[c.f_base + 2 + 4 * c.fuse + p] = k
            s[P_STEPS] = (s[P_STEPS] + steps) & M32
            s[P_GEN] = (s[P_GEN] + s[x + X_EGEN]) & M32
            s[P_MAXD] = max(s[P_MAXD], maxd)
            more = False
            if c.f_base >= 0:
                lanes = c.f_base + 2
                s[lanes + k] = steps
                s[lanes + c.fuse + k] = s[x + X_EGEN]
                s[lanes + 2 * c.fuse + k] = (s[P_UNIQUE] - s[x + X_UNIQ_IN]) & M32
                s[lanes + 3 * c.fuse + k] = s[P_COUNT]
                k += 1
                s[c.f_base + 1] = k
                slab_full = c.s_base >= 0 and g[3 + P] > 0
                more = budget_only and not slab_full and k < s[c.f_base]
            else:
                k = 1
            s[P_REC] = rec_all
            s[P_MAX_STEPS] = nxt & M32
            s[x + X_K] = k
            s[x + X_MORE] = int(more)
        if P:
            for t in (o.hseen, o.facc1, o.facc2, o.faccd):
                t.zero_()

    def write(self) -> None:
        self.state.copy_(torch.tensor(self.rows, dtype=torch.int64))
        self.sums_t.copy_(torch.tensor(self.sums, dtype=torch.int64))


def mesh_era_plain(phases, c: MeshConfig, state, sums, ops: MeshOperands) -> None:
    pl = _Plain(c, state, sums, ops)
    for ph in phases:
        pl.run(ph)
    pl.write()


def _launch(phases, c: MeshConfig, state, sums, ops: MeshOperands, handle: int, scratch,
            final: bool = True) -> None:
    """One launch: the commit grid where `phases` start with C1 (`final`:
    on one rank, C1, C2 and CGATE; else C1 alone), else the one-block
    kernel over `phases`."""
    p = kernels.ptr

    def opt(t):
        return None if t is None else p(t)

    o = ops
    N, L = state.shape
    if phases[0] == PH_C1:
        need = {"is_new", "unresolved", "n_ovf", "n_val", "valid"}
        if c.P:
            need |= {"hits", "rows", "hseen", "facc1", "facc2", "faccd"}
        if c.cov_base >= 0:
            need.add("rdepth")
        missing = sorted(f for f in need if getattr(o, f) is None)
        if missing or scratch is None:
            raise ValueError(f"the mesh commit reads {missing + ([] if scratch is not None else ['scratch'])}")
        hits = (ctypes.c_void_p * max(1, c.P))(*(p(h) for h in (o.hits or ()))) if c.P else None
        rows = [None] * 3 if o.rows is None else [p(t) for t in o.rows]
        kernels.MESH_COMMIT.launch(
            int(final), c.ptr, p(state), N, L, p(sums), p(o.is_new), p(o.unresolved), o.is_new.shape[1],
            opt(o.rdepth), p(o.n_ovf), p(o.n_val), None if hits is None else ctypes.addressof(hits),
            p(o.valid), *rows, opt(o.hseen), opt(o.facc1), opt(o.facc2), opt(o.faccd),
            opt(o.slab_counts), p(scratch), int(handle),
        )
        return
    need = set()
    if PH_C2 in phases:
        need |= {"n_ovf", "n_val"}
    if PH_E2 in phases:
        need |= {"hseen", "facc1", "facc2", "faccd", "ring_depth"}
    missing = sorted(f for f in need if getattr(o, f) is None)
    if missing or (PH_C2 in phases and scratch is None):
        raise ValueError(f"the mesh era kernel's phases {tuple(phases)} read {missing or ['scratch']}")
    if o.ring_depth is not None and o.ring_depth.stride(-1) != 1:
        raise ValueError("the ring's depth lane must be contiguous")
    ph = list(phases) + [-1] * (3 - len(phases))
    kernels.MESH_ERA.launch(
        ph[0], ph[1], ph[2], c.ptr, p(state), N, L, p(sums), opt(o.n_ovf), opt(o.n_val),
        opt(o.hseen), opt(o.facc1), opt(o.facc2), opt(o.faccd),
        None if o.ring_depth is None else o.ring_depth.data_ptr(),
        0 if o.ring_depth is None else o.ring_depth.stride(0),
        opt(o.slab), opt(o.slab_counts), opt(scratch), int(handle),
    )


def mesh_era(mode, c: MeshConfig, state, sums, ops: MeshOperands = MeshOperands(),
             reduce=None, handle: int = 0, scratch=None) -> None:
    """Run the phases of `mode` (START, BEGIN, COMMIT, EPILOGUE, TAIL) on
    a rank's shard state [N, L] and sums vector, in place.

    START opens a dispatch (zeroes its outputs, the discovery outputs,
    the sample slabs; clamps fuse_lim); BEGIN opens an era (the gate);
    COMMIT folds the step's operands (the first-hit lanes and the owner's
    depth histogram, on every step) and, while the gate is open, commits
    the step of every shard under the global veto — an overflow at a
    shard's sender (a bucket past its quota, or more valid candidates
    than the compaction's vcap), or any unresolved insert anywhere,
    consumes none of that shard's pops and halves its take_cap — with its
    coverage counts, then the gate; EPILOGUE ends an era (each shard's
    discoveries and max depth, the global next budget, the fusion
    continuation); TAIL ends the dispatch (the coverage tail summed over
    the mesh into every row, the error word as 0/1, the sample tail's
    header). The gate is the same on every shard: X_OPEN, and X_TAKE /
    X_TAIL per shard.

    `reduce` (None on one rank) is called on `sums` between two phases:
    the all_reduce of a world with several ranks. `handle` (a CUDA
    graph's conditional handle, or 0; one rank only) receives the gate
    (BEGIN, COMMIT), 1 (START) or the continuation (EPILOGUE). `scratch`
    (`commit_scratch`, COMMIT on the card; a program passes its own, a
    call without one gets a fresh one) carries the commit grid's
    accumulators and ticket. On CPU tensors the plain version runs."""
    if not kernels.on_card(state, sums):
        if reduce is None:
            return mesh_era_plain(mode, c, state, sums, ops)
        for i, ph in enumerate(mode):
            mesh_era_plain((ph,), c, state, sums, ops)
            if i + 1 < len(mode):
                reduce(sums)
        return
    if scratch is None and PH_C1 in mode:
        scratch = commit_scratch(state.shape[0], c.P, c.A, state.device)
    if reduce is None:
        return _launch(mode, c, state, sums, ops, handle, scratch)
    if handle:
        raise ValueError("a graph's handle takes the one-rank mesh era")
    for i, ph in enumerate(mode):
        _launch((ph,), c, state, sums, ops, 0, scratch, final=False)
        if i + 1 < len(mode):
            reduce(sums)
