"""The simulation era's bookkeeping on the card (K13f): the state-vector
layout and the walk-era kernel (gate, step commit, epilogue) with its
plain torch version.

The port's counterpart of the scalar parts of
`stateright_tpu/engines/tpu_simulation.py:140 loop`: the packed params
(:61-71), the `cond` gate (:168-182), the era's zeroed carry (:407-453)
and the epilogue that packs `params_out` (:457-495). The simulation
program (engines/gpu_simulation.py) keeps one int64 state vector on the
card: the JAX `params_out` words, word for word (uint32 values) — the
head words P_REC .. P_SEED, disc_walk[P], disc_plen[P], the coverage
tail act[A] | hits[P] | depth[DEPTH_CAP] and the sample tail [t1, t2,
occupied, 0] | fp1, fp2, depth and the S state lanes of the sk2
smallest slab rows | their ok lane — then the port's own words (X_*),
the first five of which are ops/walk.py's `stats`.

`walk_era` runs its kernel (kernels/csrc/walk_era.cu) on CUDA tensors
and its plain version on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..obs.coverage import DEPTH_CAP
from ..obs.sample import slab_entries

M32 = 0xFFFFFFFF

# The packed params (tpu_simulation.py:61-71).
P_REC = 0
P_MAX_STEPS = 1
P_FIN_ANY = 2
P_FIN_ALL = 3
P_FIN_ALL_EN = 4
P_TARGET_GEN = 5
P_GEN0 = 6
P_GEN = 7
P_STEPS = 8
P_MAXD = 9
P_SEED = 10
P_LEN = 11

# The port's words after the params (walk_era.cu): ops/walk.py's stats
# (gen, occupied, the recorded bits, maxd, frozen), then the era's steps,
# the steps run and the gate.
X_GEN = 0
X_OCC = 1
X_REC = 2
X_MAXD = 3
X_FROZEN = 4
X_STEPS = 5
X_RUN = 6
X_OPEN = 7
X_LEN = 8

# The era's inputs (`era_in`, the host's one upload an era): the head
# words, then the sample threshold.
IN_LEN = P_LEN + 2

# Kernel modes (walk_era.cu).
BEGIN = 0
COMMIT = 1
EPILOGUE = 2

# The config vector the kernel reads (walk_era.cu Cfg), in this order.
CFG_FIELDS = ("P", "B", "cov_base", "n_cov", "s_base", "s_high", "x")


class WalkEraConfig:
    """One simulation program's layout: the sizes and offsets of
    CFG_FIELDS (an absent tail's offset is -1) and the lengths of the
    params and of the whole state vector; the kernel takes the
    CFG_FIELDS values by pointer."""

    def __init__(self, S: int, A: int, P: int, B: int, cov: bool, sample_k: int, s_high: int):
        self.S, self.A, self.P, self.B = S, A, P, B
        self.n_cov = A + P + DEPTH_CAP if cov else 0
        self.cov_base = P_LEN + 2 * P if cov else -1
        self.sk2 = slab_entries(sample_k) if sample_k else 0
        self.s_base = P_LEN + 2 * P + self.n_cov if sample_k else -1
        self.s_high = s_high if sample_k else 0
        self.plen = P_LEN + 2 * P + self.n_cov + (4 + (4 + S) * self.sk2 if sample_k else 0)
        self.x = self.plen
        self.length = self.plen + X_LEN
        self._array = (ctypes.c_longlong * len(CFG_FIELDS))(*(getattr(self, n) for n in CFG_FIELDS))

    @property
    def ptr(self) -> int:
        return ctypes.addressof(self._array)


def _gate(c: WalkEraConfig, s: list) -> None:
    x = c.x
    rec = s[x + X_REC]
    fin = (rec & s[P_FIN_ANY]) != 0 or (
        s[P_FIN_ALL_EN] != 0 and (rec & s[P_FIN_ALL]) == s[P_FIN_ALL]
    )
    target = s[P_TARGET_GEN]
    is_open = (
        s[x + X_STEPS] < s[P_MAX_STEPS] and not fin
        and (target == 0 or s[P_GEN0] + s[x + X_GEN] < target)
        and (c.s_base < 0 or s[x + X_OCC] <= c.s_high)
    )
    if is_open and s[x + X_FROZEN] >= c.B:
        s[x + X_STEPS] = s[P_MAX_STEPS]
        is_open = False
    s[x + X_OPEN] = int(is_open)


def walk_era_plain(mode: int, c: WalkEraConfig, state, era_in=None, hseen=None, plen=None) -> None:
    s = state.tolist()
    x = c.x
    if mode == BEGIN:
        hseen.zero_()
        plen.zero_()
        if c.cov_base >= 0:
            s[c.cov_base:c.cov_base + c.n_cov] = [0] * c.n_cov
        head = era_in.tolist()
        s[:P_LEN] = head[:P_LEN]
        if c.s_base >= 0:
            s[c.s_base:c.s_base + 2] = head[P_LEN:P_LEN + 2]
        s[x + X_GEN] = s[x + X_OCC] = s[x + X_MAXD] = s[x + X_FROZEN] = 0
        s[x + X_REC] = s[P_REC]
        s[x + X_STEPS] = s[x + X_RUN] = 0
        _gate(c, s)
    elif mode == COMMIT:
        if not s[x + X_OPEN]:
            return
        s[x + X_STEPS] += 1
        s[x + X_RUN] += 1
        _gate(c, s)
    elif mode == EPILOGUE:
        P = c.P
        rec = s[P_REC]
        if P:
            # The shortest first hit, the first walk on ties (argmin).
            sel = torch.where(hseen, plen, M32).argmin(1)
            walks = sel.tolist()
            lens = plen.gather(1, sel[:, None]).view(-1).tolist()
            found = hseen.any(1).tolist()
            for i in range(P):
                s[P_LEN + i] = walks[i]
                s[P_LEN + P + i] = lens[i] & M32
                if found[i]:
                    rec |= 1 << i
        s[P_REC] = rec
        s[P_GEN0] = s[P_GEN] = (s[P_GEN0] + s[x + X_GEN]) & M32
        s[P_STEPS] = s[x + X_STEPS] & M32
        s[P_MAXD] = s[x + X_MAXD] & M32
        if c.s_base >= 0:
            s[c.s_base + 2] = s[x + X_OCC] & M32
            s[c.s_base + 3] = 0
    else:
        raise ValueError(f"unknown walk era mode {mode}")
    state.copy_(torch.tensor(s, dtype=torch.int64))


def walk_era(mode: int, c: WalkEraConfig, state, era_in=None, hseen=None, plen=None,
             handle: int = 0) -> None:
    """One launch of K13f on the simulation era's state vector (int64,
    the JAX params_out words then the X_* words), in place. BEGIN takes
    the era's inputs from `era_in` (int64 [IN_LEN]: the head words and
    the sample threshold), zeroes the era's counts, its first-hit lanes
    `hseen` (bool [P, B]) and `plen` (int64 [P, B]) and the coverage
    tail, then gates; COMMIT counts the step just run, then gates (an
    era whose walks are all frozen ends with its steps at max_steps);
    EPILOGUE writes the era's params_out words from the first-hit lanes
    and the counts (the sample rows are K13d's). `handle` (a CUDA graph's
    conditional handle, or 0) receives the gate. On CPU tensors the plain
    version runs."""
    tensors = [state] + [t for t in (era_in, hseen, plen) if t is not None]
    if not kernels.on_card(*tensors):
        return walk_era_plain(mode, c, state, era_in, hseen, plen)
    if c.P > 32:
        raise ValueError("the walk-era kernel takes at most 32 properties")
    p = kernels.ptr

    def opt(t):
        return None if t is None else p(t)

    kernels.WALK_ERA.launch(mode, c.ptr, p(state), opt(era_in), opt(hseen), opt(plen), int(handle))
