"""The batched random walks of device simulation (K13): the port's
counterpart of the loop body of `stateright_tpu/engines/tpu_simulation.py`
(`_build_sim_loop`, :77).

Walk state is structure-of-arrays on the engine's device:

- ``walk`` int64 [S + 4, B]: the S state lanes of the walks' current
  states, then the lanes ``seed``, ``ptr`` (the path length), ``ebits``
  (the eventually bits still open) and ``frozen`` (0 or 1), all holding
  uint32 values;
- ``path`` int64 [B, L]: each walk's fingerprint path, one packed word
  ``h1 << 32 | h2`` a slot (`visited_set.pack64`). Only the slots below
  ``ptr`` are ever read (by the cycle test and by the discovery harvest),
  so a restart resets ``ptr`` and never clears the row: the JAX loop's
  [B, L] multiply by ``keep_row`` (:373-375, :403-404) has no
  counterpart here;
- ``stats`` int64 [5]: the era's ``gen`` (counted walks), the sample
  slab's ``occupied``, ``rec_acc`` (the recorded-property bits),
  ``maxd`` (the longest path seen) and ``frozen`` (the walks frozen this
  era), which the era's gate reads after every step (K13f,
  ops/walk_era.py: they are words of the era's state vector);
- ``hseen`` bool [P, B] and ``plen`` int64 [P, B]: per property and walk,
  hit this era, and the path length at its first hit;
- ``cov`` int64 [A + P + DEPTH_CAP]: per-action taken counts,
  per-property hit counts and the depth histogram of the era.

One step is K1 (`fingerprint.hash_lanes`), `record` (K13a), `capture`
(K13c, when sampling), the model's properties and `step_lanes` in torch,
and `step` (K13b); the era ends with `slab_bottom_k` (K13d). Each wrapper
launches its kernel (kernels/csrc) on CUDA tensors and runs its plain
torch version on CPU tensors; the walks draw their choices from `prng`,
the integer hash written out in the JAX loop (:131-135), so the port
takes the same walks as the JAX engine, bit for bit.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..core import Expectation
from ..fingerprint import mul32
from .visited_set import compact_ids, pack64

M32 = 0xFFFFFFFF
CHOOSE_MUL = 0x9E3779B9
RESTART_ADD = 0x6A09E667
# stats slots
GEN, OCC, REC, MAXD, FROZEN = range(5)


def prng(x: torch.Tensor) -> torch.Tensor:
    """The JAX loop's splitmix-style avalanche over uint32 values held in
    int64 (tpu_simulation.py:131-135); the multiplies go through `mul32`,
    since a plain int64 product would overflow."""
    x = mul32(x ^ (x >> 16), 0x7FEB352D)
    x = mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def seed_walks(master: int, B: int, inits: torch.Tensor, init_ebits: int) -> torch.Tensor:
    """The walk lanes of `seed_run` (tpu_simulation.py:536): per-walk seeds
    prng(master ^ (i * 0x9E3779B9)), walk 0 on the master seed itself, each
    walk on init row prng(seed) % n_init. inits int64 [S, n_init]."""
    dev = inits.device
    S, n_init = inits.shape
    master &= M32
    iota = torch.arange(B, dtype=torch.int64, device=dev)
    seeds = prng(master ^ mul32(iota, CHOOSE_MUL))
    seeds[0] = master
    rows = inits.index_select(1, prng(seeds) % n_init)
    walk = torch.zeros((S + 4, B), dtype=torch.int64, device=dev)
    walk[:S] = rows
    walk[S] = seeds
    walk[S + 2] = init_ebits
    return walk


def prop_masks(props):
    """(eventually, always) bitmasks over the property indices; the rest
    are sometimes-properties."""
    ev = sum(1 << i for i, p in enumerate(props) if p.expectation == Expectation.EVENTUALLY)
    al = sum(1 << i for i, p in enumerate(props) if p.expectation == Expectation.ALWAYS)
    return ev, al


# -- K13a: cycle test, path record, depth histogram, maxd --------------------

def record_plain(h1, h2, walk, path, stats, dhist):
    S = walk.shape[0] - 4
    B, L = path.shape
    ptr = walk[S + 1]
    key = pack64(h1, h2)
    below = torch.arange(L, device=path.device)[None, :] < ptr[:, None]
    in_path = ((path == key[:, None]) & below).any(1)
    active = walk[S + 3] == 0
    cycle = active & in_path
    counted = active & ~in_path
    wr = counted & (ptr < L)
    w = wr.nonzero().view(-1)
    path[w, ptr.index_select(0, w)] = key.index_select(0, w)
    ptr += counted.to(torch.int64)
    stats[GEN] += counted.sum()
    stats[MAXD] = torch.maximum(stats[MAXD], ptr.max())
    if dhist is not None:
        dhist.index_add_(0, ptr.clamp(max=dhist.shape[0] - 1), counted.to(torch.int64))
    return counted, cycle


def record(h1, h2, walk, path, stats, dhist=None):
    """Per walk, from its state's fingerprint (h1, h2): is it on the walk's
    own path below ``ptr`` (a cycle)? An active walk that is not cycling is
    counted: it writes the fingerprint at ``ptr`` and ``ptr += 1``. Adds the
    counted walks to ``stats[GEN]``, raises ``stats[MAXD]`` to the longest
    path and, with coverage, bins the counted walks by depth into
    ``dhist`` [DEPTH_CAP]. Updates walk, path, stats and dhist in place;
    returns (counted, cycle), bool [B]."""
    if walk.dtype != torch.int64 or walk.dim() != 2 or walk.shape[0] < 4:
        raise ValueError("walk takes int64 [S + 4, B] lanes")
    if path.dtype != torch.int64 or path.dim() != 2 or path.shape[0] != walk.shape[1]:
        raise ValueError("path takes int64 [B, L] rows, one a walk")
    tensors = [h1, h2, walk, path, stats] + ([dhist] if dhist is not None else [])
    if not kernels.on_card(*tensors):
        return record_plain(h1, h2, walk, path, stats, dhist)
    B, L = path.shape
    S = walk.shape[0] - 4
    h1, h2 = h1.contiguous(), h2.contiguous()
    counted = torch.empty(B, dtype=torch.bool, device=walk.device)
    cycle = torch.empty(B, dtype=torch.bool, device=walk.device)
    kernels.WALK_RECORD.launch(
        kernels.ptr(h1), kernels.ptr(h2), kernels.ptr(walk), S, B,
        kernels.ptr(path), L, kernels.ptr(counted), kernels.ptr(cycle),
        kernels.ptr(stats), kernels.ptr(dhist) if dhist is not None else None,
        dhist.shape[0] if dhist is not None else 0,
    )
    return counted, cycle


# -- K13b: properties, first hits, freezing, the choice, advance/restart -----

def _restart_lanes(walk, restart, inits, init_ebits):
    S = walk.shape[0] - 4
    seed = walk[S]
    seed2 = prng((seed + RESTART_ADD) & M32)
    rows = inits.index_select(1, prng(seed2) % inits.shape[1])
    walk[:S] = torch.where(restart, rows, walk[:S])
    walk[S] = torch.where(restart, seed2, seed)
    walk[S + 1] = torch.where(restart, 0, walk[S + 1])
    walk[S + 2] = torch.where(restart, init_ebits, walk[S + 2])


def step_plain(walk, counted, cycle, checks, ev_mask, al_mask, valid, succ,
               inits, init_ebits, L, hseen, plen, stats, cov):
    S = walk.shape[0] - 4
    P, A = checks.shape[0], valid.shape[0]
    seed, ptr, ebits = walk[S], walk[S + 1], walk[S + 2]
    active = walk[S + 3] == 0
    hits = [None] * P
    eslot = {}
    for i in range(P):
        if (ev_mask >> i) & 1:
            eslot[i] = len(eslot)
            ebits = torch.where(checks[i] & counted, ebits & ~(1 << eslot[i]), ebits)
        elif (al_mask >> i) & 1:
            hits[i] = counted & ~checks[i]
        else:
            hits[i] = counted & checks[i]
    ne = valid.sum(0)
    terminal = counted & (ne == 0)
    capped = counted & (ptr >= L)
    ended = terminal | cycle
    for i, e in eslot.items():
        hits[i] = ended & (((ebits >> e) & 1) != 0)
    newly = torch.zeros_like(counted)
    for i in range(P):
        first = hits[i] & ~hseen[i]
        plen[i] = torch.where(first, ptr, plen[i])
        hseen[i] |= hits[i]
        n = hits[i].sum()
        stats[REC] |= (n > 0).to(torch.int64) << i
        if cov is not None:
            cov[A + i] += n
        newly |= first

    stats[FROZEN] += newly.sum()
    r = prng(seed ^ mul32(ptr, CHOOSE_MUL))
    pick = torch.where(ne > 0, r % ne.clamp(min=1), 0)
    vi = valid.to(torch.int64)
    sel = valid & ((vi.cumsum(0) - vi) == pick)  # the pick-th valid action
    a_star = sel.to(torch.int8).argmax(0)
    new_rows = succ.gather(0, a_star.view(1, 1, -1).expand(1, S, -1))[0] & M32
    advance = counted & ~terminal & ~capped & ~newly
    restart = active & ~newly & (cycle | terminal | capped)
    if cov is not None:
        cov[:A] += (sel & advance).sum(1)
    walk[:S] = torch.where(advance, new_rows, walk[:S])
    walk[S + 2] = ebits
    walk[S + 3] |= newly.to(torch.int64)
    _restart_lanes(walk, restart, inits, init_ebits)


def step(walk, counted, cycle, checks, ev_mask, al_mask, valid, succ,
         inits, init_ebits, L, hseen, plen, stats, cov=None):
    """The rest of one walk step (tpu_simulation.py:268-380), per walk:
    property evaluation on its current state (checks bool [P, B], the raw
    predicates; eventually bits clear on satisfaction, always and sometimes
    give hits), the terminal and capped tests over the valid successors
    (valid bool [A, B]), eventually hits at a walk's end, first hits
    (``plen`` = ``ptr``, ``hseen``, the hit counts and ``stats[REC]``)
    that freeze the walk (counted in ``stats[FROZEN]``), the PRNG choice of the pick-th valid successor
    (succ int64 [A, S, B]), and the advance or the restart on an init row
    (inits int64 [S, n_init]). Updates walk, hseen, plen, stats and cov
    in place."""
    tensors = [walk, counted, cycle, checks, valid, succ, inits, hseen, plen, stats]
    if cov is not None:
        tensors.append(cov)
    if not kernels.on_card(*tensors):
        return step_plain(walk, counted, cycle, checks, ev_mask, al_mask, valid, succ,
                          inits, init_ebits, L, hseen, plen, stats, cov)
    S, B = walk.shape[0] - 4, walk.shape[1]
    P, A = checks.shape[0], valid.shape[0]
    if A > 64 or P > 32:
        raise ValueError("the walk-step kernel takes at most 64 actions and 32 properties")
    if (succ.shape != (A, S, B) or checks.shape[1] != B or valid.shape[1] != B
            or checks.dtype != torch.bool or valid.dtype != torch.bool
            or hseen.dtype != torch.bool or succ.dtype != torch.int64):
        raise ValueError("walk step: mismatched shapes or types")
    args = [t.contiguous() for t in (checks, valid, succ, inits)]
    kernels.WALK_STEP.launch(
        kernels.ptr(walk), S, B, L, kernels.ptr(args[0]), P, ev_mask, al_mask,
        kernels.ptr(args[1]), A, kernels.ptr(args[2]), kernels.ptr(args[3]),
        inits.shape[1], init_ebits, kernels.ptr(counted), kernels.ptr(cycle),
        kernels.ptr(hseen), kernels.ptr(plen), kernels.ptr(stats),
        kernels.ptr(cov) if cov is not None else None,
    )


def restart_frozen_plain(walk, inits, init_ebits):
    S = walk.shape[0] - 4
    frozen = walk[S + 3] != 0
    _restart_lanes(walk, frozen, inits, init_ebits)
    walk[S + 3] = 0


def restart_frozen(walk, inits, init_ebits):
    """The era prologue (tpu_simulation.py:394-405): walks that arrive
    frozen restart on an init row with an evolved seed, and thaw. The
    walk-step kernel's second entry point; updates walk in place."""
    if not kernels.on_card(walk, inits):
        return restart_frozen_plain(walk, inits, init_ebits)
    S, B = walk.shape[0] - 4, walk.shape[1]
    inits = inits.contiguous()
    kernels.WALK_PROLOGUE.launch(
        kernels.ptr(walk), S, B, kernels.ptr(inits), inits.shape[1], init_ebits,
    )


# -- K13c: sample capture into the slab ---------------------------------------

def empty_walk_slab(S: int, scap: int, device) -> torch.Tensor:
    """Sample slab lanes int64 [3 + S, scap + 1]: fp1, fp2, depth and the S
    state lanes; row scap takes out-of-range writes."""
    return torch.zeros((3 + S, scap + 1), dtype=torch.int64, device=device)


def capture_plain(slab, stats, counted, h1, h2, walk, thresh):
    S, B = walk.shape[0] - 4, walk.shape[1]
    scap = slab.shape[1] - 1
    t1, t2 = thresh[0], thresh[1]
    below = counted & ((h1 < t1) | ((h1 == t1) & (h2 < t2)))
    cids, cvalid, n_c = compact_ids(below, B)
    pos = stats[OCC] + torch.arange(B, dtype=torch.int64, device=h1.device)
    widx = torch.where(cvalid & (pos < scap), pos, scap)
    src = torch.cat([h1[None], h2[None], walk[S + 1:S + 2], walk[:S]])
    slab.index_copy_(1, widx[cvalid], src.index_select(1, cids[cvalid]))
    stats[OCC] += n_c


def capture(slab, stats, counted, h1, h2, walk, thresh) -> None:
    """Append the counted walks whose fingerprint is below the threshold
    (t1, t2) = thresh[0..1] (int64 [2] on the walks' device: the era's
    state vector holds it), lexicographically and unsigned, to the slab
    at ``stats[OCC]``, in walk order, with their depth (``ptr``) and state
    lanes (tpu_simulation.py:219-252); ``stats[OCC]`` counts them.
    Updates slab and stats in place."""
    if not kernels.on_card(slab, stats, counted, h1, h2, walk, thresh):
        return capture_plain(slab, stats, counted, h1, h2, walk, thresh)
    S, B = walk.shape[0] - 4, walk.shape[1]
    if slab.shape[0] != 3 + S or counted.dtype != torch.bool:
        raise ValueError("capture: the slab must hold 3 + S lanes; counted is bool")
    if S + 3 > 40:
        raise ValueError("the capture kernel appends at most 40 lanes (S <= 37)")
    h1, h2 = h1.contiguous(), h2.contiguous()
    scratch = kernels.capture_scratch(B, walk.device)
    kernels.WALK_CAPTURE.launch(
        kernels.ptr(counted), kernels.ptr(h1), kernels.ptr(h2), kernels.ptr(walk),
        S, B, kernels.ptr(thresh), kernels.ptr(slab), slab.shape[1] - 1,
        kernels.ptr(stats), kernels.ptr(scratch), scratch.shape[0],
    )


# -- K13d: the slab epilogue: dedup, then the bottom sk2 by fp1 ---------------

def slab_bottom_k_plain(slab, stats, sk2: int):
    scap = slab.shape[1] - 1
    dev = slab.device
    occ = min(int(stats[OCC]), scap)
    key = pack64(slab[0, :occ], slab[1, :occ])
    ok = torch.zeros(scap, dtype=torch.bool, device=dev)
    if occ:
        _uniq, inv = torch.unique(key, return_inverse=True)
        idx = torch.arange(occ, device=dev)
        first = torch.full((int(inv.max()) + 1,), occ, dtype=torch.int64, device=dev)
        first.scatter_reduce_(0, inv, idx, reduce="amin")
        ok[:occ] = first.index_select(0, inv) == idx
    skey = torch.where(ok, (~slab[0, :scap]) & M32, 0)
    # Stable descending sort: equal keys keep the lower row first, the
    # order lax.top_k gives.
    top = torch.sort(skey, descending=True, stable=True).indices[:sk2]
    vals = slab.index_select(1, top)
    return torch.where(top < occ, vals, 0), ok.index_select(0, top)


def slab_bottom_k(slab, stats, sk2: int):
    """The era's sample tail (tpu_simulation.py:502-531): over the used
    slab rows, every (fp1, fp2) but its first occurrence is a duplicate;
    of the rest, the sk2 with the smallest fp1, lower row first on ties,
    padded by the other rows in row order — `lax.top_k` of the key
    ``~fp1`` (0 for duplicates and unused rows). Returns (lanes int64
    [3 + S, sk2], ok bool [sk2]); unused rows read as 0."""
    scap = slab.shape[1] - 1
    if not 0 < sk2 <= min(scap, 2048):
        raise ValueError("slab_bottom_k takes 0 < sk2 <= min(scap, 2048)")
    if not kernels.on_card(slab, stats):
        return slab_bottom_k_plain(slab, stats, sk2)
    dev = slab.device
    lanes = slab.shape[0]
    out = torch.empty((lanes, sk2), dtype=torch.int64, device=dev)
    ok = torch.empty(sk2, dtype=torch.bool, device=dev)
    tsize = 1 << (2 * scap - 1).bit_length()
    table = torch.full((tsize,), 0x7FFFFFFF, dtype=torch.int32, device=dev)
    rowok = torch.empty(scap, dtype=torch.bool, device=dev)
    tile = 4096
    n_cand = -(-scap // tile) * sk2
    scratch = torch.empty(2 * max(n_cand, 1), dtype=torch.int64, device=dev)
    kernels.WALK_SLAB.launch(
        kernels.ptr(slab), lanes, scap, kernels.ptr(stats), sk2,
        kernels.ptr(table), tsize, kernels.ptr(rowok), kernels.ptr(scratch),
        n_cand, kernels.ptr(out), kernels.ptr(ok),
    )
    return out, ok
