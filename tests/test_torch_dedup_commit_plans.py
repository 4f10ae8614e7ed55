"""K3's in-batch dedup (claim_dedup.cu) and K15f's COMMIT grid
(mesh_era.cu srt_mesh_commit), transcribed here block by block and held
against their plain versions and the JAX functions, bit for bit.

K3: CLAIM's atomics in a random order over the tiles of each lane's
valid prefix, then KEEP (the epoch raised once CLAIM's grid is done),
several calls on one scratch so that stale epochs and stale winners stay
in it; every call against the JAX `claim_dedup` (and its vmap) of
`valid & index < n_val`, with prefixes of 0, partial and the full width;
and the tiles past a prefix shown not to read a key.

K15f's COMMIT: the grid's blocks in a random order (the insert-mask
tiles with the owner's depth histogram, the hit tiles with the first-hit
lanes and the hit-or-seen counts, the valid tiles), the accumulators in
the scratch, the grid's ticket, and the last block's staged C1, C2 and
CGATE; on one rank, and across ranks (the grid's C1 alone, the sums
reduced, the C2 launch, the sums reduced, CGATE), held against the new
plain COMMIT (ops/mesh_era.py), which is held against the step's glue
as the mesh ran it before the fold (torch launches before the COMMIT)
followed by that COMMIT, on clean, overflowing, vetoed and closed-gate
steps. (The plain COMMIT against the JAX sharded step, word for word
through whole eras: tests/test_torch_mesh.py.)

Each transcription takes a `mutate` argument that breaks one thing the
kernel relies on (K3: the slot tag's 64-bit compare, the epoch's rise;
K15f: the ticket, the histogram's clamp); a test shows each mutant
disagrees. Tolerance: exact equality throughout.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.ops import frontier as jfr
from stateright_tpu_torch.obs.coverage import DEPTH_CAP
from stateright_tpu_torch.obs.sample import slab_high_water
from stateright_tpu_torch.ops import frontier as fr
from stateright_tpu_torch.ops import mesh_era as me

M32 = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

K3_TILE = 256  # claim_dedup.cu kThreads: a block's candidates, a thread each


def _slot(a, b, cap):
    return (int(a) ^ ((int(b) * 0x9E3779B9) & M32)) & (cap - 1)


def _k3_transcribed(scratch, h1, h2, valid, n_val, cap, seed, mutate=None, reads=None):
    """claim_dedup.cu on [N, n] candidates with `scratch` (a list of N *
    cap slots, then the epoch word; updated in place): CLAIM's atomicMax
    of every valid prefix candidate in an order drawn from `seed`, then
    KEEP block by block in another. `reads` collects the (lane, tile)
    blocks that read a key. Returns keep [N, n]."""
    N, n = h1.shape
    tiles = -(-n // K3_TILE)
    ep = N * cap
    lim = [n if n_val is None else min(max(int(n_val[l]), 0), n) for l in range(N)]
    order = random.Random(seed)
    # CLAIM: a block past the prefix exits at once.
    tag = ((scratch[ep] + 1) & M32) << 32
    atomics = []
    for l in range(N):
        for tile in range(tiles):
            lo = tile * K3_TILE
            if lo >= lim[l]:
                continue
            if reads is not None:
                reads.add((l, tile))
            for i in range(lo, min(lo + K3_TILE, lim[l])):
                if valid[l, i]:
                    atomics.append((l * cap + _slot(h1[l, i], h2[l, i], cap), tag | (i + 1)))
    order.shuffle(atomics)
    for at, v in atomics:
        if mutate == "compare":  # the low word alone: the index, not the epoch
            scratch[at] = v if (v & M32) > (scratch[at] & M32) else scratch[at]
        else:
            scratch[at] = max(scratch[at], v)
    # KEEP: block (0, 0) raises the epoch after CLAIM's grid.
    if mutate != "epoch":
        scratch[ep] += 1
    keep = np.zeros((N, n), dtype=bool)
    blocks = [(l, tile) for l in range(N) for tile in range(tiles)]
    order.shuffle(blocks)
    for l, tile in blocks:
        lo = tile * K3_TILE
        if lo >= lim[l]:
            continue  # keep = false, no key read
        if reads is not None:
            reads.add((l, tile))
        for i in range(lo, min(lo + K3_TILE, lim[l])):
            if valid[l, i]:
                w = (scratch[l * cap + _slot(h1[l, i], h2[l, i], cap)] & M32) - 1
                keep[l, i] = w == i or h1[l, w] != h1[l, i] or h2[l, w] != h2[l, i]
    return keep


def _jax_dedup(h1, h2, valid, n_val, cap):
    """The JAX claim_dedup under jax.vmap of valid & index < n_val."""
    n = h1.shape[1]
    pre = valid & (np.arange(n)[None, :] < np.asarray(n_val)[:, None])
    out = jax.vmap(lambda a, b, v: jfr.claim_dedup(a, b, v, cap))(
        jnp.asarray(h1.astype(np.uint32)), jnp.asarray(h2.astype(np.uint32)), jnp.asarray(pre))
    return np.asarray(out)


def _k3_calls(N, n, cap, seed):
    """A run of calls on one scratch: keys from a small pool (duplicates in
    a lane, slots shared across calls), prefixes from 0 to the full width,
    a wide call first so that later calls find stale higher winners."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 32, size=(2, max(4, n // 6)))
    calls = []
    for call in range(4):
        pick = rng.integers(0, pool.shape[1], size=(N, n))
        h1, h2 = pool[0, pick].astype(np.int64), pool[1, pick].astype(np.int64)
        h1[:, :8] = 5
        h2[:, :8] = np.arange(8)  # one h1, several h2: slots contended across keys
        valid = rng.random((N, n)) < 0.85
        if call == 0:
            n_val = np.full(N, n)
        else:
            n_val = rng.integers(0, n + 1, size=N)
            n_val[0] = 0
            n_val[-1] = n + 7  # past the width: the whole width
            if N > 2:
                n_val[1] = n
        calls.append((h1, h2, valid, n_val))
    return calls


K3_CASES = [(1, 5000, 1 << 10), (3, 4097, 1 << 12), (4, 2048, 1 << 9), (2, 300, 1 << 6), (5, 16, 4)]


@pytest.mark.parametrize("N,n,cap", K3_CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_k3_blocks_on_one_scratch_equal_the_jax_dedup(N, n, cap, seed):
    scratch = [0] * (N * cap + 1)
    for h1, h2, valid, n_val in _k3_calls(N, n, cap, seed):
        reads = set()
        keep = _k3_transcribed(scratch, h1, h2, valid, n_val, cap, seed, reads=reads)
        want = _jax_dedup(h1, h2, valid, np.minimum(n_val, n), cap)
        assert np.array_equal(keep, want)
        # The plain version (the CPU path) is the same function.
        plain = fr.claim_dedup_lanes_plain(torch.from_numpy(h1), torch.from_numpy(h2), torch.from_numpy(valid),
                                           cap, torch.from_numpy(n_val))
        assert np.array_equal(plain.numpy(), want)
        # A block past its lane's prefix reads no key.
        assert all(tile * K3_TILE < min(n_val[l], n) for l, tile in reads)
    assert scratch[N * cap] == 4  # the epoch rose once a call


@pytest.mark.parametrize("n_val", [0, 1, 2999, 3000, 4000])
def test_k3_solo_plain_takes_a_prefix(n_val):
    rng = np.random.default_rng(n_val)
    pick = rng.integers(0, 400, size=3000)
    h1, h2 = (torch.from_numpy(rng.integers(0, 1 << 32, size=400)[pick]) for _ in range(2))
    valid = torch.from_numpy(rng.random(3000) < 0.9)
    got = fr.claim_dedup(h1, h2, valid, 1 << 11, torch.tensor(n_val))
    pre = valid & (torch.arange(3000) < n_val)
    want = jfr.claim_dedup(jnp.asarray(h1.numpy().astype(np.uint32)), jnp.asarray(h2.numpy().astype(np.uint32)),
                           jnp.asarray(pre.numpy()), 1 << 11)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(fr.claim_dedup_plain(h1, h2, valid, 1 << 11, torch.tensor(n_val)), got)


@pytest.mark.parametrize("mutate", ["compare", "epoch"])
def test_k3_mutants_disagree_with_the_jax_dedup(mutate):
    N, n, cap = 3, 4097, 1 << 12
    scratch = [0] * (N * cap + 1)
    wrong = 0
    for h1, h2, valid, n_val in _k3_calls(N, n, cap, 0):
        keep = _k3_transcribed(scratch, h1, h2, valid, n_val, cap, 0, mutate=mutate)
        wrong += int((keep != _jax_dedup(h1, h2, valid, np.minimum(n_val, n), cap)).sum())
    assert wrong > 0


# ---------------------------------------------------------------------------
# K15f's COMMIT
# ---------------------------------------------------------------------------

COMMIT_THREADS, RUN = 256, 16  # mesh_era.cu kCommitThreads, fold::kRun
COMMIT_TILE = COMMIT_THREADS * RUN
SAMPLE_K = 64


def _mesh_cfg(C, A, P, R, fuse=4):
    cov = True
    plen = me.shard_params_len(A, P, cov, SAMPLE_K, fuse)
    ncov = me.cov_len(A, P)
    nsamp = me.sample_tail_len(SAMPLE_K)
    s_high = slab_high_water(SAMPLE_K)
    return me.MeshConfig(
        chunk=C, qmask=(1 << 12) - 1, P=P, A=A, cov_base=me.P_LEN, s_base=me.P_LEN + ncov, s_high=s_high,
        f_base=me.P_LEN + ncov + nsamp, fuse=fuse, d_base=plen, x=plen + 3 * P, regrow=max(1, C // 16),
        budget_min=me.BUDGET_MIN, n_cov=ncov, scap=s_high + R, sum_cov=me.S_GATE + 4 + P, vcap=C * A // 3,
    )


def _mesh_rows(rng, c, N, closed=False, take=None, count=None):
    L = c.x + me.X_LEN
    s = rng.integers(0, 1 << 20, size=(N, L)).astype(np.int64)
    cnt = rng.integers(0, 3 * c.chunk, size=N) if count is None else np.full(N, count)
    for l in range(N):
        s[l, :me.P_LEN] = [int(rng.integers(0, 1 << 12)), cnt[l], 10 ** 6, 0, M32, 2 * 10 ** 6, 1 << 11, 64,
                           5, 7, 2, 0, c.chunk, 1 << (c.P - 1) if c.P else 0, 0, 0, 64]
    s[:, c.cov_base:c.cov_base + c.n_cov] = rng.integers(0, 1 << 20, size=(N, c.n_cov))
    s[:, c.x + me.X_ITS] = s[:, c.x + me.X_ESTEPS] = 3
    s[:, c.x + me.X_REC0] = 0
    s[:, c.x + me.X_OPEN] = 0 if closed else 1
    s[:, c.x + me.X_TAKE] = np.minimum(cnt, c.chunk) if take is None else take
    return s


def _mesh_ops(rng, c, N, R, ovf=0.0, unres=0.0, deep=0.2, n_val_over=0.0):
    C, A, P = c.chunk, c.A, c.P
    depth_rows = rng.integers(1, 40, size=N * C)
    rdepth = rng.integers(1, 40, size=(N, R))
    far = rng.random((N, R)) < deep
    rdepth[far] = rng.integers(DEPTH_CAP - 3, DEPTH_CAP + 40, size=int(far.sum()))  # at and past the last bin
    n_val = rng.integers(0, c.vcap + 1, size=N)
    n_val[rng.random(N) < n_val_over] = c.vcap + 1
    return me.MeshOperands(
        is_new=torch.from_numpy(rng.random((N, R)) < 0.4),
        unresolved=torch.from_numpy(rng.random((N, R)) < unres),
        rdepth=torch.from_numpy(rdepth),
        n_ovf=torch.from_numpy(np.where(rng.random(N) < ovf, rng.integers(1, 9, size=N), 0)),
        n_val=torch.from_numpy(n_val),
        hits=[torch.from_numpy(rng.random(N * C) < 0.05) for _ in range(P)],
        valid=torch.from_numpy(rng.random(A * N * C) < 0.3),
        rows=(torch.from_numpy(rng.integers(0, 1 << 32, size=N * C)),
              torch.from_numpy(rng.integers(0, 1 << 32, size=N * C)), torch.from_numpy(depth_rows)),
        hseen=torch.from_numpy(rng.random((P, N * C)) < 0.02),
        facc1=torch.from_numpy(rng.integers(0, 1 << 32, size=(P, N * C))),
        facc2=torch.from_numpy(rng.integers(0, 1 << 32, size=(P, N * C))),
        faccd=torch.from_numpy(rng.integers(1, 9, size=(P, N * C))),
        slab_counts=torch.from_numpy(rng.integers(0, 700, size=(N, 2))),
    )


def _clone_ops(o):
    return o._replace(
        hits=[h.clone() for h in o.hits], rows=tuple(r.clone() for r in o.rows),
        **{f: getattr(o, f).clone() for f in ("is_new", "unresolved", "rdepth", "n_ovf", "n_val", "valid",
                                              "hseen", "facc1", "facc2", "faccd", "slab_counts")})


def _gate(c, sums, s, xw):
    """mesh_era.cu gate on a shard's params `s` and X words `xw`."""
    g = sums[me.S_GATE:]
    rec = xw[me.X_REC0]
    for p in range(c.P):
        if g[3 + p] > 0:
            rec |= 1 << p
    fin = (rec & s[me.P_FIN_ANY]) != 0 or (s[me.P_FIN_ALL_EN] != 0 and (rec & s[me.P_FIN_ALL]) == s[me.P_FIN_ALL])
    is_open = (g[0] > 0 and g[1] == 0 and g[2] == 0 and not fin and xw[me.X_ITS] < s[me.P_MAX_STEPS]
               and (c.s_base < 0 or g[3 + c.P] == 0))
    take = min(s[me.P_COUNT], c.chunk, s[me.P_TAKE_CAP]) if is_open and s[me.P_COUNT] > 0 else 0
    xw[me.X_OPEN], xw[me.X_TAKE] = int(is_open), take
    xw[me.X_TAIL] = (s[me.P_HEAD] + s[me.P_COUNT]) & c.qmask


def _commit_phases(c, rows, sums, scratch, o, c1, c2, cgate):
    """mesh_era.cu commit_phases: the shards' scalars and accumulators
    staged, C1 (thread 0), C2 (a thread a shard, then the coverage words),
    the gate partials, CGATE, the rows written back, the scratch zeroed
    after C2."""
    N = rows.shape[0]
    P, A, x = c.P, c.A, c.x
    W = 4 + 2 * P + A
    st = [list(rows[l, :me.P_LEN]) + list(rows[l, x:x + me.X_LEN]) for l in range(N)]
    acc = [[int(v) for v in scratch[l * W:(l + 1) * W]] for l in range(N)]
    n_ovf, n_val = o.n_ovf.tolist(), o.n_val.tolist()
    occ = o.slab_counts[:, 0].tolist()
    X = me.P_LEN
    is_open = st[0][X + me.X_OPEN] != 0
    if is_open and c1:
        for l in range(N):
            st[l][X + me.X_NEW], st[l][X + me.X_UNRES] = acc[l][1], acc[l][0]
        sums[me.S_UNRES] = sum(a[0] for a in acc)
        sums[me.S_SHRINK] = sum(int(s[X + me.X_TAKE] > 1) for s in st)
    if is_open and c2:
        g_unres, g_shrink = sums[me.S_UNRES], sums[me.S_SHRINK]
        ovf, consumed = [], []
        for l, s in enumerate(st):
            take, nw = s[X + me.X_TAKE], s[X + me.X_NEW]
            pred = s[me.P_COUNT] > 0
            if g_shrink == 0:
                s[me.P_ERR] = (s[me.P_ERR] + g_unres) & M32
            o_ = n_ovf[l] > 0 or n_val[l] > c.vcap or g_unres > 0
            k = 0 if o_ else take
            s[me.P_HEAD] = (s[me.P_HEAD] + k) & c.qmask
            s[me.P_COUNT] = (s[me.P_COUNT] - k + nw) & M32
            s[me.P_UNIQUE] = (s[me.P_UNIQUE] + nw) & M32
            if not o_:
                s[X + me.X_EGEN] = (s[X + me.X_EGEN] + acc[l][2]) & M32
                s[X + me.X_ESTEPS] += int(pred)
                s[me.P_TAKE_CAP] = min(s[me.P_TAKE_CAP] + c.regrow, c.chunk)
            else:
                s[me.P_TAKE_CAP] = max(take >> 1, 1)
            s[X + me.X_ITS] += 1
            s[X + me.X_ITER] += 1
            s[X + me.X_PARTIAL] += int(o_)
            ovf.append(o_)
            consumed.append(k)
        for l in range(N):
            for i in range(A + P + 1):
                if i == A + P:
                    add = consumed[l]
                elif ovf[l]:
                    continue
                else:
                    add = acc[l][4 + 2 * P + i] if i < A else acc[l][4 + i - A]
                rows[l, c.cov_base + i] = (rows[l, c.cov_base + i] + add) & M32
        g = [0] * (4 + P)
        for l, s in enumerate(st):
            g[0] += int(s[me.P_COUNT] > 0)
            g[1] += int(s[me.P_COUNT] > s[me.P_HIGH_WATER] or s[me.P_UNIQUE] > s[me.P_GROW_LIMIT])
            g[2] += int(s[me.P_ERR] > 0)
            for p in range(P):
                g[3 + p] += int(acc[l][4 + P + p] != 0)
            if c.s_base >= 0:
                g[3 + P] += int(occ[l] > c.s_high)
        sums[me.S_GATE:me.S_GATE + 4 + P] = g
    if is_open and cgate:
        for s in st:
            xw = s[X:]
            _gate(c, sums, s, xw)
            s[X:] = xw
    if is_open and (c1 or c2 or cgate):
        for l, s in enumerate(st):
            rows[l, :me.P_LEN] = s[:X]
            rows[l, x:x + me.X_LEN] = s[X:]
    if c2:
        scratch[:N * W] = 0


def _commit_grid(c, rows, sums, scratch, o, seed, final=True, mutate=None):
    """mesh_era.cu srt_mesh_commit over N shards, block by block in an
    order drawn from `seed`: each block's tile folded into its shard's
    accumulators (the histogram into the row), the grid's ticket; the
    last block runs C1 (and, `final`, C2 and CGATE) and zeroes the ticket.
    `rows` [N, L], `scratch`: numpy, in place; the first-hit lanes of `o`
    in place."""
    N = rows.shape[0]
    C, P, A = c.chunk, c.P, c.A
    W = 4 + 2 * P + A
    n = o.is_new.shape[1]
    new, unres, rdepth = o.is_new.numpy(), o.unresolved.numpy(), o.rdepth.numpy()
    hits = [h.numpy() for h in o.hits]
    valid = o.valid.numpy().reshape(A, N, C)
    rh1, rh2, rdep = (r.numpy() for r in o.rows)
    hseen, f1, f2, fd = (t.numpy() for t in (o.hseen, o.facc1, o.facc2, o.faccd))
    t_mask, t_hits, t_valid = -(-n // COMMIT_TILE), -(-(P * C) // COMMIT_TILE), -(-(A * C) // COMMIT_TILE)
    tiles = t_mask + t_hits + t_valid
    dbase = c.cov_base + A + P + 1
    blocks = [(t, l) for l in range(N) for t in range(tiles)]
    random.Random(seed).shuffle(blocks)
    clamp = DEPTH_CAP if mutate == "clamp" else DEPTH_CAP - 1
    last_at = len(blocks) - (2 if mutate == "ticket" else 1)
    for tile, l in blocks:
        a = l * W
        if tile < t_mask:
            lo = tile * COMMIT_TILE
            for e in range(lo, min(lo + COMMIT_TILE, n)):
                scratch[a] += unres[l, e]
                if new[l, e]:
                    scratch[a + 1] += 1
                    rows[l, dbase + min(rdepth[l, e], clamp)] += 1
        elif tile < t_mask + t_hits:
            lo = (tile - t_mask) * COMMIT_TILE
            for e in range(lo, min(lo + COMMIT_TILE, P * C)):
                i, p = divmod(e, C)
                q = l * C + p
                bit, seen = bool(hits[i][q]), bool(hseen[i, q])
                if bit and not seen:
                    f1[i, q], f2[i, q], fd[i, q] = rh1[q], rh2[q], rdep[q]
                    hseen[i, q] = True
                scratch[a + 4 + i] += bit
                scratch[a + 4 + P + i] += bit or seen
        else:
            lo = (tile - t_mask - t_hits) * COMMIT_TILE
            for e in range(lo, min(lo + COMMIT_TILE, A * C)):
                r, p = divmod(e, C)
                if valid[r, l, p]:
                    scratch[a + 2] += 1
                    scratch[a + 4 + 2 * P + r] += 1
        ticket = scratch[N * W]
        scratch[N * W] += 1
        if ticket == last_at:
            _commit_phases(c, rows, sums, scratch, o, True, final, final)
            scratch[N * W] = 0


def _old_glue_then_commit(c, state, sums, o):
    """The mesh step's torch launches before the fold (the first hits, hs,
    pa, generated, the owner's depth histogram) and then its COMMIT (C1,
    C2, CGATE) on those sums, as they ran before the fold: an independent
    copy of that code, kept here as the reference."""
    N, C, P, A, x = state.shape[0], c.chunk, c.P, c.A, c.x
    hits = torch.stack(list(o.hits)) if P else torch.zeros((0, N * C), dtype=torch.bool)
    first = hits & ~o.hseen
    for acc, src in zip((o.facc1, o.facc2, o.faccd), o.rows):
        acc.copy_(torch.where(first, src, acc))
    o.hseen.logical_or_(hits)
    hs = hits.view(P, N, C).sum(2).tolist()
    valid = o.valid.view(A, N, C)
    pa = valid.sum(2).T.tolist()
    gen = valid.sum((0, 2)).tolist()
    lane_dhist = (torch.arange(N) * state.shape[1] + c.cov_base + A + P + 1)[:, None]
    state.view(-1).index_add_(0, (lane_dhist + o.rdepth.clamp(max=DEPTH_CAP - 1)).view(-1),
                              o.is_new.view(-1).to(torch.int64))
    rows = state.tolist()
    sm = sums.tolist()
    if rows[0][x + me.X_OPEN]:
        unres = o.unresolved.sum(1).tolist()
        newc = o.is_new.sum(1).tolist()
        for l, s in enumerate(rows):
            s[x + me.X_NEW], s[x + me.X_UNRES] = newc[l], unres[l]
        sm[me.S_UNRES] = sum(unres)
        sm[me.S_SHRINK] = sum(int(s[x + me.X_TAKE] > 1) for s in rows)
        n_ovf, n_val = o.n_ovf.tolist(), o.n_val.tolist()
        g_unres, g_shrink = sm[me.S_UNRES], sm[me.S_SHRINK]
        for l, s in enumerate(rows):
            take, nw = s[x + me.X_TAKE], s[x + me.X_NEW]
            pred = s[me.P_COUNT] > 0
            if g_shrink == 0:
                s[me.P_ERR] = (s[me.P_ERR] + g_unres) & M32
            ovf = n_ovf[l] > 0 or n_val[l] > c.vcap or g_unres > 0
            k = 0 if ovf else take
            s[me.P_HEAD] = (s[me.P_HEAD] + k) & c.qmask
            s[me.P_COUNT] = (s[me.P_COUNT] - k + nw) & M32
            s[me.P_UNIQUE] = (s[me.P_UNIQUE] + nw) & M32
            if not ovf:
                s[x + me.X_EGEN] = (s[x + me.X_EGEN] + gen[l]) & M32
                s[x + me.X_ESTEPS] += int(pred)
                s[me.P_TAKE_CAP] = min(s[me.P_TAKE_CAP] + c.regrow, c.chunk)
            else:
                s[me.P_TAKE_CAP] = max(take >> 1, 1)
            b = c.cov_base
            if not ovf:
                for i in range(A):
                    s[b + i] = (s[b + i] + pa[l][i]) & M32
                for p in range(P):
                    s[b + A + p] = (s[b + A + p] + hs[p][l]) & M32
            s[b + A + P] = (s[b + A + P] + k) & M32
            s[x + me.X_ITS] += 1
            s[x + me.X_ITER] += 1
            s[x + me.X_PARTIAL] += int(ovf)
        bits = o.hseen.view(P, N, C).any(2).T.tolist() if P else [[] for _ in range(N)]
        occ = o.slab_counts[:, 0].tolist()
        g = [0] * (4 + P)
        for l, s in enumerate(rows):
            g[0] += int(s[me.P_COUNT] > 0)
            g[1] += int(s[me.P_COUNT] > s[me.P_HIGH_WATER] or s[me.P_UNIQUE] > s[me.P_GROW_LIMIT])
            g[2] += int(s[me.P_ERR] > 0)
            for p in range(P):
                g[3 + p] += int(bits[l][p])
            g[3 + P] += int(occ[l] > c.s_high)
        sm[me.S_GATE:me.S_GATE + 4 + P] = g
        for s in rows:
            xw = s[x:x + me.X_LEN]
            _gate(c, sm, s, xw)
            s[x:x + me.X_LEN] = xw
    state.copy_(torch.tensor(rows))
    sums.copy_(torch.tensor(sm))


# (N shards, chunk, actions, properties, receive width R)
COMMIT_SHAPES = [(1, 64, 5, 2, 512), (2, 100, 7, 3, 640), (8, 64, 37, 3, 1024), (8, 16, 21, 4, 8 * 64)]
# (name, rows options, operand options)
COMMIT_CASES = [
    ("clean", {}, {}),
    ("sender overflow", {}, dict(ovf=0.5, n_val_over=0.3)),
    ("veto, takes shrink", {}, dict(unres=0.002)),
    ("veto, takes of 1", dict(take=1, count=1), dict(unres=0.01)),
    ("closed gate", dict(closed=True), {}),
]


def _case(shape, case, seed):
    N, C, A, P, R = shape
    rng = np.random.default_rng(seed + 100 * N + C)
    c = _mesh_cfg(C, A, P, R)
    _name, row_opts, op_opts = case
    rows = _mesh_rows(rng, c, N, **row_opts)
    ops = _mesh_ops(rng, c, N, R, **op_opts)
    sums = torch.from_numpy(rng.integers(0, 1 << 10, size=me.sums_len(A, P, True)))
    return c, rows, ops, sums


def _plain_commit(c, rows, ops, sums):
    st, sm, o = torch.from_numpy(rows.copy()), sums.clone(), _clone_ops(ops)
    me.mesh_era_plain(me.COMMIT, c, st, sm, o)
    return st, sm, o


def _same(a_rows, a_sums, a_ops, b_rows, b_sums, b_ops):
    assert np.array_equal(np.asarray(a_rows), np.asarray(b_rows)), np.argwhere(np.asarray(a_rows) != np.asarray(b_rows))[:6]
    assert list(a_sums) == list(b_sums)
    for f in ("hseen", "facc1", "facc2", "faccd"):
        assert torch.equal(getattr(a_ops, f), getattr(b_ops, f)), f


@pytest.mark.parametrize("shape", COMMIT_SHAPES)
@pytest.mark.parametrize("case", COMMIT_CASES, ids=[c[0] for c in COMMIT_CASES])
def test_new_plain_commit_equals_the_old_glue_and_commit(shape, case):
    c, rows, ops, sums = _case(shape, case, 0)
    want_rows, want_sums, want_ops = torch.from_numpy(rows.copy()), sums.clone(), _clone_ops(ops)
    _old_glue_then_commit(c, want_rows, want_sums, want_ops)
    got_rows, got_sums, got_ops = _plain_commit(c, rows, ops, sums)
    _same(got_rows, got_sums.tolist(), got_ops, want_rows, want_sums.tolist(), want_ops)


@pytest.mark.parametrize("shape", COMMIT_SHAPES)
@pytest.mark.parametrize("case", COMMIT_CASES, ids=[c[0] for c in COMMIT_CASES])
@pytest.mark.parametrize("seed", [0, 1])
def test_k15f_commit_grid_blocks_in_random_orders_equal_the_plain_commit(shape, case, seed):
    c, rows, ops, sums = _case(shape, case, seed)
    N, _C, A, P, _R = shape
    want_rows, want_sums, want_ops = _plain_commit(c, rows, ops, sums)
    scratch = np.zeros(N * (4 + 2 * P + A) + 1, dtype=np.int64)
    got_ops = _clone_ops(ops)
    got_rows, got_sums = rows.copy(), sums.tolist()
    _commit_grid(c, got_rows, got_sums, scratch, got_ops, seed)
    _same(got_rows, got_sums, got_ops, want_rows, want_sums.tolist(), want_ops)
    assert not scratch.any()  # left zero: a replay needs no reset
    # A second step on the same scratch (its ticket and accumulators as
    # the first left them).
    _c, _rows, ops2, _s = _case(shape, case, seed + 7)
    want2 = _plain_commit(c, got_rows, ops2, torch.tensor(got_sums))
    ops2 = _clone_ops(ops2)
    _commit_grid(c, got_rows, got_sums, scratch, ops2, seed + 1)
    _same(got_rows, got_sums, ops2, want2[0], want2[1].tolist(), want2[2])


def _split(o, lo, hi, C):
    """Shards lo..hi of the operands (one rank's)."""
    A = o.valid.numel() // (o.is_new.shape[0] * C)
    N = o.is_new.shape[0]
    cols = slice(lo * C, hi * C)
    return me.MeshOperands(
        is_new=o.is_new[lo:hi].clone(), unresolved=o.unresolved[lo:hi].clone(), rdepth=o.rdepth[lo:hi].clone(),
        n_ovf=o.n_ovf[lo:hi].clone(), n_val=o.n_val[lo:hi].clone(), hits=[h[cols].clone() for h in o.hits],
        valid=o.valid.view(A, N, C)[:, lo:hi].reshape(-1).clone(), rows=tuple(r[cols].clone() for r in o.rows),
        hseen=o.hseen[:, cols].clone(), facc1=o.facc1[:, cols].clone(), facc2=o.facc2[:, cols].clone(),
        faccd=o.faccd[:, cols].clone(), slab_counts=o.slab_counts[lo:hi].clone(),
    )


@pytest.mark.parametrize("case", COMMIT_CASES, ids=[c[0] for c in COMMIT_CASES])
@pytest.mark.parametrize("world", [2, 4])
def test_k15f_commit_across_ranks_equals_one_rank(case, world):
    """The grid's C1 on each rank, the sums all-reduced, the C2 launch,
    the sums all-reduced, CGATE: every shard's row as one rank holding all
    eight commits them."""
    shape = (8, 64, 37, 3, 1024)
    c, rows, ops, sums = _case(shape, case, 3)
    N, C, A, P, _R = shape
    want_rows, want_sums, want_ops = _plain_commit(c, rows, ops, sums)
    nl = N // world
    parts = [(rows[r * nl:(r + 1) * nl].copy(), sums.tolist(), _split(ops, r * nl, (r + 1) * nl, C),
              np.zeros(nl * (4 + 2 * P + A) + 1, dtype=np.int64)) for r in range(world)]

    def all_reduce():
        total = [sum(v) for v in zip(*(p[1] for p in parts))]
        for p in parts:
            p[1][:] = total

    for r, (rw, sm, o, scr) in enumerate(parts):
        _commit_grid(c, rw, sm, scr, o, r, final=False)
        assert scr[-1] == 0  # the ticket reset; the accumulators wait for C2
    all_reduce()
    for rw, sm, o, scr in parts:
        _commit_phases(c, rw, sm, scr, o, False, True, False)
        assert not scr.any()
    all_reduce()
    for i, (rw, sm, o, scr) in enumerate(parts):
        st, t = torch.from_numpy(rw), torch.tensor(sm)
        me.mesh_era_plain((me.PH_CGATE,), c, st, t, o)
        parts[i] = (st.numpy(), t.tolist(), o, scr)
    got = np.concatenate([p[0] for p in parts])
    assert np.array_equal(got, want_rows.numpy())
    if rows[0, c.x + me.X_OPEN]:  # a closed gate writes no sums (its stale ones were reduced)
        for p in parts:
            assert p[1][me.S_GATE:me.S_GATE + 4 + P] == want_sums.tolist()[me.S_GATE:me.S_GATE + 4 + P]
    for f in ("hseen", "facc1", "facc2", "faccd"):
        assert torch.equal(torch.cat([getattr(p[2], f) for p in parts], 1), getattr(want_ops, f))
    # The plain version across ranks (one phase at a time, the sums
    # reduced between) is the same function.
    pl = [(torch.from_numpy(rows[r * nl:(r + 1) * nl].copy()), sums.clone(), _split(ops, r * nl, (r + 1) * nl, C))
          for r in range(world)]
    for i, ph in enumerate(me.COMMIT):
        for st, sm, o in pl:
            me.mesh_era_plain((ph,), c, st, sm, o)
        if i + 1 < len(me.COMMIT):
            total = sum(sm for _st, sm, _o in pl)
            for _st, sm, _o in pl:
                sm.copy_(total)
    assert np.array_equal(torch.cat([p[0] for p in pl]).numpy(), want_rows.numpy())


@pytest.mark.parametrize("mutate", ["ticket", "clamp"])
def test_k15f_commit_mutants_disagree_with_the_plain_commit(mutate):
    wrong = 0
    for case in COMMIT_CASES[:2]:
        c, rows, ops, sums = _case((8, 64, 37, 3, 1024), case, 5)
        want_rows, _ws, _wo = _plain_commit(c, rows, ops, sums)
        scratch = np.zeros(8 * (4 + 6 + 37) + 1, dtype=np.int64)
        got = rows.copy()
        _commit_grid(c, got, sums.tolist(), scratch, _clone_ops(ops), 5, mutate=mutate)
        wrong += int((got != want_rows.numpy()).sum())
    assert wrong > 0
