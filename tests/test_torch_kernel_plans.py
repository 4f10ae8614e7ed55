"""The host-side plans of K2 (stable compaction), K7s (the spill's
drain and refill) and K15a (the owner exchange), held against
brute-force enumeration, K2's plain version against the JAX
`_compact_ids` at the kernel's edges, and K4's three phases (the
visited insert) run thread by thread in random interleavings against
the JAX insert.

Each plan is what the wrapper hands its CUDA kernel; the kernel's own
index arithmetic (kernels/csrc/compact_ids.cu, ring_spill.cu,
exchange.cu) is transcribed here block by block, so that every mask
element, id slot, ring row, block word and send slot is shown to be
covered exactly once, and the transcription's result equals the plain
version's (and, for K15a, the JAX buckets'). K4's transcription
(visited_insert.cu) steps each candidate's thread one memory access at a
time in an order drawn from a seed, with the phases' barriers between.
Tolerance: exact equality throughout.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from test_torch_mesh import _jax_exchange

from stateright_tpu.ops import visited_set as jvs
from stateright_tpu_torch.ops import era as eo
from stateright_tpu_torch.ops import exchange as xc
from stateright_tpu_torch.ops import frontier as fr
from stateright_tpu_torch.ops import slab as sl
from stateright_tpu_torch.ops import visited_set as vs

SUB = vs.COMPACT_SUB
ITEMS = 16  # mask bytes a K2 thread


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

PLAN_CASES = [
    (0, 0), (0, 5), (5, 0), (1, 1), (7, 3), (SUB - 1, 10), (SUB, SUB), (SUB + 1, 2 * SUB + 5),
    (3 * SUB, 100_000), (227_328, 75_776), (344_064, 114_688), (4_077, 1_359),
    (SUB * vs.COMPACT_MAX_TILES, 9), (SUB * vs.COMPACT_MAX_TILES + 1, 9), (SUB * 2_500 + 17, 4),
]


@pytest.mark.parametrize("n,cap", PLAN_CASES)
def test_compact_plan_covers_every_element_and_slot_once(n, cap):
    per, tiles, blocks = vs.compact_plan(n, cap)
    assert tiles <= vs.COMPACT_MAX_TILES and blocks >= max(1, tiles)
    # COUNT/WRITE tiles: every element in exactly one, none empty.
    span = per * SUB
    seen = np.zeros(n, dtype=np.int64)
    for t in range(tiles):
        lo, hi = t * span, min(n, (t + 1) * span)
        assert lo < hi, "an empty tile"
        seen[lo:hi] += 1
    assert (seen == 1).all()
    # WRITE's finish: the blocks' stripes of [0, cap), each at most SUB long.
    stripe = -(-cap // blocks)
    assert stripe <= SUB
    cover = np.zeros(cap, dtype=np.int64)
    for b in range(blocks):
        cover[b * stripe:min(cap, (b + 1) * stripe)] += 1
    assert (cover == 1).all()


def _k2_transcribed(mask: np.ndarray, cap: int):
    """K2's two launches, block by block, on a [N, n] bool mask: COUNT's
    per-tile counts, then each WRITE block's offset and lane total from
    them, its ranks written sub-tile by sub-tile (16 elements a thread),
    and its stripe of the finish. Every output slot is written exactly
    once."""
    N, n = mask.shape
    per, tiles, blocks = vs.compact_plan(n, cap)
    counts = np.zeros((N, max(1, tiles)), dtype=np.int64)
    for l in range(N):
        for t in range(tiles):
            counts[l, t] = mask[l, t * per * SUB:(t + 1) * per * SUB].sum()
    ids = np.full((N, cap), -1, dtype=np.int64)
    valid = np.zeros((N, cap), dtype=np.int8) - 1
    n_set = np.zeros(N, dtype=np.int64)
    writes = np.zeros((N, cap), dtype=np.int64)
    for l in range(N):
        for t in range(blocks):
            before, total = counts[l, :min(t, tiles)].sum(), counts[l, :tiles].sum()
            lim = min(total, cap)
            if t < tiles and before < cap:
                running = before
                for s in range(per):
                    if running >= cap:
                        break
                    j0 = (t * per + s) * SUB
                    loc = []
                    for th in range(SUB // ITEMS):
                        for k in range(ITEMS):
                            j = j0 + th * ITEMS + k
                            if j < n and mask[l, j]:
                                loc.append(th * ITEMS + k)
                    for i, p in enumerate(loc):
                        if running + i < cap:
                            ids[l, running + i] = j0 + p
                            writes[l, running + i] += 1
                    running += len(loc)
            stripe = -(-cap // blocks)
            for i in range(t * stripe, min(cap, (t + 1) * stripe)):
                valid[l, i] = i < lim
                if i >= lim:
                    ids[l, i] = 0
                    writes[l, i] += 1
            if t == 0:
                n_set[l] = total
    assert (writes == 1).all()
    return ids, valid.astype(bool), n_set


@pytest.mark.parametrize("n,density,cap", [
    (0, 0.5, 4), (9, 0.5, 0), (SUB - 1, 0.3, 2_000), (SUB + 1, 0.3, 900), (2 * SUB, 0.5, 3 * SUB),
    (3 * SUB + 5, 0.9, 5_000), (300, 1.0, 1_000),
])
def test_k2_transcription_equals_the_plain_version(n, density, cap):
    mask = np.random.default_rng(n + cap).random((2, n)) < density
    got = _k2_transcribed(mask, cap)
    want = vs.compact_ids_lanes_plain(torch.from_numpy(mask), cap)
    for a, b in zip(got, want):
        assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("n,density,cap", [
    (0, 0.5, 8), (50, 0.5, 0), (0, 0.0, 0), (100, 0.7, 1_000),        # n = 0, cap = 0, cap > n
    (SUB - 1, 0.4, 900), (SUB, 0.4, 900), (SUB + 1, 0.4, 900),         # a tile edge, n_set > cap
    (2 * SUB - 1, 0.2, 4_000), (2 * SUB + 1, 1.0, 2 * SUB + 1),
])
def test_compact_ids_plain_matches_jax_at_the_edges(n, density, cap):
    mask = np.random.default_rng(7 * n + cap).random(n) < density
    ids, valid, n_set = vs.compact_ids(torch.from_numpy(mask), cap)
    j_ids, j_valid, j_n = jvs._compact_ids(jnp.asarray(mask), cap)
    assert np.array_equal(ids.numpy(), np.asarray(j_ids).astype(np.int64))
    assert np.array_equal(valid.numpy(), np.asarray(j_valid))
    assert int(n_set) == int(j_n) == int(mask.sum())


@pytest.mark.parametrize("N,A,C,cap", [(8, 37, 55, 700), (3, 5, 4_099, 2_000), (2, 2, 55, 400)])
def test_compact_ids_lanes_transposed_view_matches_vmap(N, A, C, cap):
    """The mesh's and the lanes' [A, N, C] validity mask read as [N, A, C]
    (C = 55: 2pc-7's chunk after the spill clamp), n_set past cap too."""
    amask = np.random.default_rng(N * C).random((A, N, C)) < 0.6
    view = torch.from_numpy(amask).transpose(0, 1)
    ids, valid, n_set = vs.compact_ids_lanes(view, cap)
    per_lane = np.ascontiguousarray(amask.transpose(1, 0, 2)).reshape(N, A * C)
    j = jax.vmap(lambda m: jvs._compact_ids(m, cap))(jnp.asarray(per_lane))
    assert np.array_equal(ids.numpy(), np.asarray(j[0]).astype(np.int64))
    assert np.array_equal(valid.numpy(), np.asarray(j[1]))
    assert np.array_equal(n_set.numpy(), np.asarray(j[2]).astype(np.int64))


# ---------------------------------------------------------------------------
# K7s
# ---------------------------------------------------------------------------

def _k7s_transcribed(W, qcap, runs, per_block, ring_base, rows_base):
    """K7s's blocks over the plan: for each block its run (the last whose
    first block is at or before it), its rows, the ring side's runs of
    positions split at the wrap (a scalar head where the first position's
    address is 8 mod 16, 16-byte pairs, a scalar tail) and the block
    side's words (a scalar head to 16-byte alignment, quads, a tail); each
    pair of a lane's run falls to one (pair, lane group) thread.
    `ring_base` / `rows_base`: the tensors' byte addresses mod 16.
    Returns {(ring, w, position): block row} and {block word: block row}
    maps, each entry made exactly once."""
    stride = qcap + 1
    firsts, blocks = [], 0
    for ring, off, k, pos in runs:
        firsts.append(blocks)
        blocks += -(-k // per_block)
    firsts.append(blocks)
    ring_map, word_map = {}, {}

    def put(m, key, val):
        assert key not in m, f"{key} moved twice"
        m[key] = val

    for b in range(blocks):
        g = 0
        while g + 1 < len(runs) and firsts[g + 1] <= b:
            g += 1
        ring, off, k, pos = runs[g]
        r0 = (b - firsts[g]) * per_block
        n = min(per_block, k - r0)
        assert n > 0
        i = 0
        while i < n:
            a = (pos + r0 + i) & (qcap - 1)
            m = min(qcap - a, n - i)
            # The pairs' threads: (q, lane group) over kThreads = 256.
            qmax = m >> 1
            qs = 256 if qmax >= 256 else 1 if qmax <= 1 else 1 << (qmax - 1).bit_length()
            shift = qs.bit_length() - 1
            groups = 256 >> shift
            pair_of = {}
            for t in range(256):
                for q in range(t & (qs - 1), qmax, qs):
                    for w in range(t >> shift, W, groups):
                        put(pair_of, (w, q), t)
            for w in range(W):
                addr = ring_base + 8 * (ring * W * stride + w * stride + a)
                head = (addr >> 3) & 1
                pairs = (m - head) >> 1
                done = []
                if head:
                    done.append(0)
                if (m - head) & 1:
                    done.append(m - 1)
                for q in range(pairs):
                    assert (w, q) in pair_of
                    assert (addr + 8 * (head + 2 * q)) % 16 == 0
                    done += [head + 2 * q, head + 2 * q + 1]
                assert sorted(done) == list(range(m))
                for d in done:
                    put(ring_map, (ring, w, a + d), (off + r0 + i + d, w))
            i += m
        M = n * W
        first_word = (off + r0) * W
        blk_addr = rows_base + 4 * first_word
        head = min((4 - ((blk_addr >> 2) & 3)) & 3, M)
        quads = (M - head) >> 2
        done = list(range(head)) + list(range(head + 4 * quads, M))
        for q in range(quads):
            assert (blk_addr + 4 * (head + 4 * q)) % 16 == 0
            done += list(range(head + 4 * q, head + 4 * q + 4))
        assert sorted(done) == list(range(M))
        for j in done:
            put(word_map, first_word + j, divmod(first_word + j, W))
    return ring_map, word_map


@pytest.mark.parametrize("W,qcap,starts,ks", [
    (5, 1 << 14, [(1 << 14) - 1_000], [9_000]),                       # one ring, wrapping
    (5, 1 << 12, [3, 4_000, 0, 1, 77, 10], [0, 1, 1 << 12, 1_700, 1_639, 3_277]),  # ragged, blocks' edges
    (32, 1 << 10, [7, 8], [1 << 10, 255]),                            # the paxos width, a whole ring
    (7, 1 << 9, [511, 0, 2], [512, 3, 0]),                            # no bundled model's width
    (4, 1 << 6, [63], [64]),                                          # a block longer than the ring
])
@pytest.mark.parametrize("ring_base,rows_base", [(0, 0), (8, 4), (0, 12), (8, 8)])
def test_spill_plan_moves_every_row_once(W, qcap, starts, ks, ring_base, rows_base):
    runs, per_block = fr.spill_plan(starts, ks, W)
    most = fr.SPILL_BLOCK_WORDS // W
    assert per_block * W <= fr.SPILL_BLOCK_WORDS
    assert min(most, fr.SPILL_MIN_ROWS) <= per_block <= most
    assert [tuple(r) for r in runs] == [
        (l, sum(ks[:l]), ks[l], starts[l]) for l in range(len(ks)) if ks[l]]
    ring_map, word_map = _k7s_transcribed(W, qcap, runs.tolist(), per_block, ring_base, rows_base)
    want = {}
    for l, (s, k) in enumerate(zip(starts, ks)):
        for i in range(k):
            for w in range(W):
                want[(l, w, (s + i) & (qcap - 1))] = (sum(ks[:l]) + i, w)
    assert ring_map == want
    assert sorted(word_map) == list(range(sum(ks) * W))
    # The transcription agrees with the plain drain on real rings.
    rings = torch.from_numpy(np.random.default_rng(W).integers(0, 1 << 32, size=(len(ks), W, qcap + 1)))
    rows = fr.ring_drain_lanes_plain(rings, starts, ks)
    flat = rings.numpy()
    for (l, w, p), (r, w2) in ring_map.items():
        assert int(rows[r, w2]) & 0xFFFFFFFF == int(flat[l, w, p]) & 0xFFFFFFFF


@pytest.mark.parametrize("W,K,want", [
    (5, 2_416_640, 819), (5, 80_226, 512), (5, 264 * 600, 600), (32, 80_226, 128), (7, 10, 512)])
def test_spill_plan_rows_a_block(W, K, want):
    """Full blocks where the rows fill the card twice over; smaller ones,
    down to SPILL_MIN_ROWS, where they would not."""
    assert fr.spill_plan([0], [K], W)[1] == want


def test_spill_plan_refuses_rows_wider_than_a_block():
    with pytest.raises(ValueError):
        fr.spill_plan([0], [1], fr.SPILL_BLOCK_WORDS + 1)


# ---------------------------------------------------------------------------
# K15a
# ---------------------------------------------------------------------------

XSUB = xc.EXCHANGE_SUB
WARP = 32
ZERO = 1024  # empty slots a WRITE block zeroes at once (exchange.cu kZero)


@pytest.mark.parametrize("V,n_total", [
    (0, 8), (1, 1), (255, 8), (256, 8), (257, 8), (12_629, 8), (14_336, 8), (14_336, 1),
    (XSUB * 64, 256), (XSUB * 64 + 1, 256), (1_000_000, 256), (1 << 22, 1),
])
def test_exchange_plan_covers_every_candidate_once(V, n_total):
    per, tiles = xc.exchange_plan(V, n_total)
    assert per >= 1 and tiles * n_total <= xc.EXCHANGE_MAX_CELLS and tiles <= 65535
    seen = np.zeros(V, dtype=np.int64)
    span = per * XSUB
    for t in range(tiles):
        lo, hi = t * span, min(V, (t + 1) * span)
        assert lo < hi, "an empty tile"
        seen[lo:hi] += 1
    assert (seen == 1).all()


def _k15a_transcribed(h1, reps, vals, n_total, quota, world):
    """K15a's two launches, block by block, on one rank's nl sources: COUNT's
    counts a (source, tile, owner); each WRITE block's base and bucket
    totals from them, its ranks (warps of 32 in candidate order: a lane's
    rank in its owner's group, the warps' exclusive prefix, the tile's
    earlier sub-tiles), the X lanes of every candidate ranked below quota,
    its round-robin share of the empty slots, and block 0's n_ovf. Every
    send slot is written exactly once."""
    nl, V = reps.shape
    X = vals.shape[0]
    per, tiles = xc.exchange_plan(V, n_total)
    owner = h1.reshape(nl, V) % n_total
    counts = np.zeros((nl, max(1, tiles), n_total), dtype=np.int64)
    for l in range(nl):
        for t in range(tiles):
            lo, hi = t * per * XSUB, min(V, (t + 1) * per * XSUB)
            counts[l, t] = np.bincount(owner[l, lo:hi][reps[l, lo:hi]], minlength=n_total)
    size = world * X * nl * nl * quota
    send = np.full(size, -1, dtype=np.int64)
    writes = np.zeros(size, dtype=np.int64)
    n_ovf = np.zeros(nl, dtype=np.int64)
    step = nl * nl * quota
    chunks = -(-quota // ZERO)
    units = X * n_total * chunks
    blocks = max(1, tiles)
    for l in range(nl):
        total = counts[l, :tiles].sum(0)
        for t in range(blocks):
            base = counts[l, :min(t, tiles)].sum(0)
            if t < tiles:
                run = np.zeros(n_total, dtype=np.int64)
                for s in range(per):
                    i = (t * per + s) * XSUB + np.arange(XSUB)
                    ok = i < V
                    ok[ok] = reps[l, i[ok]]
                    o = np.where(ok, owner[l, np.minimum(i, V - 1)], -1)
                    cnt = np.zeros((XSUB // WARP, n_total), dtype=np.int64)
                    in_group = np.zeros(XSUB, dtype=np.int64)
                    for w in range(XSUB // WARP):
                        ow = o[w * WARP:(w + 1) * WARP]
                        for j in range(WARP):
                            in_group[w * WARP + j] = int((ow[:j] == ow[j]).sum())
                        cnt[w] = np.bincount(ow[ow >= 0], minlength=n_total)
                    pre = run + np.cumsum(cnt, 0) - cnt
                    run += cnt.sum(0)
                    rank = base[np.maximum(o, 0)] + pre[np.arange(XSUB) // WARP, np.maximum(o, 0)] + in_group
                    put = ok & (rank < quota)
                    d, ol = o[put] // nl, o[put] % nl
                    for x in range(X):
                        idx = (((d * X + x) * nl + ol) * nl + l) * quota + rank[put]
                        send[idx] = vals[x, l * V + i[put]]
                        np.add.at(writes, idx, 1)
            for u in range(t, units, blocks):
                p, ch = divmod(u, chunks)
                x, o = divmod(p, n_total)
                lo, hi = max(min(total[o], quota), ch * ZERO), min(quota, (ch + 1) * ZERO)
                d, ol = divmod(o, nl)
                dst = (((d * X + x) * nl + ol) * nl + l) * quota
                if hi > lo:
                    send[dst + lo:dst + hi] = 0
                    writes[dst + lo:dst + hi] += 1
            if t == 0:
                n_ovf[l] = np.maximum(total - quota, 0).sum()
    assert (writes == 1).all(), "a send slot written twice or never"
    return send.reshape(xc.send_shape(world, X, nl, quota)), n_ovf


# (n_total, world, V, quota, X, how): quota below and above the buckets,
# V off the sub-tile, an empty shard, every candidate to one owner, 256
# shards (a tile of several sub-tiles where 64 tiles would not do), and
# the world = 2 and 4 layouts.
EXCHANGE_CASES = [
    (1, 1, 1_000, 2_048, 3, "random"), (1, 1, 1_000, 100, 3, "random"),
    (8, 1, 3_001, 40, 5, "random"), (8, 1, 3_001, 2_000, 5, "random"),
    (8, 1, 700, 64, 4, "empty shard"), (8, 1, 600, 100, 3, "one owner"),
    (8, 1, 600, 1_100, 2, "one owner"),
    (256, 1, 40, 1, 2, "random"), (256, 1, 40, 64, 2, "random"),
    (256, 64, 17_000, 3, 2, "random"), (8, 2, 500, 30, 3, "random"), (8, 4, 500, 30, 3, "random"),
    (8, 4, 300, 2_500, 2, "one owner"),
]


def _exchange_inputs(n_total, V, X, how, seed):
    rng = np.random.default_rng(seed)
    h1 = rng.integers(0, 1 << 32, size=(n_total, V), dtype=np.uint64).astype(np.int64)
    reps = rng.random((n_total, V)) < 0.75
    if how == "empty shard":
        reps[3] = False
    if how == "one owner":
        h1 = h1 - h1 % n_total + (5 % n_total)
    vals = rng.integers(1, 1 << 32, size=(n_total, X, V), dtype=np.uint64).astype(np.int64)
    return h1, reps, vals


@pytest.mark.parametrize("n_total,world,V,quota,X,how", EXCHANGE_CASES)
def test_k15a_transcription_equals_plain_and_the_jax_buckets(n_total, world, V, quota, X, how):
    h1, reps, vals = _exchange_inputs(n_total, V, X, how, n_total * 7 + V + quota)
    nl = n_total // world
    recv = []
    for r in range(world):
        sl = slice(r * nl, (r + 1) * nl)
        rh1, rreps = h1[sl].reshape(-1), reps[sl]
        rvals = vals[sl].transpose(1, 0, 2).reshape(X, nl * V)
        send, n_ovf = _k15a_transcribed(rh1, rreps, rvals, n_total, quota, world)
        want, want_ovf = xc.exchange_plain(torch.from_numpy(rh1), torch.from_numpy(rreps),
                                           torch.from_numpy(rvals), n_total, quota, world)
        assert np.array_equal(send, want.numpy()) and np.array_equal(n_ovf, want_ovf.numpy())
        if how == "empty shard":
            assert n_ovf[3] == 0
        recv.append(send)
    if n_total > len(jax.devices()):
        return
    # all_to_all_single: rank d gets every rank's send[d]; owner o's slots
    # in global source order, against the JAX shard_map's receive.
    got = np.concatenate(
        [xc.receive(torch.from_numpy(np.stack([recv[s][d] for s in range(world)]))).numpy()
         for d in range(world)], axis=1)
    j_recv, j_ovf = _jax_exchange(n_total, quota, h1.astype(np.uint32), reps, vals.astype(np.uint32))
    assert np.array_equal(got.transpose(1, 0, 2), j_recv.astype(np.int64))
    mine = np.concatenate([_k15a_transcribed(
        h1[r * nl:(r + 1) * nl].reshape(-1), reps[r * nl:(r + 1) * nl],
        vals[r * nl:(r + 1) * nl].transpose(1, 0, 2).reshape(X, nl * V), n_total, quota, world)[1]
        for r in range(world)])
    assert np.array_equal(mine, j_ovf.astype(np.int64))


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

NONE, PLACED, FOUND, CONTESTED = range(4)
HI = 0xFFFFFFFF00000000


def _k4_transcribed(keys, parents, stamps, epoch, h1, h2, p1, p2, active, seed):
    """K4's PROBE, STAMP and COMMIT (visited_insert.cu) on [N, cap] tables
    of Python ints, one generator a candidate's thread that yields before
    every access to the tables; a seeded scheduler steps the live threads
    of a phase in a random order, and each phase starts when the one
    before has ended (griddepcontrol.wait). Updates the tables in place;
    returns (is_new, unresolved)."""
    N, m = h1.shape
    cap = len(keys[0])
    mask = cap - 1
    eh = epoch << 32
    is_new = np.zeros((N, m), dtype=bool)
    unres = np.zeros((N, m), dtype=bool)
    state = np.zeros((N, m), dtype=np.int64)
    slot = np.zeros((N, m), dtype=np.int64)

    def probe(L, i):
        if not active[L, i]:
            return
        a, b = int(h1[L, i]), int(h2[L, i])
        key, pos, stride = (a << 32) | b, a & mask, b | 1
        for _k in range(vs.MAX_PROBES):
            yield
            cur = keys[L][pos]
            if cur == 0:
                yield  # atomicCAS
                cur = keys[L][pos]
                if cur == 0:
                    keys[L][pos] = key
                    yield
                    stamps[L][pos] = eh | (i + 1)
                    yield
                    parents[L][pos] = (int(p1[L, i]) << 32) | int(p2[L, i])
                    is_new[L, i], state[L, i], slot[L, i] = True, PLACED, pos
                    return
            if cur == key:
                state[L, i], slot[L, i] = FOUND, pos
                return
            pos = (pos + stride) & mask
        unres[L, i] = True

    def stamp(L, i):
        if state[L, i] != FOUND:
            return
        s, mine = slot[L, i], eh | (i + 1)
        yield
        cur = stamps[L][s]
        if cur & HI != eh or cur > mine:
            return
        yield  # atomicMax
        old = stamps[L][s]
        stamps[L][s] = max(old, mine)
        if old < mine:
            state[L, i] = CONTESTED
            yield  # the old stamp's holder is not the winner now
            is_new[L, (old & 0xFFFFFFFF) - 1] = False

    def commit(L, i):
        if state[L, i] != CONTESTED:
            return
        s = slot[L, i]
        yield
        if stamps[L][s] == eh | (i + 1):
            yield
            parents[L][s] = (int(p1[L, i]) << 32) | int(p2[L, i])
            is_new[L, i] = True

    order = random.Random(seed)
    for phase in (probe, stamp, commit):
        live = [phase(L, i) for L in range(N) for i in range(m)]
        while live:
            k = order.randrange(len(live))
            try:
                next(live[k])
            except StopIteration:
                live[k] = live[-1]
                live.pop()
    return is_new, unres


def _positions(a, b, cap):
    return [(a + k * (b | 1)) & (cap - 1) for k in range(vs.MAX_PROBES)]


def _place(keys, a, b, cap):
    """Place key (a, b) as a sequential insert would; False if its 24
    positions are all taken."""
    for p in _positions(a, b, cap):
        if keys[p] == 0:
            keys[p] = (a << 32) | b
            return True
    return False


# Each new key's first positions taken before the call: where the JAX
# insert resolves every copy (its 19 claim rounds: a copy that loses the
# claim at position 17 finds the key at round 19), and at the port's
# MAX_PROBES = 24 positions, which the JAX insert never reaches (ROADMAP
# Queue 3, "`unresolved` differs near a full table"): there the plain
# version is the reference.
DEPTHS = {"jax_limit": [1, 5, 16, 17], "probe_limit": [0, 22, 23, 24]}


def _k4_case(rng, cap, m, mode):
    """One lane's table and batch. The table holds old keys (each placed
    along its own probe sequence, so a finder meets only taken slots on
    the way) at a load of about 0.3. The batch: a few new keys, each
    repeated with distinct parents, old keys (some repeated), 10%
    inactive. Near a limit (`mode` a key of DEPTHS), each new key's first
    positions are taken by filler keys, the new keys' 24-position probe
    sets are disjoint (no old key lands in them), and no other fresh key
    is in the batch: a CAS race between two distinct keys for one empty
    slot (decided here by the schedule, in JAX by the rounds) can change
    which of them runs out of probes. `moderate`: fresh keys contend
    freely for slots at a load where no probe sequence runs out."""
    near = mode in DEPTHS
    keys = [0] * cap
    new, taken = [], set()
    depths = rng.permutation(DEPTHS[mode]) if near else []
    while len(new) < (4 if near else 6):
        a, b = (int(x) for x in rng.integers(1, 1 << 32, size=2))
        ps = set(_positions(a, b, cap))
        if near and ps & taken:
            continue
        taken |= ps
        new.append((a, b))
        if near:
            for p in _positions(a, b, cap)[:int(depths[len(new) - 1])]:
                keys[p] = int(rng.integers(1, 1 << 62))
    old = []
    while len(old) < int(0.3 * cap):
        a, b = (int(x) for x in rng.integers(1, 1 << 32, size=2))
        trial = list(keys)
        if _place(trial, a, b, cap) and not (near and {i for i, k in enumerate(trial) if k != keys[i]} & taken):
            keys = trial
            old.append((a, b))
    pool = new * 6 + old[:m // 4] + old[:8] * 2
    if not near:
        pool += [tuple(int(x) for x in rng.integers(1, 1 << 32, size=2)) for _ in range(m // 4)]
    pick = rng.integers(0, len(pool), size=m)
    h = np.array([pool[j] for j in pick], dtype=np.int64).T
    p = rng.integers(0, 1 << 32, size=(2, m), dtype=np.uint64).astype(np.int64)
    parents = [int(x) if k else 0 for k, x in zip(keys, rng.integers(1, 1 << 62, size=cap))]
    act = rng.random(m) < 0.9
    act[pick < len(new)] = True  # one copy of each new key at least
    return keys, parents, h[0], h[1], p[0], p[1], act


def _jax_insert_lanes(keys, parents, h1, h2, p1, p2, act):
    """The JAX insert of each lane's batch into its table (jax.vmap, as the
    multiplexed engine runs it; one lane: the solo insert_jit)."""
    def lanes(rows):
        a = np.array(rows, dtype=np.uint64)
        return (a >> np.uint64(32)).astype(np.uint32), (a & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    (k1, k2), (v1, v2) = lanes(keys), lanes(parents)
    u = [a.astype(np.uint32) for a in (h1, h2, p1, p2)]
    if len(keys) == 1:
        t, is_new, unres, _ovf = jvs.insert_jit(jvs.pack_lanes(k1[0], k2[0], v1[0], v2[0]),
                                                *(jnp.asarray(a[0]) for a in u), jnp.asarray(act[0]))
        t = jax.tree_util.tree_map(lambda x: x[None], t)
        is_new, unres = np.asarray(is_new)[None], np.asarray(unres)[None]
    else:
        def one(t, a, b, c, d, e):
            t, is_new, unres, _ovf = jvs.insert(t, a, b, c, d, e)
            return t, is_new, unres

        tables = (jnp.concatenate([jnp.asarray(k1), jnp.asarray(k2)], axis=1), jnp.asarray(v1), jnp.asarray(v2))
        t, is_new, unres = jax.jit(jax.vmap(one))(tables, *(jnp.asarray(a) for a in u), jnp.asarray(act))
    tk, tv1, tv2 = (np.asarray(x) for x in t)
    cap = tv1.shape[1]
    maps = [_kv_map(tk[L, :cap], tk[L, cap:], tv1[L], tv2[L]) for L in range(len(keys))]
    return np.asarray(is_new), np.asarray(unres), maps


def _kv_map(k1, k2, v1, v2):
    occ = (k1 != 0) | (k2 != 0)
    return {(int(a) << 32) | int(b): (int(c) << 32) | int(d) for a, b, c, d in zip(k1[occ], k2[occ], v1[occ], v2[occ])}


def _row_map(keys, parents):
    return {k: p for k, p in zip(keys, parents) if k}


def _rows(x):
    """[N, cap] int64 tensor rows as Python ints of their uint64 bits."""
    return [[int(v) for v in row] for row in x.numpy().view(np.uint64)]


@pytest.mark.parametrize("mode", ["moderate", "jax_limit", "probe_limit"])
@pytest.mark.parametrize("N", [1, 3])
@settings(max_examples=10, derandomize=True, deadline=None, database=None)
@given(seed=st.integers(0, 2**32 - 1))
def test_k4_phases_in_random_interleavings_equal_the_jax_insert(N, mode, seed):
    """PROBE, STAMP and COMMIT in a random order of their threads' accesses
    (solo, and three lanes stepped together) give the JAX insert's is_new,
    unresolved and key -> parent map (at the port's own probe limit, the
    plain version's): exactly the highest index of each new key's copies
    is new and stores its parent, whichever copy's CAS placed it."""
    cap, m = 512, 96
    rng = np.random.default_rng(seed)
    cases = [_k4_case(rng, cap, m, mode) for _ in range(N)]
    keys, parents = [c[0] for c in cases], [c[1] for c in cases]
    h1, h2, p1, p2, act = (np.stack([c[j] for c in cases]) for j in range(2, 7))
    epoch = 9
    # Stamps from earlier calls, on taken and on empty slots (a fork whose
    # keys were reset keeps its stamps), each below this call's epoch.
    stamps = [[(int(e) << 32) | int(lo) for e, lo in zip(rng.integers(0, epoch, size=cap),
                                                         rng.integers(0, 1 << 32, size=cap))]
              for _ in range(N)]

    def t(rows):
        return torch.from_numpy(np.array(rows, dtype=np.uint64).view(np.int64))

    table = vs.VisitedTable(t(keys), t(parents), torch.zeros((N, cap), dtype=torch.int64))
    p_new, p_unres = (x.numpy() for x in vs.insert_lanes_plain(
        table, *(torch.from_numpy(a) for a in (h1, h2, p1, p2, act))))
    p_maps = [_row_map(k, p) for k, p in zip(_rows(table.keys), _rows(table.parents))]
    if mode == "probe_limit":
        want = p_new, p_unres, p_maps
    else:
        want = _jax_insert_lanes(keys, parents, h1, h2, p1, p2, act)
        assert np.array_equal(p_new, want[0]) and np.array_equal(p_unres, want[1]) and p_maps == want[2]
    assert want[1].any() == (mode == "probe_limit")  # a depth-24 key's copies
    tk, tp = [list(r) for r in keys], [list(r) for r in parents]
    is_new, unres = _k4_transcribed(tk, tp, stamps, epoch, h1, h2, p1, p2, act, seed)
    assert np.array_equal(is_new, want[0]) and np.array_equal(unres, want[1])
    assert [_row_map(k, p) for k, p in zip(tk, tp)] == want[2]


# ---------------------------------------------------------------------------
# K8f's COMMIT and epilogue, and K9a: the blocks in random orders
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF
COMMIT_TILE, COMMIT_RUN = 4096, 16  # era_step.cu kTile, kRun
EPI_TILE = eo.EPILOGUE_TILE  # era_epilogue.cu kTile
CAP_TILE = sl.CAPTURE_TILE  # capture_scan.cuh kTile
CAP_READY = 1 << 31  # capture_scan.cuh kReady


def _era_cfg(C, A, P, m, N_cov=True):
    plen = eo.params_len(A, P, N_cov, 0)
    return eo.EraConfig(
        chunk=C, qmask=(1 << 12) - 1, vcap=3 * m // 2, rcap=m, P=P, A=A,
        cov_base=eo.P_LEN + 2 * P if N_cov else -1, s_base=-1, s_high=0, s_take=C, f_base=-1, fuse=1,
        x=plen, regrow=2, budget_min=eo.BUDGET_MIN, n_cov=eo.cov_len(A, P) if N_cov else 0, scap=0,
    )


def _era_rows(rng, c, N):
    L = c.x + eo.X_LEN
    s = rng.integers(0, 50, (N, L)).astype(np.int64)
    s[:, eo.P_COUNT] = rng.integers(0, 3 * c.chunk, N)
    s[:, eo.P_HIGH_WATER], s[:, eo.P_GROW_LIMIT], s[:, eo.P_MAX_STEPS] = 1 << 11, 1 << 30, 1 << 20
    s[:, eo.P_ERR] = s[:, eo.P_FIN_ANY] = s[:, eo.P_FIN_ALL_EN] = s[:, eo.P_BUDGET_CAP] = 0
    s[:, c.x + eo.X_OPEN] = rng.random(N) < 0.8
    s[:, c.x + eo.X_TAKE] = np.minimum(s[:, eo.P_COUNT], c.chunk) * s[:, c.x + eo.X_OPEN]
    return s


def _commit_transcribed(c, rows, step, seed):
    """era_step.cu's COMMIT over N lanes, block by block in an order drawn
    from `seed`: each thread's 16-element run, the first row of a run
    counted for its warp's group and the rest of a run that crosses rows
    bit by bit, the block's sums added to its lane's accumulators (the
    histogram to the row), the lane's ticket; the last block of a lane
    commits it (the plain version's row rules) and zeroes its words; the
    last lane zeroes the last ticket. Returns the scratch after the
    launch."""
    N, L = rows.shape
    C, P, A = c.chunk, c.P, c.A
    m = step.c_new.shape[-1]
    unres = step.unresolved.reshape(N, m).numpy()
    new = step.c_new.reshape(N, m).numpy()
    ddepth = step.ddepth.reshape(N, m).numpy()
    hits = [h.reshape(-1).numpy() for h in step.hits]
    valid = step.valid.reshape(-1).numpy()
    rh1, rh2, rdep = (r.reshape(-1).numpy() for r in step.rows)
    hseen, f1, f2, fd = (t.numpy() for t in step.first)  # views: written in place
    n_val, n_d = step.n_val.reshape(N).tolist(), step.n_d.reshape(N).tolist()
    gen = None if step.generated is None else step.generated.reshape(N).tolist()
    t_mask, t_hits, t_valid = -(-m // COMMIT_TILE), -(-(P * C) // COMMIT_TILE), -(-(A * C) // COMMIT_TILE)
    tiles = t_mask + t_hits + t_valid
    W = 4 + P + A
    scratch = np.zeros(N * W + 1, dtype=np.int64)
    dcap = c.n_cov - A - P - 1
    dbase = c.cov_base + A + P + 1
    blocks = [(t, l) for l in range(N) for t in range(tiles)]
    random.Random(seed).shuffle(blocks)
    for tile, l in blocks:
        acc = l * W
        if tile < t_mask:
            for t in range(256):
                e0 = tile * COMMIT_TILE + t * COMMIT_RUN
                for e in range(e0, min(e0 + COMMIT_RUN, m)):
                    scratch[acc] += unres[l, e]
                    if new[l, e]:
                        scratch[acc + 1] += 1
                        rows[l, dbase + min(ddepth[l, e], dcap - 1)] += 1
        else:
            is_hits = tile < t_mask + t_hits
            R = P if is_hits else A
            lo = (tile - t_mask - (0 if is_hits else t_hits)) * COMMIT_TILE
            cnt = np.zeros(R, dtype=np.int64)
            for t in range(256):
                e0 = lo + t * COMMIT_RUN
                left = (e0 // C + 1) * C - e0
                for k in range(COMMIT_RUN):
                    e = e0 + k
                    if e >= R * C:
                        break
                    i, p = divmod(e, C)
                    q = l * C + p
                    bit = hits[i][q] if is_hits else valid[i * N * C + q]
                    if not bit:
                        continue
                    # a run's first row summed over its warp's group, the rest bit by bit
                    cnt[e0 // C if k < left else i] += 1
                    if is_hits and not hseen[i, q]:  # a first hit
                        f1[i, q], f2[i, q], fd[i, q] = rh1[q], rh2[q], rdep[q]
                        hseen[i, q] = True
            if not is_hits:
                scratch[acc + 2] += cnt.sum()
            base = acc + 4 + (0 if is_hits else P)
            scratch[base:base + R] += cnt
        scratch[acc + 3] += 1
        if scratch[acc + 3] != tiles:
            continue
        sums = scratch[acc:acc + W].copy()
        scratch[acc:acc + W] = 0
        ops = ([n_val[l]] * N, [n_d[l]] * N, [int(sums[0])] * N, [int(sums[1])] * N,
               [gen[l] if gen is not None else int(sums[2])] * N,
               [[int(sums[4 + i])] * N for i in range(P)], [[int(v) for v in sums[4 + P:W]]] * N)
        s = rows[l].tolist()
        eo._step_row(eo.COMMIT, c, s, ops, l, 0, None)
        rows[l] = s
        scratch[N * W] += 1
        if scratch[N * W] == N:
            scratch[N * W] = 0
    return scratch


@pytest.mark.parametrize("N,C,A,P,m,gen", [
    (1, 1000, 6, 3, 5000, True),     # rcap off the runs, rows off the 16-element runs
    (1, 2048, 37, 3, 30_310, True),  # 2pc-7's rcap: the masks off the tile, rows on the runs
    (3, 64, 5, 2, 4096, False),      # the lanes: generated counted from the valid mask
    (2, 8, 3, 2, 6, True),           # the plain-kernel tests' widths
])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k8f_commit_blocks_in_random_orders_equal_the_plain_commit(N, C, A, P, m, gen, seed):
    from torch_era_ops import random_operands

    rng = np.random.default_rng(seed + 10 * N)
    c = _era_cfg(C, A, P, m)
    rows = _era_rows(rng, c, N)
    step = random_operands(rng, N, C, A, P, m, 3 * m // 2 + 3, m + 2, unres=0.002, hit=0.05, seen=0.3,
                           gen=gen, solo=False)
    want = torch.from_numpy(rows.copy())
    ref = step._replace(first=eo.FirstHits(*(t.clone() for t in step.first)))
    eo.era_step_plain(eo.COMMIT, c, want, ref)
    scratch = _commit_transcribed(c, rows, step, seed)
    assert np.array_equal(rows, want.numpy())
    for a, b in zip(step.first, ref.first):
        assert torch.equal(a, b)
    assert not scratch.any()


def _epilogue_transcribed(c, rows, first, ring_depth, seed):
    """era_epilogue.cu over N lanes, block by block in an order drawn from
    `seed`: each block's minimum key a property over its positions, its
    minima's fingerprints in its slots, the lane's minima raised, its
    slice cleared, the lane's ticket; the last block of a lane reads the
    minima (resetting them), takes each winner's fingerprints from the
    slot of the tile holding its position and does the scalar work.
    Returns the minima and tickets after the launch."""
    N = rows.shape[0]
    C, P = c.chunk, c.P
    tiles = -(-C // EPI_TILE)
    hseen, f1, f2, fd = (t.numpy() for t in first)
    none = (1 << 64) - 1
    best = [none] * (N * P)
    ticket = [0] * N
    fp = {}
    blocks = [(t, l) for l in range(N) for t in range(tiles)]
    random.Random(seed).shuffle(blocks)
    for tile, l in blocks:
        kmin = [none] * P
        span = range(tile * EPI_TILE, min(C, (tile + 1) * EPI_TILE))
        for p in span:
            for i in range(P):
                if hseen[i, l * C + p]:
                    kmin[i] = min(kmin[i], (int(fd[i, l * C + p]) & M32) << 32 | p)
        for i in range(P):
            if kmin[i] != none:
                q = l * C + (kmin[i] & M32)
                fp[(l, tile, i)] = (int(f1[i, q]), int(f2[i, q]))
                best[l * P + i] = min(best[l * P + i], kmin[i])
        for p in span:
            hseen[:, l * C + p] = False
            f1[:, l * C + p] = f2[:, l * C + p] = fd[:, l * C + p] = 0
        ticket[l] += 1
        if ticket[l] != tiles:
            continue
        found, w1, w2 = [False] * P, [0] * P, [0] * P
        for i in range(P):
            m, best[l * P + i] = best[l * P + i], none
            if m != none:
                found[i] = True
                w1[i], w2[i] = fp[(l, (m & M32) // EPI_TILE, i)]
        ticket[l] = 0
        s = rows[l].tolist()
        eo._epilogue_row(c, s, found, w1, w2, lambda j, l=l: int(ring_depth[l, j]), 0)
        rows[l] = s
    return best, ticket


@pytest.mark.parametrize("N,C,P", [(1, 6144, 3), (1, 16384, 4), (3, 1000, 2), (4, 151, 3), (2, 8, 2)])
@pytest.mark.parametrize("seed", [0, 1])
def test_k8f_epilogue_blocks_in_random_orders_equal_the_plain_epilogue(N, C, P, seed):
    rng = np.random.default_rng(seed + N)
    c = _era_cfg(C, 3, P, 40)
    rows = _era_rows(rng, c, N)
    rows[:, c.x + eo.X_ESTEPS] = rng.integers(0, 3, N)
    rows[:, c.x + eo.X_REC0] = rng.integers(0, 1 << P, N)
    first = eo.FirstHits(torch.from_numpy(rng.random((P, N * C)) < 0.02),
                         *(torch.from_numpy(rng.integers(0, 1 << 32, (P, N * C))) for _ in range(2)),
                         torch.from_numpy(rng.integers(1, 4, (P, N * C))))  # depth ties
    ring_depth = rng.integers(0, 30, (N, (1 << 12) + 1))
    want = torch.from_numpy(rows.copy())
    ref = eo.FirstHits(*(t.clone() for t in first))
    eo.era_epilogue_plain(c, want if N > 1 else want[0], *ref,
                          torch.from_numpy(ring_depth if N > 1 else ring_depth[0]))
    best, ticket = _epilogue_transcribed(c, rows, first, ring_depth, seed)
    assert np.array_equal(rows, want.numpy())
    assert all(not t.any() for t in first) and all(not t.any() for t in ref)
    assert best == [(1 << 64) - 1] * (N * P) and ticket == [0] * N


def capture_one_transcribed(sel, h1, h2, thresh, srcs, dst, occ, dropped, step_cap, status, ticket, seed):
    """capture_scan.cuh's one launch over (tile, lane) on numpy arrays, its
    blocks' two steps interleaved in an order drawn from `seed`. sel, h1,
    h2 [N, n]; thresh [N, 2]; srcs, one [N, n] array a slab lane; dst [k,
    N, scap + 1], occ [N] and dropped [N] (or None) updated in place; the
    scratch: status [N, tiles] (kReady | a tile's count) and ticket, a list
    of (arrived, captured, tiles taken) a lane, updated in place. A block's
    first step takes its tile from its lane's counter, reads occupied,
    tests and ranks its tile and publishes its count; its second, which a
    capturing tile can take only once every earlier tile of its lane has
    published, sums those counts (the look-back), takes a ticket (the
    lane's last block advances the counters), writes its rows below
    step_cap, and, in the last block, clears the status words and the
    counter. Some block can always move: the blocks are started in any
    order, and a started block's earlier tiles are all started."""
    N, n = sel.shape
    scap = dst.shape[2] - 1
    tiles = -(-n // CAP_TILE)
    rng = random.Random(seed)
    tested = {}  # a block after its first step: (the occupied it read, its captures by rank)
    published = [0] * N  # a lane's leading tiles whose status is ready
    unstarted = [tiles] * N
    while any(unstarted) or tested:
        moves = [(None, l) for l in range(N) if unstarted[l]]
        moves += [b for b in tested if not len(tested[b][1]) or published[b[1]] >= b[0]]
        assert moves, "every started block waits"
        tile, l = b = moves[rng.randrange(len(moves))]
        if tile is None:
            unstarted[l] -= 1
            arrived, captured, tile = ticket[l]
            ticket[l] = (arrived, captured, tile + 1)
            assert tile < tiles
            i = tile * CAP_TILE + np.arange(CAP_TILE)
            i = i[i < n]
            t1, t2 = int(thresh[l, 0]) & M32, int(thresh[l, 1]) & M32
            a, c = h1[l, i] & M32, h2[l, i] & M32
            flags = sel[l, i] & ((a < t1) | ((a == t1) & (c < t2)))
            order = np.nonzero(flags)[0]  # the ranks: candidate order in the tile
            tested[(tile, l)] = (int(occ[l]), order)
            status[l, tile] = CAP_READY | len(order)
            while published[l] < tiles and status[l, published[l]] & CAP_READY:
                published[l] += 1
            continue
        occupied, order = tested.pop(b)
        total = len(order)
        base = sum(int(status[l, j]) & ~CAP_READY for j in range(tile)) if total else 0
        arrived, captured, taken = ticket[l]
        ticket[l] = (arrived + 1, captured + total, taken)
        last = ticket[l][0] == tiles
        if last:
            n_c = ticket[l][1]
            fit = min(n_c, step_cap)
            if n_c:
                occ[l] = occupied + fit
                if dropped is not None:
                    dropped[l] += n_c - fit
            ticket[l] = (0, 0, 0)
        rows = max(0, min(total, step_cap - base))
        pos = np.minimum(occupied + base + np.arange(rows), scap)
        lanes = list(range(len(srcs)))
        rng.shuffle(lanes)
        for q in lanes:
            dst[q, l, pos] = srcs[q][l, tile * CAP_TILE + order[:rows]]
        if last:
            status[l] = 0


def _k9a_transcribed(slabs, counts, is_new, h1, h2, depth, action, thresh, step_cap, seed):
    """K9a's operands (sample_capture.cu: four slab lanes, a dropped
    counter) through `capture_one_transcribed`, on a zero scratch; returns
    the tickets and status words after the launch."""
    N, n = is_new.shape
    th = np.broadcast_to(thresh, (N, 2))
    srcs = [h1, h2, depth, np.broadcast_to(action, (N, n))]
    status = np.zeros((N, -(-n // CAP_TILE)), dtype=np.int64)
    ticket = [(0, 0, 0)] * N
    occ, dropped = counts[:, 0].copy(), counts[:, 1].copy()
    capture_one_transcribed(is_new, h1, h2, th, srcs, slabs, occ, dropped, step_cap, status, ticket, seed)
    counts[:, 0], counts[:, 1] = occ, dropped
    return ticket, status


@pytest.mark.parametrize("N,n,density,thresh,step_cap,shared", [
    (1, 30_310, 0.5, (M32, M32), 512, True),                     # a flood past 512, rcap off the tile
    (1, 30_310, 0.5, (0x00800000, 0x40000000), 512, True),       # ties on the threshold's high word
    (1, 5_000, 0.5, (0, 0), 512, True),                          # nothing below the threshold
    (1, 300 * CAP_TILE + 7, 0.0005, (M32, M32), 512, True),     # over 256 tiles: a look-back past kThreads
    (8, 12_629, 0.7, (0x10000000, 0), 12_629, True),             # every shard, the receive width
    (3, 2_100, 0.6, (0x80000000, 0x1), 300, False),              # a threshold and an action lane a shard
])
@pytest.mark.parametrize("seed", [0, 1])
def test_k9a_blocks_in_random_orders_equal_the_plain_capture(N, n, density, thresh, step_cap, shared, seed):
    rng = np.random.default_rng(seed + n)
    scap = 1_100
    is_new = rng.random((N, n)) < density
    h = rng.integers(0, 1 << 32, (4, N, n)).astype(np.int64)
    h[0, :, :40] = 0x00800000
    th = np.array(thresh if shared else [thresh] * N, dtype=np.int64)
    act = h[3] if not shared else h[3, 0]
    slabs = rng.integers(0, 1 << 32, (4, N, scap + 1)).astype(np.int64)
    counts = np.stack([rng.integers(0, 600, N), rng.integers(0, 5, N)], 1).astype(np.int64)
    want_slabs, want_counts = torch.from_numpy(slabs.copy()), torch.from_numpy(counts.copy())
    sl.capture_lanes_plain(want_slabs, want_counts, torch.from_numpy(is_new), *(torch.from_numpy(x) for x in h[:3]),
                           torch.from_numpy(act), torch.from_numpy(th), step_cap)
    ticket, status = _k9a_transcribed(slabs, counts, is_new, h[0], h[1], h[2], act, th, step_cap, seed)
    assert np.array_equal(slabs[:, :, :scap], want_slabs.numpy()[:, :, :scap])
    assert np.array_equal(counts, want_counts.numpy())
    assert ticket == [(0, 0, 0)] * N and not status.any()
