"""The host-side plans of K2 (stable compaction) and K7s (the spill's
drain and refill), held against brute-force enumeration, and K2's plain
version against the JAX `_compact_ids` at the kernel's edges.

Each plan is what the wrapper hands its CUDA kernel; the kernel's own
index arithmetic (kernels/csrc/compact_ids.cu, ring_spill.cu) is
transcribed here block by block, so that every mask element, id slot,
ring row and block word is shown to be covered exactly once, and the
transcription's result equals the plain version's. Tolerance: exact
equality throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.ops import visited_set as jvs
from stateright_tpu_torch.ops import frontier as fr
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
