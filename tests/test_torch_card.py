"""The port's kernels on the card, each against its plain version, and
small BFS and simulation runs on cuda against cpu. Marked `cuda`: they skip where no
CUDA device is present. On a machine with a card (no JAX needed):

    python -m pytest --noconftest -q tests/test_torch_card.py
"""

import numpy as np
import pytest
import torch

from stateright_tpu_torch import TensorModelAdapter, kernels
from stateright_tpu_torch.fingerprint import hash_lanes, hash_lanes_plain
from stateright_tpu_torch.models import TwoPhaseTensor
from stateright_tpu_torch.ops import frontier as fr
from stateright_tpu_torch.ops import visited_set as vs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _u32(rng, *shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.int64)


def test_hash_lanes_kernel(dev):
    lanes = torch.from_numpy(_u32(np.random.default_rng(0), 9, 5000)).to(dev)
    for a, b in zip(hash_lanes(lanes), hash_lanes_plain(lanes)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,density,cap", [(100_000, 0.3, 40_000), (100_000, 0.6, 40_000), (7, 1.0, 3)])
def test_compact_ids_kernel(dev, n, density, cap):
    mask = torch.from_numpy(np.random.default_rng(n).random(n) < density).to(dev)
    for a, b in zip(vs.compact_ids(mask, cap), vs.compact_ids_plain(mask, cap)):
        assert torch.equal(a, b)


def test_claim_dedup_kernel(dev):
    rng = np.random.default_rng(1)
    pool = _u32(rng, 2, 500)
    pick = rng.integers(0, 500, size=20_000)
    h1, h2 = (torch.from_numpy(pool[i, pick]).to(dev) for i in range(2))
    valid = torch.from_numpy(rng.random(20_000) < 0.8).to(dev)
    assert torch.equal(fr.claim_dedup(h1, h2, valid, 1 << 12), fr.claim_dedup_plain(h1, h2, valid, 1 << 12))


def test_insert_kernel_and_winner_rule(dev):
    rng = np.random.default_rng(2)
    n = 20_000
    h = _u32(rng, 2, n)
    h[:, n - 64:] = h[:, :1]  # 65 copies of one key, distinct parents
    p = _u32(rng, 2, n)
    args = [torch.from_numpy(a).to(dev) for a in (h[0], h[1], p[0], p[1])]
    act = torch.ones(n, dtype=torch.bool, device=dev)
    ta, tb = vs.empty_table(1 << 17, dev), vs.empty_table(1 << 17, dev)
    for _ in range(2):  # the second call finds every key
        a = vs.insert(ta, *args, act)
        b = vs.insert_plain(tb, *args, act)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        # Same key -> parent map; the slot layout may differ.
        assert set(zip(*vs.table_to_lanes(ta))) == set(zip(*vs.table_to_lanes(tb)))
    assert not bool(a[0].any())


def test_engine_cuda_matches_cpu(dev):
    opts = dict(chunk_size=64, queue_capacity=1 << 12, table_capacity=1 << 11, sync_steps=4)

    def run(device):
        c = TensorModelAdapter(TwoPhaseTensor(4)).checker().spawn_gpu_bfs(device=device, **opts).join()
        return c.unique_state_count(), c.state_count(), c.max_depth(), dict(c._discovery_fps), c.coverage()

    assert run("cuda") == run("cpu")


def test_ring_kernel(dev):
    rng = np.random.default_rng(3)
    W, qcap = 7, 1 << 12
    ring = fr.empty_ring(W, qcap, dev)
    ring[:, :qcap] = torch.from_numpy(_u32(rng, W, qcap)).to(dev)
    for head, n in ((4000, 1000), (0, qcap), (17, 1)):
        assert torch.equal(fr.ring_pop(ring, head, n), fr.ring_pop_plain(ring, head, n))
    cand = torch.from_numpy(_u32(rng, W, 3000)).to(dev)
    valid = torch.from_numpy(rng.random(3000) < 0.4).to(dev)
    other = ring.clone()
    fr.ring_scatter(ring, 4000, cand, valid)
    fr.ring_scatter_plain(other, 4000, cand, valid)
    assert torch.equal(ring[:, :qcap], other[:, :qcap])


def test_sample_capture_kernel(dev):
    from stateright_tpu_torch.ops import slab as sl

    rng = np.random.default_rng(4)
    a, b = sl.empty_slab(1024, dev), sl.empty_slab(1024, dev)
    for t1, t2, n in ((0xFFFFFFFF, 0xFFFFFFFF, 300), (0xFFFFFFFF, 0xFFFFFFFF, 9000), (0x01000000, 0x80000000, 40_000), (0, 0, 500)):
        new = torch.from_numpy(rng.random(n) < 0.7).to(dev)
        h = torch.from_numpy(_u32(rng, 4, n)).to(dev)
        h[0, :40] = 0x01000000  # ties on the threshold's high word
        thresh = torch.tensor([t1, t2], device=dev)
        sl.capture(a, new, h[0], h[1], h[2], h[3], thresh, 512)
        sl.capture_plain(b, new, h[0], h[1], h[2], h[3], thresh, 512)
        for x, y in zip(a[:4], b[:4]):
            assert torch.equal(x[:1024], y[:1024])
        assert torch.equal(a.counts, b.counts)


@pytest.mark.parametrize("N,n,step_cap", [(8, 12_629, 12_629), (8, 5_000, 512), (3, 1, 1)])
def test_sample_capture_lanes_kernel(dev, N, n, step_cap):
    """K9a over every shard's slab in one launch against the loop of the
    plain capture over the shards: one shared threshold or one a shard,
    an action lane shared or per shard, floods past step_cap, ties on the
    threshold's high word, a shard with nothing new; the scratch's
    tickets and tile counts are left zero."""
    from stateright_tpu_torch.ops import slab as sl

    rng = np.random.default_rng(n)
    scap = 2 * n + 600
    scratch = sl.capture_scratch(N, n, dev)
    kept = N * (2 + -(-n // sl.CAPTURE_TILE))  # the tickets and tile counts
    slabs = torch.from_numpy(_u32(rng, 4, N, scap + 1)).to(dev)
    counts = torch.from_numpy(np.stack([rng.integers(0, 600, N), rng.integers(0, 5, N)], 1)).to(dev)
    for t, shared in (((0xFFFFFFFF, 0xFFFFFFFF), True), ((0x01000000, 0x80000000), False), ((0, 0), True)):
        new = torch.from_numpy(rng.random((N, n)) < 0.6).to(dev)
        new[N - 1] = False
        h = torch.from_numpy(_u32(rng, 4, N, n)).to(dev)
        h[0, :, :40] = 0x01000000
        thresh = torch.tensor(t, device=dev) if shared else torch.tensor([t] * N, device=dev)
        act = h[3] if shared else h[3, 0]
        a_slabs, a_counts = slabs.clone(), counts.clone()
        sl.capture_lanes(slabs, counts, new, h[0], h[1], h[2], act, thresh, step_cap, scratch)
        sl.capture_lanes_plain(a_slabs, a_counts, new, h[0], h[1], h[2], act, thresh, step_cap)
        assert torch.equal(slabs[:, :, :scap], a_slabs[:, :, :scap]) and torch.equal(counts, a_counts)
        assert not bool(scratch[:kept].any())


def test_slab_bottomk_kernel(dev):
    from stateright_tpu_torch.ops import slab as sl

    rng = np.random.default_rng(5)
    lanes = [torch.from_numpy(_u32(rng, 1025)).to(dev) for _ in range(4)]
    lanes[0][::3] = lanes[0][5]  # equal keys: lower row first
    for occ in (0, 9, 700, 1024):
        slab = sl.Slab(*lanes, torch.tensor([occ, 0], device=dev))
        for x, y in zip(sl.bottom_k(slab, 128), sl.bottom_k_plain(slab, 128)):
            assert torch.equal(x, y)


def test_lookup_parent_kernel(dev):
    rng = np.random.default_rng(6)
    n = 5000
    h = torch.from_numpy(_u32(rng, 4, n)).to(dev)
    table = vs.empty_table(1 << 14, dev)
    vs.insert(table, h[0], h[1], h[2], h[3], torch.ones(n, dtype=torch.bool, device=dev))
    q1 = torch.cat([h[0], torch.from_numpy(_u32(rng, 300)).to(dev)])
    q2 = torch.cat([h[1], torch.from_numpy(_u32(rng, 300)).to(dev)])
    got, want = vs.lookup_parent(table, q1, q2), vs.lookup_parent_plain(table, q1, q2)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert bool(got[0][:n].all()) and torch.equal(got[1][:n], h[2])


@pytest.mark.parametrize("symmetry", [False, True])
def test_sampled_engine_cuda_matches_cpu(dev, symmetry):
    opts = dict(chunk_size=64, queue_capacity=1 << 12, table_capacity=1 << 11, sync_steps=4)

    def run(device):
        b = TensorModelAdapter(TwoPhaseTensor(5)).checker()
        if symmetry:
            b = b.symmetry()
        c = b.spawn_gpu_bfs(device=device, **opts).join()
        paths = {k: v.encode(c.model()) for k, v in c.discoveries().items()}
        return (c.unique_state_count(), c.state_count(), dict(c._discovery_fps), c.coverage(),
                c._sampler.fingerprints(), paths)

    got = run("cuda")
    assert got == run("cpu")
    assert got[0] == (1092 if symmetry else 8832)


# -- simulation (K13a-d) ------------------------------------------------------

def _pack(h1, h2):
    return ((h1.astype(np.uint64) << np.uint64(32)) | h2.astype(np.uint64)).view(np.int64)


def _walks(rng, S, B, L):
    """Walk lanes with paths of every length, a tenth frozen, and a path row
    per walk in which about a third of the walks meet their own state."""
    walk = np.zeros((S + 4, B), dtype=np.int64)
    walk[:S] = rng.integers(0, 50, size=(S, B))
    walk[S] = _u32(rng, B)
    walk[S + 1] = rng.integers(0, L + 1, size=B)
    walk[S + 2] = rng.integers(0, 4, size=B)
    walk[S + 3] = rng.random(B) < 0.1
    h = _u32(rng, 2, B)
    path = _pack(_u32(rng, B, L), _u32(rng, B, L))
    for w in np.flatnonzero((rng.random(B) < 0.3) & (walk[S + 1] > 0)):
        path[w, rng.integers(0, walk[S + 1, w])] = _pack(h[0, w:w + 1], h[1, w:w + 1])[0]
    return walk, h, path


def test_walk_record_kernel(dev):
    from stateright_tpu_torch.ops import walk as wk

    rng = np.random.default_rng(10)
    S, B, L = 5, 20_000, 48
    walk, h, path = _walks(rng, S, B, L)
    h1, h2 = (torch.from_numpy(x).to(dev) for x in h)
    outs = []
    for fn in (wk.record, wk.record_plain):
        w, p = torch.tensor(walk, device=dev), torch.tensor(path, device=dev)
        stats = torch.zeros(5, dtype=torch.int64, device=dev)
        dhist = torch.zeros(128, dtype=torch.int64, device=dev)
        counted, cycle = fn(h1, h2, w, p, stats, dhist)
        outs.append((w, p, stats, dhist, counted, cycle))
    for x, y in zip(*outs):
        assert torch.equal(x, y)
    assert bool(outs[0][5].any()) and bool(outs[0][4].any())


def test_walk_step_kernel(dev):
    from stateright_tpu_torch.ops import walk as wk

    rng = np.random.default_rng(11)
    S, B, L, A, P = 4, 20_000, 32, 37, 3
    walk, h, path = _walks(rng, S, B, L)
    counted, cycle = wk.record_plain(torch.from_numpy(h[0]), torch.from_numpy(h[1]),
                                     torch.from_numpy(walk), torch.from_numpy(path),
                                     torch.zeros(5, dtype=torch.int64), None)
    walk = walk.copy()
    walk[S + 1] = np.minimum(walk[S + 1], L)
    checks = torch.from_numpy(rng.random((P, B)) < 0.3).to(dev)
    valid = rng.random((A, B)) < 0.2
    valid[:, :500] = False  # terminal walks
    valid = torch.from_numpy(valid).to(dev)
    succ = _u32(rng, A, S, B)
    succ[0, 0, :100] += 1 << 40  # high bits the kernel must mask
    succ = torch.from_numpy(succ).to(dev)
    inits = torch.from_numpy(rng.integers(0, 9, size=(S, 3))).to(dev)
    hseen0 = torch.from_numpy(rng.random((P, B)) < 0.05).to(dev)
    outs = []
    for fn in (wk.step, wk.step_plain):
        w = torch.tensor(walk, device=dev)
        hseen = hseen0.clone()
        plen = torch.zeros((P, B), dtype=torch.int64, device=dev)
        stats = torch.zeros(5, dtype=torch.int64, device=dev)
        cov = torch.zeros(A + P + 128, dtype=torch.int64, device=dev)
        fn(w, counted.to(dev), cycle.to(dev), checks, 0b001, 0b010, valid, succ, inits, 1, L,
           hseen, plen, stats, cov)
        outs.append((w, hseen, plen, stats, cov))
    for x, y in zip(*outs):
        assert torch.equal(x, y)
    a = torch.tensor(walk, device=dev)
    b = a.clone()
    wk.restart_frozen(a, inits, 1)
    wk.restart_frozen_plain(b, inits, 1)
    assert torch.equal(a, b) and not bool(a[S + 3].any())


def test_walk_capture_kernel(dev):
    from stateright_tpu_torch.ops import walk as wk

    rng = np.random.default_rng(12)
    S, B = 3, 20_000
    walk, h, _path = _walks(rng, S, B, 8)
    walk, h1, h2 = (torch.from_numpy(x).to(dev) for x in (walk, h[0], h[1]))
    h1[:50] = 0x01000000  # ties on the threshold's high word
    counted = torch.from_numpy(rng.random(B) < 0.8).to(dev)
    scap = 512 + B
    slabs = [wk.empty_walk_slab(S, scap, dev) for _ in range(2)]
    stats = [torch.tensor([0, 100, 0, 0, 0], device=dev) for _ in range(2)]
    for t1, t2 in ((0x01000000, 0x80000000), (0, 0), (0xFFFFFFFF, 0xFFFFFFFF)):
        stats[0][1] = stats[1][1] = 100
        thresh = torch.tensor([t1, t2], device=dev)  # read on the card
        wk.capture(slabs[0], stats[0], counted, h1, h2, walk, thresh)
        wk.capture_plain(slabs[1], stats[1], counted, h1, h2, walk, thresh)
        assert torch.equal(slabs[0][:, :scap], slabs[1][:, :scap])
        assert torch.equal(stats[0], stats[1])


@pytest.mark.parametrize("scap", [900, 20_512, 66_048])
def test_walk_slab_kernel(dev, scap):
    from stateright_tpu_torch.ops import walk as wk

    rng = np.random.default_rng(scap)
    S = 3
    slab = _u32(rng, 3 + S, scap + 1)
    slab[0] %= 5000  # equal fp1 with distinct fp2
    slab[1] %= 3
    slab[0, 9::41] = 0xFFFFFFFF
    slab = torch.from_numpy(slab).to(dev)
    for occ in (0, 7, scap // 3, scap):
        stats = torch.tensor([0, occ, 0, 0, 0], device=dev)
        got = wk.slab_bottom_k(slab, stats, 128)
        want = wk.slab_bottom_k_plain(slab, stats, 128)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


def test_simulation_cuda_matches_cpu(dev):
    from stateright_tpu_torch.has_discoveries import HasDiscoveries
    from stateright_tpu_torch.models import IncrementTensor

    def run(device, tm, seed, configure, **kw):
        c = configure(TensorModelAdapter(tm).checker()).spawn_gpu_simulation(
            seed, device=device, **kw).join()
        paths = {k: v.encode(c.model()) for k, v in c.discoveries().items()}
        tel = c.telemetry()
        return (c.state_count(), c.max_depth(), paths, c.coverage(), c._sampler.fingerprints(),
                tel["steps"], tel["eras"])

    cases = [
        (IncrementTensor(2), 7, lambda b: b.finish_when(HasDiscoveries.any_of(["fin"])), dict(walks=256, walk_cap=32)),
        (TwoPhaseTensor(4), 11, lambda b: b.target_state_count(50_000), dict(walks=512, walk_cap=64, sync_steps=4)),
    ]
    for tm, seed, configure, kw in cases:
        got = run("cuda", tm, seed, configure, **kw)
        assert got == run("cpu", tm, seed, configure, **kw)
        assert got[2]


# -- the lane forms (multiplexed lanes) --------------------------------------

def test_lane_compaction_dedup_insert_lookup_kernels(dev):
    """K2 (over the step's strided [A, N, C] mask), K3, K4 and K6 in their
    lane forms against their plain versions, and at one lane against the
    solo calls."""
    rng = np.random.default_rng(8)
    N, A, C, cap = 37, 9, 151, 700
    mask = torch.from_numpy(rng.random((A, N, C)) < 0.4).to(dev)
    view = mask.transpose(0, 1)
    for a, b in zip(vs.compact_ids_lanes(view, cap), vs.compact_ids_lanes_plain(view, cap)):
        assert torch.equal(a, b)
    m = 900
    pool = _u32(rng, 2, 300)
    pick = rng.integers(0, 300, size=(N, m))
    h1, h2 = (torch.from_numpy(pool[i, pick]).to(dev) for i in range(2))
    valid = torch.from_numpy(rng.random((N, m)) < 0.8).to(dev)
    keep = fr.claim_dedup_lanes(h1, h2, valid, 1 << 11)
    assert torch.equal(keep, fr.claim_dedup_lanes_plain(h1, h2, valid, 1 << 11))
    assert torch.equal(keep[5], fr.claim_dedup(h1[5], h2[5], valid[5], 1 << 11))
    p = torch.from_numpy(_u32(rng, 2, N, m)).to(dev)
    ta = vs.empty_table(1 << 12, dev, lanes=N)
    tb = vs.empty_table(1 << 12, dev, lanes=N)
    results = []
    for _ in range(2):  # the second call finds every key
        a = vs.insert_lanes(ta, h1, h2, p[0], p[1], valid)
        b = vs.insert_lanes_plain(tb, h1, h2, p[0], p[1], valid)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        results.append(a)
    lane = torch.from_numpy(rng.integers(0, N, size=m)).to(dev)
    for x, y in zip(vs.lookup_parent_lanes(ta, lane, h1[0], h2[0]),
                    vs.lookup_parent_lanes_plain(ta, lane, h1[0], h2[0])):
        assert torch.equal(x, y)
    solo = vs.empty_table(1 << 12, dev)
    got = vs.insert(solo, h1[3], h2[3], p[0, 3], p[1, 3], valid[3])
    for x, y in zip(got, results[0]):
        assert torch.equal(x, y[3])
    assert not bool(results[1][0].any())


def test_lane_ring_kernel(dev):
    rng = np.random.default_rng(9)
    N, W, qcap, n = 19, 5, 1 << 10, 300
    rings = fr.empty_ring(W, qcap, dev, lanes=N)
    rings[:, :, :qcap] = torch.from_numpy(_u32(rng, N, W, qcap)).to(dev)
    heads = torch.from_numpy(rng.integers(0, qcap, size=N)).to(dev)
    assert torch.equal(fr.ring_pop_lanes(rings, heads, n), fr.ring_pop_lanes_plain(rings, heads, n))
    cand = torch.from_numpy(_u32(rng, W, N * n)).to(dev)
    valid = torch.from_numpy(rng.random((N, n)) < 0.4).to(dev)
    other = rings.clone()
    fr.ring_scatter_lanes(rings, heads, cand, valid)
    fr.ring_scatter_lanes_plain(other, heads, cand, valid)
    assert torch.equal(rings[:, :, :qcap], other[:, :, :qcap])


# K7's append at its edges (the CPU tests' APPEND_EDGES in
# tests/test_torch_ring.py): a tile's width -1, 0 and +1, many tiles,
# every column valid, none valid, a wrap inside the first tile.
T = kernels.APPEND_TILE
APPEND_EDGES = [
    (3, 1 << 13, 100, T - 1, 0.4), (3, 1 << 13, 5000, T, 0.4), (3, 1 << 13, 8000, T + 1, 0.4),
    (2, 1 << 15, 30000, 5 * T + 123, 0.5), (3, 1 << 13, 50, T + 17, 1.0), (3, 1 << 13, 9, 2 * T, 0.0),
    (4, 1 << 13, (1 << 13) - 1000, 3 * T, 0.6),
]


@pytest.mark.parametrize("W,qcap,tail,m,density", APPEND_EDGES)
def test_ring_append_kernel_edges(dev, W, qcap, tail, m, density):
    """Solo (an int tail and the era's [1] tensor tail) and three lanes
    (this tail, a wrap at the lane's last columns, none valid), each bit
    for bit against the plain version."""
    rng = np.random.default_rng(tail + m)
    ring = fr.empty_ring(W, qcap, dev)
    ring[:, :qcap] = torch.from_numpy(_u32(rng, W, qcap)).to(dev)
    cand = torch.from_numpy(_u32(rng, W, m)).to(dev)
    valid = torch.from_numpy(rng.random(m) < density).to(dev)
    for at in (tail, torch.tensor([tail], device=dev)):
        a, b = ring.clone(), ring.clone()
        fr.ring_scatter(a, at, cand, valid)
        fr.ring_scatter_plain(b, at, cand, valid)
        assert torch.equal(a[:, :qcap], b[:, :qcap])
    N = 3
    rings = fr.empty_ring(W, qcap, dev, lanes=N)
    rings[:, :, :qcap] = torch.from_numpy(_u32(rng, N, W, qcap)).to(dev)
    tails = torch.tensor([tail, qcap - 7, 0], device=dev)
    cand = torch.from_numpy(_u32(rng, W, N * m)).to(dev)
    lvalid = rng.random((N, m)) < density
    lvalid[2] = False
    lvalid = torch.from_numpy(lvalid).to(dev)
    other = rings.clone()
    fr.ring_scatter_lanes(rings, tails, cand, lvalid)
    fr.ring_scatter_lanes_plain(other, tails, cand, lvalid)
    assert torch.equal(rings[:, :, :qcap], other[:, :, :qcap])


@pytest.mark.parametrize("n", [1, 2, 31, 1000, 1001])
def test_ring_pop_kernel_alignments(dev, n):
    """The pop's 16-byte pairs: heads of both parities, a wrap between a
    pair's two rows, lanes whose rows start at odd buffer columns."""
    rng = np.random.default_rng(n)
    N, W, qcap = 3, 5, 1 << 11
    rings = fr.empty_ring(W, qcap, dev, lanes=N)
    rings[:, :, :qcap] = torch.from_numpy(_u32(rng, N, W, qcap)).to(dev)
    for heads in ([0, 1, qcap - 1], [qcap - n // 2, 7, qcap - 2]):
        h = torch.tensor(heads, device=dev) % qcap
        assert torch.equal(fr.ring_pop_lanes(rings, h, n), fr.ring_pop_lanes_plain(rings, h, n))
        for lane in range(N):
            assert torch.equal(fr.ring_pop(rings[lane], heads[lane] % qcap, n),
                               fr.ring_pop_plain(rings[lane], heads[lane] % qcap, n))


def _slabs(rng, n, scap, ties, dev):
    from stateright_tpu_torch.ops import slab as sl

    slabs = torch.from_numpy(_u32(rng, 4, n, scap + 1)).to(dev)
    if ties:
        slabs[0] = torch.from_numpy(rng.integers(0, 40, size=(n, scap + 1)) * 0x01000001).to(dev)
    return sl, slabs


@pytest.mark.parametrize("occ", [0, 1, 127, 128, 129, 16384])
def test_slab_bottomk_kernel_at_16384_rows(dev, occ):
    sl, slabs = _slabs(np.random.default_rng(occ), 1, 16384, True, dev)
    slab = sl.Slab(*slabs[:, 0], torch.tensor([occ, 0], device=dev))
    for x, y in zip(sl.bottom_k(slab, 128), sl.bottom_k_plain(slab, 128)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("ties", [False, True])
def test_slab_bottomk_lanes_kernel(dev, ties):
    """K9b's lane form over 8 shards of 16,384 rows, occupancies from
    empty to full, against its plain version and the solo kernel."""
    n, scap, k = 8, 16384, 128
    rng = np.random.default_rng(12 + ties)
    sl, slabs = _slabs(rng, n, scap, ties, dev)
    occ = [0, 1, k - 1, k, k + 1, 5000, scap - 1, scap]
    counts = torch.tensor([[o, 0] for o in occ], device=dev)
    got = sl.bottom_k_lanes(slabs, counts, k)
    for x, y in zip(got, sl.bottom_k_lanes_plain(slabs, counts, k)):
        assert torch.equal(x, y)
    for s in range(n):
        for x, y in zip(sl.bottom_k(sl.Slab(*slabs[:, s], counts[s]), k), got):
            assert torch.equal(x, y[s])
    for k_big in (1, 1024, 2048):  # one word; the register network's widest; the shared-memory one
        for x, y in zip(sl.bottom_k_lanes(slabs, counts, k_big), sl.bottom_k_lanes_plain(slabs, counts, k_big)):
            assert torch.equal(x, y)


def test_append_and_sharded_tail_launch_counts(dev):
    """One ring_scatter is K7's two append launches and no K2 launch
    (solo and lanes); one sharded tail is one K9b launch over every
    shard, and its rows equal the plain per-shard bottom-k."""
    from stateright_tpu_torch.ops import slab as sl
    from stateright_tpu_torch.parallel import mesh

    rng = np.random.default_rng(13)
    W, qcap, m = 5, 1 << 14, 10_000
    ring = fr.empty_ring(W, qcap, dev)
    cand = torch.from_numpy(_u32(rng, W, m)).to(dev)
    valid = torch.from_numpy(rng.random(m) < 0.4).to(dev)
    rings = fr.empty_ring(W, qcap, dev, lanes=4)
    lcand = torch.from_numpy(_u32(rng, W, 4 * m)).to(dev)
    lvalid = torch.from_numpy(rng.random((4, m)) < 0.4).to(dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    fr.ring_scatter(ring, torch.tensor([qcap - 9], device=dev), cand, valid)
    fr.ring_scatter_lanes(rings, torch.tensor([0, 5, qcap - 3, 77], device=dev), lcand, lvalid)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["compact_ids"] == counts["compact_ids_lanes"] == 0
    assert counts["ring_append"] == 2 and counts["ring_append_lanes"] == 2
    assert sum(counts.values()) == 4

    tm = TwoPhaseTensor(3)
    n, C = 8, 64
    prog = mesh.MeshProgram(tm, tm.tensor_properties(), C, 1 << 12, 1 << 10, n,
                            mesh.quota_for(C, tm.max_actions, n), True, 64, 1, dev)
    prog.slab.copy_(torch.from_numpy(_u32(rng, *prog.slab.shape)))
    prog.slab_counts[:, 0] = torch.from_numpy(rng.integers(0, prog.scap + 1, size=n))
    torch.cuda.synchronize()
    kernels.reset_launches()
    prog._tail()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["slab_bottomk_lanes"] == 1 and counts["slab_bottomk"] == 0
    b, k = prog.s_base + 4, prog.sk2
    for s in range(n):
        fp1, fp2, depth, _a, ok = sl.bottom_k_plain(sl.Slab(*prog.slab[:, s], prog.slab_counts[s]), k)
        want = torch.cat([fp1, fp2, depth, ok.to(torch.int64)])
        assert torch.equal(prog.state[s, b:b + 4 * k], want)


def test_multiplexed_lanes_cuda_match_cpu(dev):
    from stateright_tpu_torch.engines.multiplex import run_multiplexed
    from stateright_tpu_torch.has_discoveries import HasDiscoveries

    def run(device):
        tm = TwoPhaseTensor(4)
        builders = [TensorModelAdapter(tm).checker().target_max_depth(d) for d in (3, 7, 30)]
        builders.append(TensorModelAdapter(tm).checker().finish_when(HasDiscoveries.any_of(["abort agreement"])))
        out = []
        for c in run_multiplexed(builders, lanes=6, device=device, chunk=64, queue_capacity=1 << 12,
                                 table_capacity=1 << 15):
            tel = c.telemetry()
            out.append((c.unique_state_count(), c.state_count(), c.max_depth(), dict(c._discovery_fps),
                        c.coverage(), tel["steps"], tel["partial_steps"],
                        {k: v.encode(c.model()) for k, v in c.discoveries().items()}))
        return out

    got = run("cuda")
    assert got == run("cpu")
    assert got[2][0] == 1_568


# -- device-resident eras (K8f, K10f) ----------------------------------------

PIPE_OPTS = dict(chunk_size=64, queue_capacity=1 << 12, table_capacity=1 << 11, sync_steps=4)
PIPE_SWEEP = [None, (1, 1), (2, 1), (4, 1), (4, 4)]


def _era_run(device, pipe, n=5, opts=PIPE_OPTS, configure=lambda b: b):
    b = configure(TensorModelAdapter(TwoPhaseTensor(n)).checker().coverage())
    b = b.pipeline(False) if pipe is None else b.pipeline(depth=pipe[0], fuse=pipe[1])
    c = b.spawn_gpu_bfs(device=device, **opts).join()
    tel = c.telemetry()
    return c, dict(
        unique=c.unique_state_count(), states=c.state_count(), max_depth=c.max_depth(),
        fps=dict(c._discovery_fps), coverage=c.coverage(), sample=c._sampler.fingerprints(),
        paths={k: v.encode(c.model()) for k, v in c.discoveries().items()},
        eras=tel["eras"], steps=tel["steps"],
    )


@pytest.mark.parametrize("pipe", PIPE_SWEEP)
def test_graph_eras_match_cpu_eras(dev, pipe):
    """Every (depth, fuse) of the sweep and the serial dispatch loop: the graph
    eras on the card give the cpu eras, and every BFS kernel (the era's
    two included) launched through the graph."""
    from stateright_tpu_torch import kernels

    kernels.reset_launches()
    c, got = _era_run("cuda", pipe)
    counts = kernels.launch_counts()
    assert got == _era_run("cpu", pipe)[1]
    assert got["unique"] == 8832
    tel = c.telemetry()
    assert tel["graph_captures"] >= 1 and tel["capture_secs"] > 0
    for k in kernels.BFS_KERNELS:
        assert counts[k.name] > 0, k.name
    assert counts["era_step"] >= tel["steps"]


def test_era_kernels_match_plain_in_a_run(dev):
    """One dispatch run eagerly on the card (each kernel launched on its
    own) against the same dispatch through the plain versions."""
    from stateright_tpu_torch.engines import era

    def prog(device):
        from stateright_tpu_torch.models import TwoPhaseTensor as T

        tm = T(4)
        p = era.EraProgram(tm, tm.tensor_properties(), 64, 1 << 12, 1 << 12, False, True, 64, 4, device)
        init = torch.from_numpy(np.asarray(tm.init_states_array(), dtype=np.int64).T.copy()).to(device)
        vals = np.zeros(p.plen + 12, dtype=np.int64)
        vals[:17] = [0, 1, 0, 0, 0xFFFFFFFF, 4000, (1 << 12) - 64 * tm.max_actions, 7, 0, 0, 0, 0,
                     64, 2, 0, 0, 16]
        vals[p.f_base] = 4
        vals[p.s_base:p.s_base + 2] = 0xFFFFFFFF
        p.seed(init, 0, vals)
        return p

    a, b = prog(dev), prog("cpu")
    for _ in range(3):
        a.run_eager()
        b.run_eager()
        assert torch.equal(a.state.cpu(), b.state)
        assert torch.equal(a.ring[:, :-1].cpu(), b.ring[:, :-1])  # the trash column aside
        assert torch.equal(a.slab.counts.cpu(), b.slab.counts)


def test_capture_failure_raises(dev):
    """A step that reads back mid-capture fails the capture: the run
    raises, nothing falls back."""

    class Syncing(TwoPhaseTensor):
        def step_lanes(self, xp, lanes):
            if int(lanes[0].sum()) < 0:  # a host read inside the step
                raise AssertionError
            return super().step_lanes(xp, lanes)

    with pytest.raises(RuntimeError):
        TensorModelAdapter(Syncing(3)).checker().spawn_gpu_bfs(device="cuda", **PIPE_OPTS).join()


def test_graph_recaptured_after_growth(dev):
    """2pc-7 from a 2^16 table grows during the run: the era graph is
    captured again after each growth, and the run equals one with no
    growth."""
    opts = dict(chunk_size=6144, queue_capacity=1 << 20, table_capacity=1 << 22)
    big, want = _era_run("cuda", (2, 1), 7, opts)
    grown, got = _era_run("cuda", (2, 1), 7, dict(opts, table_capacity=1 << 16))
    # A growth ends an era (the table's limit), so the eras differ.
    del want["eras"], got["eras"]
    assert got == want and got["unique"] == 296_448
    tel = grown.telemetry()
    assert tel["table_growths"] >= 1
    assert tel["graph_captures"] == tel["table_growths"] + 1
    assert big.telemetry()["graph_captures"] == 1


# -- simulation eras and lane batches as graphs (K13f, K14f) -----------------

def _sim_program(device, tm, B=512, L=32, k=64):
    from stateright_tpu_torch.engines.gpu_simulation import SimProgram

    return SimProgram(tm, tm.tensor_properties(), B, L, True, k, device)


def test_walk_era_kernel_matches_plain(dev):
    """K13f's three modes on the card against the plain version, on the
    state of a real era (first hits, coverage and the sample included),
    with the all-frozen rule and a closed gate among the cases."""
    from stateright_tpu_torch.ops import walk_era as we

    tm = TwoPhaseTensor(4)
    progs = [_sim_program(d, tm) for d in (dev, "cpu")]
    for p in progs:
        p.seed(5)
        p.era(p.walk, p.path, rec_bits=0, max_steps=6, fin_any=0, fin_all=0, fin_all_en=0,
              target_gen=0, gen0=0)
    a, b = progs
    c = a.cfg
    rng = np.random.default_rng(3)
    for case in range(6):
        inputs = torch.tensor([int(rng.integers(0, 4)), int(rng.integers(0, 5)), int(rng.integers(0, 4)),
                               7, int(rng.integers(0, 2)), int(rng.choice([0, 600, 5000])),
                               int(rng.integers(0, 1000)), 0, 0, 0, 5, 0xFFFFFFFF, 0xFFFFFFFF])
        frozen = case == 4  # every walk frozen: steps jump to max_steps
        for mode in (we.BEGIN, we.COMMIT, we.COMMIT, we.EPILOGUE):
            for p in progs:
                p.era_in.copy_(inputs.to(p.device))
                if mode == we.COMMIT and frozen:
                    p.stats[we.X_FROZEN] = p.B
                we.walk_era(mode, c, p.state, p.era_in, p.hseen, p.plen)
            assert torch.equal(a.state.cpu(), b.state), (case, mode)
            assert torch.equal(a.hseen.cpu(), b.hseen) and torch.equal(a.plen.cpu(), b.plen)


def test_simulation_graph_eras_match_cpu_eras(dev):
    """Eras through the captured graph (one launch and one readback an
    era, captured once) against eager cpu eras: walks, path rows below
    ptr and the params_out words, with a target, finish masks and a
    tightening threshold."""
    from stateright_tpu_torch import kernels

    tm = TwoPhaseTensor(4)
    progs = [_sim_program(d, tm) for d in (dev, "cpu")]
    for p in progs:
        p.seed(9)
    kernels.reset_launches()
    rec = gen = 0
    thr = (0xFFFFFFFF, 0xFFFFFFFF)
    for era in range(8):
        kw = dict(rec_bits=rec, max_steps=1 + era % 3, fin_any=0, fin_all=7, fin_all_en=era % 2,
                  target_gen=6000, gen0=gen, threshold=thr)
        ra, rb = (p.era(p.walk, p.path, **kw) for p in progs)
        assert np.array_equal(ra.params, rb.params), era
        a, b = progs
        assert torch.equal(a.walk.cpu(), b.walk)
        S = tm.state_width
        below = torch.arange(a.L)[None, :] < b.walk[S + 1][:, None]
        assert torch.equal(a.path.cpu()[below], b.path[below])
        rec, gen = ra.rec_bits, gen + ra.gen
        thr = (0x40000000 >> era, 0)
    a = progs[0]
    assert a.graph_captures == 1 and a.readbacks == 8
    counts = kernels.launch_counts()
    for k in kernels.SIM_KERNELS:
        assert counts[k.name] > 0, k.name


def _era_cfg(C, A, P, rcap, qcap=1 << 10, vcap=None, sampled=False, fuse=1):
    from stateright_tpu_torch.ops import era as eo

    plen = eo.params_len(A, P, True, 64 if sampled else 0, fuse)
    return eo.EraConfig(
        chunk=C, qmask=qcap - 1, vcap=vcap or 3 * rcap // 2, rcap=rcap, P=P, A=A,
        cov_base=eo.P_LEN + 2 * P, s_base=eo.P_LEN + 2 * P + eo.cov_len(A, P) if sampled else -1,
        s_high=300, s_take=max(1, 512 // A), f_base=eo.params_len(A, P, True, 64 if sampled else 0) if fuse > 1 else -1,
        fuse=fuse, x=plen, regrow=2, budget_min=eo.BUDGET_MIN, n_cov=eo.cov_len(A, P), scap=600,
    )


def _era_state(rng, cfg, N, qcap=1 << 10):
    from stateright_tpu_torch.ops import era as eo

    state = torch.from_numpy(rng.integers(0, 50, (N, cfg.x + eo.X_LEN)))
    state[:, eo.P_COUNT] = torch.from_numpy(rng.integers(0, 3 * cfg.chunk, N))
    state[:, eo.P_HIGH_WATER] = qcap // 2
    state[:, eo.P_GROW_LIMIT] = 1000
    state[:, eo.P_MAX_STEPS] = torch.from_numpy(rng.integers(1, 4, N))
    state[:, eo.P_ERR] = torch.from_numpy((rng.random(N) < 0.1).astype(np.int64))
    state[:, eo.P_BUDGET_CAP] = 0
    return state


def _same_first(a, b):
    return all(torch.equal(x.cpu(), y) for x, y in zip(a, b))


@pytest.mark.parametrize("C,A,P,rcap", [(32, 5, 3, 40), (151, 27, 3, 3456), (64, 37, 2, 4739)])
def test_lane_era_kernels_match_plain_and_solo(dev, C, A, P, rcap):
    """The lane-axis era kernels (K14f) against their plain versions on
    random lane states (their step folds too: the first-hit lanes and the
    histogram), at chunks off and on the 16-byte runs, and at one lane
    against the solo kernels; every scratch word is left as found."""
    from torch_era_ops import lane, random_operands, to

    from stateright_tpu_torch.ops import era as eo

    rng = np.random.default_rng(4)
    N, qcap = 64, 1 << 10
    cfg = _era_cfg(C, A, P, rcap, qcap)
    state = _era_state(rng, cfg, N, qcap)
    step = random_operands(rng, N, C, A, P, rcap, 3 * rcap // 2 + 5, rcap + 3, gen=False)
    ring_depth = torch.from_numpy(rng.integers(0, 30, (N, qcap + 1)))
    scratch = eo.step_scratch(N, P, A, dev)
    epi = eo.epilogue_scratch(N, P, C, dev)
    epi0 = epi.clone()
    on = [state.to(dev), ring_depth.to(dev)]
    off = [state.clone(), ring_depth]
    card_step = to(step, dev)
    for mode in (eo.START, eo.BEGIN, eo.COMMIT, eo.COMMIT):
        eo.era_step(mode, cfg, on[0], card_step if mode == eo.COMMIT else None, scratch=scratch)
        eo.era_step_plain(mode, cfg, off[0], step if mode == eo.COMMIT else None)
        assert torch.equal(on[0].cpu(), off[0]), mode
        assert _same_first(card_step.first, step.first), mode
        assert not bool(scratch.any())
    eo.era_epilogue(cfg, on[0], *card_step.first, on[1], scratch=epi)
    eo.era_epilogue_plain(cfg, off[0], *step.first, off[1])
    assert torch.equal(on[0].cpu(), off[0]) and not bool(card_step.first.hseen.any())
    assert torch.equal(epi[:N * P + N], epi0[:N * P + N])
    # One lane: the lane kernels equal the solo ones on the same row.
    step = random_operands(rng, N, C, A, P, rcap, 3 * rcap // 2 + 5, rcap + 3)
    solo, one_lane = state[3].clone().to(dev), state[3:4].clone().to(dev)
    one, one_l = to(lane(step, 3, C, solo=True), dev), to(lane(step, 3, C), dev)
    for mode in (eo.START, eo.BEGIN, eo.COMMIT):
        eo.era_step(mode, cfg, solo, one if mode == eo.COMMIT else None, epoch=torch.ones(1, dtype=torch.int64, device=dev))
        eo.era_step(mode, cfg, one_lane, one_l if mode == eo.COMMIT else None, scratch=eo.step_scratch(1, P, A, dev),
                    epoch=torch.ones(1, dtype=torch.int64, device=dev))
        assert torch.equal(solo, one_lane[0]), mode
    assert all(torch.equal(x, y) for x, y in zip(one.first, one_l.first))


@pytest.mark.parametrize("C,A,P,rcap", [(6144, 37, 3, 30310), (100, 6, 2, 768), (16384, 21, 2, 45875)])
def test_era_kernels_match_plain(dev, C, A, P, rcap):
    """K8f's COMMIT (the fold with it) and epilogue against their plain
    versions, solo, sampled and fused, at the 2pc-7 and paxos-3 widths
    and a chunk off the 16-byte runs; depth ties among the first hits
    (the lowest position wins); the scratch words are left as found."""
    from torch_era_ops import random_operands, to

    from stateright_tpu_torch.ops import era as eo
    from stateright_tpu_torch.ops import slab as sl

    rng = np.random.default_rng(C)
    qcap = 1 << 14
    cfg = _era_cfg(C, A, P, rcap, qcap, sampled=True, fuse=4)
    scratch, epi = eo.step_scratch(1, P, A, dev), eo.epilogue_scratch(1, P, C, dev)
    epi0 = epi.clone()
    ring_depth = torch.from_numpy(rng.integers(0, 30, qcap + 1)).to(dev)
    for trial in range(4):
        st = _era_state(rng, cfg, 1, qcap)[0]
        st[cfg.x + eo.X_OPEN], st[cfg.x + eo.X_TAKE] = trial != 3, min(int(st[eo.P_COUNT]), C)
        st[cfg.f_base] = 4
        st[cfg.x + eo.X_K] = trial % 3
        step = random_operands(rng, 1, C, A, P, rcap, 3 * rcap // 2 + 5, rcap + 3,
                               unres=0.0 if trial < 2 else 0.001, solo=True)
        step.first.faccd.clamp_(max=3)  # depth ties
        slab = sl.empty_slab(cfg.scap, "cpu")
        slab.counts[0] = int(rng.integers(0, 400))
        a, b = st.to(dev), st.clone()
        ea, eb = torch.ones(1, dtype=torch.int64, device=dev), torch.ones(1, dtype=torch.int64)
        card = to(step, dev)
        eo.era_step(eo.COMMIT, cfg, a, card, sl.Slab(*(t.to(dev) for t in slab)), ea, scratch=scratch)
        eo.era_step_plain(eo.COMMIT, cfg, b, step, slab, eb)
        assert torch.equal(a.cpu(), b) and torch.equal(ea.cpu(), eb), trial
        assert _same_first(card.first, step.first) and not bool(scratch.any())
        counts = slab.counts.to(dev)
        eo.era_epilogue(cfg, a, *card.first, ring_depth, counts, scratch=epi)
        eo.era_epilogue_plain(cfg, b, *step.first, ring_depth.cpu(), slab.counts)
        assert torch.equal(a.cpu(), b), trial
        assert _same_first(card.first, step.first) and torch.equal(epi[:P + 1], epi0[:P + 1])


def test_warm_lane_program_captures_once(dev):
    """A warm lane program captures its graph on the first batch only;
    each batch is one graph launch and one readback, equal to the cpu
    lanes."""
    from stateright_tpu_torch import ExecutableCache, run_multiplexed
    from stateright_tpu_torch.models import IncrementTensor

    cache = ExecutableCache()
    compiled, _hit = cache.get(IncrementTensor(2), "multiplex", lanes=8, device="cuda")
    prog = compiled.program
    for _ in range(3):
        got = run_multiplexed([compiled.builder() for _ in range(5)], lanes=8, device="cuda", cache=cache)
        assert [c.unique_state_count() for c in got] == [13] * 5
    assert prog.graph_captures == 1 and prog.builds == 1 and prog.readbacks == 3
    want = run_multiplexed([compiled.builder() for _ in range(5)], lanes=8, device="cpu")
    assert [c.telemetry()["steps"] for c in got] == [c.telemetry()["steps"] for c in want]


# -- the stage profiler (K12a, K12b) ------------------------------------------

def test_stage_loop_kernel_matches_plain(dev):
    """K12a on the card against its plain version: each lane mode (MIX with
    and without a source, a mask and a modulus; XOR; MASK; RING with its
    head), then START, FOLD (first elements, a strided column, full-width
    int64 and bool sums, a shifted bit, the epoch) and ADD."""
    from stateright_tpu_torch.ops import stage as sg

    rng = np.random.default_rng(12)
    src = torch.from_numpy(_u32(rng, 3, 5000))
    mask = torch.from_numpy(rng.random((2, 3000)) < 0.5)
    st0 = torch.tensor([0xDEADBEEF, 2, 1, 0, 0], dtype=torch.int64)
    outs = []
    for d in (dev, torch.device("cpu")):
        st, s = st0.to(d), src.to(d)
        a = torch.zeros((3, 5000), dtype=torch.int64, device=d)
        sg.mix_lanes(a, 41)
        b = torch.zeros((2, 777), dtype=torch.int64, device=d)
        sg.mix_lanes(b, 101, step=6, mask=7, mod=5)
        c = torch.zeros_like(s)
        sg.mix_lanes(c, 0x6C62272E, src=s)
        x = torch.zeros_like(s)
        sg.xor_lanes(x, s, st, xor_rows=2, acc_mask=1, mask=7)
        y = torch.zeros_like(s)
        sg.xor_lanes(y, s, st, acc_mask=0xFFFFFFFF)
        m = torch.zeros(s.shape, dtype=torch.bool, device=d)
        sg.mask_lanes(m, s, st, 3)
        head = torch.tensor([0xFFF0], dtype=torch.int64, device=d)
        ring = torch.zeros((3, 900), dtype=torch.int64, device=d)
        sg.ring_lanes(ring, s[:, :300], head, (1 << 16) - 1)
        epoch = torch.ones(1, dtype=torch.int64, device=d)
        sg.start(st, 3)
        terms = [sg.term(a[:, 0]), sg.term(a.view(-1)), sg.term(m.view(-1)), sg.term(s[0, :1], shift=32),
                 sg.term(c[1, :1], shift=3, mask=1)]
        sg.fold(st, terms, 3, add=5, epoch=epoch)
        sg.fold(st, [sg.term(mask.to(d).view(-1))], 3)
        sg.add(st, [sg.term(b.view(-1))])
        outs.append([t.cpu() for t in (a, b, c, x, y, m, head, ring, epoch, st)])
    for got, want in zip(*outs):
        assert torch.equal(got, want)


def test_stage_walk_kernel_matches_plain(dev):
    """K12b's CYCLE, RECORD (rows cleared and the column at (acc + i) % L)
    and CHOOSE on the card against the plain versions."""
    from stateright_tpu_torch.ops import stage as sg

    rng = np.random.default_rng(13)
    B, L, S, A = 3000, 40, 5, 7
    path = torch.from_numpy(_u32(rng, B, L) | (_u32(rng, B, L) << 32))
    h0, g0 = (torch.from_numpy(_u32(rng, B)) for _ in range(2))
    ptr = torch.from_numpy(rng.integers(0, L + 1, size=B))
    # A third of the walks look for a key their row holds below ptr.
    hit = rng.random(B) < 0.3
    col = rng.integers(0, L, size=B)
    for w in np.flatnonzero(hit):
        path[w, col[w]] = int(vs.pack64(h0[w:w + 1] ^ 1, g0[w:w + 1]))
    restart = torch.from_numpy(rng.random(B) < 0.06)
    rows, succs = torch.from_numpy(_u32(rng, S, B)), torch.from_numpy(_u32(rng, A * S, B))
    valid = torch.from_numpy(rng.random((A, B)) < 0.4)
    l227 = torch.from_numpy(_u32(rng, B))
    st0 = torch.tensor([0x12345, 3, 1, 0, 0], dtype=torch.int64)
    outs = []
    for d in (dev, torch.device("cpu")):
        st = st0.to(d)
        cyc = torch.zeros(B, dtype=torch.bool, device=d)
        sg.cycle(st, path.to(d), h0.to(d), g0.to(d), ptr.to(d), cyc)
        p = path.to(d)
        sg.record(st, p, h0.to(d), restart.to(d))
        out = torch.zeros((S, B), dtype=torch.int64, device=d)
        sg.choose(st, rows.to(d), succs.to(d), valid.to(d), ptr.to(d), l227.to(d), out)
        outs.append([t.cpu() for t in (cyc, p, out)])
    assert outs[1][0].any()
    for got, want in zip(*outs):
        assert torch.equal(got, want)


def test_stage_programs_cuda_match_cpu(dev):
    """Every BFS and simulation stage program and the null loop through its
    CUDA graph against the plain versions on the same run state: the same
    accumulator, twice (each dispatch starts from fresh forks)."""
    from stateright_tpu_torch.engines import stages
    from stateright_tpu_torch.models import IncrementTensor

    tm = TwoPhaseTensor(5)
    c = TensorModelAdapter(tm).checker().symmetry().spawn_gpu_bfs(
        device="cpu", chunk_size=64, queue_capacity=1 << 12, table_capacity=1 << 12).join()
    ring = torch.zeros((tm.state_width + 2, (1 << 12) + 1), dtype=torch.int64)
    ring[:, :1 << 12] = torch.from_numpy(_u32(np.random.default_rng(4), tm.state_width + 2, 1 << 12) & 7)
    accs = []
    for d in (dev, torch.device("cpu")):
        progs = stages.BfsStages(tm, tm.tensor_properties(), 64, 1 << 12, True, 4, d)
        table = vs.VisitedTable(*(t.to(d) for t in (c._table.keys, c._table.parents, c._table.stamps)))
        progs.load(table, ring.to(d))
        named, null = progs.programs()
        accs.append({n: (p.run(3), p.run(3)) for n, p in dict(named, null=null).items()})
        progs.release()
        progs.free()
    assert accs[0] == accs[1] and set(accs[0]) >= {"canon", "probe", "ring", "null"}
    sim = []
    itm = IncrementTensor(2)
    path = torch.from_numpy(_u32(np.random.default_rng(5), 64, 16) | (_u32(np.random.default_rng(6), 64, 16) << 32))
    for d in (dev, torch.device("cpu")):
        progs = stages.SimStages(itm, itm.tensor_properties(), 64, 16, 4, d)
        progs.load(path.to(d))
        named, null = progs.programs()
        sim.append({n: (p.run(3), p.run(3)) for n, p in dict(named, null=null).items()})
        progs.release()
        progs.free()
    assert sim[0] == sim[1] and len(sim[0]) == 6


@pytest.mark.parametrize("engine", ["bfs", "simulation"])
def test_stage_profile_on_the_card(dev, engine):
    """`.stage_profile()` on the card: no error, the stage phases sum to
    device_era, and the run equals the unprofiled one."""
    from stateright_tpu_torch.models import IncrementTensor

    def run(profile):
        if engine == "bfs":
            b = TensorModelAdapter(TwoPhaseTensor(5)).checker()
            b = b.stage_profile(iters=8) if profile else b
            c = b.spawn_gpu_bfs(device="cuda", chunk_size=256, queue_capacity=1 << 14,
                                table_capacity=1 << 16).join()
            return c, (c.unique_state_count(), c.state_count(), dict(c._discovery_fps))
        b = TensorModelAdapter(IncrementTensor(2)).checker().target_state_count(20_000)
        b = b.stage_profile(iters=8) if profile else b
        c = b.spawn_gpu_simulation(7, walks=256, walk_cap=32, device="cuda").join()
        return c, (c.state_count(), dict(c._discovery_paths))

    c, got = run(True)
    _plain, want = run(False)
    assert got == want
    tel = c.telemetry()
    assert "stage_profile_error" not in tel, tel.get("stage_profile_error")
    phases = {k: v for k, v in tel["phase_ms"].items() if k.startswith("stage_")}
    era = tel["phase_ms"]["device_era"]
    assert len(phases) >= 5 and abs(sum(phases.values()) - era) <= 0.1 * era


# (n, world, V, quota, X, how): quota above and below the buckets, V off
# K15a's 256-candidate sub-tile, an empty shard, every candidate to one
# owner, 256 shards (several sub-tiles a tile), the world = 2 and 4
# layouts (one rank's nl = n / world sources), and the mesh's widths.
EXCHANGE_EDGES = [
    (1, 1, 5000, 2048, 7, "random"), (8, 1, 5000, 256, 7, "random"), (8, 1, 5000, 40, 7, "random"),
    (1, 1, 14_336, 10_752, 34, "random"), (8, 1, 14_336, 1_344, 34, "random"),
    (8, 1, 3_001, 2_000, 5, "empty shard"), (8, 1, 700, 64, 4, "one owner"),
    (8, 1, 600, 1_100, 2, "one owner"), (256, 1, 40, 1, 2, "random"), (256, 1, 300, 64, 3, "random"),
    (256, 64, 17_000, 3, 2, "random"), (8, 2, 500, 30, 3, "random"), (8, 4, 500, 30, 3, "random"),
    (8, 4, 300, 2_500, 2, "one owner"),
]


@pytest.mark.parametrize("n,world,V,quota,X,how", EXCHANGE_EDGES)
def test_exchange_kernel_matches_plain(dev, n, world, V, quota, X, how):
    """K15a: the owner buckets (stable ranks, overflow counts) and the
    receive layout, against the plain version, at its edges; into a send
    buffer full of garbage (`out=`, every slot written)."""
    from stateright_tpu_torch.ops import exchange as xc

    rng = np.random.default_rng(n * quota + V)
    nl = n // world
    h1 = _u32(rng, nl, V)
    if how == "one owner":
        h1 = h1 - h1 % n + 5 % n
    reps = rng.random((nl, V)) < 0.75
    if how == "empty shard":
        reps[3] = False
    h1, reps = torch.from_numpy(h1.reshape(-1)).to(dev), torch.from_numpy(reps).to(dev)
    vals = torch.from_numpy(_u32(rng, X, nl * V)).to(dev)
    out = torch.full(xc.send_shape(world, X, nl, quota), -7, dtype=torch.int64, device=dev)
    got, ovf = xc.exchange(h1, reps, vals, n, quota, world, out=out)
    want, ovf_p = xc.exchange_plain(h1, reps, vals, n, quota, world)
    assert got is out
    assert torch.equal(got, want) and torch.equal(ovf, ovf_p)


def _insert_batch(rng, dev, N, m, dup=64, pool_n=None):
    """[N, m] candidates drawn from a pool of keys (so some repeat), with
    `dup` copies of one key outside the pool in every lane (at the same
    positions, `at`), distinct parents, 90% active (every copy active)."""
    pool = _u32(rng, 2, N, pool_n or m)
    pick = rng.integers(0, pool.shape[2], size=(N, m))
    h = np.take_along_axis(pool, pick[None], 2)
    at = rng.permutation(m)[:dup]
    h[:, :, at] = _u32(rng, 2, N, 1)
    p = _u32(rng, 2, N, m)
    act = rng.random((N, m)) < 0.9
    act[:, at] = True
    return [torch.from_numpy(a).to(dev) for a in (h[0], h[1], p[0], p[1], act)], at


def _maps(table):
    """Each lane's key -> parent map (the slot layout is the CAS order's)."""
    keys, parents = table.keys.view(-1, table.capacity).cpu(), table.parents.view(-1, table.capacity).cpu()
    return [dict(zip(k[k != 0].tolist(), p[k != 0].tolist())) for k, p in zip(keys, parents)]


def test_insert_lanes_kernel_with_64_copies_a_lane(dev):
    """K4's lane form: 64 copies of one key a lane with distinct parents,
    among found and fresh keys, against insert_lanes_plain, twice (the
    second call finds every key): the highest active copy is the new one
    and its parent is stored."""
    rng = np.random.default_rng(31)
    N, m, cap = 37, 900, 1 << 12
    args, at = _insert_batch(rng, dev, N, m, pool_n=400)
    ta, tb = vs.empty_table(cap, dev, lanes=N), vs.empty_table(cap, dev, lanes=N)
    for call in range(2):
        a = vs.insert_lanes(ta, *args)
        b = vs.insert_lanes_plain(tb, *args)
        for x, y in zip(a, b):
            assert torch.equal(x, y), call
        assert _maps(ta) == _maps(tb)
    top = int(at.max())
    first = vs.insert_lanes(vs.empty_table(cap, dev, lanes=N), *args)[0]
    assert bool(first[:, top].all())
    assert int(first[:, at].sum()) == N
    assert not bool(a[0].any())


def test_exchange_and_insert_graph_replays_with_no_reset(dev):
    """K15a and K4 (solo, with the epoch on the card, raised by the graph
    after each call; and the lane form) captured once and replayed on
    changed inputs with nothing reset between replays: each replay equals
    the eager call on the same inputs (K4: into a twin table, by value)."""
    from stateright_tpu_torch.engines import graph
    from stateright_tpu_torch.ops import exchange as xc

    rng = np.random.default_rng(41)
    n, V, X, quota = 8, 14_336, 34, 1_344
    h1 = torch.zeros(n * V, dtype=torch.int64, device=dev)
    reps = torch.zeros((n, V), dtype=torch.bool, device=dev)
    vals = torch.zeros((X, n * V), dtype=torch.int64, device=dev)
    send = torch.empty(xc.send_shape(1, X, n, quota), dtype=torch.int64, device=dev)
    N, m, cap = 5, 3_000, 1 << 14
    batch = [torch.zeros((N, m), dtype=torch.int64, device=dev) for _ in range(4)]
    bact = torch.zeros((N, m), dtype=torch.bool, device=dev)
    solo, lanes = vs.empty_table(cap, dev), vs.empty_table(cap, dev, lanes=N)
    twin_solo, twin_lanes = vs.empty_table(cap, dev), vs.empty_table(cap, dev, lanes=N)
    epoch = torch.ones(1, dtype=torch.int64, device=dev)

    def calls():
        ex = xc.exchange(h1, reps, vals, n, quota, out=send)
        a = vs.insert(solo, *(t[0] for t in batch), bact[0], epoch=epoch)
        epoch.add_(1)
        b = vs.insert_lanes(lanes, *batch, bact, epoch=epoch)
        epoch.add_(1)
        return ex, a, b

    calls()  # allocations and builds outside the capture
    torch.cuda.synchronize()
    for t in (solo, lanes):
        t.keys.zero_(), t.parents.zero_(), t.stamps.zero_()
    epoch.fill_(1)
    g = torch.cuda.CUDAGraph()
    with graph.capture_guard() as stream:
        with torch.cuda.graph(g, stream=stream):
            ex, a, b = calls()
    for r, density in enumerate((0.75, 0.3, 1.0, 0.0)):
        h1.copy_(torch.from_numpy(_u32(rng, n * V)))
        reps.copy_(torch.from_numpy(rng.random((n, V)) < density))
        vals.copy_(torch.from_numpy(_u32(rng, X, n * V)))
        args, _at = _insert_batch(rng, dev, N, m, pool_n=2_000)
        for t, s in zip(batch + [bact], args):
            t.copy_(s)
        g.replay()
        torch.cuda.synchronize()
        want, want_ovf = xc.exchange(h1, reps, vals, n, quota)
        assert torch.equal(ex[0], want) and torch.equal(ex[1], want_ovf), r
        ea = vs.insert(twin_solo, *(t[0] for t in batch), bact[0])
        eb = vs.insert_lanes(twin_lanes, *batch, bact)
        for x, y in zip(a + b, ea + eb):
            assert torch.equal(x, y), r
        assert _maps(solo) == _maps(twin_solo) and _maps(lanes) == _maps(twin_lanes), r
    assert int(epoch) == 9


def test_exchange_and_insert_kernels_a_call(dev):
    """Counted on the card: the kernel nodes of one captured call, none of
    them a memset. K15a: COUNT and WRITE (WRITE alone when there are no
    candidates); K4: PROBE, STAMP and COMMIT, solo and lanes."""
    from stateright_tpu_torch.engines import graph
    from stateright_tpu_torch.ops import exchange as xc

    rng = np.random.default_rng(51)
    n, V, X, quota = 8, 12_629, 7, 1_184
    h1 = torch.from_numpy(_u32(rng, n * V)).to(dev)
    reps = torch.from_numpy(rng.random((n, V)) < 0.75).to(dev)
    vals = torch.from_numpy(_u32(rng, X, n * V)).to(dev)
    args, _at = _insert_batch(rng, dev, 4, 5_000)
    solo, lanes = vs.empty_table(1 << 15, dev), vs.empty_table(1 << 15, dev, lanes=4)
    epoch = torch.ones(1, dtype=torch.int64, device=dev)
    for fn, want in ((lambda: xc.exchange(h1, reps, vals, n, quota), 2),
                     (lambda: xc.exchange(h1[:0], reps[:, :0], vals[:, :0], n, quota), 1),
                     (lambda: vs.insert(solo, *(t[0] for t in args), epoch=epoch), 3),
                     (lambda: vs.insert_lanes(lanes, *args), 3)):
        fn()
        counts = graph.captured_nodes(fn)
        assert counts["kernels"] == want and counts["memsets"] == 0, counts


def test_sharded_bfs_cuda_matches_cpu(dev):
    """K15 at 8 shards on one card (one CUDA graph a dispatch, K15f's
    kernel) against the plain versions on the cpu: counts, discoveries,
    coverage and the sample."""
    runs = []
    for device in ("cuda", "cpu"):
        c = TensorModelAdapter(TwoPhaseTensor(5)).checker().coverage().spawn_sharded_bfs(
            devices=8, device=device, chunk_size=64, sync_steps=4).join()
        cov = c.coverage()
        runs.append((c.unique_state_count(), c.state_count(), dict(c._discovery_fps), cov["actions"],
                     cov["depths"], tuple(c._sampler.fingerprints()), c.telemetry()["partial_steps"]))
    assert runs[0] == runs[1] and runs[0][0] == 8832 and runs[0][-1] > 0


@pytest.mark.parametrize("A,S,B", [(21, 30, 16384), (52, 3, 8192), (1, 5, 1000), (3, 4, 33)])
def test_lane_agree_kernel_matches_plain(dev, A, S, B):
    """K16a against its plain version, bit for bit, with disagreements
    planted at known rows and lanes that carry high bits."""
    from stateright_tpu_torch.ops.agree import agree, agree_plain, read_table

    rng = np.random.default_rng(A * S + B)
    host = rng.integers(0, 1 << 32, size=(A, S, B), dtype=np.uint64).astype(np.uint32)
    hmask = rng.random((A, B)) < 0.7
    lanes = host.astype(np.int64) + (rng.integers(0, 3, size=(A, S, B)) << 32)
    dmask = hmask.copy()
    lanes[A - 1, S - 1, B - 1] ^= 1
    hmask[A - 1, B - 1] = dmask[A - 1, B - 1] = True
    if A > 1:
        dmask[0, B // 2] = not dmask[0, B // 2]
    args = [torch.from_numpy(x).to(dev) for x in (lanes, dmask, host, hmask)]
    table = agree(*args)
    assert torch.equal(table, agree_plain(*args))
    found = read_table(table.cpu().numpy(), A, S, B)
    want = (0, None, B // 2) if A > 1 else (A - 1, S - 1, B - 1)
    assert (found.action, found.lane, found.row) == want


def test_analyze_on_the_card_matches_cpu(dev):
    from stateright_tpu_torch import analyze
    from torch_lint_fixtures import CARD_FIXTURES

    for model in (TwoPhaseTensor(5), TwoPhaseTensor(3)):
        on_card, on_cpu = analyze(model, device=dev), analyze(model, device="cpu")
        assert on_card.to_dict() == on_cpu.to_dict()
        assert on_card.probes["captures"] >= 2 and on_card.probes["graph_launches"] >= 1
    for cls, code in CARD_FIXTURES:
        on_card, on_cpu = analyze(cls(), device=dev), analyze(cls(), device="cpu")
        assert code in {d.code for d in on_card.errors}, cls.__name__
        assert [(d.code, d.location) for d in on_card.diagnostics] == \
            [(d.code, d.location) for d in on_cpu.diagnostics]
        assert not torch.cuda.is_current_stream_capturing()


@pytest.mark.parametrize("W,qcap,starts,ks", [
    (5, 1 << 20, [(1 << 20) - 1000], [600_000]),          # one ring, wrapping
    (32, 1 << 12, [7], [1 << 12]),                         # the whole ring, paxos width
    (4, 1 << 14, [3, 16_000, 0, 8_000, 11, 5, 9, 1], [0, 900, 1 << 14, 1, 4_321, 77, 0, 16_383]),
])
def test_ring_spill_kernel_matches_plain(dev, W, qcap, starts, ks):
    """K7s DRAIN and REFILL against their plain versions: one ring and 8
    shards' rings with ragged counts (none, one row, a whole ring)."""
    gen = torch.Generator(device=dev).manual_seed(W)
    rings = torch.randint(0, 1 << 32, (len(ks), W, qcap + 1), dtype=torch.int64, device=dev, generator=gen)
    rings[..., qcap] = 0
    rows = fr.ring_drain_lanes(rings, starts, ks)
    assert torch.equal(rows, fr.ring_drain_lanes_plain(rings, starts, ks))
    staged = fr.SpillStaging(W, dev).drain(rings, starts, ks)
    assert np.array_equal(staged, rows.cpu().numpy().view(np.uint32))
    tails = [s + 333 for s in starts]
    a, b, c, d = rings.clone(), rings.clone(), rings.clone(), rings.clone()
    fr.ring_refill_lanes(a, tails, ks, rows)
    fr.ring_refill_lanes_plain(b, tails, ks, rows)
    fr.SpillStaging(W, dev).refill(c, tails, ks, staged)
    # A staging buffer smaller than the refill: the rows go up in pieces.
    fr.SpillStaging(W, dev, max(1, sum(ks) // 3 - 1)).refill(d, tails, ks, staged)
    assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d)
    assert int(a[..., qcap].abs().sum()) == 0


def test_spilling_run_matches_the_unspilled_run(dev):
    """2pc-7 through a ring it outgrows (2^14 rows, chunk 221 after the
    clamp) equals the unspilled run on counts and the sample; K7s
    launched."""
    from stateright_tpu_torch import kernels

    opts = dict(chunk_size=512, queue_capacity=1 << 14, table_capacity=1 << 21)

    def run(device, **kw):
        c = TensorModelAdapter(TwoPhaseTensor(7)).checker().coverage().spawn_gpu_bfs(device=device, **kw).join()
        return c, dict(unique=c.unique_state_count(), states=c.state_count(), fps=dict(c._discovery_fps),
                       sample=tuple(c._sampler.fingerprints()), cov=c.coverage())

    kernels.reset_launches()
    c, spilled = run("cuda", **opts)
    assert kernels.RING_DRAIN.launches > 0 and kernels.RING_REFILL.launches > 0
    assert c.telemetry()["spill_rows"] > 0
    _c, unspilled = run("cuda", **dict(opts, queue_capacity=1 << 20))
    assert spilled["unique"] == 296_448
    assert {k: spilled[k] for k in ("unique", "states", "sample")} == {
        k: unspilled[k] for k in ("unique", "states", "sample")}


# K2 and K7s as redesigned: their edges against the plain versions, bit
# for bit; K2's launches a call counted on the card, and its replay.

K2_EDGES = [
    (0, 0.5, 8), (50, 0.5, 0), (0, 0.0, 0), (100, 0.7, 1_000),        # n = 0, cap = 0, cap > n
    (3 * 4096 - 1, 0.4, 5_000), (3 * 4096, 0.4, 5_000), (3 * 4096 + 1, 0.4, 5_000),  # tile edges
    (3 * 4096 + 1, 0.9, 2_000), (4096, 1.0, 4095),                    # n_set > cap
    (4096 * 1024 + 77, 0.01, 50_000),                                  # two sub-tiles a tile
]


@pytest.mark.parametrize("n,density,cap", K2_EDGES)
def test_compact_ids_kernel_edges(dev, n, density, cap):
    """Solo K2 at its edges, on aligned masks and on views 1, 3 and 8
    bytes past 16-byte alignment (the byte loads)."""
    rng = np.random.default_rng(n + cap)
    big = torch.from_numpy(rng.random(n + 16) < density).to(dev)
    for o in (0, 1, 3, 8):
        mask = big[o:o + n]
        for a, b in zip(vs.compact_ids(mask, cap), vs.compact_ids_plain(mask, cap)):
            assert torch.equal(a, b), o


@pytest.mark.parametrize("N,A,C", [(8, 37, 55), (2, 37, 6144), (1024, 27, 151), (3, 1, 4097)])
def test_compact_ids_lanes_kernel_transposed_views(dev, N, A, C):
    """The lanes' and the mesh's [A, N, C] mask read as [N, A, C]: C = 55
    (2pc-7's chunk after the spill clamp), 6,144 (the bench chunk), the
    2pc-5 sweep's 1,024 lanes; caps under and over n_set."""
    from stateright_tpu_torch.engines.era import widths

    amask = torch.from_numpy(np.random.default_rng(C).random((A, N, C)) < 0.3).to(dev)
    view = amask.transpose(0, 1)
    vcap = widths(A, C)[0]
    for cap in (vcap, max(1, vcap // 8)):
        for a, b in zip(vs.compact_ids_lanes(view, cap), vs.compact_ids_lanes_plain(view, cap)):
            assert torch.equal(a, b)


def test_compact_ids_launches_two_kernels_a_call(dev):
    """Counted on the card: the kernel nodes of one captured call (solo,
    lanes), none of them a memset; COUNT is skipped on an empty mask."""
    from stateright_tpu_torch.engines import graph

    rng = np.random.default_rng(5)
    mask = torch.from_numpy(rng.random(227_328) < 0.3).to(dev)
    amask = torch.from_numpy(rng.random((27, 1024, 151)) < 0.3).to(dev)
    for fn, want in ((lambda: vs.compact_ids(mask, 75_776), 2),
                     (lambda: vs.compact_ids_lanes(amask.transpose(0, 1), 1_359), 2),
                     (lambda: vs.compact_ids(mask[:0], 8), 1)):
        fn()
        counts = graph.captured_nodes(fn)
        assert counts["kernels"] == want and counts["memsets"] == 0, counts


def test_compact_ids_graph_replays_with_no_reset(dev):
    """One K2 call captured once and replayed three times on changed
    masks gives the plain results each time, with nothing reset."""
    from stateright_tpu_torch.engines import graph

    rng = np.random.default_rng(6)
    n, cap = 344_064, 114_688
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    amask = torch.zeros((21, 16, 55), dtype=torch.bool, device=dev)
    vs.compact_ids(mask, cap), vs.compact_ids_lanes(amask.transpose(0, 1), 300)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with graph.capture_guard() as stream:
        with torch.cuda.graph(g, stream=stream):
            solo = vs.compact_ids(mask, cap)
            lanes = vs.compact_ids_lanes(amask.transpose(0, 1), 300)
    for density in (0.3, 0.95, 0.0):
        mask.copy_(torch.from_numpy(rng.random(n) < density))
        amask.copy_(torch.from_numpy(rng.random((21, 16, 55)) < density))
        g.replay()
        torch.cuda.synchronize()
        for a, b in zip(solo, vs.compact_ids_plain(mask, cap)):
            assert torch.equal(a, b), density
        for a, b in zip(lanes, vs.compact_ids_lanes_plain(amask.transpose(0, 1), 300)):
            assert torch.equal(a, b), density


SPILL_EDGES = [
    ([(1 << 12) - 3], [1 << 12]),                       # odd start, the whole ring, wrapping
    ([6], [3_333]),                                     # even start, no wrap
    ([4_095, 0, 1, 2_000, 17, 3_000], [1, 0, 2, 4_096, 1_639, 2_222]),  # k = 1, 0, whole; ragged
]


@pytest.mark.parametrize("W", [5, 32, 7])
@pytest.mark.parametrize("starts,ks", SPILL_EDGES)
def test_ring_spill_kernel_edges(dev, W, starts, ks):
    """K7s DRAIN and REFILL at the bundled models' widths (5, 32) and one
    no bundled model has (7): odd and even starts, a wrap at qmask, k = 0, 1 and a
    whole ring; the drain into, and the refill from, a block 3 rows
    into its buffer (off x W not a multiple of 4 words)."""
    qcap = 1 << 12
    gen = torch.Generator(device=dev).manual_seed(W + len(ks))
    rings = torch.randint(0, 1 << 32, (len(ks), W, qcap + 1), dtype=torch.int64, device=dev, generator=gen)
    rings[..., qcap] = 0
    K = sum(ks)
    want = fr.ring_drain_lanes_plain(rings, starts, ks)
    assert torch.equal(fr.ring_drain_lanes(rings, starts, ks), want)
    buf = torch.zeros((K + 3, W), dtype=torch.int32, device=dev)
    assert torch.equal(fr.ring_drain_lanes(rings, starts, ks, buf[3:]), want)
    tails = [s + 1_001 for s in starts]
    a, b = rings.clone(), rings.clone()
    buf[3:] = want
    fr.ring_refill_lanes(a, tails, ks, buf[3:])
    fr.ring_refill_lanes_plain(b, tails, ks, want)
    assert torch.equal(a, b)
    assert int(a[..., qcap].abs().sum()) == 0


@pytest.mark.parametrize("starts,ks", SPILL_EDGES)
def test_ring_spill_runtime_width_kernel_at_w5(dev, starts, ks):
    """The runtime-W K7s kernel at W = 5, where the wrappers launch the
    one with W a constant (kernel_times.py times one against the other):
    DRAIN and REFILL equal the plain versions bit for bit."""
    W, qcap = 5, 1 << 12
    gen = torch.Generator(device=dev).manual_seed(len(ks))
    rings = torch.randint(0, 1 << 32, (len(ks), W, qcap + 1), dtype=torch.int64, device=dev, generator=gen)
    rings[..., qcap] = 0
    want = fr.ring_drain_lanes_plain(rings, starts, ks)
    got = torch.zeros((sum(ks), W), dtype=torch.int32, device=dev)
    fr._spill_launch(kernels.RING_DRAIN, rings, starts, ks, got, specialise=False)
    assert torch.equal(got, want)
    tails = [s + 1_001 for s in starts]
    a, b = rings.clone(), rings.clone()
    fr._spill_launch(kernels.RING_REFILL, a, tails, ks, want, specialise=False)
    fr.ring_refill_lanes_plain(b, tails, ks, want)
    assert torch.equal(a, b)


def test_analyze_after_a_readback_heavy_run(dev):
    """The speclint probe's capture right after a BFS run whose eras each
    read their state back through pinned slots, in one process: both go
    through graph.capture_guard, and the report equals the CPU's."""
    import gc

    from stateright_tpu_torch import analyze

    c = TensorModelAdapter(TwoPhaseTensor(5)).checker().spawn_gpu_bfs(device=dev, **PIPE_OPTS).join()
    assert c.unique_state_count() == 8832 and c.telemetry()["eras"] >= 30
    del c
    gc.collect()
    for model in (TwoPhaseTensor(5), TwoPhaseTensor(3)):
        on_card, on_cpu = analyze(model, device=dev), analyze(model, device="cpu")
        assert on_card.to_dict() == on_cpu.to_dict()
        assert on_card.probes["captures"] >= 2 and on_card.probes["graph_launches"] >= 1


# -- K11: EXPAND and WALK ------------------------------------------------------

def _bfs_rows(dev, tm, opts, target=0):
    """[S + 2, n] (lanes, ebits, depth): every state a BFS on the card took,
    from its ring (a run that does not wrap it)."""
    from stateright_tpu_torch.engines import era

    kept = []
    free = era.EraProgram.free_graph

    def keep(self):
        kept.append(self)
        free(self)

    era.EraProgram.free_graph = keep
    try:
        b = TensorModelAdapter(tm).checker().target_state_count(target)
        c = b.spawn_gpu_bfs(device=dev, **opts).join()
    finally:
        era.EraProgram.free_graph = free
    return kept[-1].ring[:tm.state_width + 2, :c.unique_state_count()].contiguous()


def _k11_models():
    from stateright_tpu_torch.models import (
        AbdOrderedTensor,
        AbdTensor,
        IncrementLockTensor,
        IncrementTensor,
        PaxosTensor,
        SingleCopyTensor,
    )

    return [
        (TwoPhaseTensor(5), dict(chunk_size=256, queue_capacity=1 << 14, table_capacity=1 << 16)),
        (PaxosTensor(2), dict(chunk_size=256, queue_capacity=1 << 15, table_capacity=1 << 17)),
        (AbdTensor(2), dict(chunk_size=512, queue_capacity=1 << 14, table_capacity=1 << 13)),
        (AbdOrderedTensor(2), dict(chunk_size=512, queue_capacity=1 << 14, table_capacity=1 << 13)),
        (IncrementTensor(2), dict(chunk_size=64, queue_capacity=1 << 10, table_capacity=1 << 12)),
        (IncrementLockTensor(3), dict(chunk_size=64, queue_capacity=1 << 10, table_capacity=1 << 12)),
        (SingleCopyTensor(3), dict(chunk_size=256, queue_capacity=1 << 13, table_capacity=1 << 14)),
        (SingleCopyTensor(3, 2), dict(chunk_size=256, queue_capacity=1 << 13, table_capacity=1 << 14)),
    ]


# 2pc-5, paxos-2, abd-2, abd-ordered-2, increment-2, increment-lock-3,
# single-copy-3 and the 3x2 model
K11_MODELS = range(8)


@pytest.mark.parametrize("which", K11_MODELS)
def test_expand_kernel_matches_plain(dev, which):
    """K11's EXPAND against its plain version, bit for bit, on every
    reachable row of each model of `_k11_models`: an int, a 0-d and a
    per-row depth limit, some rows inactive; `generated` comes from the
    last block's sum."""
    from stateright_tpu_torch.ops.expand import build_expand_lean, build_expand_lean_plain
    from stateright_tpu_torch.xp import TorchXP

    tm, opts = _k11_models()[which]
    rows = _bfs_rows(dev, tm, opts)
    S, W = tm.state_width, rows.shape[1]
    xp, props = TorchXP(dev), tm.tensor_properties()
    k, plain = build_expand_lean(tm, props, W, xp), build_expand_lean_plain(tm, props, W, xp)
    assert k.route == "kernel"
    lanes, ebits, depth = rows[:S], rows[S].contiguous(), rows[S + 1].contiguous()
    active = torch.arange(W, device=dev) % 13 != 4
    limits = (0xFFFFFFFF, torch.tensor(6, device=dev), (torch.arange(W, device=dev) % 9).to(torch.int64))
    for dl in limits:
        a, b = k(lanes, ebits, depth, active, dl), plain(lanes, ebits, depth, active, dl)
        assert torch.equal(a.ebits, b.ebits) and torch.equal(a.flat, b.flat)
        assert torch.equal(a.valid, b.valid) and int(a.generated) == int(b.generated)
        assert torch.equal(torch.stack(a.prop_hits), torch.stack(b.prop_hits))


@pytest.mark.parametrize("which", K11_MODELS)
def test_walk_kernel_matches_plain(dev, which):
    from stateright_tpu_torch.ops.expand import build_walk_step, build_walk_step_plain
    from stateright_tpu_torch.xp import TorchXP

    tm, opts = _k11_models()[which]
    rows = _bfs_rows(dev, tm, opts)[:tm.state_width].contiguous()
    xp, props = TorchXP(dev), tm.tensor_properties()
    k = build_walk_step(tm, props, xp)
    assert k.route == "kernel"
    for x, y in zip(k(rows), build_walk_step_plain(tm, props, xp)(rows)):
        assert torch.equal(x, y)


def test_expand_kernel_one_node_a_call_and_replays(dev):
    """One kernel node and no memset a captured EXPAND; replayed, the graph
    sums `generated` again from a reset ticket."""
    from stateright_tpu_torch.engines import graph
    from stateright_tpu_torch.ops.expand import build_expand_lean, build_walk_step
    from stateright_tpu_torch.xp import TorchXP

    tm, opts = _k11_models()[0]
    rows = _bfs_rows(dev, tm, opts)
    W = rows.shape[1]
    xp, props = TorchXP(dev), tm.tensor_properties()
    k = build_expand_lean(tm, props, W, xp)
    args = (rows[:3], rows[3].contiguous(), rows[4].contiguous(), torch.ones(W, dtype=torch.bool, device=dev),
            torch.tensor(0xFFFFFFFF, device=dev))
    want = int(k(*args).generated)
    counts = graph.captured_nodes(lambda: k(*args))
    assert counts["kernels"] == 1 and counts["memsets"] == 0, counts
    walk = build_walk_step(tm, props, xp)
    counts = graph.captured_nodes(lambda: walk(rows[:3].contiguous()))
    assert counts["kernels"] == 1 and counts["memsets"] == 0, counts
    g = torch.cuda.CUDAGraph()
    with graph.capture_guard() as stream:
        with torch.cuda.graph(g, stream=stream):
            out = k(*args)
    for _ in range(3):
        out.generated.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert int(out.generated) == want


def test_expand_route_in_the_engines(dev):
    """`telemetry()["expand_route"]`: the kernel for 2PC and increment, once
    a BFS step, and once a walk step; the plain version for a subclass of
    increment (no kernel of its own), with no K11 launch."""
    from stateright_tpu_torch.models import IncrementTensor

    class IncrementSub(IncrementTensor):
        pass

    opts = dict(chunk_size=64, queue_capacity=1 << 12, table_capacity=1 << 11, sync_steps=4)
    for tm, route, kern in ((TwoPhaseTensor(5), "kernel", kernels.EXPAND_2PC),
                            (IncrementTensor(2), "kernel", kernels.EXPAND_INCREMENT),
                            (IncrementSub(2), "plain", None)):
        torch.cuda.synchronize()
        kernels.reset_launches()
        c = TensorModelAdapter(tm).checker().spawn_gpu_bfs(device=dev, **opts).join()
        torch.cuda.synchronize()
        n = kernels.launch_counts()
        assert c.telemetry()["expand_route"] == route
        if kern is None:
            assert not any(n[k.name] for k in kernels.EXPAND_KERNELS + kernels.WALK_KERNELS)
        else:
            assert n[kern.name] == n["claim_dedup"] > 0
    kernels.reset_launches()
    c = (TensorModelAdapter(TwoPhaseTensor(5)).checker().target_state_count(20_000)
         .spawn_gpu_simulation(11, walks=256, walk_cap=64, sync_steps=4, device=dev).join())
    torch.cuda.synchronize()
    n = kernels.launch_counts()
    assert c.telemetry()["expand_route"] == "kernel"
    assert n["walk_2pc"] == n["walk_step"] > 0


# -- K11 for ABD and increment, K11c: the engines on the card ----------------

def _k11_run(model, device, how, opts, seed=0, configure=lambda b: b):
    """A BFS or simulation of `model` on `device`: its results (counts,
    discoveries, coverage, the sample) and the routes it reports."""
    b = configure(TensorModelAdapter(model).checker())
    if how == "bfs":
        c = b.spawn_gpu_bfs(device=device, **opts).join()
    else:
        c = b.spawn_gpu_simulation(seed, device=device, **opts).join()
    tel = c.telemetry()
    if how == "bfs":
        found = dict(c._discovery_fps)
    else:
        found = {k: v.encode(c.model()) for k, v in c.discoveries().items()}
    got = (c.unique_state_count() if how == "bfs" else tel["steps"], c.state_count(), c.max_depth(),
           found, c.coverage(), tuple(c._sampler.fingerprints()))
    return got, tel["expand_route"], tel.get("canon_route")


@pytest.mark.parametrize("case", ["abd-ordered-3", "abd-2", "2pc-5 symmetry", "increment-2 simulation",
                                  "single-copy-3x2", "single-copy-3x2 simulation", "increment-lock-3"])
def test_k11_engines_cuda_match_cpu(dev, case):
    """abd-ordered-3 and abd-2 BFS at the reference bench's options
    (bench.py:1137-1161), 2pc-5 under .symmetry(), the increment-2
    simulation to its "fin" counterexample (seed 7), the single-copy 3x2
    linearizability violation by BFS at bench.py:1205-1225's options and
    by the simulation, and increment-lock-3: cuda == cpu, the card on the
    kernel routes, each kernel launched once a step."""
    from stateright_tpu_torch.has_discoveries import HasDiscoveries
    from stateright_tpu_torch.models import AbdOrderedTensor, AbdTensor, IncrementLockTensor, IncrementTensor
    from stateright_tpu_torch.models import SingleCopyTensor

    def lin(b):
        return b.finish_when(HasDiscoveries.any_of(["linearizable"]))

    make, how, opts, configure, kern, golden = {
        "abd-ordered-3": (lambda: AbdOrderedTensor(3), "bfs",
                          dict(chunk_size=2048, queue_capacity=1 << 15, table_capacity=1 << 18),
                          lambda b: b, kernels.EXPAND_ABD, 46_516),
        "abd-2": (lambda: AbdTensor(2), "bfs", dict(chunk_size=512, queue_capacity=1 << 14, table_capacity=1 << 13),
                  lambda b: b, kernels.EXPAND_ABD, 544),
        "2pc-5 symmetry": (lambda: TwoPhaseTensor(5), "bfs",
                           dict(chunk_size=64, queue_capacity=1 << 12, table_capacity=1 << 11, sync_steps=4),
                           lambda b: b.symmetry(), kernels.EXPAND_2PC, 1092),
        "increment-2 simulation": (lambda: IncrementTensor(2), "sim", dict(walks=256, walk_cap=32),
                                   lambda b: b.finish_when(HasDiscoveries.any_of(["fin"])),
                                   kernels.WALK_INCREMENT, "fin"),
        "single-copy-3x2": (lambda: SingleCopyTensor(3, 2), "bfs",
                            dict(chunk_size=256, queue_capacity=1 << 12, table_capacity=1 << 12), lin,
                            kernels.EXPAND_SINGLE_COPY, "linearizable"),
        "single-copy-3x2 simulation": (lambda: SingleCopyTensor(3, 2), "sim",
                                       dict(walks=256, walk_cap=64, sync_steps=8), lin,
                                       kernels.WALK_SINGLE_COPY, "linearizable"),
        "increment-lock-3": (lambda: IncrementLockTensor(3), "bfs",
                             dict(chunk_size=64, queue_capacity=1 << 10, table_capacity=1 << 12),
                             lambda b: b, kernels.EXPAND_INCREMENT_LOCK, 61),
    }[case]
    torch.cuda.synchronize()
    kernels.reset_launches()
    got, route, canon = _k11_run(make(), "cuda", how, opts, 7, configure)
    torch.cuda.synchronize()
    n = kernels.launch_counts()
    assert route == "kernel"
    steps = n["claim_dedup"] if how == "bfs" else n["walk_step"]
    assert n[kern.name] == steps > 0
    if case == "2pc-5 symmetry":
        assert canon == "kernel" and n["canon_2pc"] == steps
    else:
        assert n["canon_2pc"] == 0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small CPU ops: the thread pool only slows them
    try:
        want, cpu_route, _canon = _k11_run(make(), "cpu", how, opts, 7, configure)
    finally:
        torch.set_num_threads(threads)
    assert cpu_route == "plain"
    assert got == want
    if isinstance(golden, int):
        assert got[0] == golden
    else:
        assert golden in got[3]


def test_analyze_runs_the_kernel_probe(dev):
    """analyze() of a kernel-route model on the card holds numpy against
    the kernel the engines run: its K11 WALK launches once (2PC's canon
    once more, for the symmetry family), it finds nothing, and the report
    equals the cpu's."""
    from stateright_tpu_torch import analyze
    from stateright_tpu_torch.models import IncrementLockTensor, SingleCopyTensor
    from stateright_tpu_torch.ops.expand import kernel_of

    models = [tm for tm, _opts in _k11_models()] + [IncrementLockTensor(2), SingleCopyTensor(4)]
    for tm in models:
        walk = kernel_of(tm, tm.tensor_properties())[1]
        torch.cuda.synchronize()
        kernels.reset_launches()
        on_card = analyze(tm, device=dev)
        torch.cuda.synchronize()
        n = kernels.launch_counts()
        assert n[walk.name] == 1, (type(tm).__name__, n)
        assert n["canon_2pc"] == (1 if isinstance(tm, TwoPhaseTensor) else 0)
        assert walk.name in on_card.probes["kernels"]
        assert not {d.code for d in on_card.diagnostics} & {"STR205", "STR404"}
        assert on_card.to_dict() == analyze(tm, device="cpu").to_dict()


def test_canon_kernel_matches_plain_one_node_a_call(dev):
    """K11c against its plain version, bit for bit, on the canon's inputs of
    a 2pc-5 symmetry BFS (every valid successor of its representatives at
    chunk 64, compacted as the step does) and on seeded uint32 rows at
    n = 10 and 16; one kernel node and no memset a captured call."""
    from stateright_tpu_torch.engines import graph
    from stateright_tpu_torch.engines.era import widths
    from stateright_tpu_torch.ops.canon import build_canon, build_canon_plain
    from stateright_tpu_torch.ops.expand import build_expand_lean
    from stateright_tpu_torch.xp import TorchXP

    xp = TorchXP(dev)
    tm = TwoPhaseTensor(5)
    rows = _bfs_rows(dev, tm, dict(chunk_size=64, queue_capacity=1 << 12, table_capacity=1 << 11))
    C = 64
    vcap = widths(tm.max_actions, C)[0]
    expand = build_expand_lean(tm, tm.tensor_properties(), C, xp)
    k, plain = build_canon(tm, xp), build_canon_plain(tm, xp)
    assert k.route == "kernel"
    for at in range(0, rows.shape[1] - C + 1, C):
        chunk = rows[:, at:at + C]
        ex = expand(chunk[:3].contiguous(), chunk[3].contiguous(), chunk[4].contiguous(),
                    torch.ones(C, dtype=torch.bool, device=dev), 0xFFFFFFFF)
        vids, _v, _n = vs.compact_ids(ex.valid, vcap)
        cl = ex.flat.index_select(1, vids)
        assert torch.equal(k(cl), plain(cl))
    rng = np.random.default_rng(16)
    for n in (10, 16):
        big = TwoPhaseTensor(n)
        lanes = torch.from_numpy(_u32(rng, 3, 50_000)).to(dev)
        kb = build_canon(big, xp)
        assert torch.equal(kb(lanes), build_canon_plain(big, xp)(lanes))
        counts = graph.captured_nodes(lambda: kb(lanes))
        assert counts["kernels"] == 1 and counts["memsets"] == 0, counts


# -- K3 without its memset, K15f's COMMIT grid -------------------------------

def test_claim_dedup_prefix_on_a_stale_scratch_in_a_replayed_graph(dev):
    """K3's solo and lane calls, each on one program-owned scratch,
    captured once and replayed on new keys and prefixes (0, partial, the
    whole width, past it) with the stale slots of every earlier call left
    in the scratch: the plain results each time; two kernel nodes and no
    memset a call."""
    from stateright_tpu_torch.engines import graph

    rng = np.random.default_rng(61)
    N, n, cap = 37, 3_000, 1 << 13
    pool = _u32(rng, 2, 400)
    h1, h2 = (torch.zeros((N, n), dtype=torch.int64, device=dev) for _ in range(2))
    valid = torch.zeros((N, n), dtype=torch.bool, device=dev)
    n_val = torch.zeros(N, dtype=torch.int64, device=dev)
    scratch = fr.dedup_scratch(N, cap, dev)
    solo_scratch = fr.dedup_scratch(1, cap, dev)

    def lane_call():
        return fr.claim_dedup_lanes(h1, h2, valid, cap, n_val, scratch)

    def solo_call():
        return fr.claim_dedup(h1[3], h2[3], valid[3], cap, n_val[3], solo_scratch)

    def calls():
        return lane_call(), solo_call()

    for fn in (lane_call, solo_call):
        fn()
        counts = graph.captured_nodes(fn)
        assert counts["kernels"] == 2 and counts["memsets"] == 0, counts
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with graph.capture_guard() as stream:
        with torch.cuda.graph(g, stream=stream):
            lanes, solo = calls()
    for rep in range(4):
        pick = rng.integers(0, 400, size=(N, n))
        h1.copy_(torch.from_numpy(pool[0, pick]))
        h2.copy_(torch.from_numpy(pool[1, pick]))
        nv = np.full(N, n) if rep == 0 else rng.integers(0, n + 1, size=N)
        nv[:3] = [0, n, n + 5] if rep else nv[:3]
        n_val.copy_(torch.from_numpy(nv))
        valid.copy_((torch.arange(n)[None, :] < torch.from_numpy(nv)[:, None])
                    & torch.from_numpy(rng.random((N, n)) < (0.8 if rep == 2 else 1.0)))
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(lanes, fr.claim_dedup_lanes_plain(h1, h2, valid, cap, n_val)), rep
        assert torch.equal(solo, fr.claim_dedup_plain(h1[3], h2[3], valid[3], cap, n_val[3])), rep
    assert int(scratch[-1]) == int(solo_scratch[-1]) == 1 + 4  # the epoch: a rise a call


def _mesh_commit_case(rng, dev, n, closed=False, unres=0.0, ovf=0.0):
    from stateright_tpu_torch.ops import mesh_era as me
    from stateright_tpu_torch.parallel import mesh

    tm = TwoPhaseTensor(5)
    C = 100
    prog = mesh.MeshProgram(tm, tm.tensor_properties(), C, 1 << 12, 1 << 10, n,
                            mesh.quota_for(C, tm.max_actions, n), True, 64, 4, dev)
    c, x, R, P, A = prog.cfg, prog.x, prog.R, prog.P, prog.A
    s = rng.integers(0, 1 << 20, size=(n, prog.L)).astype(np.int64)
    cnt = rng.integers(0, 3 * C, size=n)
    for l in range(n):
        s[l, :me.P_LEN] = [int(rng.integers(0, 1 << 12)), cnt[l], 10 ** 6, 0, 0xFFFFFFFF, 2 * 10 ** 6, 1 << 11,
                           64, 5, 7, 2, 0, C, 1 << (P - 1), 0, 0, 64]
    s[:, x + me.X_ITS] = 3
    s[:, x + me.X_REC0] = 0
    s[:, x + me.X_OPEN] = 0 if closed else 1
    s[:, x + me.X_TAKE] = np.minimum(cnt, C)
    rdepth = rng.integers(1, 40, size=(n, R))
    rdepth[:, :50] = rng.integers(120, 190, size=(n, 50))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    ops = me.MeshOperands(
        is_new=t(rng.random((n, R)) < 0.4), unresolved=t(rng.random((n, R)) < unres), rdepth=t(rdepth),
        n_ovf=t(np.where(rng.random(n) < ovf, 3, 0)), n_val=t(rng.integers(0, c.vcap + 2, size=n)),
        hits=[t(rng.random(n * C) < 0.05) for _ in range(P)], valid=t(rng.random(A * n * C) < 0.3),
        rows=(t(_u32(rng, n * C)), t(_u32(rng, n * C)), t(rng.integers(1, 40, size=n * C))),
        hseen=t(rng.random((P, n * C)) < 0.02), facc1=t(_u32(rng, P, n * C)), facc2=t(_u32(rng, P, n * C)),
        faccd=t(rng.integers(1, 9, size=(P, n * C))), slab_counts=t(rng.integers(0, 700, size=(n, 2))),
    )
    return prog, t(s), ops


def _clone_mesh_ops(o):
    return o._replace(hits=[h.clone() for h in o.hits], rows=tuple(r.clone() for r in o.rows),
                      **{f: getattr(o, f).clone() for f in ("is_new", "unresolved", "rdepth", "n_ovf", "n_val",
                                                            "valid", "hseen", "facc1", "facc2", "faccd",
                                                            "slab_counts")})


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("how", ["clean", "veto", "overflow", "closed"])
def test_mesh_commit_grid_matches_plain(dev, n, how):
    """K15f's COMMIT, one grid launch on one rank (one kernel node, no
    memset), against the plain COMMIT: rows, sums and first-hit lanes; the
    program's scratch left zero."""
    from stateright_tpu_torch.engines import graph
    from stateright_tpu_torch.ops import mesh_era as me

    rng = np.random.default_rng(70 + n)
    prog, st, ops = _mesh_commit_case(rng, dev, n, closed=how == "closed", unres=0.003 if how == "veto" else 0.0,
                                      ovf=0.5 if how == "overflow" else 0.0)
    c = prog.cfg
    sa, sb, oa, ob = st.clone(), st.clone(), _clone_mesh_ops(ops), _clone_mesh_ops(ops)
    za, zb = torch.zeros_like(prog.sums), torch.zeros_like(prog.sums)
    torch.cuda.synchronize()
    kernels.reset_launches()
    me.mesh_era(me.COMMIT, c, sa, za, oa, scratch=prog.commit_scratch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["mesh_commit"] == 1 and counts["mesh_era"] == 0
    me.mesh_era_plain(me.COMMIT, c, sb, zb, ob)
    assert torch.equal(sa, sb) and torch.equal(za, zb)
    for f in ("hseen", "facc1", "facc2", "faccd"):
        assert torch.equal(getattr(oa, f), getattr(ob, f)), f
    assert not prog.commit_scratch.any()
    spare = _clone_mesh_ops(ops)
    nodes = graph.captured_nodes(lambda: me.mesh_era(me.COMMIT, c, st.clone(), za, spare,
                                                     scratch=prog.commit_scratch))
    assert nodes["kernels"] == 1 and nodes["memsets"] == 0, nodes


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_commit_phases_across_ranks_on_one_card(dev, world):
    """The protocol across ranks, its launches made by hand on one card:
    each rank's grid stops after C1 and leaves its accumulators, the sums
    are summed over the ranks, each rank's C2 launch reads and zeroes
    them, the sums again, CGATE: every shard's row as one rank's COMMIT."""
    from stateright_tpu_torch.ops import mesh_era as me

    rng = np.random.default_rng(80 + world)
    n = 8
    prog, st, ops = _mesh_commit_case(rng, dev, n, unres=0.002)
    c = prog.cfg
    want, wsums, wops = st.clone(), torch.zeros_like(prog.sums), _clone_mesh_ops(ops)
    me.mesh_era_plain(me.COMMIT, c, want, wsums, wops)
    nl, C = n // world, c.chunk
    ranks = []
    for r in range(world):
        lo, hi = r * nl, (r + 1) * nl
        cols = slice(lo * C, hi * C)
        o = me.MeshOperands(
            is_new=ops.is_new[lo:hi].clone(), unresolved=ops.unresolved[lo:hi].clone(),
            rdepth=ops.rdepth[lo:hi].clone(), n_ovf=ops.n_ovf[lo:hi].clone(), n_val=ops.n_val[lo:hi].clone(),
            hits=[h[cols].clone() for h in ops.hits],
            valid=ops.valid.view(c.A, n, C)[:, lo:hi].reshape(-1).clone(),
            rows=tuple(t[cols].clone() for t in ops.rows), hseen=ops.hseen[:, cols].clone(),
            facc1=ops.facc1[:, cols].clone(), facc2=ops.facc2[:, cols].clone(), faccd=ops.faccd[:, cols].clone(),
            slab_counts=ops.slab_counts[lo:hi].clone(),
        )
        ranks.append((st[lo:hi].clone(), torch.zeros_like(prog.sums), o, me.commit_scratch(nl, c.P, c.A, dev)))

    def reduce():
        total = sum(r[1] for r in ranks)
        for r in ranks:
            r[1].copy_(total)

    for phase in me.COMMIT:
        for s_, sm, o, scr in ranks:
            me._launch((phase,), c, s_, sm, o, 0, scr, final=False)
        if phase != me.PH_CGATE:
            reduce()
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([r[0] for r in ranks]), want)
    for f in ("hseen", "facc1", "facc2", "faccd"):
        assert torch.equal(torch.cat([getattr(r[2], f) for r in ranks], 1), getattr(wops, f)), f
    assert not any(bool(r[3].any()) for r in ranks)
