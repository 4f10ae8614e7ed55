"""The lane forms of K2, K3, K4 (with the lane seed, K10), K6 and K7
(plain versions) against `jax.vmap` of the JAX op on the same numpy
inputs, bit for bit — the ops the multiplexed engine runs, batched over
its lanes as `stateright_tpu/engines/multiplex.py` vmaps them. The
inputs put the same keys in every lane and same-key contenders inside a
lane, so the winner rule (the highest index within a lane) is held under
batching (ROADMAP P5). Each solo op is also held against its lane form
at one lane."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.fingerprint import hash_lanes_jnp
from stateright_tpu.ops import frontier as jfr
from stateright_tpu.ops import visited_set as jvs
from stateright_tpu_torch.engines.era import seed
from stateright_tpu_torch.engines.gpu_bfs import seed_lanes
from stateright_tpu_torch.ops import frontier as tfr
from stateright_tpu_torch.ops import visited_set as tvs
from torch_parity import reference_uncached  # noqa: F401

N = 4


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _np(x):
    return np.asarray(x).astype(np.int64)


def _keys(rng, *shape):
    return rng.integers(1, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _map(k1, k2, v1, v2):
    k1, k2, v1, v2 = (np.asarray(a) for a in (k1, k2, v1, v2))
    occ = (k1 != 0) | (k2 != 0)
    return {
        (int(a), int(b)): (int(c), int(d))
        for a, b, c, d in zip(k1[occ], k2[occ], v1[occ], v2[occ])
    }


def _port_maps(table):
    """Each lane's key -> parent map of a stacked port table."""
    return [
        _map(*tvs.table_to_lanes(tvs.VisitedTable(table.keys[l], table.parents[l], table.stamps[l])))
        for l in range(table.keys.shape[0])
    ]


def _jax_maps(tables):
    keys, v1, v2 = (np.asarray(a) for a in tables)
    cap = v1.shape[1]
    return [_map(keys[l, :cap], keys[l, cap:], v1[l], v2[l]) for l in range(keys.shape[0])]


# -- K2 ---------------------------------------------------------------------

@pytest.mark.parametrize("n,density,cap", [(1000, 0.3, 512), (1000, 0.5, 200), (300, 1.0, 300), (64, 0.0, 32)])
def test_compact_ids_lanes_matches_vmap(n, density, cap):
    rng = np.random.default_rng(n + cap)
    mask = rng.random((N, n)) < density
    mask[1] = mask[0]  # two lanes alike
    ids, valid, n_set = tvs.compact_ids_lanes(torch.from_numpy(mask), cap)
    j_ids, j_valid, j_n = jax.vmap(lambda m: jvs._compact_ids(m, cap))(jnp.asarray(mask))
    assert np.array_equal(ids.numpy(), _np(j_ids))
    assert np.array_equal(valid.numpy(), np.asarray(j_valid))
    assert np.array_equal(n_set.numpy(), _np(j_n))
    solo = tvs.compact_ids(torch.from_numpy(mask[2]), cap)
    for a, b in zip(solo, (ids[2], valid[2], n_set[2])):
        assert torch.equal(a, b)


def test_compact_ids_lanes_reads_action_major_masks_in_solo_order():
    """The lane step's validity mask is action-major over all lanes,
    [A, N, C]; lane l's compaction must be that of its own [A*C] mask in
    the solo order a*C + c."""
    rng = np.random.default_rng(3)
    A, C, cap = 5, 37, 60
    per_lane = rng.random((N, A, C)) < 0.4
    flat = np.ascontiguousarray(per_lane.transpose(1, 0, 2))  # [A, N, C]
    view = torch.from_numpy(flat).view(A, N, C).transpose(0, 1)
    ids, valid, n_set = tvs.compact_ids_lanes(view, cap)
    j = jax.vmap(lambda m: jvs._compact_ids(m, cap))(jnp.asarray(per_lane.reshape(N, A * C)))
    for a, b in zip((ids, valid, n_set), j):
        assert np.array_equal(a.numpy().astype(np.int64), _np(b))


# -- K3 ---------------------------------------------------------------------

@pytest.mark.parametrize("scratch_cap", [64, 1024])
def test_claim_dedup_lanes_matches_vmap(scratch_cap):
    rng = np.random.default_rng(scratch_cap)
    n = 1500
    pool = rng.integers(0, 1 << 32, size=(2, 150), dtype=np.uint64).astype(np.uint32)
    pick = rng.integers(0, 150, size=(N, n))
    h1, h2 = pool[0, pick], pool[1, pick]
    # One key pool for every lane (cross-lane collisions), keys sharing
    # h1 with different h2 (slot contenders), extreme values.
    h1[:, :40] = 7
    h2[:, :40] = np.arange(40)
    h2[:, 40:60] = 0xFFFFFFFF
    h1[3] = h1[0]
    h2[3] = h2[0]
    valid = rng.random((N, n)) < 0.8
    keep = tfr.claim_dedup_lanes(_t(h1), _t(h2), torch.from_numpy(valid), scratch_cap)
    j_keep = jax.vmap(lambda a, b, v: jfr.claim_dedup(a, b, v, scratch_cap))(
        jnp.asarray(h1), jnp.asarray(h2), jnp.asarray(valid)
    )
    assert np.array_equal(keep.numpy(), np.asarray(j_keep))
    solo = tfr.claim_dedup(_t(h1[1]), _t(h2[1]), torch.from_numpy(valid[1]), scratch_cap)
    assert torch.equal(solo, keep[1])


# -- K4 and K10 -------------------------------------------------------------

def _vmap_insert(tables, h1, h2, p1, p2, act):
    def one(t, a, b, c, d, e):
        t, is_new, unres, _ovf = jvs.insert(t, a, b, c, d, e)
        return t, is_new, unres

    return jax.jit(jax.vmap(one))(tables, *(jnp.asarray(x) for x in (h1, h2, p1, p2, act)))


@pytest.mark.parametrize("cap,m", [(1 << 12, 600), (1 << 10, 200)])
def test_insert_lanes_matches_vmap_and_keeps_the_winner_rule(cap, m):
    rng = np.random.default_rng(cap + m)
    n_dup = 48
    base = _keys(rng, 2, m)
    base[0, :n_dup] = 0xCAFEF00D  # one key, n_dup contenders a lane
    base[1, :n_dup] = 0x0BADBEEF
    h = np.stack([base[:, rng.permutation(m)] for _ in range(N)], axis=1)  # [2, N, m]
    h[:, 2, :] = h[:, 1, :]  # two lanes alike
    p = _keys(rng, 2, N, m)
    act = rng.random((N, m)) < 0.9
    table = tvs.empty_table(cap, "cpu", lanes=N)
    jt = jax.vmap(lambda _: jvs.empty_table(cap))(jnp.arange(N))
    known = None
    for _ in range(2):  # the second call finds keys of the first
        is_new, unres = tvs.insert_lanes(table, _t(h[0]), _t(h[1]), _t(p[0]), _t(p[1]), torch.from_numpy(act))
        jt, j_new, j_unres = _vmap_insert(jt, h[0], h[1], p[0], p[1], act)
        assert np.array_equal(is_new.numpy(), np.asarray(j_new))
        assert np.array_equal(unres.numpy(), np.asarray(j_unres))
        assert _port_maps(table) == _jax_maps(jt)
        if known is None:
            known = is_new.numpy().copy()
            for lane in range(N):
                dup = np.flatnonzero((h[0, lane] == 0xCAFEF00D) & act[lane])
                assert np.flatnonzero(known[lane, dup]).tolist() == [len(dup) - 1]
                assert _port_maps(table)[lane][(0xCAFEF00D, 0x0BADBEEF)] == (
                    int(p[0, lane, dup[-1]]), int(p[1, lane, dup[-1]]))
        p = _keys(rng, 2, N, m)
    assert not is_new.numpy().any()
    # The solo insert is the one-lane case.
    solo = tvs.empty_table(cap, "cpu")
    one = tvs.insert(solo, _t(h[0, 3]), _t(h[1, 3]), _t(p[0, 3]), _t(p[1, 3]), torch.from_numpy(act[3]))
    again = tvs.insert_lanes_plain(
        tvs.empty_table(cap, "cpu", lanes=1), _t(h[0, 3:]), _t(h[1, 3:]), _t(p[0, 3:]), _t(p[1, 3:]),
        torch.from_numpy(act[3:]),
    )
    for a, b in zip(one, again):
        assert torch.equal(a, b[0])


def test_seed_lanes_matches_the_vmapped_lane_seed():
    """K10's lane form against the seeding half of the reference's
    `one_lane` (multiplex.py:117-143) under vmap: n_init is data, a
    padding lane has 0, duplicate inits keep one key and every row."""
    rng = np.random.default_rng(17)
    S, icap, tcap, qcap = 3, 16, 1 << 10, 64
    W = S + 2
    rows = _keys(rng, S, icap)
    rows[:, 5] = rows[:, 2]  # a duplicate init
    n_init = np.array([7, 7, 0, 7], dtype=np.uint32)
    ebits = 5
    table = tvs.empty_table(tcap, "cpu", lanes=N)
    rings = tfr.empty_ring(W, qcap, "cpu", lanes=N)
    unique, unres = seed_lanes(table, rings, _t(rows), _t(n_init), ebits)

    def one_lane(qinit, n, h1, h2):
        u = jnp.uint32
        valid = jnp.arange(icap, dtype=u) < n
        zero = jnp.zeros(icap, dtype=u)
        t, is_new, unresolved, _ = jvs.insert(
            jvs.empty_table(tcap), jnp.where(valid, h1, u(0)), jnp.where(valid, h2, u(0)), zero, zero, valid
        )
        queue = jnp.stack([jnp.zeros(qcap, dtype=u).at[:icap].set(jnp.where(valid, qinit[i], u(0)))
                           for i in range(W)])
        return t, queue, is_new.sum(dtype=u), unresolved.sum(dtype=u)

    h1, h2 = hash_lanes_jnp(tuple(jnp.asarray(r) for r in rows))
    qinit = np.zeros((W, icap), dtype=np.uint32)
    qinit[:S] = rows
    qinit[S] = ebits
    qinit[S + 1] = 1
    jt, jq, j_unique, j_unres = jax.vmap(one_lane)(
        jnp.asarray(np.broadcast_to(qinit, (N, W, icap))), jnp.asarray(n_init),
        jnp.broadcast_to(h1, (N, icap)), jnp.broadcast_to(h2, (N, icap)),
    )
    assert np.array_equal(unique.numpy(), _np(j_unique))
    assert unique.tolist() == [6, 6, 0, 6] and not unres.any() and not np.asarray(j_unres).any()
    assert _port_maps(table) == _jax_maps(jt)
    assert np.array_equal(rings[:, :, :qcap].numpy(), _np(jq))
    # The solo seed takes the same rows into the same table and ring.
    t1, r1 = tvs.empty_table(tcap, "cpu"), tfr.empty_ring(W, qcap, "cpu")
    new, _unres = seed(t1, r1, _t(rows[:, :7]), ebits)
    assert int(new) == 6 and torch.equal(r1, rings[0])
    assert _map(*tvs.table_to_lanes(t1)) == _port_maps(table)[0]


# -- K6 ---------------------------------------------------------------------

def test_lookup_parent_lanes_matches_vmap():
    rng = np.random.default_rng(23)
    cap, m = 1 << 11, 300
    h = _keys(rng, 2, N, m)
    h[:, 1] = h[:, 0]  # the same keys in two lanes, other parents
    p = _keys(rng, 2, N, m)
    act = np.ones((N, m), dtype=bool)
    table = tvs.empty_table(cap, "cpu", lanes=N)
    tvs.insert_lanes(table, _t(h[0]), _t(h[1]), _t(p[0]), _t(p[1]), torch.from_numpy(act))
    jt, _, _ = _vmap_insert(jax.vmap(lambda _: jvs.empty_table(cap))(jnp.arange(N)), h[0], h[1], p[0], p[1], act)
    # Queries: every lane asks its own keys, lane 0's keys (found only in
    # lanes 0 and 1) and absent keys.
    q = np.concatenate([h[:, :, :50], np.broadcast_to(h[:, :1, 50:80], (2, N, 30)), _keys(rng, 2, N, 10)], axis=2)
    j_found, j_p1, j_p2 = jax.vmap(jvs.lookup_parent)(jt, jnp.asarray(q[0]), jnp.asarray(q[1]))
    lane = torch.arange(N).repeat_interleave(q.shape[2])
    found, p1, p2 = tvs.lookup_parent_lanes(table, lane, _t(q[0].reshape(-1)), _t(q[1].reshape(-1)))
    assert np.array_equal(found.numpy().reshape(N, -1), np.asarray(j_found))
    assert np.array_equal(p1.numpy().reshape(N, -1), _np(j_p1))
    assert np.array_equal(p2.numpy().reshape(N, -1), _np(j_p2))
    assert found.numpy().reshape(N, -1)[:, 50:80].tolist() == [[True] * 30] * 2 + [[False] * 30] * 2
    solo = tvs.VisitedTable(table.keys[2], table.parents[2], table.stamps[2])
    for a, b in zip(tvs.lookup_parent(solo, _t(q[0, 2]), _t(q[1, 2])),
                    tvs.lookup_parent_lanes(table, torch.full((q.shape[2],), 2), _t(q[0, 2]), _t(q[1, 2]))):
        assert torch.equal(a, b)


# -- K7 ---------------------------------------------------------------------

def test_ring_lanes_match_vmap_across_wraps():
    rng = np.random.default_rng(29)
    W, qcap, n = 5, 256, 96
    ring_np = _keys(rng, N, W, qcap)
    rings = tfr.empty_ring(W, qcap, "cpu", lanes=N)
    rings[:, :, :qcap] = _t(ring_np)
    heads = np.array([200, 0, 255, 17], dtype=np.uint32)  # pops that wrap
    jr = tuple(jnp.asarray(ring_np[:, w]) for w in range(W))
    j_rows, _idx = jax.vmap(lambda lanes, h: jfr.ring_gather(lanes, h, n))(jr, jnp.asarray(heads))
    rows = tfr.ring_pop_lanes(rings, _t(heads), n)
    assert np.array_equal(
        rows.numpy(), np.stack([_np(l) for l in j_rows]).reshape(W, N * n)
    )
    cand = _keys(rng, W, N, n)
    valid = rng.random((N, n)) < 0.6
    valid[2] = False  # a closed lane appends nothing
    tails = np.array([230, 10, 250, 255], dtype=np.uint32)
    tfr.ring_scatter_lanes(rings, _t(tails), _t(cand.reshape(W, N * n)), torch.from_numpy(valid))
    j_ring = jax.vmap(lambda lanes, t, c, v: jfr.ring_scatter(lanes, t, c, v))(
        jr, jnp.asarray(tails), tuple(jnp.asarray(cand[w]) for w in range(W)), jnp.asarray(valid)
    )
    assert np.array_equal(rings[:, :, :qcap].numpy(), np.stack([_np(l) for l in j_ring], axis=1))
    assert np.array_equal(rings[2, :, :qcap].numpy(), _np(ring_np[2]))
    # The solo ops are the one-lane case.
    solo = rings[1].clone()
    assert torch.equal(tfr.ring_pop(solo, 7, n), tfr.ring_pop_lanes(rings[1:2], _t([7]), n))
    tfr.ring_scatter(solo, 40, _t(cand[:, 1]), torch.from_numpy(valid[1]))
    tfr.ring_scatter_lanes(rings[1:2], _t([40]), _t(cand[:, 1]), torch.from_numpy(valid[1:2]))
    assert torch.equal(solo[:, :qcap], rings[1, :, :qcap])
