"""K4 insert (plain version), K5 rehash and the carry-across of tables
between the JAX package and the port: exact equality of is_new,
unresolved and the key -> parent map (the slot layout may differ)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.ops import visited_set as jvs
from stateright_tpu_torch.ops import visited_set as tvs


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _keys(rng, n):
    return rng.integers(1, 1 << 32, size=(2, n), dtype=np.uint64).astype(np.uint32)


def _jax_insert(jt, h1, h2, p1, p2, active):
    jt, is_new, unres, _ovf = jvs.insert_jit(
        jt, *(jnp.asarray(a) for a in (h1, h2, p1, p2, active))
    )
    return jt, np.asarray(is_new), np.asarray(unres)


def _map(lanes):
    k1, k2, v1, v2 = (np.asarray(a) for a in lanes)
    occ = (k1 != 0) | (k2 != 0)
    return {
        (int(a), int(b)): (int(c), int(d))
        for a, b, c, d in zip(k1[occ], k2[occ], v1[occ], v2[occ])
    }


def _batch(rng, n, known):
    """n candidates: a third already in the table, the rest fresh, with
    in-batch duplicates carrying different parents; 90% active."""
    fresh = _keys(rng, n)
    old = known[:, rng.integers(0, known.shape[1], size=n // 3)]
    h = np.concatenate([old, fresh[:, : n - old.shape[1]]], axis=1)
    h = h[:, rng.permutation(n)]
    h[:, n - n // 8:] = h[:, n // 8: n // 4]
    p = _keys(rng, n)
    return h[0], h[1], p[0], p[1], rng.random(n) < 0.9


@pytest.mark.parametrize("cap,n,seed", [(1 << 12, 600, 0), (1 << 14, 3000, 1), (1 << 10, 200, 2)])
def test_insert_matches_jax(cap, n, seed):
    rng = np.random.default_rng(seed)
    tt = tvs.empty_table(cap, "cpu")
    jt = jvs.empty_table(cap)
    known = _keys(rng, 1)
    for _ in range(2):  # the second batch finds keys of the first
        h1, h2, p1, p2, act = _batch(rng, n, known)
        is_new, unres = tvs.insert(tt, _t(h1), _t(h2), _t(p1), _t(p2), torch.from_numpy(act))
        jt, j_new, j_unres = _jax_insert(jt, h1, h2, p1, p2, act)
        assert np.array_equal(is_new.numpy(), j_new)
        assert np.array_equal(unres.numpy(), j_unres)
        assert _map(tvs.table_to_lanes(tt)) == _map(jvs.unpack_lanes_np(jt))
        known = np.stack([h1[act], h2[act]])
    assert int(tvs.occupied_mask(tt).sum()) == len(_map(tvs.table_to_lanes(tt)))


def test_winner_rule_highest_index():
    rng = np.random.default_rng(5)
    n_dup, n_other = 64, 200
    other = _keys(rng, n_other)
    h1 = np.concatenate([np.full(n_dup, 0xCAFEF00D, np.uint32), other[0]])
    h2 = np.concatenate([np.full(n_dup, 0x0BADBEEF, np.uint32), other[1]])
    order = rng.permutation(n_dup + n_other)
    h1, h2 = h1[order], h2[order]
    p1 = np.arange(1, n_dup + n_other + 1, dtype=np.uint32)
    p2 = p1 * np.uint32(3)
    act = np.ones(n_dup + n_other, dtype=bool)
    tt = tvs.empty_table(1 << 12, "cpu")
    is_new, unres = tvs.insert(tt, _t(h1), _t(h2), _t(p1), _t(p2), torch.from_numpy(act))
    jt, j_new, _ = _jax_insert(jvs.empty_table(1 << 12), h1, h2, p1, p2, act)
    copies = np.flatnonzero(order < n_dup)
    top = copies.max()
    assert np.flatnonzero(is_new.numpy()[copies]).tolist() == [len(copies) - 1]
    assert is_new.numpy()[top] and j_new[top]
    assert np.array_equal(is_new.numpy(), j_new)
    ours = _map(tvs.table_to_lanes(tt))
    assert ours[(0xCAFEF00D, 0x0BADBEEF)] == (int(p1[top]), int(p2[top]))
    assert ours == _map(jvs.unpack_lanes_np(jt))
    assert not unres.any()


def test_rehash_into_4x_table():
    rng = np.random.default_rng(9)
    h = _keys(rng, 900)
    p = _keys(rng, 900)
    act = np.ones(900, dtype=bool)
    old = tvs.empty_table(1 << 12, "cpu")
    tvs.insert(old, _t(h[0]), _t(h[1]), _t(p[0]), _t(p[1]), torch.from_numpy(act))
    new = tvs.empty_table(1 << 14, "cpu")
    assert tvs.rehash(old, new) == 0
    jt, _, _ = _jax_insert(jvs.empty_table(1 << 12), h[0], h[1], p[0], p[1], act)
    j_new, j_unres = jvs.rehash_jit(jt, jvs.empty_table(1 << 14))
    assert int(j_unres) == 0
    assert _map(tvs.table_to_lanes(new)) == _map(jvs.unpack_lanes_np(j_new))
    assert _map(tvs.table_to_lanes(new)) == _map(tvs.table_to_lanes(old))


def test_jax_table_imports_into_port():
    rng = np.random.default_rng(11)
    h = _keys(rng, 1000)
    p = _keys(rng, 1000)
    act = np.ones(1000, dtype=bool)
    jt, _, _ = _jax_insert(jvs.empty_table(1 << 12), h[0], h[1], p[0], p[1], act)
    lanes = jvs.unpack_lanes_np(jt)
    tt = tvs.table_from_lanes(*lanes, device="cpu")
    # Slot for slot: converting back gives the JAX lanes again.
    for ours, ref in zip(tvs.table_to_lanes(tt), lanes):
        assert np.array_equal(ours, np.asarray(ref))
    is_new, unres = tvs.insert(tt, _t(h[0]), _t(h[1]), _t(p[0]), _t(p[1]), torch.from_numpy(act))
    assert not is_new.any() and not unres.any()


def test_port_table_answers_jax_lookups():
    rng = np.random.default_rng(12)
    h = _keys(rng, 1000)
    p = _keys(rng, 1000)
    tt = tvs.empty_table(1 << 12, "cpu")
    tvs.insert(tt, _t(h[0]), _t(h[1]), _t(p[0]), _t(p[1]), torch.ones(1000, dtype=torch.bool))
    lanes = tvs.table_to_lanes(tt)
    for i in range(0, 1000, 7):
        assert jvs.lookup_parent_np(lanes, int(h[0, i]), int(h[1, i])) == (True, int(p[0, i]), int(p[1, i]))
        assert tvs.lookup_parent_np(lanes, int(h[0, i]), int(h[1, i])) == (True, int(p[0, i]), int(p[1, i]))
    # And the JAX device lookup over the same lanes.
    found, q1, q2 = jvs.lookup_parent_jit(jvs.pack_lanes(*lanes), jnp.asarray(h[0]), jnp.asarray(h[1]))
    assert np.asarray(found).all()
    assert np.array_equal(np.asarray(q1), p[0]) and np.array_equal(np.asarray(q2), p[1])
