"""K7 ring pop/append and K6 lookup_parent of the port (plain versions)
against the JAX ops on the same numpy inputs: exact equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.ops import frontier as jfr
from stateright_tpu.ops import visited_set as jvs
from stateright_tpu_torch import kernels
from stateright_tpu_torch.ops import frontier as tfr
from stateright_tpu_torch.ops import visited_set as tvs


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _u32(rng, *shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _ring(rng, W, qcap):
    ring_np = _u32(rng, W, qcap)
    ring = tfr.empty_ring(W, qcap, "cpu")
    ring[:, :qcap] = _t(ring_np)
    return ring_np, ring


@pytest.mark.parametrize("W,qcap,head,n", [(5, 256, 200, 96), (3, 64, 0, 64), (32, 1 << 12, 4000, 1000), (1, 16, 15, 1)])
def test_ring_pop_matches_jax(W, qcap, head, n):
    rng = np.random.default_rng(head + n)
    ring_np, ring = _ring(rng, W, qcap)
    rows = tfr.ring_pop(ring, head, n)
    j_rows, _idx = jfr.ring_gather(tuple(jnp.asarray(lane) for lane in ring_np), jnp.uint32(head), n)
    assert torch.equal(rows, tfr.ring_pop_plain(ring, head, n))
    assert np.array_equal(rows.numpy(), np.stack([np.asarray(lane) for lane in j_rows]).astype(np.int64))


# The append's edges at its tile T (columns a COUNT block counts): m at
# T - 1, T and T + 1, many tiles, every column valid, none valid, and a
# tail whose wrap falls inside the first tile.
T = kernels.APPEND_TILE
APPEND_EDGES = [
    (3, 1 << 13, 100, T - 1, 0.4), (3, 1 << 13, 5000, T, 0.4), (3, 1 << 13, 8000, T + 1, 0.4),
    (2, 1 << 15, 30000, 5 * T + 123, 0.5), (3, 1 << 13, 50, T + 17, 1.0), (3, 1 << 13, 9, 2 * T, 0.0),
    (4, 1 << 13, (1 << 13) - 1000, 3 * T, 0.6),
]


@pytest.mark.parametrize("W,qcap,tail,m,density", [
    (5, 256, 230, 96, 0.6), (4, 128, 0, 128, 1.0), (32, 1 << 12, 4090, 900, 0.3), (3, 64, 7, 40, 0.0),
] + APPEND_EDGES)
def test_ring_append_matches_jax(W, qcap, tail, m, density):
    rng = np.random.default_rng(tail + m)
    ring_np, ring = _ring(rng, W, qcap)
    cand = _u32(rng, W, m)
    valid = rng.random(m) < density
    tfr.ring_scatter(ring, tail, _t(cand), torch.from_numpy(valid))
    j_ring = jfr.ring_scatter(
        tuple(jnp.asarray(lane) for lane in ring_np), jnp.uint32(tail),
        tuple(jnp.asarray(c) for c in cand), jnp.asarray(valid),
    )
    assert np.array_equal(ring[:, :qcap].numpy(), np.stack([np.asarray(lane) for lane in j_ring]).astype(np.int64))


@pytest.mark.parametrize("W,qcap,tail,m,density", APPEND_EDGES)
def test_ring_append_lanes_matches_vmap(W, qcap, tail, m, density):
    """The lane form at the same edges, three lanes: this tail, one that
    wraps at the lane's last columns, and one at 0 with none valid."""
    N = 3
    rng = np.random.default_rng(tail + m + 1)
    ring_np = _u32(rng, N, W, qcap)
    rings = tfr.empty_ring(W, qcap, "cpu", lanes=N)
    rings[:, :, :qcap] = _t(ring_np)
    tails = np.array([tail, qcap - 7, 0], dtype=np.uint32)
    cand = _u32(rng, W, N, m)
    valid = rng.random((N, m)) < density
    valid[2] = False
    tfr.ring_scatter_lanes(rings, _t(tails), _t(cand.reshape(W, N * m)), torch.from_numpy(valid))
    j_ring = jax.vmap(lambda lanes, t, c, v: jfr.ring_scatter(lanes, t, c, v))(
        tuple(jnp.asarray(ring_np[:, w]) for w in range(W)), jnp.asarray(tails),
        tuple(jnp.asarray(cand[w]) for w in range(W)), jnp.asarray(valid),
    )
    assert np.array_equal(rings[:, :, :qcap].numpy(), np.stack([np.asarray(lane) for lane in j_ring], axis=1))


def _jax_table(table):
    """The port's table in the JAX layout: (keys [2*cap], v1, v2)."""
    k1, k2, v1, v2 = tvs.table_to_lanes(table)
    return jnp.asarray(np.concatenate([k1, k2])), jnp.asarray(v1), jnp.asarray(v2)


@pytest.mark.parametrize("cap,fill", [(1 << 10, 200), (1 << 12, 1000), (1 << 8, 60)])
def test_lookup_parent_matches_jax(cap, fill):
    rng = np.random.default_rng(cap)
    keys = _u32(rng, 2, fill)
    keys[1, :20] = keys[1, 20:40]  # shared h2, so probe chains cross
    keys[0, 5] = keys[0, 6]  # shared h1: same first slot
    parents = _u32(rng, 2, fill)
    parents[:, :3] = 0  # initial states: no parent
    table = tvs.empty_table(cap, "cpu")
    is_new, unres = tvs.insert(table, _t(keys[0]), _t(keys[1]), _t(parents[0]), _t(parents[1]),
                               torch.ones(fill, dtype=torch.bool))
    assert bool(is_new.all()) and not bool(unres.any())
    absent = _u32(rng, 2, 50)
    q = np.concatenate([keys, absent], axis=1)
    order = rng.permutation(q.shape[1])
    q1, q2 = q[0, order], q[1, order]
    found, p1, p2 = tvs.lookup_parent(table, _t(q1), _t(q2))
    j_found, j_p1, j_p2 = jvs.lookup_parent(_jax_table(table), jnp.asarray(q1), jnp.asarray(q2))
    assert np.array_equal(found.numpy(), np.asarray(j_found))
    assert np.array_equal(p1.numpy(), np.asarray(j_p1).astype(np.int64))
    assert np.array_equal(p2.numpy(), np.asarray(j_p2).astype(np.int64))
    expect = dict(zip(zip(keys[0], keys[1]), zip(parents[0], parents[1])))
    lanes = tvs.table_to_lanes(table)
    for i in range(len(q1)):
        want = expect.get((q1[i], q2[i]))
        assert bool(found[i]) == (want is not None)
        if want is not None:
            assert (int(p1[i]), int(p2[i])) == (int(want[0]), int(want[1]))
        host = tvs.lookup_parent_np(lanes, int(q1[i]), int(q2[i]))
        assert host == (bool(found[i]), int(p1[i]), int(p2[i]))
