"""K2 compaction, K3 in-batch dedup and K7 ring ops of the port (plain
versions) against the JAX ops on the same numpy inputs: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.ops import frontier as jfr
from stateright_tpu.ops import visited_set as jvs
from stateright_tpu_torch.ops import frontier as tfr
from stateright_tpu_torch.ops import visited_set as tvs


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize(
    "n,density,cap",
    [(1000, 0.3, 512), (1000, 0.3, 200), (4096, 0.9, 1024), (64, 0.0, 32), (300, 1.0, 300)],
)
def test_compact_ids_matches_jax(n, density, cap):
    mask = np.random.default_rng(n + cap).random(n) < density
    ids, valid, n_set = tvs.compact_ids(torch.from_numpy(mask), cap)
    j_ids, j_valid, j_n = jvs._compact_ids(jnp.asarray(mask), cap)
    assert np.array_equal(ids.numpy(), np.asarray(j_ids).astype(np.int64))
    assert np.array_equal(valid.numpy(), np.asarray(j_valid))
    assert int(n_set) == int(j_n) == int(mask.sum())


@pytest.mark.parametrize("scratch_cap", [64, 1024])
def test_claim_dedup_matches_jax(scratch_cap):
    rng = np.random.default_rng(scratch_cap)
    n = 2000
    pool = rng.integers(0, 1 << 32, size=(2, 150), dtype=np.uint64).astype(np.uint32)
    pick = rng.integers(0, 150, size=n)
    h1, h2 = pool[0, pick], pool[1, pick]
    # Keys that share h1 and differ in h2 collide on slots; a few extreme
    # values exercise the 32-bit multiply.
    h1[:40] = 7
    h2[:40] = np.arange(40)
    h2[40:60] = 0xFFFFFFFF
    valid = rng.random(n) < 0.8
    keep = tfr.claim_dedup(_t(h1), _t(h2), torch.from_numpy(valid), scratch_cap)
    j_keep = jfr.claim_dedup(jnp.asarray(h1), jnp.asarray(h2), jnp.asarray(valid), scratch_cap)
    assert np.array_equal(keep.numpy(), np.asarray(j_keep))
    # Every distinct valid key keeps at least one candidate.
    kept = set(zip(h1[keep.numpy()], h2[keep.numpy()]))
    assert kept == set(zip(h1[valid], h2[valid]))


def test_ring_gather_and_scatter_across_wrap():
    rng = np.random.default_rng(3)
    W, qcap, n = 5, 256, 96
    ring_np = rng.integers(0, 1 << 32, size=(W, qcap), dtype=np.uint64).astype(np.uint32)
    ring = tfr.empty_ring(W, qcap, "cpu")
    ring[:, :qcap] = _t(ring_np)
    head = 200  # a pop of 96 rows wraps past the end
    rows, idx = tfr.ring_gather(ring, head, n)
    j_rows, j_idx = jfr.ring_gather(tuple(jnp.asarray(l) for l in ring_np), jnp.uint32(head), n)
    assert np.array_equal(idx.numpy(), np.asarray(j_idx).astype(np.int64))
    assert np.array_equal(rows.numpy(), np.stack([np.asarray(l) for l in j_rows]).astype(np.int64))

    cand = rng.integers(0, 1 << 32, size=(W, n), dtype=np.uint64).astype(np.uint32)
    valid = rng.random(n) < 0.6
    tail = 230
    tfr.ring_scatter(ring, tail, _t(cand), torch.from_numpy(valid))
    j_ring = jfr.ring_scatter(
        tuple(jnp.asarray(l) for l in ring_np), jnp.uint32(tail),
        tuple(jnp.asarray(c) for c in cand), jnp.asarray(valid),
    )
    assert np.array_equal(ring[:, :qcap].numpy(), np.stack([np.asarray(l) for l in j_ring]).astype(np.int64))
