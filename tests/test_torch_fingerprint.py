"""The port's fingerprints (K1 plain version and the host hashes) against
the JAX package's, bit for bit."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu_torch import fingerprint as tfp

# The JAX package's __init__ exports a function named `fingerprint`.
jfp = importlib.import_module("stateright_tpu.fingerprint")

# 3-lane rows whose raw hash halves are both 0, so h2 must become 1.
# Found by inverting the last absorb round of each half (a bijection in
# its last word, and the final avalanche maps 0 to 0) and searching all
# 2^32 values of w0 for a fixed point, with w1 = 0.
BOTH_ZERO_ROWS = ((2392970816, 0, 4120996650), (2503669636, 0, 1754888951))


def _rows(S, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, size=(S, n), dtype=np.uint64).astype(np.uint32)
    x[:, :16] = 0xFFFFFFFF - np.arange(16, dtype=np.uint32)[None, :]
    x[:, 16:20] = 0
    x[:, 20:24] = 0x80000000
    return x


def _check_rows(x):
    S = x.shape[0]
    h1, h2 = tfp.hash_lanes(torch.from_numpy(x.astype(np.int64)))
    j1, j2 = jfp.hash_lanes_jnp([jnp.asarray(x[s]) for s in range(S)])
    n1, n2 = jfp.hash_lanes_np(list(x))
    for ours, ref in ((h1, j1), (h2, j2), (h1, n1), (h2, n2)):
        assert np.array_equal(ours.numpy(), np.asarray(ref).astype(np.int64))
    p1, p2 = tfp.hash_lanes_np(list(x))
    assert np.array_equal(p1, n1) and np.array_equal(p2, n2)
    w1, w2 = tfp.hash_words_np(x.T)
    assert np.array_equal(w1, n1) and np.array_equal(w2, n2)
    return h1, h2


@pytest.mark.parametrize("S,seed", [(9, 0), (3, 1), (1, 2)])
def test_hash_lanes_matches_jax(S, seed):
    _check_rows(_rows(S, 4096, seed))


def test_both_zero_rule():
    x = np.asarray(BOTH_ZERO_ROWS, dtype=np.uint32).T
    h1, h2 = _check_rows(x)
    assert h1.tolist() == [0, 0] and h2.tolist() == [1, 1]


def test_mul32_never_overflows():
    a = torch.tensor([0, 1, 0xFFFFFFFF, 0x80000000, 0x12345678], dtype=torch.int64)
    for c in (0x9E3779B9, 0xFFFFFFFF, 3266489917, 1):
        want = [(int(v) * c) & 0xFFFFFFFF for v in a]
        assert tfp.mul32(a, c).tolist() == want


def test_host_fingerprints_match_jax():
    for value in [(1, 2, 3), {"a": frozenset({1, 2})}, "x", None, 2**70]:
        assert tfp.canonical_bytes(value) == jfp.canonical_bytes(value)
        assert tfp.fingerprint(value) == jfp.fingerprint(value)
    fp = tfp.combine64(0xDEADBEEF, 0x12345678)
    assert fp == jfp.combine64(0xDEADBEEF, 0x12345678)
    assert tfp.split64(fp) == jfp.split64(fp)
