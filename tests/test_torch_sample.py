"""Bottom-k sampling in the port: the K9a capture and K9b slab epilogue
(plain versions) against the JAX ops the era program runs
(`stateright_tpu/engines/tpu_bfs.py:506-549` and `:983-995`), the copied
`SpaceSampler` against the JAX one, and engine runs with sampling on by
default whose whole parity dict, sample included, equals
`spawn_tpu_bfs`'s."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from stateright_tpu.obs import sample as jsample
from stateright_tpu.ops import visited_set as jvs
from stateright_tpu_torch.obs import sample as tsample
from stateright_tpu_torch.ops import slab as tslab
from torch_parity import OPTS, one_torch_thread, parity_dict, paths, reference_uncached, run_pair  # noqa: F401

K = 64
SCAP = tsample.slab_capacity(K, tsample.DEVICE_STEP_CAP)
SK2 = tsample.slab_entries(K)
CAP = tsample.DEVICE_STEP_CAP
MAX = 0xFFFFFFFF


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def jax_capture(sc, c_new, dh1, dh2, ddepth, dact, st1, st2):
    """The capture of tpu_bfs.py:515-549, its `lax.cond` included."""
    u = jnp.uint32
    st1, st2 = u(st1), u(st2)
    below = c_new & ((dh1 < st1) | ((dh1 == st1) & (dh2 < st2)))

    def _capture(sc):
        sfp1, sfp2, sdep, sact, socc, sdrp = sc
        cids, cvalid, n_c = jvs._compact_ids(below, CAP)
        fit = jnp.minimum(n_c, u(CAP))
        pos = socc + jnp.arange(CAP, dtype=u)
        widx = jnp.where(cvalid & (pos < u(SCAP)), pos, u(SCAP))
        return (
            sfp1.at[widx].set(dh1[cids]), sfp2.at[widx].set(dh2[cids]),
            sdep.at[widx].set(ddepth[cids]), sact.at[widx].set(dact[cids]),
            socc + fit, sdrp + (n_c - fit),
        )

    return lax.cond(below.any(), _capture, lambda sc: sc, sc)


def jax_epilogue(sc, scap=SCAP):
    """The slab epilogue of tpu_bfs.py:991-1003."""
    sfp1, sfp2, sdep, sact, socc, _sdrp = sc
    u = jnp.uint32
    used = jnp.arange(scap, dtype=u) < socc
    skey = jnp.where(used, ~sfp1[:scap], u(0))
    _v, topi = lax.top_k(skey, SK2)
    return (sfp1[:scap][topi], sfp2[:scap][topi], sdep[:scap][topi], sact[:scap][topi], used[topi])


def _batch(rng, n, hi_bits):
    """A step's worth of inserts: n candidates, ~70% new; fingerprints
    drawn below 2^hi_bits in h1 so that a threshold catches a chosen
    share, with the high bit set on some (the unsigned compare)."""
    h1 = rng.integers(0, 1 << hi_bits, size=n, dtype=np.uint64).astype(np.uint32)
    h1[::7] |= np.uint32(0x80000000)
    h2 = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    return (
        rng.random(n) < 0.7, h1, h2,
        rng.integers(1, 40, size=n).astype(np.uint32),
        rng.integers(0, 21, size=n).astype(np.uint32),
    )


@pytest.mark.parametrize(
    "steps",
    [
        # Loose threshold (MAX, MAX): everything new is captured.
        [(MAX, MAX, 200, 32), (MAX, MAX, 300, 32)],
        # A flood past the per-step width: the excess counts as dropped.
        [(MAX, MAX, 2000, 32)],
        # Tight thresholds, ties on h1 decided by h2, and a step where
        # nothing is below (no write at all).
        [(0x00400000, 0x80000000, 5000, 24), (0x00000010, 0, 3000, 32), (0x0040ABCD, MAX, 4000, 23)],
    ],
)
def test_capture_matches_jax(steps):
    rng = np.random.default_rng(len(steps))
    slab = tslab.empty_slab(SCAP, "cpu")
    z = jnp.zeros(SCAP + 1, dtype=jnp.uint32)
    sc = (z, z, z, z, jnp.uint32(0), jnp.uint32(0))
    for t1, t2, n, bits in steps:
        new, h1, h2, dep, act = _batch(rng, n, bits)
        if t1 not in (MAX, 0x10):
            h1[:50] = t1  # ties on the threshold's high word
        tslab.capture(slab, torch.from_numpy(new), _t(h1), _t(h2), _t(dep), _t(act), torch.tensor([t1, t2]), CAP)
        sc = jax_capture(sc, jnp.asarray(new), *(jnp.asarray(a) for a in (h1, h2, dep, act)), t1, t2)
        for lane, j in zip(slab[:4], sc[:4]):
            assert np.array_equal(lane[:SCAP].numpy(), np.asarray(j[:SCAP]).astype(np.int64))
        assert slab.counts.tolist() == [int(sc[4]), int(sc[5])]
    assert int(slab.counts[0]) <= SCAP


# The mesh's largest slab (slab.SLAB_MAX_ROWS) with heavy ties on fp1,
# at the occupancies around the kept count.
BIG = tslab.SLAB_MAX_ROWS


def _slab_lanes(rng, scap, ties):
    lanes = [rng.integers(0, 1 << 32, size=scap + 1, dtype=np.uint64).astype(np.uint32) for _ in range(4)]
    lanes[0][::3] = lanes[0][5]  # many equal keys: top_k's tie order
    lanes[0][1::11] = MAX  # real rows that key to 0, like the padding
    if ties:
        lanes[0][:] = rng.integers(0, 40, size=scap + 1).astype(np.uint32) * 0x01000001  # 40 keys in all
        lanes[0][2::13] = MAX
    return lanes


@pytest.mark.parametrize("occupied,scap", [pytest.param(o, SCAP, id=str(o)) for o in (0, 7, 128, 600, SCAP)] + [
    pytest.param(o, BIG, id=f"{BIG}-rows-{o}") for o in (0, 1, SK2 - 1, SK2, SK2 + 1, BIG)
])
def test_bottom_k_matches_jax_top_k(occupied, scap):
    rng = np.random.default_rng(occupied)
    lanes = _slab_lanes(rng, scap, ties=scap == BIG)
    slab = tslab.Slab(*(_t(a) for a in lanes), torch.tensor([occupied, 0]))
    ours = tslab.bottom_k(slab, SK2)
    ref = jax_epilogue(tuple(jnp.asarray(a) for a in lanes) + (jnp.uint32(occupied), jnp.uint32(0)), scap)
    for a, b in zip(ours, ref):
        assert np.array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype))


def test_bottom_k_lanes_matches_jax_per_shard():
    """The sharded tail's one call over 8 shards' slabs equals the JAX
    epilogue on each shard, and the solo call on each."""
    n, scap = 8, 2 * SCAP
    rng = np.random.default_rng(11)
    occ = [0, 1, SK2 - 1, SK2, SK2 + 1, 700, scap - 3, scap]
    lanes = [_slab_lanes(rng, scap, ties=s % 2 == 1) for s in range(n)]
    slabs = torch.stack([torch.stack([_t(lanes[s][j]) for s in range(n)]) for j in range(4)])
    counts = torch.tensor([[o, 0] for o in occ])
    ours = tslab.bottom_k_lanes(slabs, counts, SK2)
    for s in range(n):
        ref = jax_epilogue(tuple(jnp.asarray(a) for a in lanes[s]) + (jnp.uint32(occ[s]), jnp.uint32(0)), scap)
        solo = tslab.bottom_k(tslab.Slab(*(slabs[j, s] for j in range(4)), counts[s]), SK2)
        for a, b, c in zip(ours, ref, solo):
            assert np.array_equal(a[s].numpy(), np.asarray(b).astype(a.numpy().dtype))
            assert torch.equal(a[s], c)


def test_sampler_copy_matches_jax():
    """The same offers and drains give the same kept set and snapshot."""
    rng = np.random.default_rng(5)
    ours, ref = tsample.SpaceSampler(k=16), jsample.SpaceSampler(k=16)
    fps = rng.integers(0, 1 << 63, size=300, dtype=np.uint64)
    for s in (ours, ref):
        s.offer_array(fps[:100], depths=np.arange(100))
    for _ in range(3):
        n = 40
        fp1 = rng.integers(0, 1 << 20, size=n, dtype=np.uint64)
        fp2 = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
        ok = rng.random(n) < 0.8
        for s in (ours, ref):
            s.drain_slab(fp1, fp2, np.ones(n), ok, occupied=n + 5, dropped=1, actions=np.arange(n))
    assert ours.fingerprints() == ref.fingerprints()
    assert ours.snapshot() == ref.snapshot()
    assert ours.threshold_parts() == ref.threshold_parts()


@pytest.fixture(scope="module")
def runs():
    return {
        5: run_pair("TwoPhaseTensor", (5,), OPTS),
        # 2pc-6 at chunk 1024 overflows rcap on some steps: partial commits.
        6: run_pair("TwoPhaseTensor", (6,), dict(chunk_size=1024, queue_capacity=1 << 16,
                                                  table_capacity=1 << 12, sync_steps=4)),
    }


@pytest.mark.parametrize("n,golden", [(5, 8832), (6, 50816)])
def test_sampled_engine_matches_jax(runs, n, golden):
    ref, ours = runs[n]
    assert ours._sampler is not None and ours._sampler.size() == 64
    assert parity_dict(ours) == parity_dict(ref)
    assert paths(ours) == paths(ref)
    assert ours.unique_state_count() == golden
    if n == 6:
        assert ours.telemetry()["partial_steps"] >= 1


def test_space_profile(runs):
    ours = runs[5][1]
    prof = ours.space_profile()
    assert prof["samples"] == 64 and prof["unresolved"] == 0
    assert prof["fingerprints"] == [str(fp) for fp in ours._sampler.fingerprints()]
    assert sum(d["count"] for d in prof["depths"].values()) == 64
    assert ours.telemetry()["space"]["samples"] == 64
    ref = runs[5][0].space_profile()
    assert prof["fields"] == ref["fields"] and prof["depths"] == ref["depths"]
