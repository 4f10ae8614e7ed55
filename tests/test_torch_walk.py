"""The walk step of device simulation in the port (`ops/walk.py`: `prng`,
and the plain versions of K13a record, K13b step and its prologue, K13c
capture and K13d slab epilogue, driven by `engines/gpu_simulation.
SimProgram`) against the JAX era program (`stateright_tpu/engines/
tpu_simulation.py:77 _build_sim_loop`) run one step per era: after every
era the walk lanes, the path rows below ptr and the whole params vector
(counts, discoveries, coverage, the sample tail) are equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import stateright_tpu.models as jax_models
import stateright_tpu_torch.models as torch_models
from stateright_tpu.engines import tpu_simulation as ts
from stateright_tpu_torch.engines.gpu_simulation import SimProgram
from stateright_tpu_torch.obs.coverage import DEPTH_CAP
from stateright_tpu_torch.obs.sample import SpaceSampler, slab_entries
from stateright_tpu_torch.ops import walk as wk
from torch_parity import one_torch_thread, reference_uncached  # noqa: F401
from torch_sim_models import JaxTinyClock, TinyClock

MAX = 0xFFFFFFFF
K = 64


def np_prng(x):
    """tpu_simulation.py:131-135 over numpy uint32."""
    x = np.asarray(x, dtype=np.uint32)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
        x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def test_prng_matches_the_uint32_hash():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 32, size=100_000, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, MAX, 0x80000000]
    got = wk.prng(torch.from_numpy(x.astype(np.int64)))
    assert np.array_equal(got.numpy(), np_prng(x).astype(np.int64))


def jax_slab_epilogue(f1, f2, socc, sk2):
    """The dedup + top_k of tpu_simulation.py:509-522 on a slab's fp lanes."""
    u = jnp.uint32
    scap = f1.shape[0]
    used = jnp.arange(scap, dtype=u) < u(socc)
    same = (f1[:, None] == f1[None, :]) & (f2[:, None] == f2[None, :]) & used[None, :]
    idx = jnp.arange(scap, dtype=u)
    dup = (same & (idx[None, :] < idx[:, None])).any(axis=1)
    used = used & ~dup
    _v, topi = lax.top_k(jnp.where(used, ~f1, u(0)), sk2)
    return np.asarray(topi), np.asarray(used[topi])


@pytest.mark.parametrize("occ", [0, 5, 300, 700])
def test_slab_bottom_k_plain_matches_the_jax_epilogue(occ):
    """Duplicates, fp1 = MAX rows (key 0, like duplicates and unused rows)
    and equal fp1 with distinct fp2 exercise both tie rules."""
    rng = np.random.default_rng(occ)
    S, scap, sk2 = 2, 700, 128
    slab = rng.integers(0, 1 << 32, size=(3 + S, scap + 1), dtype=np.uint64).astype(np.int64)
    slab[0, :scap] %= 1000  # many equal fp1
    slab[1, :scap] %= 3
    slab[0, 7::50] = MAX
    f1 = jnp.asarray(slab[0, :scap].astype(np.uint32))
    f2 = jnp.asarray(slab[1, :scap].astype(np.uint32))
    topi, ok = jax_slab_epilogue(f1, f2, occ, sk2)
    want = np.where(topi[None, :] < occ, slab[:, topi], 0)
    stats = torch.tensor([0, occ, 0, 0])
    lanes, got_ok = wk.slab_bottom_k(torch.from_numpy(slab), stats, sk2)
    assert np.array_equal(lanes.numpy(), want)
    assert np.array_equal(got_ok.numpy(), ok)


def _jax_walk(walk_j):
    return np.stack([np.asarray(x) for x in walk_j]).astype(np.int64)


def drive(jax_tm, torch_tm, B, L, master, eras, fin=(0, 0, 0)):
    """Run the JAX era program and the port's SimProgram side by side, one
    step an era, comparing after every era; returns the era results."""
    S, A = torch_tm.state_width, torch_tm.max_actions
    jprops, tprops = jax_tm.tensor_properties(), torch_tm.tensor_properties()
    P = len(tprops)
    loop, seed_run, n_init = ts._build_sim_loop(jax_tm, jprops, B, L, True, sample_k=K)
    prog = SimProgram(torch_tm, tprops, B, L, True, K, "cpu")
    assert prog.n_init == n_init
    sk2 = slab_entries(K)
    ncov = A + P + DEPTH_CAP
    s_base = ts.P_LEN + 2 * P + ncov
    params = np.zeros(s_base + 4 + (4 + S) * sk2, dtype=np.uint32)
    params[ts.P_MAX_STEPS] = 1
    params[ts.P_FIN_ANY], params[ts.P_FIN_ALL], params[ts.P_FIN_ALL_EN] = fin
    params[ts.P_SEED] = master
    params[s_base:s_base + 2] = MAX
    sampler = SpaceSampler(K)
    thr = (MAX, MAX)

    # Seeding alone: an era of no steps leaves the seeded walks.
    zero = params.copy()
    zero[ts.P_MAX_STEPS] = 0
    walk_t, path = prog.seed(master)
    assert np.array_equal(_jax_walk(seed_run(jnp.asarray(zero))[0]), walk_t.numpy())

    walk_j, f1, f2, out = seed_run(jnp.asarray(params))
    rec = gen = 0
    results = []
    for era in range(eras):
        if era:
            walk_j, f1, f2, out = loop(walk_j, f1, f2, jnp.asarray(params))
        r = prog.era(walk_t, path, rec_bits=rec, max_steps=1, fin_any=fin[0], fin_all=fin[1],
                     fin_all_en=fin[2], target_gen=0, gen0=gen, threshold=thr)
        vals = np.array(out).astype(np.int64)
        assert np.array_equal(_jax_walk(walk_j), walk_t.numpy()), f"walk lanes, era {era}"
        ptr = walk_t[S + 1].numpy()
        below = np.arange(L)[None, :] < ptr[:, None]
        pw = path.numpy()
        for lane, half in ((f1, (pw >> 32) & MAX), (f2, pw & MAX)):
            assert np.array_equal(np.asarray(lane).reshape(B, L)[below], half[below]), f"path, era {era}"
        gen += r.gen
        head = [r.rec_bits, 1, *fin, 0, gen, gen, r.steps, r.maxd, master]
        port = np.concatenate([
            head, r.disc_walk, r.disc_plen, r.coverage, [thr[0], thr[1], r.occupied, 0],
            r.sample.reshape(-1), r.sample_ok,
        ]).astype(np.int64)
        assert np.array_equal(vals, port), f"params vector, era {era}"
        results.append(r)
        rec = r.rec_bits
        if r.occupied:
            s = r.sample
            sampler.drain_slab(s[0], s[1], s[2], r.sample_ok, r.occupied, states=s[3:].T, exact=False)
        thr = sampler.threshold_parts()
        params = vals.astype(np.uint32)
        params[s_base:s_base + 2] = thr
    return results


_JAX = {}


def _pair(name, *args):
    jm = _JAX.setdefault((name, args), getattr(jax_models, name)(*args))
    return jm, getattr(torch_models, name)(*args)


def test_increment_walks_match_jax_step_by_step():
    res = drive(*_pair("IncrementTensor", 2), B=64, L=8, master=7, eras=12)
    assert any(r.rec_bits for r in res)  # "fin" is hit
    assert any(r.sample_ok.any() for r in res)


def test_2pc_walks_match_jax_step_by_step():
    res = drive(*_pair("TwoPhaseTensor", 3), B=64, L=6, master=11, eras=30)
    assert res[-1].rec_bits  # sometimes-properties recorded
    assert sum(r.gen for r in res) > 64 * 15
    cov = sum(r.coverage for r in res)
    assert cov[:6].sum() > 0  # actions taken


def test_cycling_walks_match_jax_step_by_step():
    jm = _JAX.setdefault(("TinyClock",), JaxTinyClock())
    res = drive(jm, TinyClock(), B=16, L=8, master=5, eras=10)
    assert res[0].rec_bits == 0 and res[1].rec_bits == 1
