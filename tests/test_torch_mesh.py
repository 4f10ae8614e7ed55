"""The sharded engine (K15) on one rank: the port's `spawn_sharded_bfs`
(`device="cpu"`: every kernel's plain version, all shards on one device)
against a fresh JAX `spawn_sharded_bfs` on the virtual CPU mesh, and its
two new kernels' plain versions against the JAX block. Exact throughout.

(a) K15a (`ops/exchange.py`): the JAX owner bucketing (mesh.py:337-384:
the one-hot cumsum rank, the quota, the scatter and the tiled
all_to_all, run under shard_map on N devices) and `exchange_plain` on
the same candidates, with some owners' buckets past the quota.

(b) K15f (`ops/mesh_era.py`) through the whole era: the JAX block
(`_build_block`) and the port's `MeshProgram` take the same tables,
rings and params (the host seeder's, then one JAX dispatch further), and
must leave the same params rows (coverage, sample and fusion tails, the
next budget), rec_fp1 / rec_fp2 / disc_depth, rings and tables. A case
with a quota far below the fanout takes the partial-commit path; a case
whose tables are full leaves every insert unresolved, so the global veto
halves every take down to 1 and then raises the error word.

(c) The engine: the `_fingerprint` dict of tests/test_pipeline.py:42
(counts, discoveries, coverage, the bottom-k sample) against JAX at N =
8 and N = 2, a (depth, fuse) sweep, symmetry (which neither engine
applies on the mesh), cross-shard discovery paths, and the refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stateright_tpu.models as jax_models
import stateright_tpu_torch.models as torch_models
from stateright_tpu.parallel import mesh as jmesh
from stateright_tpu.tensor import TensorModelAdapter as JaxAdapter
from stateright_tpu_torch import TensorModelAdapter
from stateright_tpu_torch.fingerprint import split64
from stateright_tpu_torch.ops import exchange as xc
from stateright_tpu_torch.ops import mesh_era as me
from stateright_tpu_torch.parallel import mesh
from torch_parity import one_torch_thread, parity_dict, paths, reference_uncached  # noqa: F401

M32 = 0xFFFFFFFF
_JAX_MODELS = {}


def _jax_model(name, args):
    return _JAX_MODELS.setdefault((name, args), getattr(jax_models, name)(*args))


def _devices(n):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} virtual devices")
    return devs[:n]


def run_pair(name, args, n, opts, configure=lambda b: b):
    ref = configure(JaxAdapter(_jax_model(name, args)).checker().coverage()).spawn_sharded_bfs(
        devices=_devices(n), **opts).join()
    tm = getattr(torch_models, name)(*args)
    ours = configure(TensorModelAdapter(tm).checker().coverage()).spawn_sharded_bfs(
        devices=["cpu"] * n, **opts).join()
    return ref, ours


# -- (a) K15a ------------------------------------------------------------------

def _jax_exchange(n, quota, h1, reps, vals):
    """mesh.py:337-384 on n devices: each shard's candidates [V] (h1,
    reps, X lanes) to the tiled all_to_all's receive [X, n * quota]."""
    from jax.sharding import Mesh, PartitionSpec

    u = jnp.uint32

    def per_device(h1, reps, vals):
        h1, reps, vals = h1[0], reps[0], vals[0]
        V = h1.shape[0]
        owner = h1 % u(n)
        onehot = (owner[:, None] == jnp.arange(n, dtype=u)[None, :]) & reps[:, None]
        csum = jnp.cumsum(onehot.astype(u), axis=0)
        rank = (csum * onehot.astype(u)).sum(axis=1) - u(1)
        counts = csum[-1]
        n_ovf = (counts - jnp.minimum(counts, u(quota))).sum(dtype=u)
        dest = jnp.where(reps & (rank < u(quota)), owner * u(quota) + rank,
                         u(n * quota) + jnp.arange(V, dtype=u))
        send = [jnp.zeros(n * quota, dtype=u).at[dest].set(c, mode="drop", unique_indices=True)
                for c in vals]
        recv = [jax.lax.all_to_all(x, "s", split_axis=0, concat_axis=0, tiled=True) for x in send]
        return jnp.stack(recv)[None], n_ovf[None]

    spec = PartitionSpec("s")
    fn = jax.jit(jax.shard_map(per_device, mesh=Mesh(np.array(_devices(n)), ("s",)),
                               in_specs=(spec,) * 3, out_specs=(spec, spec)))
    recv, n_ovf = fn(jnp.asarray(h1), jnp.asarray(reps), jnp.asarray(vals))
    return np.asarray(recv), np.asarray(n_ovf)


@pytest.mark.parametrize("n,V,quota,X", [(8, 300, 8, 5), (2, 500, 64, 7), (1, 100, 64, 3)])
def test_exchange_plain_matches_the_jax_buckets(n, V, quota, X):
    rng = np.random.default_rng(n * 1000 + V)
    h1 = rng.integers(0, 1 << 32, size=(n, V), dtype=np.uint64).astype(np.uint32)
    reps = rng.random((n, V)) < 0.7
    vals = rng.integers(1, 1 << 32, size=(n, X, V), dtype=np.uint64).astype(np.uint32)
    want, want_ovf = _jax_exchange(n, quota, h1, reps, vals)
    send, n_ovf = xc.exchange(
        torch.from_numpy(h1.astype(np.int64)).reshape(-1), torch.from_numpy(reps),
        torch.from_numpy(vals.astype(np.int64)).permute(1, 0, 2).reshape(X, n * V), n, quota,
    )
    got = send.view(X, n, n * quota).permute(1, 0, 2).numpy()
    assert np.array_equal(got, want.astype(np.int64))
    assert n_ovf.tolist() == want_ovf.astype(np.int64).tolist()
    if n == 8:
        assert int(n_ovf.sum()) > 0  # some bucket overflowed its quota


def test_exchange_receive_layout_across_ranks():
    """W ranks' send buffers, moved as all_to_all_single moves them, give
    each rank the one-rank receive buffer's columns of its owners."""
    n, W, V, quota, X = 8, 4, 200, 16, 3
    nl = n // W
    rng = np.random.default_rng(7)
    h1 = torch.from_numpy(rng.integers(0, 1 << 32, size=(n, V), dtype=np.int64))
    reps = torch.from_numpy(rng.random((n, V)) < 0.8)
    vals = torch.from_numpy(rng.integers(1, 1 << 32, size=(X, n * V), dtype=np.int64))
    whole, _ = xc.exchange(h1.reshape(-1), reps, vals, n, quota)
    whole = whole.view(X, n, n * quota)
    sends = [xc.exchange(h1[r * nl:(r + 1) * nl].reshape(-1), reps[r * nl:(r + 1) * nl],
                         vals.view(X, n, V)[:, r * nl:(r + 1) * nl].reshape(X, nl * V), n, quota,
                         world=W)[0] for r in range(W)]
    for r in range(W):
        delivered = torch.stack([sends[s][r] for s in range(W)])
        assert torch.equal(xc.receive(delivered), whole[:, r * nl:(r + 1) * nl])


# -- (b) K15f through the JAX block ------------------------------------------------

# name -> (model, args, n, chunk, qcap, tcap, quota, cov, sample_k, fuse)
ERA_CASES = {
    "2pc-5 n8": ("TwoPhaseTensor", (5,), 8, 64, 1 << 12, 1 << 11, 64, True, 64, 1),
    "2pc-5 n8 quota 8": ("TwoPhaseTensor", (5,), 8, 64, 1 << 12, 1 << 11, 8, True, 64, 1),
    "2pc-5 n2 fuse 4": ("TwoPhaseTensor", (5,), 2, 64, 1 << 12, 1 << 12, 64, True, 0, 4),
    "paxos-2 n8 fuse 2": ("PaxosTensor", (2,), 8, 128, 1 << 12, 1 << 12, 64, True, 64, 2),
    "paxos-2 n8 quota 4": ("PaxosTensor", (2,), 8, 128, 1 << 12, 1 << 12, 4, True, 64, 1),
}


def _seeded(tm, n, qcap, tcap):
    """The JAX host seeder's tables and rings (mesh.py:1323-1370)."""
    S = tm.state_width
    inits = np.asarray(tm.init_states_array(), dtype=np.uint32)
    from stateright_tpu.fingerprint import hash_words_np

    h1, h2 = hash_words_np(inits)
    queue = np.zeros((n, qcap, S + 2), dtype=np.uint32)
    counts = np.zeros(n, dtype=np.int64)
    table = np.zeros((n, tcap, 4), dtype=np.uint32)
    ebits = 0
    e = 0
    for p in tm.tensor_properties():
        if p.expectation.name == "EVENTUALLY":
            ebits |= 1 << e
            e += 1
    for i in range(len(inits)):
        o = int(h1[i]) % n
        queue[o, counts[o], :S] = inits[i]
        queue[o, counts[o], S] = ebits
        queue[o, counts[o], S + 1] = 1
        counts[o] += 1
        jmesh.ShardedBfsChecker._host_insert(table[o], int(h1[i]), int(h2[i]))
    keys = np.concatenate([table[:, :, 0], table[:, :, 1]], axis=1)
    return (keys, table[:, :, 2], table[:, :, 3]), tuple(queue[:, :, w] for w in range(S + 2)), counts


def _params(n, plen, counts, unique, rng, tm, props, qcap, tcap, quota, cov, k, fuse):
    """Host-owned params rows as the JAX driver builds them (mesh.py:2040),
    with the budget, budget cap, take caps and fuse_lim drawn."""
    A = tm.max_actions
    from stateright_tpu.ops import visited_set as jvs

    p = np.zeros((n, plen), dtype=np.uint32)
    grow_limit = max(0, int(jvs.MAX_LOAD * tcap) - n * quota)
    max_steps = int(rng.integers(2, 7))
    cap = int(rng.choice([0, 64]))
    for s in range(n):
        p[s, :me.P_LEN] = [0, counts[s], unique[s], 0, M32, grow_limit, qcap - n * quota,
                           max_steps, 0, 0, 0, 0, int(rng.integers(1, 65)), 0, 0, 0, cap]
    s_base = me.P_LEN + (me.cov_len(A, len(props)) if cov else 0)
    if k:
        p[:, s_base:s_base + 2] = M32
    if fuse > 1:
        p[:, s_base + me.sample_tail_len(k)] = fuse
    return p


def _table_map(keys, v1, v2):
    tcap = keys.shape[0] // 2
    k1, k2 = keys[:tcap], keys[tcap:]
    occ = (k1 != 0) | (k2 != 0)
    return dict(zip(zip(k1[occ].tolist(), k2[occ].tolist()), zip(v1[occ].tolist(), v2[occ].tolist())))


def _compare(jout, prog, n):
    jt, jq, jf1, jf2, jp, jdd = (jax.tree.map(np.asarray, o) for o in jout)
    (keys, v1, v2), q, f1, f2, params, dd = mesh.state_to_jax(prog)
    assert np.array_equal(params, jp), np.argwhere(params != jp)[:8]
    assert np.array_equal(f1, jf1) and np.array_equal(f2, jf2) and np.array_equal(dd, jdd)
    for w in range(len(q)):
        assert np.array_equal(q[w], jq[w]), f"ring lane {w}"
    for s in range(n):
        assert _table_map(keys[s], v1[s], v2[s]) == _table_map(jt[0][s], jt[1][s], jt[2][s])


def _jax_block(tm, props, n, chunk, qcap, quota, cov, k, fuse):
    from jax.sharding import Mesh

    return jmesh._build_block(tm, props, chunk, qcap, n, quota, Mesh(np.array(_devices(n)), ("shards",)),
                              "shards", cov, sample_k=k, fuse=fuse).serial


@pytest.mark.parametrize("case", list(ERA_CASES))
def test_mesh_era_matches_the_jax_block(case):
    name, args, n, C, qcap, tcap, quota, cov, k, fuse = ERA_CASES[case]
    jtm = _jax_model(name, args)
    props = jtm.tensor_properties()
    block = _jax_block(jtm, props, n, C, qcap, quota, cov, k, fuse)
    tm = getattr(torch_models, name)(*args)
    prog = mesh.MeshProgram(tm, tm.tensor_properties(), C, qcap, tcap, n, quota, cov, k, fuse, "cpu")
    table, queue, counts = _seeded(jtm, n, qcap, tcap)
    unique = [int(((table[0][s, :tcap] != 0) | (table[0][s, tcap:] != 0)).sum()) for s in range(n)]
    rng = np.random.default_rng(len(case))
    P = len(props)
    partial = 0
    for _round in range(3):
        params = _params(n, prog.plen, counts, unique, rng, jtm, props, qcap, tcap, quota, cov, k, fuse)
        if _round:
            params[:, me.P_HEAD] = jp[:, me.P_HEAD]
            params[:, me.P_REC] = np.bitwise_or.reduce(jp[:, me.P_REC])
        mesh.state_from_jax(prog, table, queue, params)
        z = jnp.zeros((n, P), dtype=jnp.uint32)
        jout = block(tuple(map(jnp.asarray, table)), tuple(map(jnp.asarray, queue)), z, z,
                     jnp.asarray(params))
        prog.run_eager()
        _compare(jout, prog, n)
        partial += int(prog.state[:, prog.x + me.X_PARTIAL].sum())
        table = tuple(np.asarray(t) for t in jout[0])
        queue = tuple(np.asarray(q) for q in jout[1])
        jp = np.asarray(jout[4])
        counts, unique = jp[:, me.P_COUNT], jp[:, me.P_UNIQUE]
    if "quota" in case:
        assert partial > 0  # the partial-commit path ran


def test_mesh_era_veto_on_full_tables_matches_the_jax_block():
    """Every slot of every shard's table holds a foreign key, so every
    insert is unresolved: the global veto keeps every shard from
    consuming, halves each take to 1, then counts the error."""
    n, C, qcap, tcap, quota = 4, 64, 1 << 12, 64, 64
    jtm = _jax_model("TwoPhaseTensor", (3,))
    props = jtm.tensor_properties()
    block = _jax_block(jtm, props, n, C, qcap, quota, True, 0, 1)
    tm = torch_models.TwoPhaseTensor(3)
    prog = mesh.MeshProgram(tm, tm.tensor_properties(), C, qcap, tcap, n, quota, True, 0, 1, "cpu")
    _t, queue, counts = _seeded(jtm, n, qcap, tcap)
    rng = np.random.default_rng(3)
    k1 = rng.integers(1, 1 << 32, size=(n, tcap), dtype=np.uint64).astype(np.uint32)
    k2 = rng.integers(1, 1 << 32, size=(n, tcap), dtype=np.uint64).astype(np.uint32)
    zero = np.zeros((n, tcap), dtype=np.uint32)
    table = (np.concatenate([k1, k2], axis=1), zero, zero)
    params = _params(n, prog.plen, counts, [tcap] * n, rng, jtm, props, qcap, 1 << 20, quota, True, 0, 1)
    params[:, me.P_MAX_STEPS] = 12
    params[:, me.P_TAKE_CAP] = 64
    mesh.state_from_jax(prog, table, queue, params)
    z = jnp.zeros((n, len(props)), dtype=jnp.uint32)
    jout = block(tuple(map(jnp.asarray, table)), tuple(map(jnp.asarray, queue)), z, z,
                 jnp.asarray(params))
    prog.run_eager()
    _compare(jout, prog, n)
    out = prog.state
    assert int(out[:, me.P_ERR].sum()) > 0
    assert out[:, me.P_STEPS].sum() == 0 and torch.equal(out[:, me.P_TAKE_CAP], torch.ones(n, dtype=torch.int64))


# -- (c) the engine ------------------------------------------------------------------

SMALL = dict(chunk_size=64)
ENGINE_CASES = {
    "2pc-3 n8": ("TwoPhaseTensor", (3,), 8, SMALL),
    "2pc-5 n8": ("TwoPhaseTensor", (5,), 8, SMALL),
    "2pc-5 n2": ("TwoPhaseTensor", (5,), 2, SMALL),
    "2pc-5 n8 growth": ("TwoPhaseTensor", (5,), 8, dict(chunk_size=64, table_capacity_per_shard=1 << 12)),
    "increment-2 n8": ("IncrementTensor", (2,), 8, SMALL),
    "paxos-2 n8": ("PaxosTensor", (2,), 8, dict(chunk_size=256)),
    "abd-2 n8": ("AbdTensor", (2,), 8, dict(chunk_size=128)),
    # Two properties first hit in one era at one depth.
    "single-copy 2x2 n8": ("SingleCopyTensor", (2, 2), 8, SMALL),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_sharded_matches_jax(case):
    name, args, n, opts = ENGINE_CASES[case]
    ref, ours = run_pair(name, args, n, opts)
    assert parity_dict(ours) == parity_dict(ref)
    tel = ours.telemetry()
    assert tel["n_shards"] == n and tel["quota"] == ref.telemetry()["quota"]
    if case == "2pc-5 n8":
        assert tel["partial_steps"] > 0  # some shard's bucket overflowed its quota
    if "growth" in case:
        assert tel["table_growths"] == 1 and tel["table_capacity"] == 1 << 13  # K15g, mid-run


def test_sharded_symmetry_matches_jax():
    ref, ours = run_pair("TwoPhaseTensor", (5,), 8, SMALL, lambda b: b.symmetry())
    assert parity_dict(ours) == parity_dict(ref)
    assert ours.unique_state_count() == 8832  # the mesh does not canonicalize


SWEEP = [None, (1, 1), (2, 1), (4, 4)]


@pytest.mark.parametrize("pipe", SWEEP, ids=lambda p: "serial" if p is None else f"d{p[0]}-f{p[1]}")
def test_sharded_pipeline_sweep_2pc5_matches_jax(pipe):
    def configure(b):
        return b.pipeline(False) if pipe is None else b.pipeline(depth=pipe[0], fuse=pipe[1])

    ref, ours = run_pair("TwoPhaseTensor", (5,), 8, dict(chunk_size=64, sync_steps=4), configure)
    assert parity_dict(ours) == parity_dict(ref)
    assert ours.telemetry()["eras"] == ref.telemetry()["eras"]
    assert ours.telemetry()["steps"] == ref.telemetry()["steps"]


def test_sharded_discovery_paths_replay_across_shards():
    ref, ours = run_pair("TwoPhaseTensor", (3,), 8, SMALL)
    got = paths(ours)
    assert got == paths(ref) and set(got) == {"abort agreement", "commit agreement"}
    for name, path in ours.discoveries().items():
        assert len(path.into_states()) >= 2
        ours.assert_discovery(name, path.into_actions())
    # A chain visits several owners: the walk hops shards.
    owners = {split64(fp)[0] % 8 for fp in ours._sampler.fingerprints()}
    assert len(owners) > 1
    prof = ours.space_profile()
    assert prof["unresolved"] == 0


def test_sharded_refusals():
    b = TensorModelAdapter(torch_models.TwoPhaseTensor(3)).checker()
    with pytest.raises(NotImplementedError, match="group="):
        b.spawn_sharded_bfs(devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="4 \\* n_shards"):
        b.spawn_sharded_bfs(devices=8, device="cpu", queue_capacity_per_shard=1 << 8)


def test_sharded_bfs_wrapper():
    run = mesh.ShardedBfs(torch_models.TwoPhaseTensor(3), devices=["cpu"] * 4, chunk_size=64).run()
    assert run.unique_state_count == 288 and run.state_count == 1146
    assert set(run.discovery_fps) == {"abort agreement", "commit agreement"}



# -- two faults of the JAX sharded engine the port does not copy ----------------

def test_chained_partial_dispatches_keep_their_states():
    """A chained dispatch whose steps were all partial inserted and
    enqueued its delivered rows. The JAX driver treats it as a no-op (it
    reads P_STEPS, the clean steps, mesh.py:2191) and drops that work:
    2pc-7 at chunk 1,024 on 8 shards stops at 22,852 of 296,448 states.
    The port consumes it (it reads the steps run) and reaches the golden,
    as its serial run does."""
    opts = dict(chunk_size=1024, queue_capacity_per_shard=1 << 16, table_capacity_per_shard=1 << 18)
    ref, ours = run_pair("TwoPhaseTensor", (7,), 8, opts)
    assert ref.unique_state_count() == 22_852  # the reference's loss
    assert ours.unique_state_count() == 296_448
    assert set(ours._discovery_fps) == {"abort agreement", "commit agreement"}
    serial = TensorModelAdapter(torch_models.TwoPhaseTensor(7)).checker().coverage().pipeline(
        False).spawn_sharded_bfs(devices=8, device="cpu", **opts).join()
    assert parity_dict(serial) == parity_dict(ours)


def test_commit_vetoes_a_sender_past_vcap():
    """A shard with more valid candidates than the compaction's vcap
    consumes none of its pops and halves its take_cap (a partial step, as
    the solo era's commit does); the JAX block drops the candidates past
    vcap instead (mesh.py:329, n_val unused) and consumes the rows."""
    tm = torch_models.TwoPhaseTensor(3)
    n = 4
    prog = mesh.MeshProgram(tm, tm.tensor_properties(), 64, 1 << 12, 1 << 10, n, 64, True, 0, 1, "cpu")
    x, c = prog.x, prog.cfg
    st = prog.state
    st[:, me.P_COUNT] = 100
    st[:, me.P_TAKE_CAP] = 64
    st[:, me.P_HIGH_WATER] = 1 << 20
    st[:, me.P_GROW_LIMIT] = 1 << 20
    st[:, me.P_MAX_STEPS] = 10
    st[:, x + me.X_OPEN] = 1
    st[:, x + me.X_TAKE] = 64
    R, C, A = prog.R, prog.C, prog.A
    valid = torch.zeros((A, n, C), dtype=torch.bool)
    valid[0, :, :7] = True  # 7 generated a shard
    ops = me.MeshOperands(
        is_new=torch.zeros((n, R), dtype=torch.bool), unresolved=torch.zeros((n, R), dtype=torch.bool),
        rdepth=torch.ones((n, R), dtype=torch.int64),
        n_ovf=torch.zeros(n, dtype=torch.int64), n_val=torch.tensor([c.vcap + 1, c.vcap, 5, 0]),
        hits=[torch.zeros(n * C, dtype=torch.bool) for _ in range(prog.P)], valid=valid.view(-1),
        rows=tuple(torch.zeros(n * C, dtype=torch.int64) for _ in range(3)), hseen=prog.hseen,
        facc1=prog.facc1, facc2=prog.facc2, faccd=prog.faccd,
    )
    me.mesh_era(me.COMMIT, c, st, prog.sums, ops)
    assert st[:, me.P_HEAD].tolist() == [0, 64, 64, 64]
    assert st[:, me.P_TAKE_CAP].tolist() == [32, 64, 64, 64]
    assert st[:, x + me.X_PARTIAL].tolist() == [1, 0, 0, 0]
    assert st[:, x + me.X_EGEN].tolist() == [0, 7, 7, 7]
