"""K11 for the lock-protected increment and the single-copy register
against the JAX package, bit for bit.

The CUDA kernels (`kernels/csrc/expand_increment_lock.cu`,
`expand_single_copy.cu`) run the model headers
`kernels/csrc/models/increment_lock.cuh` and `single_copy.cuh` (over
`actor_net.cuh`'s unordered network and register client) one row a
thread. Here the same headers are compiled with g++ through the host
harness (tests/torch_expand_host.py), and its EXPAND and WALK outputs,
`flat` whole and not only the valid slots, are held against the JAX
package's `build_expand_lean` and the model step of its walk
(`engines/tpu_simulation.py:268-300`): the lock at n = 1, 2, 3 and 8 (the
top of the instantiated range), the register at (clients, servers) =
(1, 1), (2, 2), (3, 2), (4, 1) and (5, 4) (the top of both ranges), on
reachable rows from a few BFS levels, on seeded rows (the lock: every
program counter and lock value; the register: every message type and
actor id in play, sorted nets) and on hypothesis rows, with `active` and
depth limits both scalar and a row. Tolerance: exact. Then the route:
the CPU, a subclass, an instance that overrides the model code, other
properties and sizes past the instantiations take the plain version;
"cuda" with the exact class takes the kernel (decided from the model and
the device's type alone, no card probed).
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from torch_expand_host import (
    M32,
    assert_same,
    bfs_levels,
    build_harness,
    host_expand,
    host_walk,
    inputs,
    jax_reference,
    jax_walk,
)

from stateright_tpu.models import IncrementLockTensor as JaxIncrementLock
from stateright_tpu.models import SingleCopyTensor as JaxSingleCopy
from stateright_tpu_torch.kernels import (
    EXPAND_INCREMENT_LOCK,
    EXPAND_SINGLE_COPY,
    WALK_INCREMENT_LOCK,
    WALK_SINGLE_COPY,
)
from stateright_tpu_torch.models import IncrementLockTensor, SingleCopyTensor
from stateright_tpu_torch.ops.expand import build_expand_lean, build_walk_step, expand_route, kernel_of
from stateright_tpu_torch.xp import TorchXP

LOCK = [("lock", (1,)), ("lock", (2,)), ("lock", (3,)), ("lock", (8,))]
COPY = [("copy", (1, 1)), ("copy", (2, 2)), ("copy", (3, 2)), ("copy", (4, 1)), ("copy", (5, 4))]
MODELS = LOCK + COPY
IDS = [f"{k}-{'-'.join(map(str, a))}" for k, a in MODELS]


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return build_harness(tmp_path_factory.mktemp("expand_host_lock_copy"))


def _jax_model(kind, args):
    return {"lock": JaxIncrementLock, "copy": JaxSingleCopy}[kind](*args)


def _lock_rows(rng, jm, W):
    """[S, W] uint32 lock rows: counter and locals of 8 bits (and a few
    of 32), lock bits 0-2, program counters 0-5."""
    rows = rng.integers(0, 256, size=(jm.state_width, W)).astype(np.uint32)
    rows[1] = rng.integers(0, 3, size=W)
    rows[3::2] = rng.integers(0, 6, size=(jm.n, W))
    wide = rng.random(W) < 0.1
    rows[0, wide] = rng.integers(0, 1 << 32, size=int(wide.sum()), dtype=np.uint64).astype(np.uint32)
    return rows


def _copy_rows(rng, jm, W):
    """[S, W] uint32 register rows in the model's alphabet: stored values
    0-7 (a few of 32 bits), client tester lanes (phase 0-2, read value
    0-4, peers' phases 0-2), and a net of words of every type (and a few
    past the last) between actors 0..s+c, payloads with small request ids
    and every value code, half empty, sorted as the ring keeps it."""
    s, c, NA, K = jm.s, jm.c, jm.n_actor_lanes, jm.K
    rows = np.zeros((jm.state_width, W), dtype=np.uint32)
    rows[:s] = rng.integers(0, 8, size=(s, W))
    wide = rng.random(W) < 0.05
    rows[0, wide] = rng.integers(0, 1 << 32, size=int(wide.sum()), dtype=np.uint64).astype(np.uint32)
    for i in range(c):
        lane = rng.integers(0, 3, W) | (rng.integers(0, 5, W) << 2)
        for p in range(c):
            lane |= rng.integers(0, 3, W) << (6 + 2 * p)
        rows[s + i] = lane
    typ = rng.integers(1, 7, (K, W))
    src, dst = rng.integers(0, s + c + 1, (K, W)), rng.integers(0, s + c + 1, (K, W))
    pay = rng.integers(0, 4 * s + 4 * c, (K, W)) | (rng.integers(0, 1 << 8, (K, W)) << 4)
    net = ((typ << 28) | (src << 24) | (dst << 20) | pay).astype(np.uint32)
    net[rng.random((K, W)) < 0.5] = 0
    rows[NA:] = np.sort(net, axis=0)
    return rows


def _seeded_rows(rng, jm, W):
    return (_lock_rows if isinstance(jm, JaxIncrementLock) else _copy_rows)(rng, jm, W)


@pytest.mark.parametrize("kind,args", MODELS, ids=IDS)
@pytest.mark.parametrize("limit", ["scalar", "per_row", "unbounded"])
def test_expand_on_reachable_rows_matches_jax(harness, kind, args, limit):
    jm = _jax_model(kind, args)
    rows = bfs_levels(jm, 10, 2048)
    rng = np.random.default_rng(sum(args) * 11 + len(limit) + len(kind))
    rows = rows[rng.permutation(len(rows))].T.copy()  # [S, W]
    W = rows.shape[1]
    ebits, depth, active = inputs(rng, W)
    depth_limit = {"scalar": 9, "unbounded": M32,
                   "per_row": rng.integers(1, 16, size=W).astype(np.uint32)}[limit]
    ours = host_expand(harness, jm, rows, ebits, depth, active, depth_limit)
    assert_same(ours, jax_reference(jm, rows, ebits, depth, active, depth_limit))
    assert ours["generated"][0] == ours["valid"].sum() and (W < 64 or ours["generated"][0] > 0)


@pytest.mark.parametrize("kind,args", MODELS, ids=IDS)
def test_expand_on_seeded_rows_matches_jax(harness, kind, args):
    jm = _jax_model(kind, args)
    rng = np.random.default_rng(600 + sum(args) + len(kind))
    W = 1500
    rows = _seeded_rows(rng, jm, W)
    ebits, depth, active = inputs(rng, W)
    ours = host_expand(harness, jm, rows, ebits, depth, active, 11)
    assert_same(ours, jax_reference(jm, rows, ebits, depth, active, 11))
    assert ours["hits"].any() and ours["valid"].any()


@settings(max_examples=15, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(seed=st.integers(0, 2**32 - 1), which=st.sampled_from(["lock", "copy"]),
       c=st.integers(1, 5), s=st.integers(1, 4), W=st.integers(1, 40))
def test_expand_hypothesis_rows_match_jax(harness, seed, which, c, s, W):
    jm = _jax_model(which, (c,) if which == "lock" else (c, s))
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 32, size=(jm.state_width, W), dtype=np.uint64).astype(np.uint32)
    # Small values make the handlers' branches fire (typ, src, dst, ids,
    # program counters, the lock bit).
    rows[:, rng.random(W) < 0.5] &= np.uint32(0xF03FFFFF)
    rows[:, rng.random(W) < 0.3] &= np.uint32(0x7)
    ebits, depth, active = inputs(rng, W)
    dl = rng.integers(0, 16, size=W).astype(np.uint32)
    ours = host_expand(harness, jm, rows, ebits, depth, active, dl)
    assert_same(ours, jax_reference(jm, rows, ebits, depth, active, dl))


@pytest.mark.parametrize("kind,args", MODELS, ids=IDS)
def test_walk_matches_jax(harness, kind, args):
    jm = _jax_model(kind, args)
    rng = np.random.default_rng(700 + sum(args) + len(kind))
    reach = bfs_levels(jm, 10, 1024)
    rows = np.concatenate([reach.T, _seeded_rows(rng, jm, 300)], axis=1)
    for ours, ref in zip(host_walk(harness, jm, rows), jax_walk(jm, rows)):
        assert np.array_equal(ours, ref)


def test_two_servers_read_none_like_jax(harness):
    """Single-copy at 2 clients and 2 servers: client 2's write completes
    at server 0, its read goes to server 1 with request id 4, server 1
    answers with the code of its empty register (1 = None), and the
    completed read of None breaks `linearizable`: each step in the
    harness as in JAX."""
    jm = JaxSingleCopy(2, 2)
    NA = jm.n_actor_lanes
    row = jm.init_states_array()[0].astype(np.uint32)

    def deliver(word):
        rows = row[:, None]
        ours, ref = host_walk(harness, jm, rows), jax_walk(jm, rows)
        for o, r in zip(ours, ref):
            assert np.array_equal(o, r)
        k = [int(e) for e in row[NA:]].index(word)
        assert ours[1][k, 0]
        return ours[2][k, :, 0].astype(np.uint32), ours[0][:, 0]

    def env(typ, src, dst, pay):
        return (typ << 28) | (src << 24) | (dst << 20) | pay

    row, _ = deliver(env(1, 2, 0, 2 | 1 << 4))  # Put(rid 2, value 1) 2 -> 0
    assert row[0] == 1
    row, _ = deliver(env(3, 0, 2, 2))  # PutOk(rid 2) 0 -> 2
    assert env(2, 2, 1, 4) in row[NA:].tolist()  # Get(rid 4) 2 -> 1
    row, _ = deliver(env(2, 2, 1, 4))
    assert env(4, 1, 2, 4 | 1 << 4) in row[NA:].tolist()  # GetOk(None) 1 -> 2
    row, checks = deliver(env(4, 1, 2, 4 | 1 << 4))
    assert checks[0]  # linearizable held before the read completed
    final = host_walk(harness, jm, row[:, None])[0][:, 0]
    assert not final[0] and (row[2] >> 2) & 15 == 1  # the read of None


# -- the route ---------------------------------------------------------------

class LockSub(IncrementLockTensor):
    pass


class CopySub(SingleCopyTensor):
    def deliver(self, xp, lanes, env):
        return super().deliver(xp, lanes, env)


@pytest.mark.parametrize("make,expand,walk,size", [
    (lambda: IncrementLockTensor(1), EXPAND_INCREMENT_LOCK, WALK_INCREMENT_LOCK, (1,)),
    (lambda: IncrementLockTensor(3), EXPAND_INCREMENT_LOCK, WALK_INCREMENT_LOCK, (3,)),
    (lambda: IncrementLockTensor(8), EXPAND_INCREMENT_LOCK, WALK_INCREMENT_LOCK, (8,)),
    (lambda: SingleCopyTensor(4), EXPAND_SINGLE_COPY, WALK_SINGLE_COPY, (1, 4)),
    (lambda: SingleCopyTensor(3, 2), EXPAND_SINGLE_COPY, WALK_SINGLE_COPY, (2, 3)),
    (lambda: SingleCopyTensor(5, 4), EXPAND_SINGLE_COPY, WALK_SINGLE_COPY, (4, 5)),
])
def test_route_kernel_for_the_exact_class_on_cuda(make, expand, walk, size):
    tm = make()
    props = tm.tensor_properties()
    assert expand_route(tm, props, "cuda") == "kernel"
    assert expand_route(tm, props, torch.device("cuda", 0)) == "kernel"
    assert kernel_of(tm, props) == (expand, walk, size)


@pytest.mark.parametrize("make", [lambda: IncrementLockTensor(2), lambda: SingleCopyTensor(3, 2)])
def test_route_plain_on_the_cpu(make):
    tm = make()
    props = tm.tensor_properties()
    assert expand_route(tm, props, "cpu") == "plain"
    xp = TorchXP("cpu")
    assert build_expand_lean(tm, props, 64, xp).route == "plain"
    assert build_walk_step(tm, props, xp).route == "plain"


@pytest.mark.parametrize("make", [lambda: LockSub(2), lambda: CopySub(2, 2)])
def test_route_plain_for_a_subclass(make):
    tm = make()
    assert expand_route(tm, tm.tensor_properties(), "cuda") == "plain"


def test_route_plain_for_other_properties_an_override_or_no_instantiation():
    tm = SingleCopyTensor(3, 2)
    props = tm.tensor_properties()
    assert expand_route(tm, props[:2], "cuda") == "plain"
    assert expand_route(tm, props[::-1], "cuda") == "plain"
    # The register properties close over their model: another instance's
    # are other properties.
    assert expand_route(tm, SingleCopyTensor(3, 2).tensor_properties(), "cuda") == "plain"
    for name, value in (("deliver", lambda xp, lanes, env: SingleCopyTensor.deliver(tm, xp, lanes, env)),
                        ("linearizable_lanes", lambda xp, lanes: SingleCopyTensor.linearizable_lanes(tm, xp, lanes)),
                        ("step_lanes", lambda xp, lanes: SingleCopyTensor.step_lanes(tm, xp, lanes))):
        other = SingleCopyTensor(3, 2)
        setattr(other, name, value)
        assert expand_route(other, other.tensor_properties(), "cuda") == "plain", name
    lock = IncrementLockTensor(2)
    assert expand_route(lock, IncrementLockTensor(3).tensor_properties(), "cuda") == "plain"
    lock.step_lanes = lambda xp, lanes: IncrementLockTensor.step_lanes(lock, xp, lanes)
    assert expand_route(lock, lock.tensor_properties(), "cuda") == "plain"
    big = IncrementLockTensor(9)  # past the instantiated thread counts
    assert expand_route(big, big.tensor_properties(), "cuda") == "plain"
    none = SingleCopyTensor(0)  # no client: not instantiated
    assert expand_route(none, none.tensor_properties(), "cuda") == "plain"
