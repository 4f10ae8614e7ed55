"""K11 for ABD and the increment race against the JAX package, bit for bit.

The CUDA kernels (`kernels/csrc/expand_abd.cu`, `expand_increment.cu`)
run the model headers `kernels/csrc/models/abd.cuh` (over
`actor_net.cuh`'s unordered and ordered networks) and `increment.cuh`
one row a thread. Here the same headers are compiled with g++ through
the host harness (tests/torch_expand_host.py), and its EXPAND and WALK
outputs are held against the JAX package's `build_expand_lean` and the
model step of its walk (`engines/tpu_simulation.py:268-300`): ABD at
c = 1, 2 and 3 on both networks and increment at n = 1, 2, 3 and 8 (the
top of the instantiated range), on reachable rows from a few BFS levels,
on seeded rows (ABD: every message type and actor id in play, sorted
nets, ranks that are not consistent on the ordered network; increment:
every program counter) and on hypothesis rows, with `active` and depth
limits both scalar and a row. Tolerance: exact. Then the route: the CPU,
a subclass, an instance that overrides the model code and other
properties take the plain version; "cuda" with the exact class takes the
kernel (decided from the model and the device's type alone, no card
probed).
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

from stateright_tpu.models import AbdOrderedTensor as JaxAbdOrdered
from stateright_tpu.models import AbdTensor as JaxAbd
from stateright_tpu.models import IncrementTensor as JaxIncrement
from stateright_tpu_torch.kernels import EXPAND_ABD, EXPAND_INCREMENT, WALK_ABD, WALK_INCREMENT
from stateright_tpu_torch.models import AbdOrderedTensor, AbdTensor, IncrementTensor
from stateright_tpu_torch.ops.expand import build_expand_lean, build_walk_step, expand_route, kernel_of
from stateright_tpu_torch.xp import TorchXP

ABD = [("abd", 1), ("abd", 2), ("abd", 3), ("abd-ordered", 1), ("abd-ordered", 2), ("abd-ordered", 3)]
INCREMENT = [("increment", 1), ("increment", 2), ("increment", 3), ("increment", 8)]
MODELS = ABD + INCREMENT
RANK_SHIFT = 16


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return build_harness(tmp_path_factory.mktemp("expand_host_abd"))


def _jax_model(kind, size):
    return {"abd": JaxAbd, "abd-ordered": JaxAbdOrdered, "increment": JaxIncrement}[kind](size)


def _abd_rows(rng, jm, W):
    """[S, W] uint32 ABD rows in the model's alphabet: server fields with
    small request ids (so that acks meet their phase), client tester lanes
    (phase 0-2, read value 0-4, peers' phases 0-2), and a net of words of
    every type (and a few past the last) between actors 0..c+2, half empty,
    sorted as the ring keeps it; on the ordered network each word carries
    a rank of 0-2 in its flow, with no care for the flow's other ranks."""
    c, NA, K = jm.c, jm.n_actor_lanes, jm.K
    rows = np.zeros((jm.state_width, W), dtype=np.uint32)
    for j in range(2):
        rows[2 * j] = (rng.integers(0, 32, W) | (rng.integers(0, 8, W) << 5) | (rng.integers(0, 4, W) << 8)
                       | (rng.integers(0, 3, W) << 10) | (rng.integers(0, c + 3, W) << 14)
                       | (rng.integers(0, 8, W) << 18))
        rows[2 * j + 1] = rng.integers(0, 1 << 18, W)
    for i in range(c):
        lane = rng.integers(0, 3, W) | (rng.integers(0, 5, W) << 2)
        for p in range(c):
            lane |= rng.integers(0, 3, W) << (6 + 2 * p)
        rows[4 + i] = lane
    typ = rng.integers(1, 11, (K, W))
    src, dst = rng.integers(0, c + 3, (K, W)), rng.integers(0, c + 3, (K, W))
    pay = rng.integers(0, 3, (K, W)) | (rng.integers(0, 1 << 12, (K, W)) << 4)
    if jm.ordered:
        pay |= rng.integers(0, 3, (K, W)) << RANK_SHIFT
    net = ((typ << 28) | (src << 24) | (dst << 20) | pay).astype(np.uint32)
    net[rng.random((K, W)) < 0.5] = 0
    rows[NA:] = np.sort(net, axis=0)
    return rows


def _increment_rows(rng, jm, W):
    """[S, W] uint32 increment rows: counters and locals of 8 bits (and a
    few of 32), program counters 0-3."""
    rows = rng.integers(0, 256, size=(jm.state_width, W)).astype(np.uint32)
    rows[2::2] = rng.integers(0, 4, size=(jm.n, W))
    wide = rng.random(W) < 0.1
    rows[:2, wide] = rng.integers(0, 1 << 32, size=(2, int(wide.sum())), dtype=np.uint64).astype(np.uint32)
    return rows


def _seeded_rows(rng, jm, W):
    return (_increment_rows if isinstance(jm, JaxIncrement) else _abd_rows)(rng, jm, W)


@pytest.mark.parametrize("kind,size", MODELS)
@pytest.mark.parametrize("limit", ["scalar", "per_row", "unbounded"])
def test_expand_on_reachable_rows_matches_jax(harness, kind, size, limit):
    jm = _jax_model(kind, size)
    rows = bfs_levels(jm, 10, 2048)
    rng = np.random.default_rng(size * 11 + len(limit) + len(kind))
    rows = rows[rng.permutation(len(rows))].T.copy()  # [S, W]
    W = rows.shape[1]
    ebits, depth, active = inputs(rng, W)
    depth_limit = {"scalar": 9, "unbounded": M32,
                   "per_row": rng.integers(1, 16, size=W).astype(np.uint32)}[limit]
    ours = host_expand(harness, jm, rows, ebits, depth, active, depth_limit)
    assert_same(ours, jax_reference(jm, rows, ebits, depth, active, depth_limit))
    assert ours["generated"][0] == ours["valid"].sum() and (W < 64 or ours["generated"][0] > 0)


@pytest.mark.parametrize("kind,size", MODELS)
def test_expand_on_seeded_rows_matches_jax(harness, kind, size):
    jm = _jax_model(kind, size)
    rng = np.random.default_rng(400 + size + len(kind))
    W = 1500
    rows = _seeded_rows(rng, jm, W)
    ebits, depth, active = inputs(rng, W)
    ours = host_expand(harness, jm, rows, ebits, depth, active, 11)
    assert_same(ours, jax_reference(jm, rows, ebits, depth, active, 11))
    assert ours["hits"].any() and ours["valid"].any()


@settings(max_examples=15, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(seed=st.integers(0, 2**32 - 1), which=st.sampled_from(["abd", "abd-ordered", "increment"]),
       size=st.integers(1, 3), W=st.integers(1, 40))
def test_expand_hypothesis_rows_match_jax(harness, seed, which, size, W):
    jm = _jax_model(which, size)
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 32, size=(jm.state_width, W), dtype=np.uint64).astype(np.uint32)
    # Small values make the handlers' branches fire (typ, src, dst, ids).
    rows[:, rng.random(W) < 0.5] &= np.uint32(0xF03FFFFF)
    ebits, depth, active = inputs(rng, W)
    dl = rng.integers(0, 16, size=W).astype(np.uint32)
    ours = host_expand(harness, jm, rows, ebits, depth, active, dl)
    assert_same(ours, jax_reference(jm, rows, ebits, depth, active, dl))


@pytest.mark.parametrize("kind,size", MODELS)
def test_walk_matches_jax(harness, kind, size):
    jm = _jax_model(kind, size)
    rng = np.random.default_rng(500 + size + len(kind))
    reach = bfs_levels(jm, 10, 1024)
    rows = np.concatenate([reach.T, _seeded_rows(rng, jm, 300)], axis=1)
    for ours, ref in zip(host_walk(harness, jm, rows), jax_walk(jm, rows)):
        assert np.array_equal(ours, ref)


def test_ordered_delivery_ranks_match_jax(harness):
    """abd-ordered-1 with three words in one flow (server 0 -> server 1):
    only the rank-0 head is deliverable, and delivering it moves the
    others up one rank; the successor lanes of a slot that is not
    deliverable (written all the same) decrement the flow's rank-0 word
    past 0 into its dst field, as JAX's uint32 arithmetic does; a flow
    with no rank-0 word delivers nothing but another flow's head."""
    jm = JaxAbdOrdered(1)
    NA = jm.n_actor_lanes
    query = (5 << 28) | (0 << 24) | (1 << 20)  # Query(rid 0) 0 -> 1
    cases = [
        [query, query | 1 | (1 << RANK_SHIFT), query | 2 | (2 << RANK_SHIFT)],
        [query | (1 << RANK_SHIFT), query | 1 | (2 << RANK_SHIFT), (2 << 28) | (2 << 24) | (0 << 20)],
    ]
    rows = np.zeros((jm.state_width, len(cases)), dtype=np.uint32)
    rows[2] = 1  # server 1's seq
    for w, words in enumerate(cases):
        rows[NA:, w] = np.sort(np.asarray(words + [0] * (jm.K - len(words)), dtype=np.uint32))
    args = (rows, np.zeros(2, np.uint32), np.ones(2, np.uint32), np.ones(2, bool), M32)
    ours = host_expand(harness, jm, *args)
    assert_same(ours, jax_reference(jm, *args))
    assert ours["valid"].reshape(jm.K, 2).sum(0).tolist() == [1, 1]


# -- the route ---------------------------------------------------------------

class AbdSub(AbdTensor):
    pass


class IncrementSub(IncrementTensor):
    def step_lanes(self, xp, lanes):
        return super().step_lanes(xp, lanes)


@pytest.mark.parametrize("make,expand,walk,size", [
    (lambda: AbdTensor(1), EXPAND_ABD, WALK_ABD, (1, 0)),
    (lambda: AbdTensor(2), EXPAND_ABD, WALK_ABD, (2, 0)),
    (lambda: AbdOrderedTensor(3), EXPAND_ABD, WALK_ABD, (3, 1)),
    (lambda: AbdOrderedTensor(5), EXPAND_ABD, WALK_ABD, (5, 1)),
    (lambda: IncrementTensor(2), EXPAND_INCREMENT, WALK_INCREMENT, (2,)),
    (lambda: IncrementTensor(8), EXPAND_INCREMENT, WALK_INCREMENT, (8,)),
])
def test_route_kernel_for_the_exact_class_on_cuda(make, expand, walk, size):
    tm = make()
    props = tm.tensor_properties()
    assert expand_route(tm, props, "cuda") == "kernel"
    assert expand_route(tm, props, torch.device("cuda", 0)) == "kernel"
    assert kernel_of(tm, props) == (expand, walk, size)


@pytest.mark.parametrize("make", [lambda: AbdOrderedTensor(2), lambda: IncrementTensor(2)])
def test_route_plain_on_the_cpu(make):
    tm = make()
    props = tm.tensor_properties()
    assert expand_route(tm, props, "cpu") == "plain"
    xp = TorchXP("cpu")
    assert build_expand_lean(tm, props, 64, xp).route == "plain"
    assert build_walk_step(tm, props, xp).route == "plain"


@pytest.mark.parametrize("make", [lambda: AbdSub(2), lambda: IncrementSub(2)])
def test_route_plain_for_a_subclass(make):
    tm = make()
    assert expand_route(tm, tm.tensor_properties(), "cuda") == "plain"


def test_route_plain_for_other_properties_an_override_or_no_instantiation():
    tm = AbdTensor(2)
    props = tm.tensor_properties()
    assert expand_route(tm, props[:2], "cuda") == "plain"
    assert expand_route(tm, props[::-1], "cuda") == "plain"
    # The register properties close over their model: another instance's
    # are other properties.
    assert expand_route(tm, AbdTensor(2).tensor_properties(), "cuda") == "plain"
    assert expand_route(tm, tm.tensor_properties(), "cuda") == "kernel"
    for name, value in (("deliver", lambda xp, lanes, env: AbdTensor.deliver(tm, xp, lanes, env)),
                        ("ordered", True), ("step_lanes", lambda xp, lanes: AbdTensor.step_lanes(tm, xp, lanes))):
        other = AbdTensor(2)
        setattr(other, name, value)
        assert expand_route(other, other.tensor_properties(), "cuda") == "plain", name
    inc = IncrementTensor(2)
    assert expand_route(inc, IncrementTensor(3).tensor_properties(), "cuda") == "plain"
    inc.step_lanes = lambda xp, lanes: IncrementTensor.step_lanes(inc, xp, lanes)
    assert expand_route(inc, inc.tensor_properties(), "cuda") == "plain"
    big = IncrementTensor(9)  # past the instantiated thread counts
    assert expand_route(big, big.tensor_properties(), "cuda") == "plain"
