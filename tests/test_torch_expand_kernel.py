"""K11's hand-written model code against the JAX package, bit for bit.

The CUDA kernels (`kernels/csrc/expand_2pc.cu`, `expand_paxos.cu`) run
the model headers of `kernels/csrc/models/` one row a thread. Here the
same headers are compiled with g++ through the host harness
(`kernels/csrc/models/harness.cpp`, bound with ctypes), and its EXPAND
and WALK outputs are held against the JAX package's `build_expand_lean`
and the model step of its walk (`engines/tpu_simulation.py:268-300`):
2PC at n = 3, 5 and 7 and Paxos at c = 1 and 2, on reachable rows from a
few BFS levels and on seeded uint32 rows, with `active` and depth limits
both scalar and a row. Tolerance: exact. Then the route: the CPU, a
subclass, an instance that overrides the model code and other properties
take the plain version; "cuda" with the exact class takes the kernel
(decided from the model and the device's type alone, no card probed).
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

from stateright_tpu.models import PaxosTensor as JaxPaxos
from stateright_tpu.models import TwoPhaseTensor as JaxTwoPhase
from stateright_tpu_torch.kernels import EXPAND_2PC, EXPAND_PAXOS, WALK_2PC, WALK_PAXOS
from stateright_tpu_torch.models import PaxosTensor, PaxosTensorExhaustive, TwoPhaseTensor
from stateright_tpu_torch.ops.expand import (
    build_expand_lean,
    build_walk_step,
    expand_route,
    kernel_of,
)
from stateright_tpu_torch.xp import TorchXP


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return build_harness(tmp_path_factory.mktemp("expand_host"))


MODELS = [("2pc", 3), ("2pc", 5), ("2pc", 7), ("paxos", 1), ("paxos", 2)]


def _jax_model(kind, size):
    return JaxTwoPhase(size) if kind == "2pc" else JaxPaxos(size)


@pytest.mark.parametrize("kind,size", MODELS)
@pytest.mark.parametrize("limit", ["scalar", "per_row", "unbounded"])
def test_expand_on_reachable_rows_matches_jax(harness, kind, size, limit):
    jm = _jax_model(kind, size)
    rows = bfs_levels(jm, 8, 2048)
    rng = np.random.default_rng(size * 7 + len(limit))
    rows = rows[rng.permutation(len(rows))].T.copy()  # [S, W]
    W = rows.shape[1]
    ebits, depth, active = inputs(rng, W)
    depth_limit = {"scalar": 9, "unbounded": M32,
                   "per_row": rng.integers(1, 16, size=W).astype(np.uint32)}[limit]
    ours = host_expand(harness, jm, rows, ebits, depth, active, depth_limit)
    assert_same(ours, jax_reference(jm, rows, ebits, depth, active, depth_limit))
    assert ours["generated"][0] > 0


@pytest.mark.parametrize("kind,size", MODELS)
def test_expand_on_seeded_uint32_rows_matches_jax(harness, kind, size):
    jm = _jax_model(kind, size)
    rng = np.random.default_rng(100 + size)
    W = 600
    rows = rng.integers(0, 1 << 32, size=(jm.state_width, W), dtype=np.uint64).astype(np.uint32)
    if kind == "paxos":
        # Half the net slots empty and the rest sorted, as the ring keeps
        # them, with every message type and actor id in play.
        NA, K = 6 + size, 7 * size
        net = rng.integers(0, 1 << 32, size=(K, W), dtype=np.uint64).astype(np.uint32)
        net[rng.random((K, W)) < 0.5] = 0
        rows[NA:] = np.sort(net, axis=0)
        # Client tester lanes in their own alphabet (phase 0-2, read
        # value 0-4, peers' phases 0-2), so the linearizability verdict
        # meets every edge rule and both of its outcomes.
        for i in range(size):
            lane = rng.integers(0, 3, size=W) | (rng.integers(0, 5, size=W) << 2)
            for p in range(size):
                lane |= rng.integers(0, 3, size=W) << (6 + 2 * p)
            rows[6 + i] = lane.astype(np.uint32)
    ebits, depth, active = inputs(rng, W)
    ours = host_expand(harness, jm, rows, ebits, depth, active, 11)
    assert_same(ours, jax_reference(jm, rows, ebits, depth, active, 11))


@settings(max_examples=15, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(seed=st.integers(0, 2**32 - 1), kind=st.sampled_from(["2pc", "paxos"]), W=st.integers(1, 40))
def test_expand_hypothesis_rows_match_jax(harness, seed, kind, W):
    jm = _jax_model(kind, 3 if kind == "2pc" else 1)
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 32, size=(jm.state_width, W), dtype=np.uint64).astype(np.uint32)
    # Small values make the handlers' branches fire (typ, dst, ballots).
    rows[:, rng.random(W) < 0.5] &= np.uint32(0xF03FFFFF)
    ebits, depth, active = inputs(rng, W)
    dl = rng.integers(0, 16, size=W).astype(np.uint32)
    ours = host_expand(harness, jm, rows, ebits, depth, active, dl)
    assert_same(ours, jax_reference(jm, rows, ebits, depth, active, dl))


@pytest.mark.parametrize("kind,size", MODELS)
def test_walk_matches_jax(harness, kind, size):
    jm = _jax_model(kind, size)
    rng = np.random.default_rng(200 + size)
    reach = bfs_levels(jm, 8, 1024)
    rand = rng.integers(0, 1 << 32, size=(jm.state_width, 100), dtype=np.uint64).astype(np.uint32)
    rows = np.concatenate([reach.T, rand], axis=1)
    for ours, ref in zip(host_walk(harness, jm, rows), jax_walk(jm, rows)):
        assert np.array_equal(ours, ref)


@pytest.mark.parametrize("src,entries", [(1, 1), (3, 0)])
def test_paxos_prepared_matches_jax(harness, src, entries):
    """A Prepared for server 0's ballot: from server 1 onto its own entry
    (a quorum of 2: the best accepted proposal is picked), and from actor
    3, which leaves the map empty, so that ((best - 1) >> 8) & 1 runs on
    best = 0: uint32 wraps it to 1, as JAX does."""
    jm = JaxPaxos(1)
    row = np.zeros((jm.state_width, 1), dtype=np.uint32)
    row[0] = 4  # server 0: ballot 4 (round 1, proposer 0), no proposal
    row[1] = entries  # server 0's own entry in slot 0 of its prepares map
    row[-1] = (6 << 28) | (src << 24) | (0 << 20) | 4  # Prepared(ballot 4) to server 0
    args = (row, np.zeros(1, np.uint32), np.ones(1, np.uint32), np.ones(1, bool), M32)
    ours = host_expand(harness, jm, *args)
    assert_same(ours, jax_reference(jm, *args))
    assert ours["valid"].any()


# -- the route ---------------------------------------------------------------

class TwoPhaseSub(TwoPhaseTensor):
    pass


class PaxosSub(PaxosTensor):
    def step_lanes(self, xp, lanes):
        return super().step_lanes(xp, lanes)


@pytest.mark.parametrize("make,expand,walk", [
    (lambda: TwoPhaseTensor(7), EXPAND_2PC, WALK_2PC),
    (lambda: TwoPhaseTensor(16), EXPAND_2PC, WALK_2PC),
    (lambda: PaxosTensor(3), EXPAND_PAXOS, WALK_PAXOS),
    (lambda: PaxosTensorExhaustive(7), EXPAND_PAXOS, WALK_PAXOS),
])
def test_route_kernel_for_the_exact_class_on_cuda(make, expand, walk):
    tm = make()
    props = tm.tensor_properties()
    assert expand_route(tm, props, "cuda") == "kernel"
    assert expand_route(tm, props, torch.device("cuda", 0)) == "kernel"
    found = kernel_of(tm, props)
    assert found[:2] == (expand, walk)


@pytest.mark.parametrize("make", [lambda: TwoPhaseTensor(5), lambda: PaxosTensor(2)])
def test_route_plain_on_the_cpu(make):
    tm = make()
    props = tm.tensor_properties()
    assert expand_route(tm, props, "cpu") == "plain"
    xp = TorchXP("cpu")
    assert build_expand_lean(tm, props, 64, xp).route == "plain"
    assert build_walk_step(tm, props, xp).route == "plain"


@pytest.mark.parametrize("make", [lambda: TwoPhaseSub(5), lambda: PaxosSub(2)])
def test_route_plain_for_a_subclass(make):
    tm = make()
    assert expand_route(tm, tm.tensor_properties(), "cuda") == "plain"


def test_route_plain_for_other_properties_or_an_overridden_instance():
    tm = TwoPhaseTensor(5)
    props = tm.tensor_properties()
    assert expand_route(tm, props[:2], "cuda") == "plain"
    assert expand_route(tm, props[::-1], "cuda") == "plain"
    assert expand_route(tm, TwoPhaseTensor(4).tensor_properties(), "cuda") == "plain"
    assert expand_route(tm, TwoPhaseTensor(5).tensor_properties(), "cuda") == "kernel"
    tm.step_lanes = lambda xp, lanes: TwoPhaseTensor.step_lanes(tm, xp, lanes)
    assert expand_route(tm, props, "cuda") == "plain"
    px = PaxosTensor(3)
    assert expand_route(px, PaxosTensor(2).tensor_properties(), "cuda") == "plain"
    assert expand_route(px, px.tensor_properties(), "cuda") == "kernel"
