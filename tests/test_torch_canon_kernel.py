"""K11c, the 2PC symmetry canon, against the JAX package, bit for bit.

The CUDA kernel (`kernels/csrc/canon_2pc.cu`) runs `two_phase_canon<N>`
of `kernels/csrc/models/two_phase.cuh` one candidate row a thread. Here
the same header is compiled with g++ through the host harness
(tests/torch_expand_host.py) and held against the JAX package's
`TwoPhaseTensor(n).representative_lanes` under jax.numpy at n = 3, 5, 7,
10 and 16 (where JAX's lane-1 mask is 0), on reachable rows and their
successors, on seeded uint32 rows and on hypothesis rows. Tolerance:
exact. The port's plain version (`ops/canon.py`) is held to the same
references. Then the route: the CPU, a subclass, an instance that
overrides the model code and a model with no canon take the plain
version; "cuda" with the exact class takes the kernel (decided from the
model and the device's type alone, no card probed); and the BFS engine
reports it as `telemetry()["canon_route"]`.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from torch_expand_host import bfs_levels, build_harness, host_canon, jax_canon

from stateright_tpu.models import TwoPhaseTensor as JaxTwoPhase
from stateright_tpu_torch import TensorModelAdapter
from stateright_tpu_torch.kernels import CANON_2PC
from stateright_tpu_torch.models import IncrementTensor, PaxosTensor, TwoPhaseTensor
from stateright_tpu_torch.ops.canon import build_canon, build_canon_plain, canon_route, kernel_of
from stateright_tpu_torch.xp import TorchXP

SIZES = [3, 5, 7, 10, 16]


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return build_harness(tmp_path_factory.mktemp("canon_host"))


def _successors(n, rows):
    """Every enabled successor of rows [N, 3]: the canon's inputs in a BFS
    step ([3, M] uint32)."""
    jm = JaxTwoPhase(n)
    succs, valid = jm.step_lanes(np, tuple(rows[:, s] for s in range(3)))
    return np.concatenate([
        np.stack([np.broadcast_to(succs[a][s], (len(rows),)) for s in range(3)])[:, np.asarray(valid[a], bool)]
        for a in range(jm.max_actions)
    ], axis=1)


def _plain(n, rows):
    xp = TorchXP("cpu")
    return build_canon_plain(TwoPhaseTensor(n), xp)(torch.from_numpy(rows.astype(np.int64))).numpy()


def _check(harness, n, rows):
    ref = jax_canon(n, rows)
    ours = host_canon(harness, n, rows)
    assert np.array_equal(ours, ref)
    assert np.array_equal(_plain(n, rows), ref)
    return ours


@pytest.mark.parametrize("n", SIZES)
def test_canon_on_reachable_rows_and_successors_matches_jax(harness, n):
    reach = bfs_levels(JaxTwoPhase(n), 6, 1500)
    rows = np.concatenate([reach.T, _successors(n, reach)], axis=1)
    ours = _check(harness, n, rows)
    # The canon moves rows (a permutation that sorts RMs) and fixes its own
    # outputs: the representative of a representative is itself.
    assert not np.array_equal(ours, rows.astype(np.int64))
    assert np.array_equal(host_canon(harness, n, ours.astype(np.uint32)), ours)


@pytest.mark.parametrize("n", SIZES)
def test_canon_on_seeded_uint32_rows_matches_jax(harness, n):
    rng = np.random.default_rng(300 + n)
    W = 4000
    rows = rng.integers(0, 1 << 32, size=(3, W), dtype=np.uint64).astype(np.uint32)
    # A quarter with few RM states in play, so that equal keys tie and the
    # index below the key decides their order.
    few = rng.random(W) < 0.25
    rows[1, few] &= np.uint32(0x55555555)
    _check(harness, n, rows)


@settings(max_examples=20, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(seed=st.integers(0, 2**32 - 1), n=st.sampled_from(SIZES + [1, 2]), W=st.integers(1, 50))
def test_canon_hypothesis_rows_match_jax(harness, seed, n, W):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 32, size=(3, W), dtype=np.uint64).astype(np.uint32)
    _check(harness, n, rows)


def test_canon_at_16_keeps_no_high_bits_of_lane_1(harness):
    """At n = 16 the RM states fill lane 1: JAX's mask ~(2^32 - 1) is 0, so
    nothing of the input lane survives but what the sorted RMs put back;
    lane 2 keeps its Commit/Abort bits, lane 0 its tm_state."""
    row = np.array([[0xFFFFFFFF], [0xFFFFFFFF], [0xFFFFFFFF]], dtype=np.uint32)
    ours = _check(harness, 16, row)
    assert ours[:, 0].tolist() == [0x3FFFF, 0xFFFFFFFF, 0xFFFFFFFF]
    row = np.array([[1], [0x80000000], [1 << 30]], dtype=np.uint32)  # rm 15 committed, Commit sent
    ours = _check(harness, 16, row)
    assert ours[:, 0].tolist() == [1, 0x80000000, 1 << 30]


# -- the route ---------------------------------------------------------------

class TwoPhaseSub(TwoPhaseTensor):
    pass


@pytest.mark.parametrize("n", [1, 5, 10, 16])
def test_canon_route_kernel_for_the_exact_class_on_cuda(n):
    tm = TwoPhaseTensor(n)
    assert canon_route(tm, "cuda") == "kernel"
    assert canon_route(tm, torch.device("cuda", 0)) == "kernel"
    assert kernel_of(tm) == (CANON_2PC, (n,))


def test_canon_route_plain_on_the_cpu():
    tm = TwoPhaseTensor(5)
    assert canon_route(tm, "cpu") == "plain"
    assert build_canon(tm, TorchXP("cpu")).route == "plain"


def test_canon_route_plain_for_a_subclass_an_override_or_no_kernel():
    assert canon_route(TwoPhaseSub(5), "cuda") == "plain"
    tm = TwoPhaseTensor(5)
    tm.representative_lanes = lambda xp, lanes: TwoPhaseTensor.representative_lanes(tm, xp, lanes)
    assert canon_route(tm, "cuda") == "plain"
    tm = TwoPhaseTensor(5)
    tm.step_lanes = lambda xp, lanes: TwoPhaseTensor.step_lanes(tm, xp, lanes)
    assert canon_route(tm, "cuda") == "plain"
    for other in (PaxosTensor(2), IncrementTensor(2)):
        assert canon_route(other, "cuda") == "plain"


@pytest.mark.parametrize("symmetry", [False, True])
def test_engine_reports_the_canon_route(symmetry):
    b = TensorModelAdapter(TwoPhaseTensor(3)).checker()
    if symmetry:
        b = b.symmetry()
    c = b.spawn_gpu_bfs(device="cpu", chunk_size=64, queue_capacity=1 << 10, table_capacity=1 << 10).join()
    assert c.telemetry()["canon_route"] == ("plain" if symmetry else None)
    assert c.unique_state_count() == (120 if symmetry else 288)  # the canonical closure (test_torch_symmetry.py)
