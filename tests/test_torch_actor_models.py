"""Paxos, ABD, the single-copy register and the lock-protected increment
in the port (`lanes.py`, `models/paxos.py`, `models/abd.py`,
`models/single_copy.py`, `models/increment_lock.py`): `step_lanes` and
the properties under the torch `xp` against numpy over each model's full
reachable space, engine runs whose parity dict (sample included) equals
`spawn_tpu_bfs`'s with paths that replay, and a Paxos discovery path
walked through `lookup_parent`."""

import numpy as np
import pytest
import torch

from stateright_tpu_torch.fingerprint import combine64, split64
from stateright_tpu_torch.models import (
    AbdOrderedTensor,
    AbdTensor,
    IncrementLockTensor,
    PaxosTensor,
    PaxosTensorExhaustive,
    SingleCopyTensor,
)
from stateright_tpu_torch.ops import visited_set as vs
from stateright_tpu_torch.path import Path
from stateright_tpu_torch.xp import TorchXP
from torch_parity import OPTS, PAXOS_OPTS, one_torch_thread, parity_dict, paths, reference_uncached, run_pair  # noqa: F401

M32 = 0xFFFFFFFF


def reachable(tm):
    """Every reachable state row of `tm`, by a numpy BFS over step_lanes."""
    S, A = tm.state_width, tm.max_actions
    frontier = np.asarray(tm.init_states_array(), dtype=np.uint32)
    seen = {tuple(r) for r in frontier}
    while len(frontier):
        succs, valid = tm.step_lanes(np, tuple(frontier[:, i] for i in range(S)))
        rows = np.concatenate([
            np.stack([np.asarray(succs[a][s], dtype=np.uint32) for s in range(S)], 1)[np.asarray(valid[a])]
            for a in range(A)
        ])
        new = [r for r in map(tuple, np.unique(rows, axis=0)) if r not in seen]
        seen.update(new)
        frontier = np.asarray(new, dtype=np.uint32).reshape(-1, S)
    return np.asarray(sorted(seen), dtype=np.uint32)


_COMPARES = {"__lt__", "__le__", "__gt__", "__ge__", "__eq__", "__ne__", "minimum", "maximum"}


class InRange(torch.Tensor):
    """Lanes that check, at every compare, min and max, that no operand
    carries bits above 32: there int64 and uint32 arithmetic would
    disagree. (Bits above 32 may pass through `&`, `|`, `+`, `-`, `<<`
    and `>>` followed by a narrow mask: those keep numpy's low bits,
    which the exact output comparison below checks.)"""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in _COMPARES:
            for a in args:
                if isinstance(a, torch.Tensor) and a.dtype == torch.int64:
                    t = a.as_subclass(torch.Tensor)
                    assert bool(((t >= 0) & (t <= M32)).all()), f"bits above 32 reach {func.__name__}"
        return super().__torch_function__(func, types, args, kwargs or {})


@pytest.mark.parametrize(
    "make,n_states",
    [(lambda: PaxosTensor(2), 16668), (lambda: AbdTensor(2), 544), (lambda: AbdOrderedTensor(2), 620),
     (lambda: SingleCopyTensor(3), 4243), (lambda: SingleCopyTensor(2, 2), 62),
     (lambda: IncrementLockTensor(3), 61)],
    ids=["paxos-2", "abd-2", "abd-ordered-2", "single-copy-3", "single-copy-2-2", "increment-lock-3"],
)
def test_step_lanes_and_properties_match_numpy(make, n_states):
    tm = make()
    rows = reachable(tm)
    assert len(rows) == n_states
    S, A = tm.state_width, tm.max_actions
    np_lanes = tuple(rows[:, i] for i in range(S))
    t_lanes = tuple(torch.from_numpy(lane.astype(np.int64)).as_subclass(InRange) for lane in np_lanes)
    xp = TorchXP("cpu")
    want_s, want_v = tm.step_lanes(np, np_lanes)
    got_s, got_v = tm.step_lanes(xp, t_lanes)
    for a in range(A):
        assert np.array_equal(np.asarray(want_v[a]), got_v[a].as_subclass(torch.Tensor).numpy())
        for s in range(S):
            # Every slot, valid or not: the engine masks lanes to 32 bits.
            want = np.asarray(want_s[a][s], dtype=np.uint32).astype(np.int64)
            want = np.broadcast_to(want, (len(rows),))
            got = (got_s[a][s] & M32).as_subclass(torch.Tensor).numpy()
            assert np.array_equal(want, got), (a, s)
    for p in tm.tensor_properties():
        want = np.asarray(p.check(np, np_lanes))
        got = p.check(xp, t_lanes).as_subclass(torch.Tensor).numpy()
        assert np.array_equal(want, got), p.name


@pytest.fixture(scope="module")
def runs():
    return {
        "paxos-2": run_pair("PaxosTensor", (2,), PAXOS_OPTS),
        "abd-2": run_pair("AbdTensor", (2,), PAXOS_OPTS),
        "abd-ordered-2": run_pair("AbdOrderedTensor", (2,), PAXOS_OPTS),
        "single-copy-2": run_pair("SingleCopyTensor", (2,), OPTS),
        "single-copy-3": run_pair("SingleCopyTensor", (3,), OPTS),
        "single-copy-2-2": run_pair("SingleCopyTensor", (2, 2), OPTS),
        "increment-lock-2": run_pair("IncrementLockTensor", (2,), OPTS),
        "increment-lock-3": run_pair("IncrementLockTensor", (3,), OPTS),
    }


# Two servers: a read of the empty second copy is not linearizable.
VIOLATED = {"single-copy-2-2": "linearizable"}


@pytest.mark.parametrize("case,golden", [
    ("paxos-2", 16668), ("abd-2", 544), ("abd-ordered-2", 620), ("single-copy-2", 93),
    ("single-copy-3", 4243), ("single-copy-2-2", 62), ("increment-lock-2", 17), ("increment-lock-3", 61),
])
def test_engine_matches_jax(runs, case, golden):
    violated = VIOLATED.get(case)
    ref, ours = runs[case]
    assert ours.unique_state_count() == golden
    assert parity_dict(ours) == parity_dict(ref)
    assert paths(ours) == paths(ref)
    for name, path in ours.discoveries().items():
        ours.assert_discovery(name, path.into_actions())
    if violated is None:
        ours.assert_properties()
    else:
        path = ours.discovery(violated)
        assert not ours.model().property(violated).condition(ours.model(), path.last_state())


def test_paxos_path_through_lookup_parent(runs):
    ours = runs["paxos-2"][1]
    path = ours.assert_any_discovery("value chosen")
    ours.assert_discovery("value chosen", path.into_actions())
    fps = [int(fp) for fp in path.encode(ours.model()).split("/")]
    assert fps[-1] == ours._discovery_fps["value chosen"]
    # Walk the stored parents from the discovery back to the init state.
    table = ours._table
    cur, chain = fps[-1], [fps[-1]]
    while True:
        h1, h2 = split64(cur)
        found, p1, p2 = vs.lookup_parent(table, torch.tensor([h1]), torch.tensor([h2]))
        assert bool(found[0])
        if int(p1[0]) == 0 and int(p2[0]) == 0:
            break
        cur = combine64(int(p1[0]), int(p2[0]))
        chain.append(cur)
    assert chain[::-1] == fps
    replay = Path.from_fingerprints(ours.model(), fps)
    assert replay.last_state() == path.last_state()


def test_models_importable_with_reference_widths():
    # Widths measured on the JAX models (S, A).
    assert (PaxosTensorExhaustive(3).state_width, PaxosTensorExhaustive(3).max_actions) == (30, 21)
    assert (PaxosTensor(2).state_width, PaxosTensor(2).max_actions) == (22, 14)
    assert (AbdOrderedTensor(3).state_width, AbdOrderedTensor(3).max_actions) == (12, 5)
    assert (SingleCopyTensor(4).state_width, SingleCopyTensor(4).max_actions) == (10, 5)
    assert (SingleCopyTensor(3, 2).state_width, SingleCopyTensor(3, 2).max_actions) == (9, 4)
    assert (IncrementLockTensor(3).state_width, IncrementLockTensor(3).max_actions) == (8, 12)


def test_xp_namespace():
    xp = TorchXP("cpu")
    x = torch.tensor([1, 5, 9])
    assert xp.where(x > 4, 1, 0).tolist() == [0, 1, 1]
    assert xp.where(x > 4, x, 0).tolist() == [0, 5, 9]
    assert xp.concatenate([x, x]).tolist() == [1, 5, 9, 1, 5, 9]
    assert xp.full(2, 7, dtype=xp.uint32).tolist() == [7, 7]
    assert xp.full_like(x, 3).tolist() == [3, 3, 3]
    assert xp.zeros_like(x).tolist() == [0, 0, 0] and xp.ones_like(x).tolist() == [1, 1, 1]
