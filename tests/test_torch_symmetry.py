"""Symmetry reduction in the port: `.symmetry()` runs whose whole parity
dict (canonical-closure counts, discoveries, coverage, sample) equals the
JAX engine's, the 2PC canonicalizer under the torch `xp` against numpy
over the full reachable space, and the refusal of a model that defines
no `representative_lanes`."""

import numpy as np
import pytest
import torch

from stateright_tpu_torch import TensorModelAdapter
from stateright_tpu_torch.models import PaxosTensor, TwoPhaseTensor
from stateright_tpu_torch.path import Path
from stateright_tpu_torch.tensor import CanonicalTensorAdapter
from stateright_tpu_torch.xp import TorchXP
from torch_parity import OPTS, one_torch_thread, parity_dict, paths, reference_uncached, run_pair  # noqa: F401


@pytest.fixture(scope="module")
def runs():
    return {n: run_pair("TwoPhaseTensor", (n,), OPTS, lambda b: b.symmetry()) for n in (3, 5)}


@pytest.mark.parametrize("n,closure", [(3, 120), (5, 1092)])
def test_symmetry_matches_jax(runs, n, closure):
    ref, ours = runs[n]
    assert ours.unique_state_count() == closure
    assert parity_dict(ours) == parity_dict(ref)
    assert paths(ours) == paths(ref)


def test_symmetry_paths_walk_representatives(runs):
    ours = runs[5][1]
    canon = CanonicalTensorAdapter(ours.tm)
    for name, path in ours.discoveries().items():
        states = path.into_states()
        assert all(canon.representative_state(s) == tuple(s) for s in states)
        replay = Path.from_actions(canon, states[0], path.into_actions())
        assert replay is not None and replay.last_state() == path.last_state()
        assert canon.property(name).condition(canon, path.last_state())
    assert ours.space_profile()["unresolved"] == 0


def test_representative_lanes_match_numpy():
    tm = TwoPhaseTensor(5)
    model = TensorModelAdapter(tm)
    seen, frontier = set(model.init_states()), list(model.init_states())
    while frontier:
        nxt = []
        for s in frontier:
            for t in model.next_states(s):
                if t not in seen:
                    seen.add(t)
                    nxt.append(t)
        frontier = nxt
    assert len(seen) == 8832
    rows = np.asarray(sorted(seen), dtype=np.uint32)
    lanes = tuple(rows[:, i] for i in range(3))
    want = tm.representative_lanes(np, lanes)
    got = tm.representative_lanes(TorchXP("cpu"), tuple(torch.from_numpy(lane.astype(np.int64)) for lane in lanes))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w, dtype=np.uint32).astype(np.int64), (g & 0xFFFFFFFF).numpy())
        assert int(g.min()) >= 0 and int(g.max()) <= 0xFFFFFFFF


@pytest.mark.parametrize(
    "configure", [lambda b: b.symmetry(), lambda b: b.symmetry_fn(lambda state: state)]
)
def test_symmetry_without_representative_lanes_raises(configure):
    with pytest.raises(ValueError, match="representative_lanes"):
        configure(TensorModelAdapter(PaxosTensor(1)).checker()).spawn_gpu_bfs(device="cpu", **OPTS)
