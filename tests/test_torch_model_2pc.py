"""The port's TwoPhaseTensor through the torch `xp` against the JAX
package's through jax.numpy, over the whole reachable 2pc-5 space."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.models import TwoPhaseTensor as JaxTwoPhase
from stateright_tpu_torch.models import TwoPhaseTensor
from stateright_tpu_torch.xp import TorchXP


def reachable_rows(tm):
    """Every reachable state of `tm` as [N, S] uint32 rows (numpy BFS
    over the JAX model's own step_lanes)."""
    S, A = tm.state_width, tm.max_actions
    seen = {tuple(r) for r in tm.init_states_array().tolist()}
    frontier = np.asarray(sorted(seen), dtype=np.uint32)
    while len(frontier):
        succs, valid = tm.step_lanes(np, tuple(frontier[:, s] for s in range(S)))
        nxt = []
        for a in range(A):
            rows = np.stack([np.broadcast_to(succs[a][s], (len(frontier),)) for s in range(S)], axis=1)
            nxt.append(rows[np.asarray(valid[a], dtype=bool)])
        new = {tuple(r) for r in np.concatenate(nxt).tolist()} - seen
        seen |= new
        frontier = np.asarray(sorted(new), dtype=np.uint32).reshape(-1, S)
    return np.asarray(sorted(seen), dtype=np.uint32)


@pytest.fixture(scope="module")
def space5():
    rows = reachable_rows(JaxTwoPhase(5))
    assert len(rows) == 8832
    return rows


def test_init_states_match():
    for n in (3, 5, 7):
        assert np.array_equal(TwoPhaseTensor(n).init_states_array(), JaxTwoPhase(n).init_states_array())


def test_step_and_properties_match_over_2pc5(space5):
    tm, jm = TwoPhaseTensor(5), JaxTwoPhase(5)
    xp = TorchXP("cpu")
    lanes = tuple(torch.from_numpy(space5[:, s].astype(np.int64)) for s in range(3))
    jlanes = tuple(jnp.asarray(space5[:, s]) for s in range(3))
    succs, valid = tm.step_lanes(xp, lanes)
    j_succs, j_valid = jm.step_lanes(jnp, jlanes)
    assert len(succs) == len(j_succs) == tm.max_actions == jm.max_actions
    for a in range(tm.max_actions):
        assert np.array_equal(valid[a].numpy(), np.asarray(j_valid[a]))
        for s in range(3):
            ours = succs[a][s].numpy() & 0xFFFFFFFF
            assert np.array_equal(ours, np.asarray(j_succs[a][s]).astype(np.int64))
    for p, jp in zip(tm.tensor_properties(), jm.tensor_properties()):
        assert (p.name, p.expectation.value) == (jp.name, jp.expectation.value)
        assert np.array_equal(p.check(xp, lanes).numpy(), np.asarray(jp.check(jnp, jlanes)))
    canon = tm.representative_lanes(xp, lanes)
    j_canon = jm.representative_lanes(jnp, jlanes)
    for ours, ref in zip(canon, j_canon):
        assert np.array_equal(ours.numpy() & 0xFFFFFFFF, np.asarray(ref).astype(np.int64))


def test_xp_uint32_constants_match_numpy():
    xp = TorchXP("cpu")
    lane = torch.tensor([0, 5, 0xFFFFFFFF, 0x80000001], dtype=torch.int64)
    u = np.uint32
    ref = lane.numpy().astype(np.uint32)
    cases = [
        (lane & ~xp.uint32(3), ref & ~u(3)),
        (lane | (xp.uint32(1) << xp.uint32(31)), ref | (u(1) << u(31))),
        (lane & ~(xp.uint32(3) << xp.uint32(30)), ref & ~(u(3) << u(30))),
        (lane >> xp.uint32(31), ref >> u(31)),
    ]
    for ours, want in cases:
        assert np.array_equal(ours.numpy() & 0xFFFFFFFF, want.astype(np.int64))
