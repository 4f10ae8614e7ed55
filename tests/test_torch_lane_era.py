"""The multiplexed lanes' batch program (K14f): the port's `LaneProgram`
against the JAX lane program, word for word, and the lane axis of K8f's
era kernels (the plain versions) against a table of cases and against
the solo era at one lane. Exact throughout.

(b) JAX `_build_lane_program` (`stateright_tpu/engines/multiplex.py:86`,
`jax.vmap` of the K10 seed and the raw era loop) and the port's lane
program (`device="cpu"`: every kernel's plain version) take the same
init rows and per-lane params rows — padding lanes, target depths and
finish masks drawn from a numpy seed — and must leave the same
`params_out[N, plen]`, word for word, and the same tables (each lane's
key -> parent map). 2pc-6 at chunk 1024 commits partially.

(c) `era_step_plain` and `era_epilogue_plain` over a lane axis: a closed
lane keeps every word, each open lane follows the solo rules, the loop
runs while any lane is open, and one lane equals the solo call.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stateright_tpu.models as jax_models
import stateright_tpu_torch.models as torch_models
from stateright_tpu.engines import multiplex as jm
from stateright_tpu.fingerprint import hash_words_np
from stateright_tpu_torch.engines.multiplex import LaneProgram
from stateright_tpu_torch.ops import era as eo
from stateright_tpu_torch.ops import visited_set as vs
from torch_era_ops import lane as lane_of
from torch_era_ops import step_operands
from torch_parity import _JAX_MODELS, one_torch_thread, reference_uncached  # noqa: F401

M32 = 0xFFFFFFFF

# name -> (model, args, lanes, live lanes, chunk, qcap, tcap, icap)
CASES = {
    "2pc-3 mixed": ("TwoPhaseTensor", (3,), 8, 6, 64, 1 << 12, 1 << 13, 16),
    "increment-2": ("IncrementTensor", (2,), 4, 3, 256, 1 << 13, 1 << 12, 64),
    "2pc-6 partial": ("TwoPhaseTensor", (6,), 2, 2, 1024, 1 << 16, 1 << 18, 64),
    # Two properties ("linearizable", "value chosen") first hit in one era
    # at one depth.
    "single-copy 2x2": ("SingleCopyTensor", (2, 2), 4, 3, 64, 1 << 12, 1 << 12, 16),
}


def _table_maps(k1, k2, v1, v2):
    maps = []
    for lane in range(k1.shape[0]):
        occ = (k1[lane] != 0) | (k2[lane] != 0)
        maps.append(dict(zip(zip(k1[lane][occ].tolist(), k2[lane][occ].tolist()),
                             zip(v1[lane][occ].tolist(), v2[lane][occ].tolist()))))
    return maps


def _draw(rng, n, P, case):
    """Per live lane: a target depth (or none) and finish masks."""
    if case == "2pc-6 partial":
        depth = np.array([M32, 12])
    else:
        depth = rng.choice([2, 3, 5, 9, M32], size=n)
    fin_any = np.array([rng.choice([0, 0, 1 << int(rng.integers(0, P))]) for _ in range(n)])
    fin_all_en = rng.integers(0, 2, size=n)
    fin_all = np.full(n, (1 << P) - 1)
    if case in ("2pc-6 partial", "single-copy 2x2"):
        fin_any[:] = 0
        fin_all_en[:] = 0
    if case == "single-copy 2x2":
        depth = np.full(n, M32)
    return depth, fin_any, fin_all, fin_all_en


@pytest.mark.parametrize("case", list(CASES))
def test_lane_batch_matches_the_jax_lane_program(case):
    name, args, N, n, C, qcap, tcap, icap = CASES[case]
    jtm = _JAX_MODELS.setdefault((name, args), getattr(jax_models, name)(*args))
    tm = getattr(torch_models, name)(*args)
    tprops = tm.tensor_properties()
    S, P = tm.state_width, len(tprops)
    C = min(C, qcap // (2 * tm.max_actions))
    prog = LaneProgram(tm, tprops, N, C, qcap, tcap, icap, True, torch.device("cpu"))
    rng = np.random.default_rng(sum(map(ord, case)))
    depth, fin_any, fin_all, fin_all_en = _draw(rng, n, P, case)

    inits = np.asarray(tm.init_states_array(), dtype=np.uint32)
    inb = np.asarray(tm.within_boundary_lanes(np, tuple(inits[:, s] for s in range(S))), dtype=bool)
    inits = inits[inb]
    res = prog.run(inits.astype(np.int64), n, depth, fin_any, fin_all, fin_all_en)

    # The JAX lane program on the same inputs (multiplex.py:521-537).
    program = jm._build_lane_program(jtm, jtm.tensor_properties(), N, C, qcap, tcap, icap, True)
    k = len(inits)
    qinit = np.zeros((N, S + 2, icap), dtype=np.uint32)
    qinit[:n, :S, :k] = inits.T
    qinit[:n, S, :k] = prog.init_ebits
    qinit[:n, S + 1, :k] = 1
    n_inits = np.zeros(N, dtype=np.uint32)
    n_inits[:n] = k
    h1 = np.zeros((N, icap), dtype=np.uint32)
    h2 = np.zeros((N, icap), dtype=np.uint32)
    h1[:n, :k], h2[:n, :k] = hash_words_np(inits)
    params = prog.lane_params(n, depth, fin_any, fin_all, fin_all_en).astype(np.uint32)
    zero = jnp.zeros((N, P), dtype=jnp.uint32)
    tables, want = program(jnp.asarray(qinit), jnp.asarray(n_inits), jnp.asarray(h1), jnp.asarray(h2),
                           jnp.asarray(params), zero, zero)
    want = np.asarray(want).astype(np.int64)
    assert np.array_equal(res.params, want), np.argwhere(res.params != want)[:10]
    tables = np.asarray(tables)
    assert _table_maps(*vs.table_to_lanes(prog.table)) == _table_maps(*(tables[:, i] for i in range(4)))
    assert (res.unique[:n] > 1).all() and not res.params[n:, eo.P_UNIQUE].any()
    if case == "2pc-6 partial":
        assert (res.partial > 0).all()
    if case == "single-copy 2x2":
        assert ((res.params[:n, eo.P_REC] & 3) == 3).all()


# -- (c) the lane axis of the plain era kernels --------------------------------

C, QCAP, A, P = 8, 1 << 6, 3, 2
VCAP, RCAP = 10, 6


def _cfg():
    plen = eo.params_len(A, P, True, 0)
    return eo.EraConfig(
        chunk=C, qmask=QCAP - 1, vcap=VCAP, rcap=RCAP, P=P, A=A, cov_base=eo.P_LEN + 2 * P,
        s_base=-1, s_high=0, s_take=C, f_base=-1, fuse=1, x=plen, regrow=2,
        budget_min=eo.BUDGET_MIN, n_cov=eo.cov_len(A, P), scap=0,
    )


def _lanes(c, rows):
    """A lane state [N, plen + X_LEN] from per-lane dicts of words."""
    st = torch.zeros((len(rows), c.x + eo.X_LEN), dtype=torch.int64)
    for l, words in enumerate(rows):
        st[l, eo.P_HIGH_WATER] = 40
        st[l, eo.P_GROW_LIMIT] = 1000
        st[l, eo.P_MAX_STEPS] = 5
        st[l, eo.P_TAKE_CAP] = C
        for k, v in words.items():
            st[l, k] = v
    return st


def _step(N, n_val, n_d, unres, new, gen, hs, pa):
    return step_operands(C, A, P, RCAP, n_val, n_d, unres, new, hs, pa, gen=gen)


# case -> (lane rows, step operands per lane, the words each lane must
# hold after BEGIN and one COMMIT, whether the loop goes on)
LANE_CASES = {
    "one open, one empty (closed)": (
        [{eo.P_COUNT: 3}, {eo.P_COUNT: 0}],
        dict(n_val=[4, 0], n_d=[4, 0], unres=[0, 0], new=[2, 0], gen=[4, 0], hs=[[1, 0], [0, 0]],
             pa=[[1, 2, 1], [0, 0, 0]]),
        [{eo.P_HEAD: 3, eo.P_COUNT: 2, eo.P_UNIQUE: 2, eo.P_STEPS: 1, eo.P_GEN: 4, eo.P_REC: 1},
         {eo.P_HEAD: 0, eo.P_COUNT: 0, eo.P_UNIQUE: 0, eo.P_STEPS: 0, eo.P_GEN: 0, eo.P_REC: 0}],
        True,
    ),
    "an overflow lane and a finished lane": (
        [{eo.P_COUNT: 5}, {eo.P_COUNT: 2, eo.P_FIN_ANY: 1}],
        dict(n_val=[11, 3], n_d=[5, 3], unres=[0, 0], new=[3, 1], gen=[11, 3], hs=[[0, 0], [2, 0]],
             pa=[[4, 4, 3], [1, 1, 1]]),
        [{eo.P_HEAD: 0, eo.P_COUNT: 8, eo.P_UNIQUE: 3, eo.P_STEPS: 0, eo.P_TAKE_CAP: 2},
         {eo.P_HEAD: 2, eo.P_COUNT: 1, eo.P_UNIQUE: 1, eo.P_STEPS: 1, eo.P_REC: 1}],
        True,
    ),
    "every lane closes": (
        [{eo.P_COUNT: 1}, {eo.P_COUNT: 1, eo.P_MAX_STEPS: 1}],
        dict(n_val=[0, 0], n_d=[0, 0], unres=[0, 0], new=[0, 0], gen=[0, 0], hs=[[0, 0], [0, 0]],
             pa=[[0, 0, 0], [0, 0, 0]]),
        [{eo.P_COUNT: 0, eo.P_STEPS: 1}, {eo.P_COUNT: 0, eo.P_STEPS: 1}],
        False,
    ),
    "a probe error closes only its lane": (
        [{eo.P_COUNT: 1}, {eo.P_COUNT: 4}],
        dict(n_val=[2, 2], n_d=[2, 2], unres=[1, 0], new=[1, 2], gen=[2, 2], hs=[[0, 0], [0, 0]],
             pa=[[1, 1, 0], [1, 1, 0]]),
        [{eo.P_ERR: 1, eo.P_COUNT: 2, eo.P_STEPS: 0}, {eo.P_ERR: 0, eo.P_COUNT: 2, eo.P_STEPS: 1}],
        True,
    ),
}


@pytest.mark.parametrize("case", list(LANE_CASES))
def test_lane_era_step_case_table(case):
    rows, ops, want, more = LANE_CASES[case]
    c = _cfg()
    st = _lanes(c, rows)
    eo.era_step_plain(eo.START, c, st)
    eo.era_step_plain(eo.BEGIN, c, st)
    closed = [l for l in range(len(rows)) if not st[l, c.x + eo.X_OPEN]]
    before = st[closed].clone()
    eo.era_step_plain(eo.COMMIT, c, st, _step(len(rows), **ops))
    assert torch.equal(st[closed], before)  # a closed lane keeps every word
    for l, words in enumerate(want):
        for k, v in words.items():
            assert int(st[l, k]) == v, (case, l, k)
    assert bool(st[:, c.x + eo.X_OPEN].any()) == more


@pytest.mark.parametrize("case", list(LANE_CASES))
def test_one_lane_equals_the_solo_era_kernels(case):
    """Each lane of the case alone, as a one-lane state and as the solo
    vector: the same words after START, BEGIN, COMMIT and the epilogue."""
    rows, ops, _want, _more = LANE_CASES[case]
    c = _cfg()
    full = _step(len(rows), **ops)
    rng = np.random.default_rng(7)
    for l in range(len(rows)):
        solo = _lanes(c, [rows[l]])[0]
        lane = solo.clone()[None]
        one, one_l = lane_of(full, l, C, solo=True), lane_of(full, l, C)
        for mode, a, b in ((eo.START, None, None), (eo.BEGIN, None, None), (eo.COMMIT, one, one_l)):
            eo.era_step_plain(mode, c, solo, a)
            eo.era_step_plain(mode, c, lane, b)
            assert torch.equal(solo, lane[0]), (case, l, mode)
        hseen = torch.from_numpy(rng.random((P, C)) < 0.4)
        facc = [torch.from_numpy(rng.integers(0, 1 << 32, (P, C))) for _ in range(3)]
        depth = torch.from_numpy(rng.integers(0, 9, QCAP + 1))
        lane_lanes = [hseen.clone()] + [t.clone() for t in facc]
        eo.era_epilogue_plain(c, solo, hseen, *facc, depth)
        eo.era_epilogue_plain(c, lane, *lane_lanes, depth[None])
        assert torch.equal(solo, lane[0]), (case, l, "epilogue")


def test_lane_epilogue_takes_each_lanes_shallowest_hit():
    """Per lane the shallowest first hit, the lowest position on ties,
    among that lane's chunk positions only; the max depth at each lane's
    own ring slot."""
    c = _cfg()
    st = _lanes(c, [{eo.P_HEAD: 3}, {eo.P_HEAD: 1}, {}])
    st[:, c.x + eo.X_ESTEPS] = torch.tensor([1, 1, 0])
    hseen = torch.zeros((P, 3 * C), dtype=torch.bool)
    faccd = torch.zeros((P, 3 * C), dtype=torch.int64)
    facc1 = torch.arange(P * 3 * C, dtype=torch.int64).view(P, 3 * C) + 100
    hseen[0, [2, 5]] = True  # lane 0: depths 4 and 3
    faccd[0, [2, 5]] = torch.tensor([4, 3])
    hseen[0, [C + 1, C + 6]] = True  # lane 1: a tie at depth 2
    faccd[0, [C + 1, C + 6]] = 2
    depth = torch.zeros((3, QCAP + 1), dtype=torch.int64)
    depth[0, 2], depth[1, 0] = 7, 5
    eo.era_epilogue_plain(c, st, hseen, facc1, facc1.clone(), faccd, depth)
    assert st[:, eo.P_REC].tolist() == [1, 1, 0]
    assert int(st[0, eo.P_LEN]) == 105 and int(st[1, eo.P_LEN]) == 100 + C + 1
    assert st[:, eo.P_MAXD].tolist() == [7, 5, 0]
    assert not hseen.any()
