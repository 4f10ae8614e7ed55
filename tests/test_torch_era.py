"""The BFS era program (K8f): the port's `EraProgram` against the JAX era
program, word for word, and the plain versions of its two kernels
against a table of gate, overflow and budget cases. Exact throughout.

(a) The raw JAX loop (`_build_loop(..., raw=True)`) at fuse 1 and 4 and
the port's era program (`device="cpu"`: every kernel's plain version)
take the same table, queue, rec_fp and params, built from a seed with
numpy from a mid-run state (the JAX seeder and one JAX era), with the
host-owned words (step budget, budget cap, take cap, fuse_lim, the
sample threshold, the finish masks) drawn at random. Equal means the
whole params vector out (coverage, sample and fusion tails and the next
budget included), rec_fp1 and rec_fp2, the queue lanes, and the table's
key -> parent map.

(b) `era_step_plain` and `era_epilogue_plain` on hand-made states: each
row of the table names the case and the words it must leave.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stateright_tpu.models as jax_models
import stateright_tpu_torch.models as torch_models
from stateright_tpu.engines import tpu_bfs as jb
from stateright_tpu.fingerprint import hash_words_np
from stateright_tpu.ops import visited_set as jvs
from stateright_tpu_torch.engines import era
from stateright_tpu_torch.ops import era as eo
from stateright_tpu_torch.ops import slab as sl
from torch_era_ops import step_operands
from torch_parity import one_torch_thread, reference_uncached  # noqa: F401

M32 = 0xFFFFFFFF

# name -> (model, args, chunk, qcap, tcap, canon, sample_k)
CASES = {
    "2pc-5": ("TwoPhaseTensor", (5,), 64, 1 << 12, 1 << 15, False, 64),
    "2pc-5 unsampled": ("TwoPhaseTensor", (5,), 64, 1 << 12, 1 << 15, False, 0),
    "paxos-2": ("PaxosTensor", (2,), 256, 1 << 14, 1 << 16, False, 64),
    "2pc-5 symmetry": ("TwoPhaseTensor", (5,), 64, 1 << 12, 1 << 15, True, 64),
    # Two properties first hit in one era at one depth.
    "single-copy 2x2": ("SingleCopyTensor", (2, 2), 64, 1 << 12, 1 << 12, False, 64),
}
_JAX_MODELS = {}


def _table_map(k1, k2, v1, v2):
    occ = (np.asarray(k1) != 0) | (np.asarray(k2) != 0)
    return dict(zip(zip(np.asarray(k1)[occ].tolist(), np.asarray(k2)[occ].tolist()),
                    zip(np.asarray(v1)[occ].tolist(), np.asarray(v2)[occ].tolist())))


def _mid_run(case, fuse):
    """The raw JAX loop at `fuse`, and a mid-run era input: the JAX
    seeder's table and queue after one JAX era of a few steps."""
    name, args, C, qcap, tcap, canon, k = CASES[case]
    jtm = _JAX_MODELS.setdefault((name, args), getattr(jax_models, name)(*args))
    props = jtm.tensor_properties()
    S, A, P = jtm.state_width, jtm.max_actions, len(props)
    loop = jax.jit(jb._build_loop(jtm, props, C, qcap, canon, True, raw=True, sample_k=k, fuse=fuse))
    inits = np.asarray(jtm.init_states_array(), dtype=np.uint32)
    if canon:
        lanes = jtm.representative_lanes(np, tuple(inits[:, i] for i in range(S)))
        inits = np.unique(np.stack([np.asarray(x, dtype=np.uint32) for x in lanes], axis=1), axis=0)
    n = len(inits)
    qinit = np.zeros((S + 2, n), dtype=np.uint32)
    qinit[:S] = inits.T
    qinit[S + 1] = 1
    plen = jb.params_len(A, P, True, k, fuse)
    vcap = jb._vcap(A, C)
    params = np.zeros(plen, dtype=np.uint32)
    params[:eo.P_LEN] = [0, 0, 0, 0, M32, int(0.25 * tcap) - vcap, qcap - C * A, 3, 0, 0, 0, 0,
                         C, 0, 0, 0, 0]
    if k:
        s_base = eo.P_LEN + 2 * P + eo.cov_len(A, P)
        params[s_base:s_base + 2] = M32
    if fuse > 1:
        params[jb.params_len(A, P, True, k)] = 1
    h1, h2 = hash_words_np(inits)
    table, queue, params = jb._build_seed(S, qcap, tcap)(
        jnp.asarray(qinit), jnp.asarray(h1), jnp.asarray(h2), jnp.asarray(params))
    zero = jnp.zeros(P, dtype=jnp.uint32)
    table, queue, rec1, rec2, params = loop(table, queue, zero, zero, params)
    return loop, (table, queue, rec1, rec2, np.asarray(params))


def _draw(rng, case, fuse, params, budget_cap):
    """Random host-owned words on top of a JAX era's output."""
    name, args, C, _qcap, _tcap, _canon, k = CASES[case]
    jtm = _JAX_MODELS[(name, args)]
    A, P = jtm.max_actions, len(jtm.tensor_properties())
    p = params.copy()
    p[eo.P_MAX_STEPS] = rng.integers(1, 9)
    p[eo.P_BUDGET_CAP] = budget_cap
    p[eo.P_TAKE_CAP] = rng.choice([1, 2, C // 3, C])
    p[eo.P_FIN_ANY] = rng.choice([0, 0, 1 << int(rng.integers(0, P))])
    p[eo.P_FIN_ALL_EN] = rng.choice([0, 1])
    p[eo.P_FIN_ALL] = (1 << P) - 1
    if k:
        s_base = eo.P_LEN + 2 * P + eo.cov_len(A, P)
        p[s_base:s_base + 2] = (M32, M32) if rng.random() < 0.5 else (rng.integers(0, 1 << 28), 0)
    if fuse > 1:
        p[jb.params_len(A, P, True, k)] = rng.integers(0, fuse + 2)
    return p


@pytest.mark.parametrize("fuse", [1, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_era_matches_the_jax_era(case, fuse):
    name, args, C, qcap, tcap, canon, k = CASES[case]
    loop, (table, queue, rec1, rec2, params) = _mid_run(case, fuse)
    tm = getattr(torch_models, name)(*args)
    prog = era.EraProgram(tm, tm.tensor_properties(), C, qcap, tcap, canon, True, k, fuse, "cpu")
    rng = np.random.default_rng(sum(map(ord, case)) + fuse)
    for budget_cap in (0, 64, 4):  # the next budget passes through, then adapts
        p = _draw(rng, case, fuse, params, budget_cap)
        era.state_from_jax(prog, jvs.unpack_lanes_np(table), [np.asarray(q) for q in queue],
                           np.asarray(rec1), np.asarray(rec2), p)
        prog.run_eager()
        got_table, got_queue, got1, got2, got_params = era.state_to_jax(prog)
        table, queue, rec1, rec2, want = loop(table, queue, rec1, rec2, jnp.asarray(p))
        want = np.asarray(want)
        assert np.array_equal(got_params, want), np.flatnonzero(got_params != want)
        assert np.array_equal(got1, np.asarray(rec1)) and np.array_equal(got2, np.asarray(rec2))
        for a, b in zip(got_queue, queue):
            assert np.array_equal(a, np.asarray(b))
        assert _table_map(*got_table) == _table_map(*jvs.unpack_lanes_np(table))
        params = want
    assert int(params[eo.P_UNIQUE]) > 1


# -- (b) the plain kernels on hand-made states --------------------------------

C, QCAP, A, P = 8, 1 << 6, 3, 2
VCAP, RCAP = 10, 6


def _cfg(sampled=False, fuse=1):
    plen = eo.params_len(A, P, True, 64 if sampled else 0, fuse)
    return eo.EraConfig(
        chunk=C, qmask=QCAP - 1, vcap=VCAP, rcap=RCAP, P=P, A=A, cov_base=eo.P_LEN + 2 * P,
        s_base=eo.P_LEN + 2 * P + eo.cov_len(A, P) if sampled else -1, s_high=20, s_take=3,
        f_base=eo.params_len(A, P, True, 64 if sampled else 0) if fuse > 1 else -1, fuse=fuse,
        x=plen, regrow=2, budget_min=eo.BUDGET_MIN, n_cov=eo.cov_len(A, P), scap=40,
    )


def _state(c, **words):
    s = np.zeros(c.x + eo.X_LEN, dtype=np.int64)
    s[:eo.P_LEN] = [0, 5, 100, 0, M32, 1000, 40, 10, 0, 0, 0, 0, C, 0, 0, 0, 0]
    for key, v in words.items():
        if key.startswith("X_"):
            s[c.x + getattr(eo, key)] = v
        else:
            s[getattr(eo, key)] = v
    return torch.from_numpy(s)


def _slab(occupied=0):
    slab = sl.empty_slab(40, "cpu")
    slab.counts[0] = occupied
    return slab


def _word(c, s, key):
    return int(s[c.x + getattr(eo, key)] if key.startswith("X_") else s[getattr(eo, key)])


# (case, state words, sampled, slab occupancy, expected words) after BEGIN.
GATE_CASES = [
    ("open", {}, False, 0, dict(X_OPEN=1, X_TAKE=5, X_TAIL=5)),
    ("empty frontier", dict(P_COUNT=0), False, 0, dict(X_OPEN=0, X_TAKE=0)),
    ("ring past high water", dict(P_COUNT=41), False, 0, dict(X_OPEN=0)),
    ("table past its limit", dict(P_UNIQUE=1001), False, 0, dict(X_OPEN=0)),
    ("budget of zero", dict(P_MAX_STEPS=0), False, 0, dict(X_OPEN=0)),
    ("error", dict(P_ERR=1), False, 0, dict(X_OPEN=0)),
    ("finish ANY met", dict(P_REC=2, P_FIN_ANY=2), False, 0, dict(X_OPEN=0)),
    ("finish ANY unmet", dict(P_REC=1, P_FIN_ANY=2), False, 0, dict(X_OPEN=1)),
    ("finish ALL met", dict(P_REC=3, P_FIN_ALL=3, P_FIN_ALL_EN=1), False, 0, dict(X_OPEN=0)),
    ("finish ALL partial", dict(P_REC=1, P_FIN_ALL=3, P_FIN_ALL_EN=1), False, 0, dict(X_OPEN=1)),
    ("take_cap clamps", dict(P_TAKE_CAP=2), False, 0, dict(X_TAKE=2)),
    ("take_cap 0 clamps up to 1", dict(P_TAKE_CAP=0), False, 0, dict(X_TAKE=1, P_TAKE_CAP=1)),
    ("chunk clamps", dict(P_COUNT=30, P_TAKE_CAP=99), False, 0, dict(X_TAKE=C, P_TAKE_CAP=C)),
    ("loose threshold clamp", dict(P_COUNT=30), True, 0, dict(X_OPEN=1, X_TAKE=3)),
    ("slab past high water", {}, True, 21, dict(X_OPEN=0)),
    ("slab at high water", {}, True, 20, dict(X_OPEN=1)),
    ("ring tail wraps", dict(P_HEAD=60, P_COUNT=10), False, 0, dict(X_TAIL=6)),
]


@pytest.mark.parametrize("case,words,sampled,occ,want", GATE_CASES, ids=[c[0] for c in GATE_CASES])
def test_gate_cases(case, words, sampled, occ, want):
    c = _cfg(sampled)
    s = _state(c, **words)
    if sampled:
        s[c.s_base:c.s_base + 2] = M32
    eo.era_step_plain(eo.BEGIN, c, s, slab=_slab(occ))
    for key, v in want.items():
        assert _word(c, s, key) == v, key


def _commit(c, s, n_val, n_d, unresolved, new, generated=7, hs=(0, 0), pa=(1, 2, 3)):
    step = step_operands(C, A, P, RCAP, [n_val], [n_d], [unresolved], [new], [hs], [pa],
                         gen=[generated], solo=True)
    epoch = torch.ones(1, dtype=torch.int64)
    eo.era_step_plain(eo.COMMIT, c, s, step, None, epoch)
    return epoch


# (case, state words, (n_val, n_d, unresolved, new), expected words) after COMMIT.
COMMIT_CASES = [
    ("clean step", dict(X_OPEN=1, X_TAKE=5, P_TAKE_CAP=5), (9, 5, 0, 4),
     dict(P_HEAD=5, P_COUNT=4, P_UNIQUE=104, P_STEPS=1, X_ESTEPS=1, P_GEN=7, P_TAKE_CAP=7,
          X_PARTIAL=0, X_ITER=1)),
    ("regrow stops at chunk", dict(X_OPEN=1, X_TAKE=5, P_TAKE_CAP=7), (9, 5, 0, 0),
     dict(P_TAKE_CAP=C)),
    ("valid overflow", dict(X_OPEN=1, X_TAKE=5, P_TAKE_CAP=5), (11, 5, 0, 3),
     dict(P_HEAD=0, P_COUNT=8, P_UNIQUE=103, P_STEPS=0, P_GEN=0, P_TAKE_CAP=2, X_PARTIAL=1,
          P_ERR=0)),
    ("distinct overflow", dict(X_OPEN=1, X_TAKE=4), (9, 7, 0, 2), dict(P_HEAD=0, P_TAKE_CAP=2, P_COUNT=7)),
    ("unresolved, take > 1", dict(X_OPEN=1, X_TAKE=2), (3, 3, 1, 2), dict(P_ERR=0, P_TAKE_CAP=1, P_STEPS=0)),
    ("unresolved, take 1: the error", dict(X_OPEN=1, X_TAKE=1, P_TAKE_CAP=1), (3, 3, 2, 1),
     dict(P_ERR=2, P_TAKE_CAP=1, P_HEAD=0, X_OPEN=0)),
    ("take_cap at 1 stays 1", dict(X_OPEN=1, X_TAKE=1, P_TAKE_CAP=1), (11, 3, 0, 0), dict(P_TAKE_CAP=1)),
    ("closed gate: nothing", dict(X_OPEN=0, X_TAKE=0), (9, 5, 0, 4),
     dict(P_HEAD=0, P_COUNT=5, P_UNIQUE=100, X_ITER=0)),
    ("head wraps", dict(X_OPEN=1, X_TAKE=5, P_HEAD=62), (9, 5, 0, 0), dict(P_HEAD=3)),
    ("budget closes the gate", dict(X_OPEN=1, X_TAKE=5, P_MAX_STEPS=1, P_COUNT=20), (9, 5, 0, 0),
     dict(X_ESTEPS=1, X_OPEN=0, X_TAKE=0)),
]


@pytest.mark.parametrize("case,words,ops,want", COMMIT_CASES, ids=[c[0] for c in COMMIT_CASES])
def test_commit_cases(case, words, ops, want):
    c = _cfg()
    s = _state(c, **words)
    epoch = _commit(c, s, *ops)
    for key, v in want.items():
        assert _word(c, s, key) == v, key
    assert int(epoch) == (2 if words["X_OPEN"] else 1)


def test_commit_coverage_and_discovery_bits():
    c = _cfg()
    s = _state(c, X_OPEN=1, X_TAKE=5)
    _commit(c, s, 9, 5, 0, 2, hs=(0, 3))
    b = c.cov_base
    assert s[b:b + A].tolist() == [1, 2, 3] and s[b + A:b + A + P].tolist() == [0, 3]
    assert int(s[b + A + P]) == 5 and int(s[eo.P_REC]) == 2
    # An overflow step counts neither its actions nor its hits, consumes
    # nothing, and still raises the discovery bits (the JAX body does).
    s = _state(c, X_OPEN=1, X_TAKE=5)
    _commit(c, s, 11, 5, 0, 2, hs=(4, 0))
    assert s[b:b + A + P + 1].tolist() == [0] * (A + P + 1) and int(s[eo.P_REC]) == 1


def _epilogue(c, s, hits=(), ring_depth=None, occ=0):
    """hits: (property, position, depth, fp1, fp2) first hits."""
    hseen = torch.zeros((P, C), dtype=torch.bool)
    f1, f2, fd = (torch.zeros((P, C), dtype=torch.int64) for _ in range(3))
    for i, pos, d, a, b in hits:
        hseen[i, pos] = True
        fd[i, pos], f1[i, pos], f2[i, pos] = d, a, b
    depth = torch.arange(QCAP + 1) if ring_depth is None else ring_depth
    eo.era_epilogue_plain(c, s, hseen, f1, f2, fd, depth, torch.tensor([occ, 0]))
    assert not hseen.any() and not f1.any() and not fd.any()


# (case, state words, expected words) after the epilogue; budget_cap 64.
BUDGET_CASES = [
    ("budget-only exit doubles", dict(X_ESTEPS=10, P_MAX_STEPS=10, P_BUDGET_CAP=64), dict(P_MAX_STEPS=20)),
    ("doubling clamps at the cap", dict(X_ESTEPS=40, P_MAX_STEPS=40, P_BUDGET_CAP=64), dict(P_MAX_STEPS=64)),
    ("ring pressure halves", dict(X_ESTEPS=3, P_MAX_STEPS=256, P_BUDGET_CAP=512, P_COUNT=41),
     dict(P_MAX_STEPS=128)),
    ("pressure floors at BUDGET_MIN", dict(X_ESTEPS=3, P_MAX_STEPS=64, P_BUDGET_CAP=64, P_UNIQUE=1001),
     dict(P_MAX_STEPS=eo.BUDGET_MIN)),
    ("cap 0 passes through", dict(X_ESTEPS=10, P_MAX_STEPS=10, P_BUDGET_CAP=0), dict(P_MAX_STEPS=10)),
    ("frontier exhausted keeps it", dict(X_ESTEPS=4, P_MAX_STEPS=10, P_BUDGET_CAP=64, P_COUNT=0),
     dict(P_MAX_STEPS=10)),
    ("finish keeps it", dict(X_ESTEPS=10, P_MAX_STEPS=10, P_BUDGET_CAP=64, P_REC=1, P_FIN_ANY=1,
                             X_REC0=1), dict(P_MAX_STEPS=10)),
    ("err with zero steps", dict(X_ESTEPS=0, P_ERR=3, P_MAX_STEPS=10, P_BUDGET_CAP=64),
     dict(P_ERR=1, P_MAX_STEPS=10, P_MAXD=0)),
]


@pytest.mark.parametrize("case,words,want", BUDGET_CASES, ids=[c[0] for c in BUDGET_CASES])
def test_budget_cases(case, words, want):
    c = _cfg()
    s = _state(c, **words)
    _epilogue(c, s)
    for key, v in want.items():
        assert _word(c, s, key) == v, key


def test_epilogue_discoveries_and_max_depth():
    c = _cfg()
    s = _state(c, X_ESTEPS=2, P_HEAD=9, P_MAXD=3, P_REC=1, X_REC0=1)
    s[eo.P_LEN] = 77  # property 0 recorded in an earlier era: kept
    # Property 1: the shallowest hit wins, the lowest position among
    # equally shallow ones; property 0's hit only raises its bit.
    _epilogue(c, s, hits=[(1, 6, 4, 11, 12), (1, 2, 5, 21, 22), (1, 5, 4, 31, 32), (0, 1, 1, 9, 9)])
    assert int(s[eo.P_LEN]) == 77 and int(s[eo.P_LEN + P]) == 0
    assert int(s[eo.P_LEN + 1]) == 31 and int(s[eo.P_LEN + P + 1]) == 32
    assert int(s[eo.P_REC]) == 3
    assert int(s[eo.P_MAXD]) == 8  # ring depth lane at head - 1
    s = _state(c, X_ESTEPS=0, P_HEAD=0, P_MAXD=3)
    _epilogue(c, s)
    assert int(s[eo.P_MAXD]) == 3


@pytest.mark.parametrize("occ,k,more", [(0, 0, 1), (21, 0, 0), (0, 3, 0)])
def test_fusion_continuation(occ, k, more):
    """A budget-only exit chains the next inner era while the slab has
    room and fuse_lim allows; the fusion lanes take the era's numbers."""
    c = _cfg(sampled=True, fuse=4)
    s = _state(c, X_ESTEPS=10, P_MAX_STEPS=10, X_EGEN=33, X_UNIQ_IN=90, X_K=k)
    s[c.f_base] = 4
    _epilogue(c, s, occ=occ)
    lanes = c.f_base + 2
    assert int(s[lanes + k]) == 10 and int(s[lanes + 4 + k]) == 33
    assert int(s[lanes + 8 + k]) == 10 and int(s[lanes + 12 + k]) == 5
    assert int(s[c.f_base + 1]) == k + 1 and _word(c, s, "X_MORE") == more


def test_start_zeroes_the_dispatch():
    c = _cfg(sampled=True, fuse=4)
    s = _state(c, P_GEN=5, P_STEPS=6, P_MAXD=7, X_ITER=9, X_K=2)
    s[c.cov_base:c.cov_base + c.n_cov] = 3
    s[c.f_base] = 9
    slab = _slab(15)
    slab.fp1[:] = 4
    eo.era_step_plain(eo.START, c, s, slab=slab)
    assert [_word(c, s, k) for k in ("P_GEN", "P_STEPS", "P_MAXD", "X_ITER", "X_K")] == [0] * 5
    assert not s[c.cov_base:c.cov_base + c.n_cov].any() and int(s[c.f_base]) == 4
    assert not slab.fp1.any() and not slab.counts.any()
