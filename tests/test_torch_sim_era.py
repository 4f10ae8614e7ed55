"""The simulation era program (K13f): the port's `SimProgram` against the
raw JAX era program, word for word, and the plain version of the
walk-era kernel against a table of gate and epilogue cases. Exact
throughout.

(a) The JAX `seed_run` and `loop` (`stateright_tpu/engines/
tpu_simulation.py:536`, `:140`, jitted on the CPU) and the port's
simulation program (`device="cpu"`: every kernel's plain version) run
era after era from the same seed, each era's params drawn with numpy —
recorded bits, step budget, finish masks, generated target, gen0 and
the sample threshold — so that eras end on every exit: the budget, a
finish mask, the target, the slab's high-water mark and (the port's
rule) every walk frozen. After each era the walk lanes, the path rows
below ptr and the whole `params_out` vector are equal.

(c) `walk_era_plain` on hand-made states: each row of the table names
the case and the words it must leave.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stateright_tpu.models as jax_models
import stateright_tpu_torch.models as torch_models
from stateright_tpu.engines import tpu_simulation as ts
from stateright_tpu_torch.engines.gpu_simulation import SimProgram
from stateright_tpu_torch.ops import walk_era as we
from torch_parity import one_torch_thread, reference_uncached  # noqa: F401
from torch_sim_models import ChainFork, JaxChainFork

MAX = 0xFFFFFFFF
K = 64

# name -> (JAX model, port model, walks, walk_cap, eras, the exits the
# run must show)
CASES = {
    "2pc-3": (lambda: jax_models.TwoPhaseTensor(3), lambda: torch_models.TwoPhaseTensor(3), 64, 12, 14,
              {"slab", "target"}),
    "increment-2": (lambda: jax_models.IncrementTensor(2), lambda: torch_models.IncrementTensor(2), 32, 8, 12,
                    {"finish"}),
    "chain-fork": (JaxChainFork, ChainFork, 16, 8, 10, {"frozen"}),
}


def _jax_walk(walk_j):
    return np.stack([np.asarray(x) for x in walk_j]).astype(np.int64)


def _draw(rng, P, plen, s_base, master, gen0):
    """One era's params: the host-owned words at random."""
    p = np.zeros(plen, dtype=np.uint32)
    p[ts.P_REC] = rng.integers(0, 1 << P) if rng.random() < 0.3 else 0
    p[ts.P_MAX_STEPS] = rng.choice([1, 3, 8, 20, 40])
    p[ts.P_FIN_ANY] = rng.choice([0, 0, 1 << int(rng.integers(0, P))])
    p[ts.P_FIN_ALL] = rng.integers(1, 1 << P)
    p[ts.P_FIN_ALL_EN] = rng.integers(0, 2)
    p[ts.P_TARGET_GEN] = 0 if rng.random() < 0.6 else gen0 + int(rng.integers(1, 400))
    p[ts.P_GEN0] = gen0
    p[ts.P_SEED] = master
    p[s_base:s_base + 2] = (MAX, MAX) if rng.random() < 0.5 else (int(rng.integers(0, 1 << 31)), 0)
    return p


def _exits(r, params, prog):
    """The exits an era's result shows."""
    out = set()
    if r.steps_run < r.steps:
        out.add("frozen")
    if r.occupied > prog.s_high:
        out.add("slab")
    target = int(params[ts.P_TARGET_GEN])
    if target and int(params[ts.P_GEN0]) + r.gen >= target:
        out.add("target")
    fin_any, fin_all = int(params[ts.P_FIN_ANY]), int(params[ts.P_FIN_ALL])
    if r.rec_bits & fin_any or (params[ts.P_FIN_ALL_EN] and r.rec_bits & fin_all == fin_all):
        out.add("finish")
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_sim_eras_match_the_jax_era_program(case):
    make_jax, make_port, B, L, eras, exits = CASES[case]
    jtm, tm = make_jax(), make_port()
    jprops, tprops = jtm.tensor_properties(), tm.tensor_properties()
    loop, seed_run, _n_init = ts._build_sim_loop(jtm, jprops, B, L, True, sample_k=K)
    prog = SimProgram(tm, tprops, B, L, True, K, "cpu")
    S, P = tm.state_width, len(tprops)
    c = prog.cfg
    rng = np.random.default_rng(sum(map(ord, case)))
    master = int(rng.integers(0, 1 << 32))
    gen0 = int(rng.integers(0, 1 << 30))
    seen = set()
    walk_t, path = prog.seed(master)
    for era in range(eras):
        params = _draw(rng, P, c.plen, c.s_base, master, gen0)
        if era == 0:
            walk_j, f1, f2, out = seed_run(jnp.asarray(params))  # seeding fused with the era
        else:
            walk_j, f1, f2, out = loop(walk_j, f1, f2, jnp.asarray(params))
        r = prog.era(walk_t, path, rec_bits=int(params[ts.P_REC]), max_steps=int(params[ts.P_MAX_STEPS]),
                     fin_any=int(params[ts.P_FIN_ANY]), fin_all=int(params[ts.P_FIN_ALL]),
                     fin_all_en=int(params[ts.P_FIN_ALL_EN]), target_gen=int(params[ts.P_TARGET_GEN]),
                     gen0=gen0, threshold=tuple(int(t) for t in params[c.s_base:c.s_base + 2]))
        want = np.asarray(out).astype(np.int64)
        assert np.array_equal(r.params, want), (era, np.flatnonzero(r.params != want))
        assert np.array_equal(_jax_walk(walk_j), walk_t.numpy()), f"walk lanes, era {era}"
        ptr = walk_t[S + 1].numpy()
        below = np.arange(L)[None, :] < ptr[:, None]
        pw = path.numpy()
        for lane, half in ((f1, (pw >> 32) & MAX), (f2, pw & MAX)):
            assert np.array_equal(np.asarray(lane).reshape(B, L)[below], half[below]), f"path, era {era}"
        seen |= _exits(r, params, prog)
        gen0 += r.gen
    assert exits <= seen, seen


# -- (c) the plain walk-era kernel on hand-made states ------------------------

S_, A_, P_, B_ = 2, 3, 2, 4


def _prog_cfg(sampled=True):
    return we.WalkEraConfig(S_, A_, P_, B_, True, 64 if sampled else 0, 512)


def _inputs(**words):
    v = [0] * we.IN_LEN
    v[we.P_MAX_STEPS] = 5
    v[we.P_LEN:we.P_LEN + 2] = [MAX, MAX]
    for k, x in words.items():
        v[getattr(we, k)] = x
    return torch.tensor(v, dtype=torch.int64)


# case -> (era inputs, the stats after the step (gen, occ, rec, maxd,
# frozen), the era's steps before the COMMIT, the gate and steps after it)
GATE_CASES = {
    "open": (_inputs(), (4, 0, 0, 2, 0), 0, (1, 1)),
    "budget spent": (_inputs(P_MAX_STEPS=2), (4, 0, 0, 2, 0), 1, (0, 2)),
    "finish any": (_inputs(P_FIN_ANY=2), (4, 0, 2, 2, 0), 0, (0, 1)),
    "finish all": (_inputs(P_FIN_ALL=3, P_FIN_ALL_EN=1), (4, 0, 3, 2, 0), 0, (0, 1)),
    "finish all, one missing": (_inputs(P_FIN_ALL=3, P_FIN_ALL_EN=1), (4, 0, 1, 2, 0), 0, (1, 1)),
    "target reached": (_inputs(P_TARGET_GEN=104, P_GEN0=100), (4, 0, 0, 2, 0), 0, (0, 1)),
    "target one short": (_inputs(P_TARGET_GEN=105, P_GEN0=100), (4, 0, 0, 2, 0), 0, (1, 1)),
    "slab past high water": (_inputs(), (4, 513, 0, 2, 0), 0, (0, 1)),
    "slab at high water": (_inputs(), (4, 512, 0, 2, 0), 0, (1, 1)),
    "every walk frozen": (_inputs(P_MAX_STEPS=9), (4, 0, 1, 2, B_), 2, (0, 9)),
    "every walk frozen, budget spent": (_inputs(P_MAX_STEPS=4), (4, 0, 1, 2, B_), 3, (0, 4)),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_walk_era_gate_case_table(case):
    inputs, stats, steps, (gate, steps_after) = GATE_CASES[case]
    c = _prog_cfg()
    state = torch.zeros(c.length, dtype=torch.int64)
    hseen = torch.ones((P_, B_), dtype=torch.bool)
    plen = torch.ones((P_, B_), dtype=torch.int64)
    we.walk_era_plain(we.BEGIN, c, state, inputs, hseen, plen)
    assert not hseen.any() and not plen.any()
    x = c.x
    assert int(state[x + we.X_OPEN]) == int(inputs[we.P_MAX_STEPS] > 0)
    state[x:x + 5] = torch.tensor(stats)
    state[x + we.X_STEPS] = steps
    state[x + we.X_OPEN] = 1
    we.walk_era_plain(we.COMMIT, c, state)
    assert (int(state[x + we.X_OPEN]), int(state[x + we.X_STEPS])) == (gate, steps_after)
    # A closed gate changes nothing more.
    before = state.clone()
    if not gate:
        we.walk_era_plain(we.COMMIT, c, state)
        assert torch.equal(state, before)


def test_walk_era_begin_takes_the_era_inputs():
    c = _prog_cfg()
    state = torch.full((c.length,), 7, dtype=torch.int64)
    inputs = _inputs(P_REC=2, P_GEN0=40, P_SEED=9)
    inputs[we.P_LEN:we.P_LEN + 2] = torch.tensor([123, 456])
    we.walk_era_plain(we.BEGIN, c, state, inputs, torch.zeros((P_, B_), dtype=torch.bool),
                      torch.zeros((P_, B_), dtype=torch.int64))
    assert state[:we.P_LEN].tolist() == inputs[:we.P_LEN].tolist()
    assert state[c.s_base:c.s_base + 2].tolist() == [123, 456]
    assert not state[c.cov_base:c.cov_base + c.n_cov].any()
    x = c.x
    assert state[x:x + we.X_OPEN].tolist() == [0, 0, 2, 0, 0, 0, 0]


def test_walk_era_epilogue_takes_the_shortest_first_hit():
    """Per property the least plen among the walks that hit it, the first
    walk on ties; walk 0 and its plen when none did."""
    c = _prog_cfg()
    state = torch.zeros(c.length, dtype=torch.int64)
    state[we.P_REC] = 1
    state[we.P_GEN0] = MAX - 1  # the total wraps at 2^32, as the JAX word does
    x = c.x
    state[x:x + 5] = torch.tensor([5, 17, 3, 6, 1])
    state[x + we.X_STEPS] = 4
    hseen = torch.tensor([[False, False, False, False], [False, True, True, True]])
    plen = torch.tensor([[0, 9, 0, 0], [0, 4, 3, 3]])
    we.walk_era_plain(we.EPILOGUE, c, state, hseen=hseen, plen=plen)
    P = P_
    assert state[we.P_LEN:we.P_LEN + 2 * P].tolist() == [0, 2, 0, 3]
    assert int(state[we.P_REC]) == 3  # the input bits and the found ones
    assert int(state[we.P_GEN0]) == int(state[we.P_GEN]) == 3
    assert (int(state[we.P_STEPS]), int(state[we.P_MAXD])) == (4, 6)
    assert state[c.s_base + 2:c.s_base + 4].tolist() == [17, 0]
