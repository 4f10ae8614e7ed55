"""The port's BFS host loop against the JAX engine's, end to end: the era
pipeline (`.pipeline(depth, fuse)`, the serial dispatch loop), run timeouts
and the seeding error. Each reference is a fresh `spawn_tpu_bfs` run with
the same options; equal means the parity dict (`torch_parity.py`: counts,
discovery fingerprints, coverage, the bottom-k sample), every discovery
path, and the eras and steps the run took. The dispatch counts are the
port's own: the JAX engine shrinks its fusion factor from the wall-clock
share of its host gaps (auto-N), the port does not."""

import numpy as np
import pytest

import stateright_tpu.tensor as jt
import stateright_tpu_torch.tensor as tt
from stateright_tpu_torch import TensorModelAdapter
from stateright_tpu_torch.fingerprint import hash_words_np
from stateright_tpu_torch.models import TwoPhaseTensor
from torch_parity import (  # noqa: F401
    OPTS, PAXOS_OPTS, one_torch_thread, parity_dict, paths, reference_uncached, run_pair,
)

# tests/test_pipeline.py:161 MEGA_SWEEP, and the serial dispatch loop (None).
SWEEP = [None, (1, 1), (2, 1), (4, 1), (4, 4)]


def _pipe(pipe):
    if pipe is None:
        return lambda b: b.pipeline(False)
    return lambda b: b.pipeline(depth=pipe[0], fuse=pipe[1])


def _assert_equal_runs(ref, ours):
    assert parity_dict(ours) == parity_dict(ref)
    assert paths(ours) == paths(ref)
    tr, to = ref.telemetry(), ours.telemetry()
    assert (to["eras"], to["steps"]) == (tr["eras"], tr["steps"])


def _assert_telemetry(tel, pipe, fused=True):
    if pipe is None:
        assert tel.get("spec_dispatch", 0) == 0 and tel["spec_chain_depth"] == 0
        return
    depth, fuse = pipe
    assert tel["spec_dispatch"] >= 1
    assert 1 <= tel["spec_chain_depth"] <= depth
    if fuse > 1 and fused:
        assert tel["dispatches"] < tel["eras"]
        assert tel["fused_eras_per_dispatch"] > 1.0


@pytest.mark.parametrize("pipe", SWEEP, ids=lambda p: "serial" if p is None else f"d{p[0]}-f{p[1]}")
def test_pipeline_sweep_2pc5_matches_jax(pipe):
    ref, ours = run_pair("TwoPhaseTensor", (5,), OPTS, _pipe(pipe))
    _assert_equal_runs(ref, ours)
    assert ours.unique_state_count() == 8832
    _assert_telemetry(ours.telemetry(), pipe)


def test_pipeline_paxos2_matches_jax():
    ref, ours = run_pair("PaxosTensor", (2,), PAXOS_OPTS, _pipe((4, 4)))
    _assert_equal_runs(ref, ours)
    assert ours.unique_state_count() == 16_668
    # 73 steps in budgets of 64 leave too few eras to fuse (as in
    # tests/test_pipeline.py:238, which holds parity only).
    _assert_telemetry(ours.telemetry(), (4, 4), fused=False)


def test_pipeline_options_are_checked():
    b = TensorModelAdapter(TwoPhaseTensor(3)).checker()
    for bad in (dict(depth=0), dict(fuse=0)):
        with pytest.raises(ValueError):
            b.pipeline(**bad)
    assert (b.pipeline_, b.pipeline_depth_, b.fuse_eras_) == (True, None, None)


def test_generous_timeout_gives_the_untimed_result():
    """Under a timeout the eras follow the adaptive budget (64 steps,
    doubling while an era takes under an eighth of the timeout), on both
    engines alike; the counts are the untimed run's."""
    ref, ours = run_pair("TwoPhaseTensor", (5,), OPTS, lambda b: b.timeout(1000.0))
    _assert_equal_runs(ref, ours)
    untimed = TensorModelAdapter(TwoPhaseTensor(5)).checker().spawn_gpu_bfs(device="cpu", **OPTS).join()
    assert (ours.unique_state_count(), ours.state_count()) == (
        untimed.unique_state_count(), untimed.state_count())


def test_short_timeout_stops_at_an_era_boundary():
    c = (TensorModelAdapter(TwoPhaseTensor(7)).checker().coverage().timeout(0.5)
         .spawn_gpu_bfs(device="cpu", chunk_size=64, queue_capacity=1 << 16,
                        table_capacity=1 << 16).join())
    assert c.is_done() and 1 <= c.unique_state_count() < 296_448
    # At an era boundary the depth histogram holds every unique state.
    assert sum(c.coverage()["depths"].values()) == c.unique_state_count()
    assert c.telemetry()["eras"] >= 1


# -- the seeding error ---------------------------------------------------------

def _colliding_inits(cap=1 << 10, probes=24):
    """One lane value x, and `probes` values whose first probe slots are
    x's probe sequence in a `cap`-slot table: x, inserted first and losing
    its first slot, finds all its probe positions taken."""
    vals = np.arange(1, 1 << 17, dtype=np.uint32)
    h1, h2 = hash_words_np(vals[:, None])
    x = 0
    seq = [(int(h1[x]) + k * (int(h2[x]) | 1)) & (cap - 1) for k in range(probes)]
    first = {}
    for i in range(1, len(vals)):
        first.setdefault(int(h1[i]) & (cap - 1), i)
    return [int(vals[x])] + [int(vals[first[s]]) for s in seq]


class _Colliding:
    state_width = 1
    max_actions = 1
    INITS = _colliding_inits()

    def init_states_array(self):
        return np.asarray(self.INITS, dtype=np.uint32)[:, None]

    def step_lanes(self, xp, lanes):
        (v,) = lanes
        return [(v,)], [v != v]

    def tensor_properties(self):
        return [self.TP.always("small", lambda xp, lanes: lanes[0] < xp.uint32(1 << 30))]


class JaxColliding(_Colliding, jt.TensorModel):
    TP = jt.TensorProperty


class Colliding(_Colliding, tt.TensorModel):
    TP = tt.TensorProperty


def test_seeding_error_is_the_jax_message():
    opts = dict(chunk_size=64, queue_capacity=1 << 10, table_capacity=1 << 10)
    with pytest.raises(RuntimeError) as ref:
        jt.TensorModelAdapter(JaxColliding()).checker().spawn_tpu_bfs(**opts).join()
    with pytest.raises(RuntimeError) as ours:
        TensorModelAdapter(Colliding()).checker().spawn_gpu_bfs(device="cpu", **opts).join()
    assert str(ours.value) == str(ref.value)
    assert "init-state seeding" in str(ours.value)
