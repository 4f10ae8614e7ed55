"""The stage profiler (K12): the port's stage programs against the JAX
stage kernels, and `.stage_profile()` on the port's engines.

(a) Stage parity. The JAX engine runs a model to its end; its final
table and queue (BFS) or path buffers (simulation) go to the JAX stage
kernels (`_build_stage_kernels`, `_build_sim_stage_kernels`, the null
loop of `obs/stageprof.py`) and, converted to the port's layouts, to the
port's stage programs (engines/stages.py, `device="cpu"`: the plain
version of every kernel). Each returns its accumulator after `ITERS`
rounds from the same seed: equal, tolerance 0.

(b) The engines. The single-device tests of tests/test_stage_profile.py
on `spawn_gpu_bfs` and `spawn_gpu_simulation`: the `stage_*` phases sum
to `device_era` within 10% (proportional attribution), profiling is off
by default and changes no result. Then the host copy of
`attribute_stages` and `stage_rows` against the JAX module's on
synthetic timings, and the multiplexed lanes' refusal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stateright_tpu.models as jax_models
import stateright_tpu_torch.models as torch_models
from stateright_tpu.engines import tpu_bfs as jax_bfs
from stateright_tpu.engines import tpu_simulation as jax_sim
from stateright_tpu.obs import stageprof as jax_stageprof
from stateright_tpu.obs.metrics import MetricsRegistry as JaxMetrics
from stateright_tpu.ops import visited_set as jax_vs
from stateright_tpu.tensor import TensorModelAdapter as JaxAdapter
from stateright_tpu_torch import TensorModelAdapter
from stateright_tpu_torch.engines import stages
from stateright_tpu_torch.engines.multiplex import run_multiplexed
from stateright_tpu_torch.obs import stageprof
from stateright_tpu_torch.obs.metrics import MetricsRegistry
from stateright_tpu_torch.ops import frontier as fr
from stateright_tpu_torch.ops import visited_set as vs
from torch_parity import OPTS, one_torch_thread, parity_dict, reference_uncached  # noqa: F401

ITERS = 4
SEED = 1
BFS_STAGES = ("expand", "hash", "probe", "claim", "compact", "ring")
SIM_STAGES = ("hash", "cycle", "record", "expand", "choose")
# case -> (model class, args, symmetry)
BFS_MODELS = {
    "2pc-3": ("TwoPhaseTensor", (3,), False),
    "2pc-5": ("TwoPhaseTensor", (5,), False),
    "2pc-5-symmetry": ("TwoPhaseTensor", (5,), True),
}
# case -> (model class, args, walks, walk_cap)
SIM_MODELS = {
    "increment-2": ("IncrementTensor", (2,), 64, 16),
    "2pc-3": ("TwoPhaseTensor", (3,), 64, 16),
}
CASES = (
    [("bfs", m, s) for m in ("2pc-3", "2pc-5") for s in BFS_STAGES]
    + [("bfs", "2pc-5-symmetry", "canon")]
    + [("sim", m, s) for m in SIM_MODELS for s in SIM_STAGES]
    + [("bfs", "2pc-3", stages.NULL)]
)

# The JAX run's final state and its checker, and the JAX stage kernels'
# accumulators on that state, once per model.
_RUNS = {}
_ACCS = {}


def _jax_run(kind, case, monkeypatch):
    if (kind, case) in _RUNS:
        return _RUNS[kind, case]
    seen = {}
    engine = jax_bfs.TpuBfsChecker if kind == "bfs" else jax_sim.TpuSimulationChecker
    monkeypatch.setattr(engine, "_profile_stages", lambda self, *state: seen.setdefault("state", state))
    if kind == "bfs":
        name, args, sym = BFS_MODELS[case]
        b = JaxAdapter(getattr(jax_models, name)(*args)).checker()
        c = (b.symmetry() if sym else b).spawn_tpu_bfs(**OPTS).join()
    else:
        name, args, walks, cap = SIM_MODELS[case]
        b = JaxAdapter(getattr(jax_models, name)(*args)).checker().target_state_count(2000)
        c = b.spawn_tpu_simulation(7, walks=walks, walk_cap=cap).join()
    _RUNS[kind, case] = (c, seen["state"])
    return _RUNS[kind, case]


def _jax_accs(kind, case, c, state):
    """Every JAX stage kernel of the model on the run's state, from SEED:
    {stage: acc}. The kernels run inside one jitted call, so the reference
    compiles once per model, not once per stage."""
    if (kind, case) not in _ACCS:
        if kind == "bfs":
            kernels = jax_bfs._build_stage_kernels(c.tm, c._tprops, c._chunk, c._qcap, c._canon, ITERS)
        else:
            kernels = jax_sim._build_sim_stage_kernels(c.tm, c._tprops, c._B, c._L, ITERS)
        names = sorted(kernels)
        every = jax.jit(lambda *args: [kernels[n](*args) for n in names])
        accs = every(*state, jnp.asarray(SEED, dtype=jnp.uint32))
        _ACCS[kind, case] = {n: int(np.asarray(a)) for n, a in zip(names, accs)}
    return _ACCS[kind, case]


def _port_bfs(c, table, queue, name, args):
    tm = getattr(torch_models, name)(*args)
    progs = stages.BfsStages(tm, tm.tensor_properties(), c._chunk, c._qcap, c._canon, ITERS, "cpu")
    ring = fr.empty_ring(len(queue), c._qcap, "cpu")
    lanes = np.stack([np.asarray(lane, dtype=np.uint32) for lane in queue]).astype(np.int64)
    ring[:, :c._qcap] = torch.from_numpy(lanes)
    progs.load(vs.table_from_lanes(*jax_vs.unpack_lanes_np(table), device="cpu"), ring)
    return progs


def _port_sim(c, fp1, fp2, name, args):
    tm = getattr(torch_models, name)(*args)
    hi = np.asarray(fp1, dtype=np.uint32).astype(np.uint64) << np.uint64(32)
    packed = (hi | np.asarray(fp2, dtype=np.uint32).astype(np.uint64)).view(np.int64)
    progs = stages.SimStages(tm, tm.tensor_properties(), c._B, c._L, ITERS, "cpu")
    progs.load(torch.from_numpy(packed.reshape(c._B, c._L).copy()))
    return progs


@pytest.mark.parametrize("kind,case,stage", CASES, ids=["-".join(c) for c in CASES])
def test_stage_acc_matches_the_jax_kernel(kind, case, stage, monkeypatch):
    c, state = _jax_run(kind, case, monkeypatch)
    if stage == stages.NULL:
        want = jax_stageprof.build_null_kernel(ITERS)(jnp.asarray(SEED, dtype=jnp.uint32))
    else:
        want = _jax_accs(kind, case, c, state)[stage]
    if kind == "bfs":
        name, args, _sym = BFS_MODELS[case]
        progs = _port_bfs(c, *state, name, args)
    else:
        name, args, _b, _l = SIM_MODELS[case]
        progs = _port_sim(c, *state, name, args)
    stage_progs, null = progs.programs()
    prog = null if stage == stages.NULL else stage_progs[stage]
    assert set(stage_progs) == set(BFS_STAGES if kind == "bfs" else SIM_STAGES) | (
        {"canon"} if kind == "bfs" and c._canon else set())
    assert prog.run(SEED) == int(np.asarray(want))
    # A second dispatch starts from the same forks: the same value.
    assert prog.run(SEED) == int(np.asarray(want))


# -- (b) the engines ----------------------------------------------------------

def _stage_phases(telemetry):
    return {k: v for k, v in telemetry.get("phase_ms", {}).items() if k.startswith("stage_")}


BFS_RUN = dict(chunk_size=64, queue_capacity=1 << 10, table_capacity=1 << 10, device="cpu")


def test_gpu_bfs_stage_breakdown_reconciles():
    c = TensorModelAdapter(torch_models.TwoPhaseTensor(3)).checker().coverage().stage_profile(iters=4)
    c = c.spawn_gpu_bfs(**BFS_RUN).join()
    plain = TensorModelAdapter(torch_models.TwoPhaseTensor(3)).checker().coverage()
    plain = plain.spawn_gpu_bfs(**BFS_RUN).join()
    assert c.unique_state_count() == 288  # profiling must not perturb counts
    assert parity_dict(c) == parity_dict(plain)
    tel = c.telemetry()
    assert "stage_profile_error" not in tel, tel.get("stage_profile_error")
    phases = _stage_phases(tel)
    for name in BFS_STAGES:
        assert f"stage_{name}" in phases, (name, sorted(phases))
    era = tel["phase_ms"]["device_era"]
    total = sum(phases.values())
    assert era > 0
    assert abs(total - era) <= 0.1 * era, (total, era)
    assert set(tel["stage_us_per_step"]) == {k[len("stage_"):] for k in phases}
    assert tel["stage_profile_iters"] == 4
    assert tel["stage_profile_model_pct"] > 0
    assert tel["phase_ms"]["profiler_overhead"] > 0
    rows = stageprof.stage_rows(tel["phase_ms"])
    assert [n for n, _ in rows if n in stageprof.STAGE_ORDER] == [n for n, _ in rows]
    assert len(rows) == len(phases)


def test_gpu_stage_profile_off_by_default():
    c = TensorModelAdapter(torch_models.TwoPhaseTensor(3)).checker().spawn_gpu_bfs(**BFS_RUN).join()
    tel = c.telemetry()
    assert not _stage_phases(tel)
    assert "stage_us_per_step" not in tel
    assert tel["phase_ms"]["device_era"] > 0


def _sim_result(c):
    return (c.state_count(), c.max_depth(), dict(c._discovery_paths), c.coverage(),
            tuple(c._sampler.fingerprints()), c.telemetry()["steps"])


def test_gpu_simulation_stage_breakdown():
    def run(profile):
        b = TensorModelAdapter(torch_models.IncrementTensor(2)).checker().target_state_count(2000)
        if profile:
            b = b.stage_profile(iters=4)
        return b.spawn_gpu_simulation(7, walks=64, walk_cap=16, device="cpu").join()

    c, plain = run(True), run(False)
    assert _sim_result(c) == _sim_result(plain)
    tel = c.telemetry()
    assert "stage_profile_error" not in tel, tel.get("stage_profile_error")
    phases = _stage_phases(tel)
    # The simulation engine's walk pipeline, not the BFS one.
    for name in SIM_STAGES:
        assert f"stage_{name}" in phases, (name, sorted(phases))
    era = tel["phase_ms"]["device_era"]
    total = sum(phases.values())
    assert era > 0 and abs(total - era) <= 0.1 * era, (total, era)
    assert tel["stage_profile_iters"] == 4 and tel["stage_profile_model_pct"] > 0


def test_attribution_matches_the_jax_module():
    per_step = {"expand": 3e-5, "hash": 1e-5, "probe": 2.5e-5, "claim": 0.0, "ring": 7e-6,
                "zeta": 1e-6}
    ours, ref = MetricsRegistry(), JaxMetrics()
    got = stageprof.attribute_stages(ours, per_step, 0.75, 1200, 8)
    want = jax_stageprof.attribute_stages(ref, per_step, 0.75, 1200, 8)
    assert got == want
    assert ours.phase_ms() == ref.phase_ms()
    for gauge in ("stage_profile_iters", "stage_us_per_step", "stage_profile_model_pct"):
        assert ours.gauges()[gauge] == ref.snapshot()[gauge]
    assert stageprof.stage_rows(ours.phase_ms()) == jax_stageprof.stage_rows(ref.phase_ms())
    assert stageprof.STAGE_ORDER == jax_stageprof.STAGE_ORDER
    # No era time: no phases, the gauges still set.
    empty = MetricsRegistry()
    assert stageprof.attribute_stages(empty, per_step, 0.0, 0, 8) == {}
    assert empty.phase_ms() == {} and "stage_profile_model_pct" not in empty.gauges()


def test_lanes_refuse_stage_profiling():
    b = TensorModelAdapter(torch_models.TwoPhaseTensor(3)).checker().stage_profile()
    with pytest.raises(ValueError, match="multiplexed lanes do not support stage profiling; run solo"):
        run_multiplexed([b], lanes=4, chunk=16, device="cpu")


# -- the sharded engine's stage programs (K12's mesh part) ---------------------------

MESH_STAGES = ("expand", "hash", "compact", "claim", "exchange", "probe", "ring")
# case -> (model class, args, shards)
MESH_MODELS = {"2pc-3 n8": ("TwoPhaseTensor", (3,), 8), "2pc-5 n2": ("TwoPhaseTensor", (5,), 2)}
MESH_OPTS = dict(chunk_size=64, sync_steps=4)
_MESH = {}


def _jax_mesh_accs(case, monkeypatch):
    """The JAX sharded run's final tables and queues, and every JAX mesh
    stage kernel's accumulator on them from the seeds 1..N. The stage
    kernels' fori_loop carry is bool[512] going in and bool[512]{V:shards}
    coming out, which jax 0.9's varying-axes check rejects; here, and only
    here, shard_map runs with check_vma=False (mesh.py reads
    `compat.get_shard_map` at call time)."""
    if case in _MESH:
        return _MESH[case]
    import functools

    from jax.sharding import Mesh

    from stateright_tpu import compat
    from stateright_tpu.parallel import mesh as jax_mesh

    name, args, n = MESH_MODELS[case]
    seen = {}
    monkeypatch.setattr(jax_mesh.ShardedBfsChecker, "_profile_stages",
                        lambda self, table, queue: seen.setdefault("state", (table, queue)))
    c = JaxAdapter(getattr(jax_models, name)(*args)).checker().spawn_sharded_bfs(
        devices=jax.devices()[:n], **MESH_OPTS).join()
    monkeypatch.setattr(compat, "get_shard_map", lambda: functools.partial(jax.shard_map, check_vma=False))
    table, queue = seen["state"]
    kernels = jax_mesh._build_mesh_stage_kernels(
        c.tm, c._tprops, c._chunk, c._qcap, n, c._quota, Mesh(np.array(jax.devices()[:n]), ("shards",)),
        "shards", ITERS)
    seeds = jnp.arange(1, n + 1, dtype=jnp.uint32)
    accs = {k: np.asarray(fn(table, queue, seeds)) for k, fn in kernels.items()}
    for k, a in accs.items():
        assert (a == a[0]).all(), k  # the psum: one value on every shard
    _MESH[case] = (c, jax.tree.map(np.asarray, (table, queue)), {k: int(a[0]) for k, a in accs.items()})
    return _MESH[case]


def _port_mesh(c, table, queue, name, args, n):
    tm = getattr(torch_models, name)(*args)
    progs = stages.MeshStages(tm, tm.tensor_properties(), c._chunk, c._qcap, n, c._quota, ITERS, "cpu")
    keys, v1, v2 = table
    tcap = keys.shape[1] // 2
    lanes = [vs.table_from_lanes(keys[s, :tcap], keys[s, tcap:], v1[s], v2[s], "cpu") for s in range(n)]
    t = vs.VisitedTable(*(torch.stack([getattr(x, f) for x in lanes]) for f in ("keys", "parents", "stamps")))
    rings = fr.empty_ring(len(queue), c._qcap, "cpu", lanes=n)
    rings[:, :, :c._qcap] = torch.from_numpy(np.stack(queue, 1).astype(np.int64))
    progs.load(t, rings)
    return progs


@pytest.mark.parametrize("case,stage", [(m, s) for m in MESH_MODELS for s in MESH_STAGES],
                         ids=[f"{m}-{s}" for m in MESH_MODELS for s in MESH_STAGES])
def test_mesh_stage_acc_matches_the_jax_kernel(case, stage, monkeypatch):
    c, (table, queue), want = _jax_mesh_accs(case, monkeypatch)
    name, args, n = MESH_MODELS[case]
    progs = _port_mesh(c, table, queue, name, args, n)
    stage_progs, _null = progs.programs()
    assert set(stage_progs) == set(MESH_STAGES)
    with progs.lock:
        assert stage_progs[stage].run(SEED) == want[stage]
        progs.release()


def test_sharded_stage_breakdown_includes_exchange():
    """The port's counterpart of tests/test_stage_profile.py's sharded
    test: the breakdown has every mesh stage, `stage_exchange` among
    them, sums to device_era, and profiling changes no result."""
    opts = dict(devices=["cpu"] * 4, chunk_size=64, sync_steps=8)
    b = TensorModelAdapter(torch_models.TwoPhaseTensor(3)).checker().coverage()
    plain = b.spawn_sharded_bfs(**opts).join()
    c = TensorModelAdapter(torch_models.TwoPhaseTensor(3)).checker().coverage().stage_profile(
        iters=2).spawn_sharded_bfs(**opts).join()
    tel = c.telemetry()
    assert "stage_profile_error" not in tel, tel.get("stage_profile_error")
    phases = tel["phase_ms"]
    assert {f"stage_{s}" for s in MESH_STAGES} <= set(phases)
    total = sum(v for k, v in phases.items() if k.startswith("stage_"))
    assert abs(total - phases["device_era"]) <= 0.1 * phases["device_era"]
    assert parity_dict(c) == parity_dict(plain)
