"""Checkpoints, resume and the degraded regrow (slice 7) against fresh JAX
runs under `JAX_PLATFORMS=cpu`, at the sizes of tests/test_outofcore.py
and tests/test_durability_chaos.py.

With `checkpoint_every=1e-4` both engines save at every era boundary,
chain nothing and keep the adaptive budget at its floor (every era
overshoots the poll target), so their era schedules, and with them the
checkpoint files, are deterministic and can be held array for array.
The reference's checkpoints do not carry coverage, so a resumed run's
coverage counts the resumed part only, in both packages: a resumed run
is held against the JAX engine resumed from the same file (the whole
parity dict) and against an unbroken run on what a checkpoint carries.
"""

import json
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest

import stateright_tpu.models as jax_models
import stateright_tpu_torch.models as torch_models
from stateright_tpu.engines import common as jax_common
from stateright_tpu.tensor import TensorModelAdapter as JaxAdapter
from stateright_tpu_torch import TensorModelAdapter
from stateright_tpu_torch.engines import common
from stateright_tpu_torch.engines import multiplex as mx
from stateright_tpu_torch.engines.gpu_bfs import GpuBfsChecker
from stateright_tpu_torch.parallel.mesh import ShardedGpuBfsChecker
from torch_parity import _JAX_MODELS, one_torch_thread, parity_dict, reference_uncached  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
SPILL_OPTS = dict(chunk_size=32, queue_capacity=1 << 10, table_capacity=1 << 11)
OPTS = dict(chunk_size=64, queue_capacity=1 << 12, table_capacity=1 << 11)
EVERY = dict(checkpoint_every=1e-4)
GOLDEN5 = 8_832
# What a checkpoint carries: an unbroken run and a resumed one agree here.
CARRIED = ("unique", "states", "max_depth", "sample")


def _jax2pc5():
    return _JAX_MODELS.setdefault(("TwoPhaseTensor", (5,)), jax_models.TwoPhaseTensor(5))


def _jax(configure=lambda b: b):
    return configure(JaxAdapter(_jax2pc5()).checker().coverage())


def _port(configure=lambda b: b):
    return configure(TensorModelAdapter(torch_models.TwoPhaseTensor(5)).checker().coverage())


def _carried(d):
    return {k: d.get(k) for k in CARRIED}


@pytest.fixture
def jax_reads_port_files(monkeypatch):
    """Let the JAX engine resume a file the port wrote: the two packages
    name one model differently (`stateright_tpu_torch.` against
    `stateright_tpu.`), which only the port's check accepts."""
    orig = jax_common.validate_checkpoint_meta

    def validate(meta, tm, tprops, exact):
        meta = dict(meta, model=meta["model"].replace("stateright_tpu_torch.", "stateright_tpu.", 1))
        return orig(meta, tm, tprops, exact)

    monkeypatch.setattr(jax_common, "validate_checkpoint_meta", validate)


def _same_file(a_path, b_path):
    """Two checkpoint files hold the same arrays (name, dtype, shape,
    bytes) and the same meta but for the model's package."""
    a, ma = common.load_checkpoint_verified(a_path)
    b, mb = common.load_checkpoint_verified(b_path)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k
    assert ma["model"].split(".", 1)[1] == mb["model"].split(".", 1)[1]
    assert {k: v for k, v in ma.items() if k != "model"} == {k: v for k, v in mb.items() if k != "model"}
    return a, ma


# -- the checkpoint IO, held against the reference's ------------------------------

def test_checkpoint_io_reads_and_writes_the_reference_format(tmp_path):
    """A base and a delta written by either package fold the same on the
    other; the digests agree."""
    rng = np.random.default_rng(5)
    t = [rng.integers(0, 1 << 32, 256, dtype=np.uint64).astype(np.uint32) for _ in range(4)]
    for lane in t:
        lane[::3] = 0
    meta = {"fp_ver": 2, "head": 3}
    arrays = {f"table{i}": t[i] for i in range(4)}
    arrays["queue0"] = np.arange(8, dtype=np.uint32)
    t2 = [lane.copy() for lane in t]
    t2[0][0], t2[1][0], t2[2][0], t2[3][0] = 7, 9, 11, 13
    arrays2 = dict(arrays, **{f"table{i}": t2[i] for i in range(4)}, queue0=np.arange(8, dtype=np.uint32) + 1)
    for save_mod, load_mod in ((common, jax_common), (jax_common, common)):
        path = str(tmp_path / f"{save_mod.__name__}.npz")
        st = save_mod.save_checkpoint_tiered(path, meta, arrays, state=None, tcap=256)
        st = save_mod.save_checkpoint_tiered(path, meta, arrays2, state=st, tcap=256)
        assert os.path.exists(path + ".d1")
        data, got_meta = load_mod.load_checkpoint_folded(path)
        for k, v in arrays2.items():
            assert np.array_equal(data[k], v), k
        assert got_meta["delta"]["seq"] == 1
        assert common._checkpoint_digest(arrays) == jax_common._checkpoint_digest(arrays)


# -- solo ----------------------------------------------------------------------

def test_final_checkpoint_equals_the_jax_file(tmp_path):
    """A target-capped `.pipeline(False)` run through a spilling ring: the
    port's final checkpoint holds JAX's arrays, spill blocks included."""
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")

    def configure(b):
        return b.target_state_count(3000).pipeline(False)

    ref = _jax(configure).spawn_tpu_bfs(checkpoint_path=pj, **SPILL_OPTS).join()
    ours = _port(configure).spawn_gpu_bfs(device="cpu", checkpoint_path=pt, **SPILL_OPTS).join()
    assert parity_dict(ours) == parity_dict(ref)
    data, meta = _same_file(pj, pt)
    assert any(k.startswith("spill") for k in data) and meta["count"] > 0


def test_kill_and_resume_mid_spill_with_deltas(tmp_path, monkeypatch, jax_reads_port_files):
    """Kill at a target with a delta chain written at every era (and the
    disk tier under a small budget), resume: the port's file equals
    JAX's, the port resumes it to the golden, equal to JAX resuming the
    same file and, on what a checkpoint carries, to an unbroken run."""
    monkeypatch.setenv("STPU_SPILL_HOST_BUDGET_BYTES", str(1 << 13))
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")

    def configure(b):
        return b.target_state_count(4000)

    ref = _jax(configure).spawn_tpu_bfs(checkpoint_path=pj, **EVERY, **SPILL_OPTS).join()
    part = _port(configure).spawn_gpu_bfs(device="cpu", checkpoint_path=pt, **EVERY, **SPILL_OPTS).join()
    assert parity_dict(part) == parity_dict(ref)
    tel, jtel = part.telemetry(), ref.telemetry()
    for key in ("checkpoint_saves", "checkpoint_delta_saves", "spill_rows", "spill_tier_rows"):
        assert tel.get(key) == jtel.get(key), key
    assert tel["checkpoint_delta_saves"] >= 1 and tel["spill_rows"] > 0
    assert common.delta_chain_paths(pt) == [pt + f".d{i}" for i in range(1, len(common.delta_chain_paths(pj)) + 1)]
    for a, b in zip(common.delta_chain_paths(pj) + [pj], common.delta_chain_paths(pt) + [pt]):
        _same_file(a, b)
    resumed = _port().spawn_gpu_bfs(device="cpu", resume_from=pt, **SPILL_OPTS).join()
    jres = _jax().spawn_tpu_bfs(resume_from=pt, **SPILL_OPTS).join()
    unbroken = _port().spawn_gpu_bfs(device="cpu", **SPILL_OPTS).join()
    assert resumed.unique_state_count() == GOLDEN5
    assert parity_dict(resumed) == parity_dict(jres)
    assert _carried(parity_dict(resumed)) == _carried(parity_dict(unbroken))
    assert resumed.telemetry().get("checkpoint_delta_folds") == jres.telemetry().get("checkpoint_delta_folds")


def test_jax_written_checkpoint_resumes_on_the_port(tmp_path):
    path = str(tmp_path / "j.npz")
    _jax(lambda b: b.target_state_count(2500)).spawn_tpu_bfs(checkpoint_path=path, **OPTS).join()
    ours = _port().spawn_gpu_bfs(device="cpu", resume_from=path, **OPTS).join()
    ref = _jax().spawn_tpu_bfs(resume_from=path, **OPTS).join()
    assert ours.unique_state_count() == GOLDEN5
    assert parity_dict(ours) == parity_dict(ref)
    unbroken = _port().spawn_gpu_bfs(device="cpu", **OPTS).join()
    assert _carried(parity_dict(ours)) == _carried(parity_dict(unbroken))


def test_corrupt_newest_generation_falls_back(tmp_path):
    path = str(tmp_path / "g.npz")
    _port(lambda b: b.target_state_count(5000)).spawn_gpu_bfs(
        device="cpu", checkpoint_path=path, keep_checkpoints=3, **EVERY, **OPTS).join()
    assert common.checkpoint_generations(path) == [path, path + ".1", path + ".2"]
    # The newest base and any deltas pinned to it are gone with it.
    for p in common.delta_chain_paths(path):
        os.unlink(p)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    resumed = _port().spawn_gpu_bfs(device="cpu", resume_from=path, **OPTS).join()
    assert resumed.unique_state_count() == GOLDEN5
    tel = resumed.telemetry()
    assert tel["checkpoint_fallbacks"] == 1 and tel["checkpoint_corrupt_rejected"] == 1


def test_corrupt_only_generation_is_refused(tmp_path):
    path = str(tmp_path / "o.npz")
    _port(lambda b: b.target_state_count(3000)).spawn_gpu_bfs(
        device="cpu", checkpoint_path=path, keep_checkpoints=1, **OPTS).join()
    assert common.checkpoint_generations(path) == [path]
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises(common.CheckpointCorruptError, match="no loadable checkpoint generation"):
        _port().spawn_gpu_bfs(device="cpu", resume_from=path, **OPTS).join()


def test_wrong_model_is_refused(tmp_path):
    path = str(tmp_path / "m.npz")
    _port(lambda b: b.target_state_count(1000)).spawn_gpu_bfs(device="cpu", checkpoint_path=path, **OPTS).join()
    other = TensorModelAdapter(torch_models.TwoPhaseTensor(4)).checker()
    with pytest.raises(ValueError, match="model config"):
        other.spawn_gpu_bfs(device="cpu", resume_from=path, **OPTS).join()
    inc = TensorModelAdapter(torch_models.IncrementTensor(2)).checker()
    with pytest.raises(ValueError, match="written by model"):
        inc.spawn_gpu_bfs(device="cpu", resume_from=path, **OPTS).join()


def _chaos(monkeypatch, cls, era=1):
    """Arm the engine's probe-error hook before its run thread starts."""
    orig = cls._start

    def start(self):
        self._chaos_probe_error_era = era
        orig(self)

    monkeypatch.setattr(cls, "_start", start)


def test_degraded_regrow_matches_jax(tmp_path, monkeypatch):
    from stateright_tpu.engines.tpu_bfs import TpuBfsChecker

    _chaos(monkeypatch, TpuBfsChecker)
    _chaos(monkeypatch, GpuBfsChecker)
    ref = _jax().spawn_tpu_bfs(checkpoint_path=str(tmp_path / "j.npz"), **EVERY, **OPTS).join()
    ours = _port().spawn_gpu_bfs(device="cpu", checkpoint_path=str(tmp_path / "t.npz"), **EVERY, **OPTS).join()
    assert ours.unique_state_count() == GOLDEN5
    assert parity_dict(ours) == parity_dict(ref)
    tel, jtel = ours.telemetry(), ref.telemetry()
    assert tel["degraded_regrow"] == jtel["degraded_regrow"] == 1
    assert tel["table_growths"] == jtel["table_growths"]
    assert tel["table_capacity"] == jtel["table_capacity"]


def test_probe_error_without_checkpoint_aborts(monkeypatch):
    _chaos(monkeypatch, GpuBfsChecker)
    with pytest.raises(RuntimeError, match="probe budget"):
        _port().spawn_gpu_bfs(device="cpu", **OPTS).join()


def test_request_checkpoint_stop_flushes_and_resumes(tmp_path, monkeypatch):
    orig = GpuBfsChecker._start

    def start(self):
        self.request_checkpoint_stop()
        orig(self)

    monkeypatch.setattr(GpuBfsChecker, "_start", start)
    path = str(tmp_path / "s.npz")
    part = _port().spawn_gpu_bfs(device="cpu", checkpoint_path=path, **OPTS).join()
    monkeypatch.undo()
    assert part.interrupted() and part.telemetry()["interrupted"] == 1
    assert part.unique_state_count() < GOLDEN5 and os.path.exists(path)
    resumed = _port().spawn_gpu_bfs(device="cpu", resume_from=path, **OPTS).join()
    assert resumed.unique_state_count() == GOLDEN5 and not resumed.interrupted()


_SIGTERM_CHILD = """
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from stateright_tpu_torch import TensorModelAdapter
from stateright_tpu_torch.models import TwoPhaseTensor
c = TensorModelAdapter(TwoPhaseTensor(6)).checker().spawn_gpu_bfs(
    device="cpu", checkpoint_path={path!r}, chunk_size=16, queue_capacity=1 << 14,
    table_capacity=1 << 17)
print("spawned", flush=True)
c.join()
print(json.dumps(dict(interrupted=c.interrupted(), unique=c.unique_state_count())), flush=True)
"""


def test_sigterm_flushes_a_final_checkpoint(tmp_path):
    path = str(tmp_path / "sig.npz")
    code = _SIGTERM_CHILD.format(root=os.path.dirname(HERE), path=path)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    p = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=env)
    try:
        assert p.stdout.readline().strip() == "spawned"
        p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == 0, err[-2000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["interrupted"] and res["unique"] < 50_816
    meta = common.load_checkpoint_folded(path)[1]
    assert meta["unique"] == res["unique"]
    resumed = TensorModelAdapter(torch_models.TwoPhaseTensor(6)).checker().spawn_gpu_bfs(
        device="cpu", resume_from=path, chunk_size=256, queue_capacity=1 << 14, table_capacity=1 << 17).join()
    assert resumed.unique_state_count() == 50_816


@pytest.mark.parametrize(
    "kw,spawn",
    [(dict(checkpoint_every=1.0), "solo"), (dict(checkpoint_every=0.0, checkpoint_path="p"), "solo"),
     (dict(keep_checkpoints=0), "solo"), (dict(checkpoint_every=1.0), "mesh"),
     (dict(checkpoint_every=-2.0, checkpoint_path="p"), "mesh"), (dict(keep_checkpoints=0), "mesh")],
)
def test_checkpoint_cadence_is_validated(kw, spawn):
    """The port's refusals are the JAX engine's, word for word."""
    def run(b, spawn_fn, **extra):
        with pytest.raises(ValueError) as e:
            getattr(b, spawn_fn)(**extra, **kw)
        return str(e.value)

    if spawn == "solo":
        want = run(_jax(), "spawn_tpu_bfs", **OPTS)
        got = run(_port(), "spawn_gpu_bfs", device="cpu", **OPTS)
    else:
        want = run(_jax(), "spawn_sharded_bfs", devices=jax.devices()[:2], chunk_size=64)
        got = run(_port(), "spawn_sharded_bfs", devices=2, device="cpu", chunk_size=64)
    assert got == want


# -- the sharded engine ------------------------------------------------------------

MESH = [
    (2, dict(chunk_size=32, queue_capacity_per_shard=1 << 9), 6000),  # stops mid-spill
    (8, dict(chunk_size=64, queue_capacity_per_shard=1 << 11), 4000),
]


@pytest.mark.parametrize("n,opts,target", MESH, ids=["n2", "n8"])
def test_sharded_kill_and_resume(tmp_path, jax_reads_port_files, n, opts, target):
    """The sharded engine killed at a target: its file equals JAX's, and
    the port resumes either file to the golden, equal to JAX resuming it."""
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")

    def configure(b):
        return b.target_state_count(target)

    ref = _jax(configure).spawn_sharded_bfs(devices=jax.devices()[:n], checkpoint_path=pj, **EVERY,
                                            **opts).join()
    ours = _port(configure).spawn_sharded_bfs(devices=n, device="cpu", checkpoint_path=pt, **EVERY,
                                              **opts).join()
    assert parity_dict(ours) == parity_dict(ref)
    assert ours.telemetry().get("checkpoint_delta_saves", 0) >= 1
    data, _meta = _same_file(pj, pt)
    if n == 2:
        assert any(k.startswith("spill_") for k in data)
    unbroken = _port().spawn_sharded_bfs(devices=n, device="cpu", **opts).join()
    jres = _jax().spawn_sharded_bfs(devices=jax.devices()[:n], resume_from=pt, **opts).join()
    for path in (pj, pt):
        resumed = _port().spawn_sharded_bfs(devices=n, device="cpu", resume_from=path, **opts).join()
        assert resumed.unique_state_count() == GOLDEN5
        assert parity_dict(resumed) == parity_dict(jres)
        assert _carried(parity_dict(resumed)) == _carried(parity_dict(unbroken))


def test_sharded_degraded_regrow(tmp_path, monkeypatch):
    from stateright_tpu.parallel.mesh import ShardedBfsChecker

    _chaos(monkeypatch, ShardedBfsChecker)
    _chaos(monkeypatch, ShardedGpuBfsChecker)
    opts = dict(chunk_size=64)
    ref = _jax().spawn_sharded_bfs(devices=jax.devices()[:2], checkpoint_path=str(tmp_path / "j.npz"),
                                   **EVERY, **opts).join()
    ours = _port().spawn_sharded_bfs(devices=2, device="cpu", checkpoint_path=str(tmp_path / "t.npz"),
                                     **EVERY, **opts).join()
    assert ours.unique_state_count() == GOLDEN5
    assert parity_dict(ours) == parity_dict(ref)
    assert ours.telemetry()["degraded_regrow"] == ref.telemetry()["degraded_regrow"] == 1
    monkeypatch.undo()
    _chaos(monkeypatch, ShardedGpuBfsChecker)
    with pytest.raises(RuntimeError, match="probe budget"):
        _port().spawn_sharded_bfs(devices=2, device="cpu", **opts).join()


# -- batch snapshots -----------------------------------------------------------------

LANE_DEPTHS = (2, 4, 6, 9, 0)


def _lane_builders():
    return [TensorModelAdapter(torch_models.TwoPhaseTensor(3)).checker().target_max_depth(d)
            for d in LANE_DEPTHS]


def _jax_lane_builders():
    jm = _JAX_MODELS.setdefault(("TwoPhaseTensor", (3,)), jax_models.TwoPhaseTensor(3))
    return [JaxAdapter(jm).checker().target_max_depth(d) for d in LANE_DEPTHS]


def _lane_dict(c):
    return dict(parity_dict(c), steps=c.telemetry()["steps"],
                paths={k: p.encode(c.model()) for k, p in c.discoveries().items()})


def _lanes(checkers):
    return [_lane_dict(c) for c in checkers]


def test_batch_snapshots_skip_their_batches(tmp_path, monkeypatch):
    from stateright_tpu.engines import multiplex as jax_mx

    base, jbase = str(tmp_path / "sweep"), str(tmp_path / "jsweep")
    first = mx.run_multiplexed(_lane_builders(), lanes=2, device="cpu", checkpoint_path=base)
    ref = jax_mx.run_multiplexed(_jax_lane_builders(), lanes=2, checkpoint_path=jbase)
    assert sorted(f for f in os.listdir(tmp_path) if f.startswith("sweep.")) == [
        "sweep.batch0.npz", "sweep.batch2.npz", "sweep.batch4.npz"]
    assert _lanes(first) == _lanes(ref)

    def refuse(*a, **k):
        raise AssertionError("a snapshotted batch ran again")

    monkeypatch.setattr(mx.LaneProgram, "run", refuse)
    monkeypatch.setattr(jax_mx, "_build_lane_program", refuse)
    again = mx.run_multiplexed(_lane_builders(), lanes=2, device="cpu", resume_from=base)
    jagain = jax_mx.run_multiplexed(_jax_lane_builders(), lanes=2, resume_from=jbase)
    assert _lanes(again) == _lanes(jagain) == _lanes(ref)


def test_corrupt_batch_snapshot_reruns_its_batch(tmp_path, monkeypatch):
    from stateright_tpu.engines import multiplex as jax_mx

    base, jbase = str(tmp_path / "sweep"), str(tmp_path / "jsweep")
    first = mx.run_multiplexed(_lane_builders(), lanes=2, device="cpu", checkpoint_path=base)
    ref = jax_mx.run_multiplexed(_jax_lane_builders(), lanes=2, checkpoint_path=jbase)
    assert _lanes(first) == _lanes(ref)
    for b in (base, jbase):
        with open(b + ".batch2.npz", "r+b") as f:
            f.truncate(100)
    orig, ran = mx.LaneProgram.run, []

    def run(self, *a, **k):
        ran.append(1)
        return orig(self, *a, **k)

    monkeypatch.setattr(mx.LaneProgram, "run", run)
    again = mx.run_multiplexed(_lane_builders(), lanes=2, device="cpu", resume_from=base,
                               checkpoint_path=base + "2")
    jagain = jax_mx.run_multiplexed(_jax_lane_builders(), lanes=2, resume_from=jbase)
    assert len(ran) == 1
    assert _lanes(again) == _lanes(jagain) == _lanes(ref)
    # The re-run batch wrote a fresh snapshot; the skipped ones were copied.
    assert len([f for f in os.listdir(tmp_path) if f.startswith("sweep2.")]) == 3
