"""The sharded engine across ranks: W gloo processes on the CPU, each
holding N / W shards (`group=`), against the JAX mesh of N virtual CPU
devices. The one-rank runs (tests/test_torch_mesh.py) check N shards on
one device; here the exchange crosses processes (one all_to_all_single a
step), the gate, the veto and the epilogue sums are all-reduced between
K15f's phases, and the paths are walked collectively. The card checks
world size 1 only (two ranks cannot share one GPU under NCCL): this file
is where the multi-rank path is held against the reference.

Each case starts W processes of tests/torch_mesh_worker.py (which
imports only the port), rendezvous through a file in tmp_path (no fixed
port), a 60 s collective timeout, and a join limit."""

import json
import os
import subprocess
import sys

import jax
import pytest

import stateright_tpu.models as jax_models
from stateright_tpu.tensor import TensorModelAdapter as JaxAdapter
from torch_parity import paths, reference_uncached  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
OPTS = dict(chunk_size=64)
MODELS = [("TwoPhaseTensor", [3]), ("TwoPhaseTensor", [5])]
LIMIT = 150  # seconds a group of ranks may take
_REF = {}


def _normal(d):
    return json.loads(json.dumps(d, default=str))


def _reference(name, args, n):
    key = (name, tuple(args), n)
    if key not in _REF:
        c = JaxAdapter(getattr(jax_models, name)(*args)).checker().coverage().spawn_sharded_bfs(
            devices=jax.devices()[:n], **OPTS).join()
        cov = c.coverage()
        d = dict(unique=c.unique_state_count(), states=c.state_count(), max_depth=c.max_depth(),
                 discovery_fps={k: str(v) for k, v in c._discovery_fps.items()},
                 coverage_actions=cov["actions"],
                 coverage_depths={str(k): v for k, v in cov["depths"].items()},
                 coverage_properties=cov["properties"])
        if c._sampler is not None and c._sampler.size():
            d["sample"] = [str(f) for f in c._sampler.fingerprints()]
        _REF[key] = (_normal(d), paths(c))
    return _REF[key]


def _run_ranks(tmp_path, world, shards, jobs):
    init = tmp_path / "rendezvous"
    out = tmp_path / "result.jsonl"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_mesh_worker.py"), str(init), str(world), str(r),
         str(shards), str(out), json.dumps(jobs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
    ) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=LIMIT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [json.loads(line) for line in out.read_text().splitlines()]


@pytest.mark.parametrize("world,shards", [(2, 8), (4, 8), (2, 2)], ids=["w2x4", "w4x2", "w2x1"])
def test_ranks_match_the_jax_mesh(tmp_path, world, shards):
    jobs = [[name, args, OPTS] for name, args in MODELS]
    results = _run_ranks(tmp_path, world, shards, jobs)
    assert len(results) == len(jobs)
    for (name, args, _o), got in zip(jobs, results):
        want, want_paths = _reference(name, args, shards)
        assert got["world"] == world
        assert got["parity"] == want, (name, args)
        assert got["paths"] == want_paths
    if shards == 8:
        assert results[1]["partial"] > 0  # 2pc-5 at 8 shards takes the partial-commit path


def test_ranks_checkpoint_and_resume(tmp_path):
    """Two ranks of one shard each, spilling, killed at a target: rank 0
    writes the one file in the JAX layout, equal to the one-rank run's
    file, and the two ranks resume it to the golden, equal to a one-rank
    resume."""
    import numpy as np
    import torch

    import stateright_tpu_torch.models as torch_models
    from stateright_tpu_torch import TensorModelAdapter
    from stateright_tpu_torch.engines import common
    from torch_mesh_worker import parity

    opts = dict(chunk_size=32, queue_capacity_per_shard=1 << 9)
    ranks_ckpt, one_ckpt = str(tmp_path / "ranks.npz"), str(tmp_path / "one.npz")
    jobs = [["TwoPhaseTensor", [5], dict(opts, checkpoint_path=ranks_ckpt), 6000],
            ["TwoPhaseTensor", [5], dict(opts, resume_from=ranks_ckpt)]]
    part, resumed = _run_ranks(tmp_path, 2, 2, jobs)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        b = TensorModelAdapter(torch_models.TwoPhaseTensor(5)).checker().coverage()
        one = b.target_state_count(6000).spawn_sharded_bfs(devices=2, device="cpu", checkpoint_path=one_ckpt,
                                                           **opts).join()
        one_res = TensorModelAdapter(torch_models.TwoPhaseTensor(5)).checker().coverage().spawn_sharded_bfs(
            devices=2, device="cpu", resume_from=one_ckpt, **opts).join()
    finally:
        torch.set_num_threads(threads)
    assert part["parity"] == _normal(parity(one))
    a, ma = common.load_checkpoint_verified(ranks_ckpt)
    b, mb = common.load_checkpoint_verified(one_ckpt)
    assert sorted(a) == sorted(b) and any(k.startswith("spill_") for k in a)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert ma == mb
    assert resumed["parity"]["unique"] == 8_832
    assert resumed["parity"] == _normal(parity(one_res))


def test_an_eager_stage_program_on_the_card_is_timed_on_the_host(monkeypatch):
    """Across ranks the mesh's stage programs run their rounds from the
    host (the exchange's all_to_all cannot be captured), and the host
    waits for the card inside such a launch. Queued behind the stage
    timer's spin kernel, that launch outlasted the spin every time, so
    the timer doubled the spin without end: the stall of
    `scripts/mesh_ranks.py --world 4` in its profiled case. Such a program
    is timed on the host's clock, with no spin. It runs on the CPU here
    with its device named the card; the spin, the events and the streams
    are stand-ins that fail when used."""
    import torch

    from stateright_tpu_torch.engines import stages
    from stateright_tpu_torch.obs import stageprof

    def refuse(*_a, **_k):
        raise AssertionError("an eager program was queued behind the spin kernel")

    progs = stages._Programs("cpu", 4, eager=True)
    null = progs.null
    null.device = torch.device("cuda")
    assert not null.as_graph
    monkeypatch.setattr(torch.cuda, "_sleep", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *_a: None)
    secs = stageprof.time_dispatch(null)
    assert secs > 0 and null.read() == stageprof.SEED + 4
