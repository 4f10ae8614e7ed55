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
