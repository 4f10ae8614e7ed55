"""The port stands alone: importing every module of it (the speclint
CLI `analysis/__main__.py` included, without running it) and
`chip_smoke.py`, and running a BFS (serial, pipelined and fused, and
timed), a simulation, both with the stage profiler, the sharded BFS
(`parallel/`, with its stage profiler and discovery paths), multiplexed
lanes and the executable cache, and the speclint pre-flight (`analyze`, a
strict spawn), loads neither jax nor any module of the JAX package."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, pkgutil, sys
import stateright_tpu_torch
for mod in pkgutil.walk_packages(stateright_tpu_torch.__path__, "stateright_tpu_torch."):
    importlib.import_module(mod.name)
import chip_smoke
# The device-program modules: the shared graph builder, the simulation era
# and the stage profiler.
import stateright_tpu_torch.engines.graph, stateright_tpu_torch.ops.walk_era
import stateright_tpu_torch.engines.stages, stateright_tpu_torch.obs.stageprof, stateright_tpu_torch.ops.stage
from stateright_tpu_torch import TensorModelAdapter
from stateright_tpu_torch.models import TwoPhaseTensor
c = TensorModelAdapter(TwoPhaseTensor(2)).checker().spawn_gpu_bfs(
    device="cpu", chunk_size=16, queue_capacity=1 << 10, table_capacity=1 << 10).join()
assert c.unique_state_count() > 1
for configure in (lambda b: b.pipeline(False), lambda b: b.pipeline(depth=3, fuse=4), lambda b: b.timeout(60.0)):
    p = configure(TensorModelAdapter(TwoPhaseTensor(2)).checker()).spawn_gpu_bfs(
        device="cpu", chunk_size=16, queue_capacity=1 << 10, table_capacity=1 << 10, sync_steps=2).join()
    assert p.unique_state_count() == c.unique_state_count()
s = TensorModelAdapter(TwoPhaseTensor(2)).checker().target_state_count(200).spawn_gpu_simulation(
    1, device="cpu", walks=16, walk_cap=8).join()
assert s.state_count() >= 200
for spawn in (lambda b: b.spawn_gpu_bfs(device="cpu", chunk_size=16, queue_capacity=1 << 10, table_capacity=1 << 10),
              lambda b: b.target_state_count(200).spawn_gpu_simulation(1, device="cpu", walks=16, walk_cap=8)):
    tel = spawn(TensorModelAdapter(TwoPhaseTensor(2)).checker().stage_profile(iters=2)).join().telemetry()
    assert "stage_profile_error" not in tel and "stage_hash" in tel["phase_ms"], tel
import stateright_tpu_torch.parallel.mesh, stateright_tpu_torch.ops.exchange, stateright_tpu_torch.ops.mesh_era
m = TensorModelAdapter(TwoPhaseTensor(2)).checker().stage_profile(iters=2).spawn_sharded_bfs(
    devices=4, device="cpu", chunk_size=16, sync_steps=2).join()
assert m.unique_state_count() == c.unique_state_count() and m.discoveries() is not None
assert "stage_exchange" in m.telemetry()["phase_ms"], m.telemetry()
from stateright_tpu_torch import ExecutableCache, run_multiplexed
compiled, _hit = ExecutableCache().get(TwoPhaseTensor(2), "multiplex", lanes=4, chunk=16, device="cpu")
lanes = run_multiplexed([compiled.builder() for _ in range(3)], lanes=4, chunk=16, device="cpu")
assert [c.unique_state_count() for c in lanes] == [c.unique_state_count()] * 3
import stateright_tpu_torch.analysis.__main__ as lint_cli
assert lint_cli.__name__ == "stateright_tpu_torch.analysis.__main__"
from stateright_tpu_torch import analyze
assert analyze(TwoPhaseTensor(2), device="cpu").ok
st = TensorModelAdapter(TwoPhaseTensor(2)).checker().strict().spawn_gpu_bfs(
    device="cpu", chunk_size=16, queue_capacity=1 << 10, table_capacity=1 << 10).join()
assert st.telemetry()["lint_errors"] == 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "stateright_tpu" or m.startswith("stateright_tpu."))
print("LOADED", bad)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", PROBE],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
