"""stateright_tpu_torch: the PyTorch/CUDA port of stateright_tpu.

Exhaustive batched BFS over a `TensorModel` on an NVIDIA H100, with
bottom-k state sampling (on by default) and symmetry reduction, and
batched random-walk simulation, through hand-written Hopper kernels
(kernels/csrc): for BFS fingerprinting, compaction, in-batch dedup, the
visited-set insert, the ring queue, the sample capture and its epilogue,
and the parent lookup of path reconstruction; for simulation the walks'
cycle test and path record, their step, their sample capture and the
slab's dedup and bottom-k; and many small same-shape checks as lanes of
one BFS step loop (`run_multiplexed`), through the same BFS kernels
with a lane axis, with a cache of warm executables (`ExecutableCache`).
Models: two-phase commit, Paxos, ABD and the increment race
(`stateright_tpu_torch.models`). `analyze`, `CheckerBuilder.lint()` and
`.strict()` are the speclint pre-flight (`analysis/`), which runs a
model's lane programs on the card as the engines capture them. It
imports torch and numpy, never jax and nothing of the JAX package, and
keeps its own copy of the host layers it needs.

    from stateright_tpu_torch import TensorModelAdapter, run_multiplexed
    from stateright_tpu_torch.models import TwoPhaseTensor

    c = TensorModelAdapter(TwoPhaseTensor(7)).checker().spawn_gpu_bfs().join()
    c.assert_properties()

    s = TensorModelAdapter(TwoPhaseTensor(7)).checker().target_state_count(
        10**7).spawn_gpu_simulation(0, walks=16384).join()
    s.assert_any_discovery("abort agreement")

    # Many small same-shape checks as lanes of one step loop:
    lanes = run_multiplexed(
        [TensorModelAdapter(TwoPhaseTensor(5)).checker().target_max_depth(d)
         for d in range(1, 19)], lanes=32)

Engines run on `cuda` unless the caller passes `device="cpu"`, which runs
each kernel's plain torch version instead.
"""

from .checker import Checker, CheckerBuilder
from .core import Expectation, Model, Property
from .engines.compiled import CompiledCheck, ExecutableCache
from .engines.multiplex import run_multiplexed
from .has_discoveries import HasDiscoveries
from .path import Path
from .tensor import TensorModel, TensorModelAdapter, TensorProperty
from .analysis import AnalysisReport, SpecLintError, analyze

__all__ = [
    "AnalysisReport",
    "Checker",
    "CheckerBuilder",
    "CompiledCheck",
    "ExecutableCache",
    "Expectation",
    "HasDiscoveries",
    "Model",
    "Path",
    "Property",
    "SpecLintError",
    "TensorModel",
    "TensorModelAdapter",
    "TensorProperty",
    "analyze",
    "run_multiplexed",
]
