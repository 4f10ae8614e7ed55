"""Shared helpers of the port's engine-parity tests: run one model through
the JAX `spawn_tpu_bfs` and the port's `spawn_gpu_bfs(device="cpu")` with
the same options and compare everything the golden contract covers."""

import contextlib

import jax
import pytest
import torch

import stateright_tpu.models as jax_models
import stateright_tpu_torch.models as torch_models
from stateright_tpu.tensor import TensorModelAdapter as JaxAdapter
from stateright_tpu_torch import TensorModelAdapter

# The engine-parity options of tests/test_pipeline.py:25 and :33.
OPTS = dict(chunk_size=64, queue_capacity=1 << 12, table_capacity=1 << 11, sync_steps=4)
PAXOS_OPTS = dict(chunk_size=1024, queue_capacity=1 << 16, table_capacity=1 << 16, sync_steps=64)

# One JAX model instance per (class, args): its compiled era program is
# cached per instance, so the reference compiles once per model.
_JAX_MODELS = {}


def parity_dict(c):
    """`tests/test_pipeline.py:42 _fingerprint` plus the property counts."""
    cov = c.coverage()
    fp = dict(
        unique=c.unique_state_count(),
        states=c.state_count(),
        max_depth=c.max_depth(),
        discovery_fps=dict(c._discovery_fps),
        coverage_actions=cov["actions"],
        coverage_depths=cov["depths"],
        coverage_properties=cov["properties"],
    )
    sampler = getattr(c, "_sampler", None)  # lane checkers have none
    if sampler is not None and sampler.size():
        fp["sample"] = tuple(sampler.fingerprints())
    return fp


def paths(c):
    return {name: p.encode(c.model()) for name, p in c.discoveries().items()}


def run_pair(name, args, opts, configure=lambda b: b):
    """(reference, port) checkers of model `name`(*args), both built with
    coverage and `configure`, run to the end."""
    jm = _JAX_MODELS.setdefault((name, args), getattr(jax_models, name)(*args))
    ref = configure(JaxAdapter(jm).checker().coverage()).spawn_tpu_bfs(**opts).join()
    tm = getattr(torch_models, name)(*args)
    ours = configure(TensorModelAdapter(tm).checker().coverage()).spawn_gpu_bfs(device="cpu", **opts).join()
    return ref, ours


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small CPU ops, which torch's thread
    pool only slows down; the JAX side is unaffected."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@contextlib.contextmanager
def persistent_cache_off():
    """Compile the reference with JAX's persistent compilation cache off.
    Reading that cache while other test processes write it has crashed
    the reference (a segfault in `compilation_cache.get_executable_and_
    time`). JAX decides once per process whether the cache is used
    (`is_cache_used`), so the switch resets that decision on the way in
    and on the way out; the JAX package's own tests keep the cache."""
    from jax._src import compilation_cache

    before = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", before)
        compilation_cache.reset_cache()


@pytest.fixture(scope="module", autouse=True)
def reference_uncached():
    """Every reference compile of a port test module runs uncached."""
    with persistent_cache_off():
        yield
