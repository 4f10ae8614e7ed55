"""The mapping guard of tests/torch_mappings.py, which this module loads
for the whole test process: it counts the process's mappings, reads the
kernel's limit, and drops JAX's compiled executables only when the
process holds more than its share of the limit."""

import mmap

import jax
import jax.numpy as jnp
import pytest

pytest_plugins = ("torch_mappings",)


@pytest.fixture
def guard(pytestconfig):
    return pytestconfig.pluginmanager.get_plugin("torch_mappings")


def test_count_sees_a_new_mapping(guard):
    before = guard.mapping_count()
    with mmap.mmap(-1, 1 << 20) as region:
        region[0] = 1
        assert guard.mapping_count() > before > 0


def test_limit_is_the_kernels(guard):
    with open("/proc/sys/vm/max_map_count") as f:
        assert guard.mapping_limit() == int(f.read()) > 0


@pytest.mark.parametrize("limit,released", [(1 << 40, False), (1, True), (0, False)])
def test_release_only_when_crowded(guard, limit, released):
    """A limit the process is far under keeps the executable; a limit of 1
    is always crowded and drops it; an unknown limit (0) never does."""
    double = jax.jit(lambda x: x * 2 + 1)
    assert int(double(jnp.arange(4))[3]) == 7
    assert double._cache_size() == 1
    assert guard.release_if_crowded(limit) is released
    assert double._cache_size() == (0 if released else 1)
    # Dropped or kept, the function still runs.
    assert int(double(jnp.arange(4))[3]) == 7


def test_plugin_is_loaded(guard):
    assert guard is not None and guard.pytest_runtest_teardown
