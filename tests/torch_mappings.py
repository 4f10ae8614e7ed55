"""A pytest plugin that keeps a test process under the kernel's limit on
memory mappings (`vm.max_map_count`, 65530 by default on Linux).

Every XLA:CPU executable that JAX loads holds three mappings (code,
read-only data, data) for each kernel it compiled, and JAX keeps the
executables of every jitted function it has run in its caches. One
engine test loads thousands of kernels, so a pytest-xdist worker that
runs a long stretch of engine tests — the JAX package's and the port's
references alike — runs out of mappings and segfaults in its next
compile or persistent-cache load. Which worker gets such a stretch
depends on how many tests the suite collects, so adding tests anywhere
moves the crash onto tests that passed before.

After each test that leaves the process holding more than half the
limit, the plugin drops JAX's caches: the next test recompiles, or
reloads from the persistent compilation cache, what it needs. No single
test comes near half the limit, so the process stays below it.

tests/test_torch_mappings.py loads the plugin through `pytest_plugins`;
every xdist worker imports that module while it collects, so the guard
runs in every worker of a run over `tests/`."""

import gc

import jax
import pytest

SHARE = 0.5  # of the limit, above which the caches are dropped


def mapping_count() -> int:
    """The mappings this process holds now, or 0 where /proc has none."""
    try:
        with open("/proc/self/maps", "rb") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


def mapping_limit() -> int:
    """The kernel's limit on mappings per process, or 0 where it is unknown."""
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return 0


def release_if_crowded(limit: int, share: float = SHARE) -> bool:
    """Drop JAX's caches, and the executables only they hold, if the
    process holds more than `share` of `limit` mappings. True if it did."""
    if limit <= 0 or mapping_count() <= limit * share:
        return False
    jax.clear_caches()
    gc.collect()
    return True


_LIMIT = mapping_limit()


@pytest.hookimpl(trylast=True)
def pytest_runtest_teardown(item, nextitem):
    # trylast: after the test's fixtures are finalized, so what they held
    # is freed with the caches.
    release_if_crowded(_LIMIT)
