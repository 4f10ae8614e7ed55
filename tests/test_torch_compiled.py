"""The port's build/run split (engines/compiled.py) against the JAX
package's: model signatures and config digests, the intern pool, the
solo era geometry, and the executable cache's keys and stats (the
counterparts of tests/test_serve.py:385-410), with the warm lane program
that a cached "multiplex" executable holds."""

import gc
import weakref

import pytest

import stateright_tpu.models as jax_models
import stateright_tpu_torch.models as torch_models
from stateright_tpu.engines.compiled import era_geometry as jax_era_geometry
from stateright_tpu.engines.compiled import model_signature as jax_signature
from stateright_tpu_torch import TensorModelAdapter
from stateright_tpu_torch.engines import multiplex
from stateright_tpu_torch.engines.compiled import (
    CompiledCheck,
    ExecutableCache,
    era_geometry,
    intern_model,
    model_signature,
)
from torch_parity import one_torch_thread, reference_uncached  # noqa: F401


@pytest.mark.parametrize("name,args", [
    ("IncrementTensor", (2,)), ("TwoPhaseTensor", (3,)), ("PaxosTensor", (2,)), ("AbdTensor", (2,)),
])
def test_config_digest_and_signature_match_the_jax_models(name, args):
    ours, ref = getattr(torch_models, name)(*args), getattr(jax_models, name)(*args)
    assert ours.config_digest() == ref.config_digest()
    # The signature differs only in the class's module path.
    assert model_signature(ours).split("|", 1)[1] == jax_signature(ref).split("|", 1)[1]


def test_model_signature_stable_across_instances():
    assert model_signature(torch_models.IncrementTensor(2)) == model_signature(
        TensorModelAdapter(torch_models.IncrementTensor(2))
    )
    assert model_signature(torch_models.IncrementTensor(2)) != model_signature(
        torch_models.IncrementTensor(3)
    )
    tm_a, sig = intern_model(torch_models.IncrementTensor(2))
    tm_b, sig_b = intern_model(torch_models.IncrementTensor(2))
    assert tm_a is tm_b and sig == sig_b  # one canonical instance
    with pytest.raises(TypeError):
        model_signature(object())


@pytest.mark.parametrize("options", [
    {}, dict(chunk_size=64, queue_capacity=1 << 12, table_capacity=1 << 11),
    dict(chunk_size=6144, table_capacity=1 << 10, coverage=False),
    dict(chunk_size=64, fuse_eras=4),
])
def test_era_geometry_matches_jax(options):
    ours = era_geometry(torch_models.TwoPhaseTensor(5), options)
    ref = jax_era_geometry(jax_models.TwoPhaseTensor(5), options)
    assert ours == {k: ref[k] for k in ours}


def test_executable_cache_keys_by_shape_and_options():
    cache = ExecutableCache(capacity=4)
    a, hit_a = cache.get(torch_models.IncrementTensor(2), "multiplex", lanes=4, chunk=64, device="cpu")
    assert not hit_a
    b, hit_b = cache.get(torch_models.IncrementTensor(2), "multiplex", lanes=4, chunk=64, device="cpu")
    assert hit_b and b is a
    _, hit_c = cache.get(torch_models.IncrementTensor(2), "multiplex", lanes=8, chunk=64, device="cpu")
    assert not hit_c  # different shape options = different executable
    assert cache.stats() == {"hits": 1, "misses": 2, "size": 2, "capacity": 4}
    for k in range(3, 6):
        cache.get(torch_models.IncrementTensor(k), "gpu_bfs", device="cpu")
    assert cache.stats()["size"] == 4  # LRU-bounded


def test_warm_multiplex_executable_serves_every_batch():
    cache = ExecutableCache()
    compiled, _hit = cache.get(torch_models.IncrementTensor(2), "multiplex", lanes=4, device="cpu")
    warm = compiled.program
    assert isinstance(warm, multiplex.LaneProgram) and (warm.lanes, warm.chunk) == (4, 256)
    builders = [compiled.builder() for _ in range(6)]  # two batches
    lanes = multiplex.run_multiplexed(builders, lanes=4, device="cpu", cache=cache)
    assert [c.unique_state_count() for c in lanes] == [13] * 6
    # Fresh model instances share the signature: the same entry and
    # program, whether the options are spelled out or left at defaults.
    again = multiplex.run_multiplexed(
        [TensorModelAdapter(torch_models.IncrementTensor(2)).checker()], lanes=4, chunk=256, device="cpu",
        cache=cache,
    )
    assert again[0].unique_state_count() == 13
    assert cache.stats() == {"hits": 2, "misses": 1, "size": 1, "capacity": 8}
    assert cache.get(torch_models.IncrementTensor(2), "multiplex", lanes=4, device="cpu")[0].program is warm
    # Three batches on one warm program: its batch segments were built
    # once (on the card: one graph capture, tests/test_torch_card.py).
    assert warm.builds == 1 and warm.graph_captures == 0


def test_evicting_a_multiplex_entry_frees_its_lane_workspace():
    cache = ExecutableCache(capacity=1)
    multiplex.run_multiplexed([TensorModelAdapter(torch_models.IncrementTensor(2)).checker()],
                              lanes=2, device="cpu", cache=cache)
    compiled, hit = cache.get(torch_models.IncrementTensor(2), "multiplex", lanes=2, device="cpu")
    assert hit
    tables = weakref.ref(compiled.program.table.keys)
    del compiled
    cache.get(torch_models.IncrementTensor(3), "multiplex", lanes=2, device="cpu")
    gc.collect()
    assert tables() is None  # the one owner let go: the workspace is freed
    assert cache.stats()["size"] == 1


def test_compiled_solo_spawn_runs_the_interned_model():
    compiled = CompiledCheck(
        "gpu_bfs", torch_models.TwoPhaseTensor(3),
        dict(chunk_size=64, queue_capacity=1 << 12, table_capacity=1 << 11, device="cpu"),
    ).warm()
    c = compiled.spawn(TensorModelAdapter(torch_models.TwoPhaseTensor(3)).checker()).join()
    assert c.unique_state_count() == 288 and c.tm is compiled.tm and compiled.uses == 1
    with pytest.raises(ValueError, match="signature mismatch"):
        compiled.spawn(TensorModelAdapter(torch_models.TwoPhaseTensor(4)).checker())
    with pytest.raises(ValueError, match="spawn"):
        CompiledCheck("multiplex", torch_models.TwoPhaseTensor(3), dict(device="cpu")).spawn()
    with pytest.raises(ValueError, match="unknown compiled-check engine"):
        CompiledCheck("tpu_bfs", torch_models.TwoPhaseTensor(3), {}).warm()


def test_fusion_factor_keys_the_solo_executable():
    """The fusion factor is part of a solo executable's shape (the JAX
    loop cache keys it): its own entry, and its runs are fused."""
    cache = ExecutableCache()
    opts = dict(chunk_size=16, queue_capacity=1 << 10, table_capacity=1 << 10, device="cpu")
    plain, _ = cache.get(torch_models.TwoPhaseTensor(3), "gpu_bfs", **opts)
    fused, hit = cache.get(torch_models.TwoPhaseTensor(3), "gpu_bfs", fuse_eras=4, **opts)
    assert not hit and fused is not plain
    c = fused.spawn(sync_steps=2).join()
    tel = c.telemetry()
    assert c.unique_state_count() == 288
    assert tel["dispatches"] < tel["eras"] and tel["fused_eras_per_dispatch"] > 1.0
