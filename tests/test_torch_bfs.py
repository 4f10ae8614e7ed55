"""The port's engine end to end: `spawn_gpu_bfs(device="cpu")` (every
kernel through its plain version) against the JAX `spawn_tpu_bfs` on the
same model and options, both with sampling off. Equal means the whole
result dict — unique and total states, max depth, discovery
fingerprints, coverage actions, depths and property counts — and every
discovery path's encoding. The sampled default runs are held in
test_torch_sample.py, symmetry in test_torch_symmetry.py."""

import pytest

from stateright_tpu import HasDiscoveries as JaxHasDiscoveries
from stateright_tpu.models import TwoPhaseTensor as JaxTwoPhase
from stateright_tpu.tensor import TensorModelAdapter as JaxAdapter
from stateright_tpu_torch import HasDiscoveries, TensorModelAdapter
from stateright_tpu_torch.models import TwoPhaseTensor
from torch_parity import reference_uncached  # noqa: F401

# Many short eras and table growth (tests/test_pipeline.py:25).
OPTS = dict(chunk_size=64, queue_capacity=1 << 12, table_capacity=1 << 11, sync_steps=4)
# 2pc-6 at chunk 1024 also overflows rcap on some steps: partial commits.
OPTS6 = dict(chunk_size=1024, queue_capacity=1 << 16, table_capacity=1 << 12, sync_steps=4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small CPU ops, which torch's thread
    pool only slows down; the JAX side is unaffected."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def result_dict(c):
    cov = c.coverage()
    return dict(
        unique=c.unique_state_count(),
        states=c.state_count(),
        max_depth=c.max_depth(),
        discovery_fps=dict(c._discovery_fps),
        coverage_actions=cov["actions"],
        coverage_depths=cov["depths"],
        coverage_properties=cov["properties"],
    )


def paths(c):
    return {name: p.encode(c.model()) for name, p in c.discoveries().items()}


_JAX_MODELS = {}


def run_pair(n, opts=OPTS, configure_jax=lambda b: b, configure_port=lambda b: b):
    # One JAX model instance per size: its compiled era program is cached
    # per instance, so the reference compiles once per size.
    jm = _JAX_MODELS.setdefault(n, JaxTwoPhase(n))
    ref = configure_jax(
        JaxAdapter(jm).checker().coverage().sample(False)
    ).spawn_tpu_bfs(**opts).join()
    ours = configure_port(
        TensorModelAdapter(TwoPhaseTensor(n)).checker().coverage().sample(False)
    ).spawn_gpu_bfs(device="cpu", **opts).join()
    return ref, ours


@pytest.fixture(scope="module")
def runs():
    out = {n: run_pair(n) for n in (3, 5)}
    out["partial"] = run_pair(6, OPTS6)
    out["target"] = run_pair(
        5, OPTS, lambda b: b.target_state_count(3000), lambda b: b.target_state_count(3000)
    )
    out["finish"] = run_pair(
        5,
        OPTS,
        lambda b: b.finish_when(JaxHasDiscoveries.any_of(["abort agreement"])),
        lambda b: b.finish_when(HasDiscoveries.any_of(["abort agreement"])),
    )
    out["depth"] = run_pair(
        5, OPTS, lambda b: b.target_max_depth(7), lambda b: b.target_max_depth(7)
    )
    return out


@pytest.mark.parametrize("case,golden", [(3, 288), (5, 8832)])
def test_exhaustive_matches_jax(runs, case, golden):
    ref, ours = runs[case]
    assert ours.unique_state_count() == golden
    assert result_dict(ours) == result_dict(ref)
    assert paths(ours) == paths(ref)
    ours.assert_properties()
    assert sum(ours.coverage()["depths"].values()) == golden


@pytest.mark.parametrize("case,golden", [("partial", 50816)])
def test_partial_commits_match_jax(runs, case, golden):
    ref, ours = runs[case]
    assert ours.unique_state_count() == golden
    assert result_dict(ours) == result_dict(ref)
    assert paths(ours) == paths(ref)
    assert ours.telemetry()["partial_steps"] >= 1


def test_runs_cross_eras_and_growth(runs):
    tel = runs[5][1].telemetry()
    assert tel["eras"] > 10
    assert tel["table_growths"] >= 1


@pytest.mark.parametrize("case", ["target", "finish", "depth"])
def test_early_stop_matches_jax(runs, case):
    ref, ours = runs[case]
    assert result_dict(ours) == result_dict(ref)
    assert paths(ours) == paths(ref)
    assert ours.unique_state_count() < 8832


def test_discovery_paths_replay():
    c = TensorModelAdapter(TwoPhaseTensor(3)).checker().spawn_gpu_bfs(device="cpu", **OPTS).join()
    path = c.assert_any_discovery("commit agreement")
    c.assert_discovery("commit agreement", path.into_actions())
    c.assert_no_discovery("consistent")


@pytest.mark.parametrize(
    "configure",
    [
        lambda b: b.threads(4),
        lambda b: b.visitor(print),
    ],
)
def test_unported_options_raise(configure):
    with pytest.raises(NotImplementedError, match="slice"):
        configure(TensorModelAdapter(TwoPhaseTensor(3)).checker())


def test_cuda_is_the_default_device(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TensorModelAdapter(TwoPhaseTensor(3)).checker().spawn_gpu_bfs(**OPTS)
