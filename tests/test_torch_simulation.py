"""The port's simulation engine, `spawn_gpu_simulation(device="cpu")`,
against `spawn_tpu_simulation` on the cases of
`tests/test_tpu_simulation.py`, plus Paxos-2 and ABD-2 with a target,
coverage and sampling, and the single-copy register's linearizability
violation: state count, max depth, every discovery's path,
coverage, the sample and telemetry steps/eras are equal."""

import pytest
import torch

import stateright_tpu.has_discoveries as jhd
import stateright_tpu.models as jax_models
import stateright_tpu_torch.has_discoveries as thd
import stateright_tpu_torch.models as torch_models
from stateright_tpu.tensor import TensorModelAdapter as JaxAdapter
from stateright_tpu_torch import TensorModelAdapter
from torch_parity import one_torch_thread, reference_uncached  # noqa: F401
from torch_sim_models import ChainFork, JaxChainFork, JaxTinyClock, TinyClock

_JAX = {}


def summary(c):
    cov = c.coverage()
    tel = c.telemetry()
    return dict(
        states=c.state_count(),
        unique=c.unique_state_count(),
        max_depth=c.max_depth(),
        paths={k: v.encode(c.model()) for k, v in c.discoveries().items()},
        chains=dict(c._discovery_paths),
        coverage=cov,
        sample=tuple(c._sampler.fingerprints()) if c._sampler is not None else (),
        steps=tel["steps"],
        eras=tel["eras"],
    )


def run_pair(model, seed, configure=lambda b, hd: b, **kw):
    """(reference, port) summaries of one simulation run; `model` is a
    model name and its arguments, or a (jax, port) pair of instances."""
    if isinstance(model[0], str):
        name, args = model[0], model[1:]
        jm = _JAX.setdefault(model, getattr(jax_models, name)(*args))
        tm = getattr(torch_models, name)(*args)
    else:
        jm = _JAX.setdefault(type(model[0]), model[0])
        tm = model[1]
    ref = configure(JaxAdapter(jm).checker(), jhd.HasDiscoveries).spawn_tpu_simulation(seed, **kw).join()
    ours = configure(TensorModelAdapter(tm).checker(), thd.HasDiscoveries).spawn_gpu_simulation(
        seed, device="cpu", **kw).join()
    return summary(ref), summary(ours), ours


def fin_any(b, hd):
    return b.finish_when(hd.any_of(["fin"]))


def test_increment_race_found_like_jax():
    ref, ours, c = run_pair(("IncrementTensor", 2), 7, fin_any, walks=64, walk_cap=32)
    assert ours == ref
    path = c.discovery("fin")
    assert not c.model().property("fin").condition(c.model(), path.last_state())
    c.assert_discovery("fin", path.into_actions())


@pytest.mark.parametrize("seed", [123, 321])
def test_seed_determinism_like_jax(seed):
    ref, ours, _c = run_pair(("IncrementTensor", 2), seed, fin_any, walks=32, walk_cap=32)
    assert ours == ref
    again = run_pair(("IncrementTensor", 2), seed, fin_any, walks=32, walk_cap=32)[1]
    assert again == ours


def test_seeds_differ():
    a = run_pair(("IncrementTensor", 2), 123, fin_any, walks=32, walk_cap=32)[1]
    b = run_pair(("IncrementTensor", 2), 321, fin_any, walks=32, walk_cap=32)[1]
    assert a["paths"] != b["paths"] or a["states"] != b["states"]


def test_cycle_restarts_like_jax():
    ref, ours, c = run_pair((JaxTinyClock(), TinyClock()), 5, walks=8, walk_cap=16)
    assert ours == ref
    assert c.discovery("is one") is not None
    assert ours["steps"] >= 2


def test_2pc_agreements_like_jax():
    def conf(b, hd):
        return b.finish_when(hd.all_of(["abort agreement", "commit agreement"]))

    ref, ours, c = run_pair(("TwoPhaseTensor", 3), 11, conf, walks=128, walk_cap=64)
    assert ours == ref
    assert set(ours["paths"]) == {"abort agreement", "commit agreement"}
    assert "consistent" not in ours["paths"]
    for name in ours["paths"]:
        c.assert_discovery(name, c.discovery(name).into_actions())


def test_target_state_count_like_jax():
    def conf(b, hd):
        return b.finish_when(hd.all_of(["no such property"])).target_state_count(5_000)

    ref, ours, _c = run_pair((JaxTinyClock(), TinyClock()), 1, conf, walks=16, walk_cap=8)
    assert ours == ref
    assert ours["states"] >= 5_000


def test_frozen_walks_restart_like_jax():
    def conf(b, hd):
        return b.target_state_count(3_000).timeout(60)

    ref, ours, _c = run_pair((JaxChainFork(), ChainFork()), 13, conf, walks=64, walk_cap=32, sync_steps=4)
    assert ours == ref
    assert "at one" in ours["paths"] and "reaches end" not in ours["paths"]
    assert ours["states"] >= 3_000


@pytest.mark.parametrize("name,seed", [("PaxosTensor", 3), ("AbdTensor", 4)])
def test_actor_models_sampled_like_jax(name, seed):
    def conf(b, hd):
        return b.coverage().target_state_count(20_000)

    ref, ours, c = run_pair((name, 2), seed, conf, walks=256, walk_cap=64, sync_steps=8)
    assert ours == ref
    assert len(ours["sample"]) == 64 and ours["eras"] > 5
    assert "value chosen" in ours["paths"]
    c.assert_discovery("value chosen", c.discovery("value chosen").into_actions())


def test_single_copy_violation_found_like_jax():
    """SingleCopyTensor(3, 2): the walks find the read of an empty second
    copy, as the JAX walks do, and the path replays."""
    def conf(b, hd):
        return b.coverage().finish_when(hd.any_of(["linearizable"]))

    ref, ours, c = run_pair(("SingleCopyTensor", 3, 2), 5, conf, walks=256, walk_cap=64, sync_steps=8)
    assert ours == ref
    path = c.discovery("linearizable")
    assert not c.model().property("linearizable").condition(c.model(), path.last_state())
    c.assert_discovery("linearizable", path.into_actions())


def test_telemetry_and_refusals():
    b = TensorModelAdapter(torch_models.TwoPhaseTensor(3)).checker()
    c = b.target_state_count(500).spawn_gpu_simulation(1, walks=32, walk_cap=16, sync_steps=2, device="cpu").join()
    tel = c.telemetry()
    assert tel["walks"] == 32 and tel["walk_cap"] == 16 and tel["eras"] >= 2
    assert tel["states_generated"] == c.state_count() >= 500
    with pytest.raises(ValueError, match="symmetry"):
        TensorModelAdapter(torch_models.TwoPhaseTensor(3)).checker().symmetry().spawn_gpu_simulation(
            1, device="cpu")


def test_simulation_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TensorModelAdapter(torch_models.TwoPhaseTensor(3)).checker().spawn_gpu_simulation(1)
