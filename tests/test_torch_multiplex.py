"""The port's multiplexed lanes (`run_multiplexed(device="cpu")`, the
kernels' plain versions) against the JAX `run_multiplexed`, lane by lane
and bit for bit: the parity dict (counts, discoveries, coverage), the
discovery paths, and the telemetry's steps and states_generated. Also
the batching across dispatches, a lane against its solo run, and the
refusals."""

import pytest

import stateright_tpu.models as jax_models
import stateright_tpu_torch.models as torch_models
from stateright_tpu.engines.multiplex import run_multiplexed as jax_run_multiplexed
from stateright_tpu.has_discoveries import HasDiscoveries as JaxHasDiscoveries
from stateright_tpu.tensor import TensorModelAdapter as JaxAdapter
from stateright_tpu_torch import TensorModelAdapter
from stateright_tpu_torch.engines.multiplex import run_multiplexed
from stateright_tpu_torch.has_discoveries import HasDiscoveries
from torch_parity import _JAX_MODELS, one_torch_thread, parity_dict, paths, reference_uncached  # noqa: F401


def lane_dict(c):
    tel = c.telemetry()
    return dict(
        parity_dict(c), paths=paths(c), steps=tel["steps"],
        states_generated=tel["states_generated"],
    )


def run_both(name, args, configs, **shape):
    """The JAX lanes and the port's lanes of model `name`(*args), one
    builder a config (config(builder, HasDiscoveries) -> builder)."""
    jm = _JAX_MODELS.setdefault((name, args), getattr(jax_models, name)(*args))
    ref = jax_run_multiplexed(
        [cfg(JaxAdapter(jm).checker(), JaxHasDiscoveries) for cfg in configs], **shape
    )
    tm = getattr(torch_models, name)(*args)
    ours = run_multiplexed(
        [cfg(TensorModelAdapter(tm).checker(), HasDiscoveries) for cfg in configs],
        device="cpu", **shape,
    )
    return ref, ours


def plain(b, _h):
    return b


def depth(d):
    return lambda b, _h: b.target_max_depth(d)


def finish_any(*names):
    return lambda b, h: b.finish_when(h.any_of(list(names)))


def assert_lanes_equal(ref, ours):
    assert len(ref) == len(ours)
    for lane, (r, o) in enumerate(zip(ref, ours)):
        assert lane_dict(o) == lane_dict(r), f"lane {lane}"


def test_increment_lanes_match_jax():
    ref, ours = run_both("IncrementTensor", (2,), [plain] * 4, lanes=4)
    assert_lanes_equal(ref, ours)
    assert [c.unique_state_count() for c in ours] == [13] * 4
    assert all(c.telemetry()["eras"] == 1 for c in ours)
    for c in ours:
        c.assert_discovery("fin", c.discovery("fin").into_actions())


def test_2pc3_mixed_options_and_padding_lanes_match_jax():
    configs = [
        plain, depth(4), finish_any("abort agreement"),
        lambda b, h: b.target_max_depth(9).finish_when(h.any_of(["commit agreement"])),
        depth(9),
    ]
    ref, ours = run_both("TwoPhaseTensor", (3,), configs, lanes=8)  # 3 padding lanes
    assert_lanes_equal(ref, ours)
    assert [c.unique_state_count() for c in ours][:2] == [288, 67]
    assert ours[0].telemetry()["multiplexed_lanes"] == 8


def test_abd2_lanes_match_jax():
    ref, ours = run_both("AbdTensor", (2,), [plain] * 2, lanes=2)
    assert_lanes_equal(ref, ours)
    assert ours[0].unique_state_count() == 544


def test_2pc6_lanes_commit_partially_and_match_jax():
    """chunk 1024 overflows the rcap width on some steps: those lanes
    commit partially, halve take_cap and re-run the rows (counted in the
    port's `partial_steps`, which the reference does not report)."""
    ref, ours = run_both(
        "TwoPhaseTensor", (6,), [plain, depth(12)],
        lanes=2, chunk=1024, queue_capacity=1 << 16, table_capacity=1 << 18,
    )
    assert_lanes_equal(ref, ours)
    assert ours[0].unique_state_count() == 50_816
    assert ours[0].telemetry()["steps"] == 64
    assert all(c.telemetry()["partial_steps"] > 0 for c in ours)


def test_batch_wider_than_lanes_runs_twice_on_one_program():
    ref, ours = run_both("IncrementTensor", (2,), [depth(1 + i) for i in range(5)], lanes=4)
    assert_lanes_equal(ref, ours)
    assert [c.unique_state_count() for c in ours] == [
        run_multiplexed([TensorModelAdapter(torch_models.IncrementTensor(2)).checker().target_max_depth(1 + i)],
                        lanes=4, device="cpu")[0].unique_state_count()
        for i in range(5)
    ]
    assert ours[-1].unique_state_count() == 13


@pytest.mark.parametrize("configure", [plain, depth(5), finish_any("abort agreement")],
                         ids=["exhaustive", "depth-5", "finish-abort"])
def test_lane_equals_its_solo_run(configure):
    shape = dict(chunk=64, queue_capacity=1 << 12, table_capacity=1 << 15)
    tm = torch_models.TwoPhaseTensor(4)
    lane = run_multiplexed(
        [configure(TensorModelAdapter(tm).checker(), HasDiscoveries)], lanes=3, device="cpu", **shape
    )[0]
    solo = configure(TensorModelAdapter(tm).checker().sample(False), HasDiscoveries).spawn_gpu_bfs(
        device="cpu", chunk_size=shape["chunk"], queue_capacity=shape["queue_capacity"],
        table_capacity=shape["table_capacity"], sync_steps=1 << 20,
    ).join()
    assert (lane.unique_state_count(), lane.state_count(), lane.max_depth()) == (
        solo.unique_state_count(), solo.state_count(), solo.max_depth())
    assert lane._discovery_fps == solo._discovery_fps
    assert lane.coverage() == solo.coverage()


def _builder():
    return TensorModelAdapter(torch_models.IncrementTensor(2)).checker()


@pytest.mark.parametrize("configure,words", [
    (lambda b: b.timeout(1.0), "timeouts"),
    (lambda b: b.symmetry(), "symmetry reduction"),
    (lambda b: b.target_state_count(100), "state-count targets"),
])
def test_rejects_unsupported_options(configure, words):
    with pytest.raises(ValueError, match=words):
        run_multiplexed([configure(_builder())], lanes=4, device="cpu")


def test_mixed_signatures_rejected():
    builders = [_builder(), TensorModelAdapter(torch_models.IncrementTensor(3)).checker()]
    with pytest.raises(ValueError, match="signature"):
        run_multiplexed(builders, lanes=4, device="cpu")


def test_lane_budget_and_capacity_errors_use_the_reference_words():
    tm = torch_models.TwoPhaseTensor(5)
    # The table's growth limit (MAX_LOAD * 2^14 - vcap = 640 states)
    # closes the lane's gate long before 8,832; lanes do not grow.
    with pytest.raises(RuntimeError, match="did not complete within the lane budget"):
        run_multiplexed([TensorModelAdapter(tm).checker()], lanes=2, device="cpu",
                        chunk=64, queue_capacity=1 << 12, table_capacity=1 << 14)
    with pytest.raises(ValueError, match="raise table_capacity"):
        run_multiplexed([TensorModelAdapter(tm).checker()], lanes=2, device="cpu",
                        chunk=256, table_capacity=1 << 12)
