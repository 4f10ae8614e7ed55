"""The port's speclint (stateright_tpu_torch.analysis) against the JAX
package's (stateright_tpu.analysis) on the CPU: the same sampled rows and
findings on the bundled models, each JAX fixture's code from its port copy,
the divergences only the port's int64 lanes have, the agreement table's
plain version (K16a) against the JAX comparison loop, the builder's
`.lint()` / `.strict()` on every engine, and the CLI.

The port runs its lane programs with `device="cpu"`: on meta lanes for
their structure and eagerly for their values (analysis/probe.py). The JAX
side runs without its `program` family (STR6xx), which the port has not
ported yet.
"""

import random

import numpy as np
import pytest
import torch

import stateright_tpu.analysis as jax_analysis
import stateright_tpu.models as jax_models
import stateright_tpu.models.paxos as jax_paxos
import stateright_tpu_torch.models as torch_models
import test_speclint as jax_fixtures
import torch_lint_fixtures as fx
from stateright_tpu.analysis import sampling as jax_sampling
from stateright_tpu.tensor import TensorModel as JaxTensorModel
from stateright_tpu.tensor import TensorModelAdapter as JaxAdapter
from stateright_tpu_torch import SpecLintError, TensorModelAdapter, analyze, kernels
from stateright_tpu_torch.analysis import sampling
from stateright_tpu_torch.analysis.__main__ import main
from stateright_tpu_torch.engines.common import HostEngineBase
from stateright_tpu_torch.ops.agree import agree, agree_plain, read_table
from torch_parity import OPTS, one_torch_thread, reference_uncached  # noqa: F401

JAX_FAMILIES = ("determinism", "device", "properties", "symmetry", "spawn")


def jax_model(name, *args):
    return (getattr(jax_models, name, None) or getattr(jax_paxos, name))(*args)


def error_codes(report):
    return {d.code for d in report.errors}


def keys(report):
    return [(d.code, d.severity.value, d.location) for d in report.diagnostics]


# -- parity on the bundled models ----------------------------------------------

MODELS = [
    ("TwoPhaseTensor", (3,)),
    ("TwoPhaseTensor", (5,)),  # has representative_lanes: the symmetry family runs
    ("PaxosTensorExhaustive", (2,)),
    ("AbdTensor", (2,)),
    ("AbdOrderedTensor", (2,)),
    ("IncrementTensor", (2,)),
    ("IncrementLockTensor", (2,)),
    ("SingleCopyTensor", (2, 1)),
]


@pytest.mark.parametrize("name,args", MODELS, ids=[f"{n}{a}" for n, a in MODELS])
def test_analyze_matches_jax(name, args):
    ref = jax_analysis.analyze(jax_model(name, *args), families=JAX_FAMILIES)
    ours = analyze(getattr(torch_models, name)(*args), device="cpu")
    rows_ref = jax_sampling.sample_states(JaxAdapter(jax_model(name, *args)), 256).states
    rows = sampling.sample_states(TensorModelAdapter(getattr(torch_models, name)(*args)), 256).states
    assert rows == rows_ref
    assert ours.sample.to_dict() == ref.sample.to_dict()
    assert ours.families_run == ref.families_run
    assert keys(ours) == keys(ref)
    # Host families: the message too (the device family's speak of the port).
    host = [(d.code, d.message) for d in ours.diagnostics if not d.code.startswith("STR2")]
    assert host == [(d.code, d.message) for d in ref.diagnostics if not d.code.startswith("STR2")]
    assert ours.to_dict()["counts_by_code"] == ref.to_dict()["counts_by_code"]


def test_cpu_probes_capture_nothing():
    """On the CPU the lane programs run on meta lanes and eagerly: 2pc-5's
    device and symmetry probes capture no graph; the symmetry family ran
    both halves and found nothing."""
    ours = analyze(torch_models.TwoPhaseTensor(5), device="cpu")
    assert "symmetry" in ours.families_run and not ours.by_code("STR404")
    assert ours.probes == {"captures": 0, "capture_secs": 0.0, "graph_launches": 0}  # no card here


# -- the JAX fixtures and their port copies ------------------------------------

FIXTURES = [
    # (JAX fixture in tests/test_speclint.py, the port's copy, JAX codes, port codes)
    ("RngActionsModel", fx.RngActionsModel, {"STR101"}, {"STR101"}),
    ("MutatingModel", fx.MutatingModel, {"STR103"}, {"STR103"}),
    ("RngNextStateModel", fx.RngNextStateModel, {"STR102", "STR101"}, {"STR102", "STR101"}),
    ("UnfingerprintableModel", fx.UnfingerprintableModel, {"STR104"}, {"STR104"}),
    ("OverflowPackTensor", fx.OverflowPackTensor, {"STR207"}, {"STR207"}),
    ("UntraceableTensor", fx.UntraceableTensor, {"STR201"}, {"STR201"}),
    ("BadMaskTensor", fx.BadMaskTensor, {"STR202"}, {"STR202"}),
    ("BadDecodeTensor", fx.BadDecodeTensor, {"STR204"}, {"STR204"}),
    ("DupPropsModel", fx.DupPropsModel, {"STR301"}, {"STR301"}),
    ("RaisingPropModel", fx.RaisingPropModel, {"STR302"}, {"STR302"}),
    ("NonIdempotentRepModel", fx.NonIdempotentRepModel, {"STR402"}, {"STR402"}),
    ("PropChangingRepModel", fx.PropChangingRepModel, {"STR403"}, {"STR403"}),
    # The JAX fixture's int64 product agrees on int64 lanes; the port's
    # copy diverges on the port's own lane type (torch_lint_fixtures.py).
    ("DivergentRepTensor", fx.DivergentRepTensor, {"STR404", "STR402"}, {"STR404"}),
]


@pytest.mark.parametrize("jax_name,port_cls,jax_codes,port_codes", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_fixture_raises_its_code_in_both(jax_name, port_cls, jax_codes, port_codes):
    random.seed(0xC0FFEE)  # the RNG fixtures: a fixed draw (tests/test_speclint.py:326)
    ref = jax_analysis.analyze(getattr(jax_fixtures, jax_name)(), families=JAX_FAMILIES)
    random.seed(0xC0FFEE)
    ours = analyze(port_cls(), device="cpu")
    assert error_codes(ref) & jax_codes, ref.format()
    assert error_codes(ours) & port_codes, ours.format()
    assert not ours.ok


class WrapShiftJax(fx.WrapShiftBody, JaxTensorModel):
    pass


class WrapRepJax(fx.WrapRepBody, JaxTensorModel):
    pass


@pytest.mark.parametrize("port_cls,jax_cls,code", [
    (fx.WrapShiftTensor, WrapShiftJax, "STR205"),
    (fx.WrapRepTensor, WrapRepJax, "STR404"),
], ids=["step_lanes", "representative_lanes"])
def test_int64_lane_divergence_only_in_the_port(port_cls, jax_cls, code):
    """`(lane - 1) >> 1` on a zero lane: numpy and jax agree in uint32
    (0x7FFFFFFF), the port's int64 lane gives 0xFFFFFFFF."""
    ref = jax_analysis.analyze(jax_cls(), families=JAX_FAMILIES)
    ours = analyze(port_cls(), device="cpu")
    assert ref.ok and not ref.by_code(code), ref.format()
    assert error_codes(ours) == {code}, ours.format()
    assert ours.sample.to_dict() == ref.sample.to_dict()


def test_card_fixtures_give_their_codes_here():
    """Every fixture chip_smoke.py holds on the card gives its code here."""
    for cls, code in fx.CARD_FIXTURES:
        assert code in error_codes(analyze(cls(), device="cpu")), cls.__name__


# -- the agreement table (K16a's plain version) ----------------------------------


def jax_loop_first(host, hmask, dev, dmask):
    """The JAX comparison loop (analysis/device.py:360-393) in numpy: for
    each action the masks, then each lane on the valid rows; returns
    (action, lane or None, batch row) of the first finding, or None."""
    A, S, _B = host.shape
    for a in range(A):
        if not np.array_equal(hmask[a], dmask[a]):
            return a, None, int(np.nonzero(hmask[a] != dmask[a])[0][0])
        valid = np.nonzero(hmask[a])[0]
        for s in range(S):
            nl = host[a, s][valid]
            jl = (dev[a, s] & 0xFFFFFFFF)[valid]
            if not np.array_equal(nl, jl):
                return a, s, int(valid[np.nonzero(nl != jl)[0][0]])
    return None


def _table_case(seed, A, S, B, plant):
    rng = np.random.default_rng(seed)
    host = rng.integers(0, 1 << 32, size=(A, S, B), dtype=np.uint64).astype(np.uint32)
    hmask = rng.random((A, B)) < 0.6
    # The card's lanes carry high bits, which the 32-bit compare ignores.
    dev = host.astype(np.int64) + (rng.integers(0, 3, size=(A, S, B)) << 32)
    dev[rng.random((A, S, B)) < 0.1] -= 1 << 32
    dmask = hmask.copy()
    for kind, a, s, b in plant:
        if kind == "mask":
            dmask[a, b] = not dmask[a, b]
        else:
            dev[a, s, b] ^= 1 << (b % 32)
    return host, hmask, dev, dmask


CASES = [
    (0, 3, 4, 100, []),
    (1, 3, 4, 100, [("lane", 1, 2, 57), ("lane", 2, 0, 3)]),
    (2, 3, 4, 100, [("lane", 0, 3, 99), ("mask", 0, 0, 98)]),
    (3, 5, 2, 300, [("mask", 4, 0, 0), ("lane", 4, 1, 0)]),
    (4, 1, 7, 1, [("lane", 0, 6, 0)]),
    (5, 21, 30, 64, [("lane", 20, 29, 63)]),
]


@pytest.mark.parametrize("seed,A,S,B,plant", CASES)
def test_agree_plain_matches_the_jax_loop(seed, A, S, B, plant):
    host, hmask, dev, dmask = _table_case(seed, A, S, B, plant)
    want = jax_loop_first(host, hmask, dev, dmask)
    table = agree(torch.from_numpy(dev), torch.from_numpy(dmask), torch.from_numpy(host),
                  torch.from_numpy(hmask))
    assert table.dtype == torch.int32 and table.shape == (3 * A + A * S,)
    got = read_table(table.numpy(), A, S, B)
    assert (None if got is None else (got.action, got.lane, got.row)) == want
    counts = table.numpy()[:2 * A]
    assert counts.tolist() == dmask.sum(1).tolist() + hmask.sum(1).tolist()
    if not plant:
        assert want is None and (table.numpy()[2 * A:] == -1).all()


def test_agree_plain_every_first_row():
    """Each (action, lane) word is the first row valid on both sides whose
    low 32 bits differ, whatever comes before it in the walk."""
    host, hmask, dev, dmask = _table_case(9, 4, 3, 200, [("lane", a, s, 7 * a + 11 * s)
                                                           for a in range(4) for s in range(3)])
    table = agree_plain(torch.from_numpy(dev), torch.from_numpy(dmask),
                        torch.from_numpy(host), torch.from_numpy(hmask)).numpy()
    for a in range(4):
        for s in range(3):
            bad = hmask[a] & dmask[a] & ((dev[a, s] & 0xFFFFFFFF) != host[a, s])
            want = int(np.nonzero(bad)[0][0]) if bad.any() else -1
            assert table[12 + a * 3 + s] == want


# -- builder, strict mode, telemetry ------------------------------------------------

BROKEN = [fx.OverflowPackTensor, fx.WrapShiftTensor, fx.UntraceableTensor]
SPAWNS = {
    "bfs": lambda b: b.spawn_gpu_bfs(device="cpu", **OPTS),
    "simulation": lambda b: b.spawn_gpu_simulation(1, device="cpu", walks=16, walk_cap=8),
    "sharded": lambda b: b.spawn_sharded_bfs(devices=2, device="cpu", chunk_size=16),
}


@pytest.mark.parametrize("engine", sorted(SPAWNS))
@pytest.mark.parametrize("cls", BROKEN, ids=[c.__name__ for c in BROKEN])
def test_strict_refuses_before_any_launch(monkeypatch, engine, cls):
    started = []
    monkeypatch.setattr(HostEngineBase, "_start", lambda self: started.append(self))
    before = kernels.launch_counts()
    with pytest.raises(SpecLintError) as exc:
        SPAWNS[engine](TensorModelAdapter(cls()).checker().strict())
    assert not started and kernels.launch_counts() == before
    assert exc.value.report.errors


def test_strict_2pc5_reaches_golden_with_jax_lint_telemetry():
    from stateright_tpu.models import TwoPhaseTensor as JaxTwoPhase

    ours = TensorModelAdapter(torch_models.TwoPhaseTensor(5)).checker().strict().spawn_gpu_bfs(
        device="cpu", **OPTS).join()
    ref = JaxAdapter(JaxTwoPhase(5)).checker().strict().spawn_tpu_bfs(**OPTS).join()
    assert ours.unique_state_count() == ref.unique_state_count() == 8_832

    def lint(tel):
        return {k: v for k, v in tel.items() if k.startswith("lint_") and not k.startswith("lint_STR6")}

    assert lint(ours.telemetry()) == lint(ref.telemetry())
    assert lint(ours.telemetry())["lint_errors"] == 0 and "lint_STR303" in ours.telemetry()


def test_builder_lint_and_telemetry():
    builder = TensorModelAdapter(torch_models.IncrementTensor(2)).checker()
    report = builder.lint(samples=64, device="cpu")
    assert report.ok and builder.lint_report_ is report
    c = builder.spawn_gpu_bfs(device="cpu", **OPTS).join()
    assert c.telemetry()["lint_errors"] == 0 and c.unique_state_count() == 13
    # Without lint() or strict(), no pre-flight runs and no lint keys appear.
    plain = TensorModelAdapter(torch_models.IncrementTensor(2)).checker().spawn_gpu_bfs(
        device="cpu", **OPTS).join()
    assert not [k for k in plain.telemetry() if k.startswith("lint_")]


def test_host_model_lint_and_program_family_not_ported():
    random.seed(0xC0FFEE)
    report = fx.RngActionsModel().checker().lint()  # no lane programs: no device needed
    assert "STR101" in error_codes(report)
    with pytest.raises(SpecLintError, match="STR101"):
        report.raise_on_errors()
    with pytest.raises(NotImplementedError, match="slice 6c"):
        analyze(torch_models.IncrementTensor(2), families=("program",), device="cpu")
    with pytest.raises(ValueError, match="unknown rule families"):
        analyze(torch_models.IncrementTensor(2), families=("nonsense",), device="cpu")


def test_report_format_and_dict_round_trip():
    report = analyze(fx.DupPropsModel())
    d = report.to_dict()
    assert d["ok"] is False and d["counts_by_code"].get("STR301", 0) >= 1
    assert "STR301" in report.format()
    assert any(x["severity"] == "error" for x in d["diagnostics"])
    assert "STR301" in str(SpecLintError(report))


# -- the CLI -----------------------------------------------------------------------


def test_cli_exit_codes(capsys):
    assert main(["increment:2", "--samples", "64", "--device", "cpu"]) == 0
    assert "IncrementTensor" in capsys.readouterr().out
    assert main(["tests.torch_lint_fixtures:DupPropsModel", "--json", "--device", "cpu"]) == 1
    assert "STR301" in capsys.readouterr().out
    # A warning alone fails only under --strict.
    assert main(["tests.torch_lint_fixtures:NoPropsModel", "--device", "cpu"]) == 0
    assert main(["tests.torch_lint_fixtures:NoPropsModel", "--device", "cpu", "--strict"]) == 1
    assert main(["tests.torch_lint_fixtures:WrapShiftTensor", "--device", "cpu"]) == 1
    assert "STR205" in capsys.readouterr().out
    for usage in (["2pc:3", "--program"], ["2pc:3", "--write-budgets"],
                  ["2pc:3", "--families", "program"], ["2pc:3", "--families", "nonsense"]):
        assert main(usage + ["--device", "cpu"]) == 2
    assert "slice 6c" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        main(["no-such-model", "--device", "cpu"])
    assert exc.value.code == 2
    if not torch.cuda.is_available():
        assert main(["2pc:3"]) == 2  # no card and no --device cpu
