"""The speclint probes held against the kernels the engines run (K16 with
K11 and K11c), on the CPU.

On the card a model on the kernel route runs no `xp` code in a check: the
engines launch its K11 kernel (and, for 2PC under symmetry, K11c). So
STR205 and STR404 also hold numpy against one launch of that kernel's
WALK entry (and of the canon) on the sampled rows. Here there is no card:
the harness (tests/torch_expand_host.py) runs the same model headers with
g++, and its WALK and canon outputs on the rows `analyze` samples are fed
to the agreement checks the card path calls (`device.kernel_agreement`,
`symmetry.canon_agreement`): they find nothing, and with one successor
lane, one mask bit or one canon lane changed they report STR205 (STR404)
at that action, lane and row, naming the kernel's source. The selection
rule names the kernel for every kernel-route model on "cuda" without
building or launching anything, and none on the CPU or for a subclass.
"""

import numpy as np
import pytest
import torch
from torch_expand_host import build_harness, host_canon, host_walk

import stateright_tpu.models as jax_models
import stateright_tpu_torch.models as torch_models
from stateright_tpu_torch import TensorModelAdapter, analyze, kernels
from stateright_tpu_torch.analysis import device as device_rules
from stateright_tpu_torch.analysis import probe, sampling
from stateright_tpu_torch.analysis import symmetry as symmetry_rules
from stateright_tpu_torch.analysis.diagnostics import AnalysisReport

MODELS = [
    ("TwoPhaseTensor", (3,), "WALK_2PC"),
    ("PaxosTensor", (2,), "WALK_PAXOS"),
    ("AbdTensor", (2,), "WALK_ABD"),
    ("AbdOrderedTensor", (2,), "WALK_ABD"),
    ("IncrementTensor", (2,), "WALK_INCREMENT"),
    ("IncrementLockTensor", (3,), "WALK_INCREMENT_LOCK"),
    ("SingleCopyTensor", (3, 2), "WALK_SINGLE_COPY"),
]
IDS = [f"{n}{a}" for n, a, _k in MODELS]


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return build_harness(tmp_path_factory.mktemp("analysis_kernel_host"))


def sampled_rows(tm):
    """The [B, S] uint32 rows the device family runs on (analysis/__init__.py)."""
    states = sampling.sample_states(TensorModelAdapter(tm), 256).states[:128]
    return np.asarray(states, dtype=np.uint32)


def walk_case(harness, name, args):
    tm = getattr(torch_models, name)(*args)
    rows = sampled_rows(tm)
    S, A = tm.state_width, tm.max_actions
    np_out = tm.step_lanes(np, tuple(np.ascontiguousarray(rows[:, s]) for s in range(S)))
    _checks, valid, succ = host_walk(harness, getattr(jax_models, name)(*args), rows.T.copy())
    return tm, rows, np_out, valid, succ, S, A


def findings(tm, kern, valid, succ, np_out, S, A):
    report = AnalysisReport(type(tm).__name__)
    device_rules.kernel_agreement(tm, kern, torch.from_numpy(valid), torch.from_numpy(succ), np_out,
                                  report, S, A)
    return report.diagnostics


@pytest.mark.parametrize("name,args,kern", MODELS, ids=IDS)
def test_harness_walk_agrees_with_numpy(harness, name, args, kern):
    tm, rows, np_out, valid, succ, S, A = walk_case(harness, name, args)
    assert valid.any() and rows.shape[0] > 1
    assert findings(tm, getattr(kernels, kern), valid, succ, np_out, S, A) == []


@pytest.mark.parametrize("name,args,kern", MODELS, ids=IDS)
def test_a_changed_successor_lane_gives_str205_there(harness, name, args, kern):
    tm, rows, np_out, valid, succ, S, A = walk_case(harness, name, args)
    rng = np.random.default_rng(len(name) + sum(args))
    acts, cols = np.nonzero(valid)
    pick = rng.integers(len(acts))
    a, i, s = int(acts[pick]), int(cols[pick]), int(rng.integers(S))
    succ[a, s, i] ^= 1 << int(rng.integers(32))
    diags = findings(tm, getattr(kernels, kern), valid, succ, np_out, S, A)
    assert [(d.code, d.severity.value) for d in diags] == [("STR205", "error")]
    msg = diags[0].message
    assert f"action {a} lane {s} differs" in msg and f"batch row {i}:" in msg
    assert f"kernels/csrc/{getattr(kernels, kern).source}" in msg
    assert diags[0].location == f"{name}.step_lanes"


@pytest.mark.parametrize("name,args,kern", MODELS, ids=IDS)
def test_a_changed_mask_bit_gives_str205_there(harness, name, args, kern):
    tm, rows, np_out, valid, succ, S, A = walk_case(harness, name, args)
    rng = np.random.default_rng(3 * len(name) + sum(args))
    a, i = int(rng.integers(A)), int(rng.integers(rows.shape[0]))
    valid[a, i] = not valid[a, i]
    diags = findings(tm, getattr(kernels, kern), valid, succ, np_out, S, A)
    assert [d.code for d in diags] == ["STR205"]
    msg = diags[0].message
    assert f"action {a} validity mask differs" in msg and f"first at batch row {i})" in msg
    assert getattr(kernels, kern).source in msg


@pytest.mark.parametrize("n", [3, 5])
def test_harness_canon_agrees_and_a_changed_lane_gives_str404(harness, n):
    tm = torch_models.TwoPhaseTensor(n)
    rows = sampled_rows(tm)
    lanes = tuple(np.ascontiguousarray(rows[:, s]) for s in range(3))
    rep_np = tuple(np.asarray(l, dtype=np.uint32) for l in tm.representative_lanes(np, lanes))
    out = torch.from_numpy(host_canon(harness, n, rows.T.copy()))
    report = AnalysisReport("TwoPhaseTensor")
    symmetry_rules.canon_agreement(tm, kernels.CANON_2PC, out, rep_np, report)
    assert report.diagnostics == []
    i = rows.shape[0] // 2
    out[2, i] ^= 4
    symmetry_rules.canon_agreement(tm, kernels.CANON_2PC, out, rep_np, report)
    assert [d.code for d in report.diagnostics] == ["STR404"]
    msg = report.diagnostics[0].message
    assert f"on lane 2 (batch row {i}:" in msg and "kernels/csrc/canon_2pc.cu" in msg


class SingleCopySub(torch_models.SingleCopyTensor):
    pass


def test_probe_selection_launches_nothing(monkeypatch):
    def no_build(*_a, **_k):
        raise AssertionError("the selection rule built a kernel")

    monkeypatch.setattr(kernels, "build_all", no_build)
    before = kernels.launch_counts()
    for name, args, kern in MODELS:
        tm = getattr(torch_models, name)(*args)
        assert probe.kernel_probe(tm, "cuda") is getattr(kernels, kern)
        assert probe.kernel_probe(tm, torch.device("cuda", 0)) is getattr(kernels, kern)
        assert probe.kernel_probe(tm, "cpu") is None
        assert probe.canon_probe(tm, "cuda") is (kernels.CANON_2PC if name == "TwoPhaseTensor" else None)
        assert probe.canon_probe(tm, "cpu") is None
    assert probe.kernel_probe(SingleCopySub(3, 2), "cuda") is None
    other = torch_models.IncrementLockTensor(2)
    other.step_lanes = lambda xp, lanes: torch_models.IncrementLockTensor.step_lanes(other, xp, lanes)
    assert probe.kernel_probe(other, "cuda") is None
    assert kernels.launch_counts() == before


def test_cpu_analyze_runs_no_kernel_probe(monkeypatch):
    def no_kernel(*_a, **_k):
        raise AssertionError("a kernel probe ran on the CPU")

    monkeypatch.setattr(device_rules, "run_kernel", no_kernel)
    monkeypatch.setattr(symmetry_rules, "run_kernel", no_kernel)
    for tm in (torch_models.SingleCopyTensor(2, 2), torch_models.TwoPhaseTensor(3)):
        report = analyze(tm, device="cpu")
        assert "kernels" not in report.probes
