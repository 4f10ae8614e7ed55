"""Per-stage era profiling: isolated stage programs and the attribution
of the era time (the port's copy of `stateright_tpu/obs/stageprof.py`).

The device engines run their search inside eras — on the card one CUDA
graph launch an era, thousands of steps — so no host timer sits inside
a step. What is measured instead is each stage alone, at the widths the
era runs: the engines build one stage program a stage (engines/
stages.py) that repeats that stage `iters` times, each round chained to
the last through an accumulator so that no round can be skipped, behind
one dispatch. The null program, the same loop with no stage in it,
measures what every dispatch pays regardless of its work (the launch,
the loop's own kernel and node scheduling a round, the readback), and
is taken off.

Attribution is PROPORTIONAL: the isolated per-step stage costs give each
stage's share, and those shares scale the run's measured `device_era`
time, so the reported `stage_*` phase timers sum to the era total by
construction, while the raw isolated costs stay visible in the
`stage_us_per_step` gauge. The `stage_profile_model_pct` gauge reports
how much of the measured era time the isolated-stage cost model predicts
(per-step sum x steps / era time): near 100 means the stages account for
the era; far below means per-step costs outside the stages (the era's
gate and commit kernels, graph node scheduling of the step's launches,
the readbacks) dominate; far above means the stages run slower alone
than inside the era.
"""

from __future__ import annotations

import time
from typing import Dict, Mapping

import torch

# Canonical display order for the per-stage breakdown (engines populate
# the subset their architecture has; e.g. `canon` only under symmetry,
# the walk stages only on the simulation engine; `exchange` only on the
# sharded engine, parallel/mesh.py).
STAGE_ORDER = (
    "expand",
    "hash",
    "probe",
    "claim",
    "compact",
    "ring",
    "canon",
    "exchange",
    "cycle",
    "choose",
    "record",
)


SEED = 1  # the accumulator's start, as the JAX engines seed their kernels

SPIN_S = 1e-3  # the spin a dispatch is queued behind on the card, doubled while too short
SPIN_CYCLES_PER_S = 2e9  # torch.cuda._sleep's unit: SM clock cycles (the card's is under 2 GHz)


def time_dispatch(program) -> float:
    """Seconds of one dispatch of a stage program: its launch and the
    readback of its accumulator. Its state is forked afresh first, outside
    the window. For a program that runs as one graph on the card the
    window is two CUDA events on the launch stream, queued with the launch
    behind a spin kernel that outlasts the host's queueing, so the window
    holds device time only (without it a program whose fork leaves the
    card idle, the null program first, would also pay the host's launch
    latency). A program whose host runs the rounds (on the CPU, or eager
    on the card: a round with a collective across ranks) waits for the
    card inside its launch, so a spin would only lengthen the launch, and
    double, without end; it is timed on the host's clock."""
    if program.as_graph:
        stream = torch.cuda.current_stream(program.device)
        spin_s = SPIN_S
        while True:
            program.prepare(SEED)
            spin, t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
            spin.record(stream)
            torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
            h = time.perf_counter()
            t0.record(stream)
            program.launch()
            t1.record(stream)
            queued_ms = (time.perf_counter() - h) * 1e3
            program.read()
            if queued_ms < spin.elapsed_time(t0):
                return t0.elapsed_time(t1) / 1e3
            spin_s *= 2
    program.prepare(SEED)
    if program.device.type == "cuda":
        torch.cuda.synchronize(program.device)  # the fork stays out of the window
    t = time.perf_counter()
    program.launch()
    program.read()
    return time.perf_counter() - t


def measure_stage_programs(programs: Mapping, null, iters: int, repeats: int = 2) -> Dict[str, float]:
    """Time each stage program; returns per-ROUND seconds per stage, with
    the null program's dispatch taken off (floored at 0). Every program
    first takes one warm dispatch (on the card its graph's capture is
    paid there), all of them before any is timed, so that the null
    program is not timed on a card that was idle; then each takes the
    best of `repeats`."""
    for p in [null, *programs.values()]:
        time_dispatch(p)

    def best(p) -> float:
        return min(time_dispatch(p) for _ in range(max(1, repeats)))

    base = best(null)
    return {name: max(0.0, best(p) - base) / max(1, iters) for name, p in programs.items()}


def attribute_stages(
    metrics,
    per_step_secs: Dict[str, float],
    era_secs: float,
    steps: int,
    iters: int,
) -> Dict[str, float]:
    """Record the breakdown into the metrics registry as `stage_<name>`
    phase timers scaled so their sum equals `era_secs` exactly, plus the
    raw-measurement gauges. Returns the scaled seconds per stage."""
    total = sum(per_step_secs.values())
    scaled: Dict[str, float] = {}
    if total > 0.0 and era_secs > 0.0:
        for name, secs in per_step_secs.items():
            share = era_secs * (secs / total)
            metrics.add_phase("stage_" + name, share)
            scaled["stage_" + name] = share
    metrics.set_gauge("stage_profile_iters", int(iters))
    metrics.set_gauge(
        "stage_us_per_step",
        {k: round(v * 1e6, 3) for k, v in per_step_secs.items()},
    )
    if steps and era_secs > 0.0:
        metrics.set_gauge(
            "stage_profile_model_pct",
            round(100.0 * total * steps / era_secs, 1),
        )
    return scaled


def stage_rows(phase_ms: Dict[str, float]):
    """(name, ms) rows for every populated stage phase, in STAGE_ORDER
    then alphabetically for any stage this module doesn't know."""
    rows = []
    seen = set()
    for name in STAGE_ORDER:
        key = "stage_" + name
        if key in phase_ms:
            rows.append((name, phase_ms[key]))
            seen.add(key)
    for key in sorted(phase_ms):
        if key.startswith("stage_") and key not in seen:
            rows.append((key[len("stage_"):], phase_ms[key]))
    return rows
