#!/usr/bin/env python3
"""The per-stage split of the port's device eras (`.stage_profile()`) for
the speed cells, on one card:

    python3 scripts/stage_split.py [--cells 2pc-7 paxos-3 "paxos-3 sim" "2pc-5 symmetry"]
                                   [--iters 32] [--runs N] [--timing spin events]

Each cell runs once without and `--runs` times with the stage profiler,
at the options chip_smoke.py runs it with (2pc-7 at bench.py:798's,
paxos-3 at bench.py:1305-1307's, the paxos-3 simulation with 16,384
walks to 2,000,000 states, 2pc-5 under `.symmetry()` at chunk 64, phase
17's), and prints for each run its unique or generated states, wall
seconds, steps, peak device memory and the telemetry's stage keys
(`phase_ms`: `device_era`, `profiler_overhead`, `stage_*`;
`stage_us_per_step`, `stage_profile_model_pct`). `--timing` names how
the stage programs' dispatches are timed, the profiled runs taking the
timings in turn: `spin` as `obs/stageprof.py time_dispatch` times them
(CUDA events queued with the launch behind a spin kernel, device time
only), `events` with two CUDA events around the launch and no spin (so
the window also holds the host's launch latency wherever the card ran
dry first). Then one summary line a cell and timing (the profiled runs
whose split was empty, every stage at or below the null loop, and each
stage's us a round, min / median / max), and the card's name and power
limit. The first run of a process pays its warm-up.

    python3 scripts/stage_split.py --walls [--trees DIR ...] [--runs N]

splits the walls of the BFS runs (2pc-7 at the bench options, 2pc-10 at
the reference's `2pc check 10` options) outside the stages, under the
default pipeline and under `.pipeline(False)`, for each tree in a fresh
process (to compare two: parent, change, change, parent). The host time
of the era program's calls is taken by wrapping them in that process:
`capture` (the era graph's captures: `EraProgram._capture`), `launch`
(the graph launches and the readback copies queued behind them, the
captures taken off), `readback` (the host blocked in `EraProgram.result`
until a dispatch's state has come back: device time the host did not
hide), `seed` (K10f) and `grow` (K5); `between` is the rest of the wall:
the host between dispatches (the engine's bookkeeping, the sample's
drain, the chain's decisions). Beside them `device_era` (telemetry, as
the engine reports it) and the stage sum (the isolated cost of a step's
stages, `stage_us_per_step` summed, times the steps, from one more run
under `.stage_profile()`). Each cell: one warm-up run, `--runs` timed
runs, one profiled run; one JSON line a run and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cells():
    from stateright_tpu_torch.models import PaxosTensor, PaxosTensorExhaustive, TwoPhaseTensor

    return {
        "2pc-7": (lambda: TwoPhaseTensor(7),
                  lambda b: b.spawn_gpu_bfs(chunk_size=6144, queue_capacity=1 << 20, table_capacity=1 << 22)),
        "paxos-3": (lambda: PaxosTensorExhaustive(3),
                    lambda b: b.spawn_gpu_bfs(chunk_size=16384, queue_capacity=1 << 21, table_capacity=1 << 26)),
        "paxos-3 sim": (lambda: PaxosTensor(3),
                        lambda b: b.target_state_count(2_000_000).spawn_gpu_simulation(
                            0, walks=16384, walk_cap=256)),
        "2pc-5 symmetry": (lambda: TwoPhaseTensor(5),
                           lambda b: b.symmetry().spawn_gpu_bfs(chunk_size=64, queue_capacity=1 << 12,
                                                                table_capacity=1 << 11, sync_steps=4)),
    }


def events_dispatch(program) -> float:
    """A stage program's dispatch between two CUDA events with no spin."""
    import torch

    from stateright_tpu_torch.obs import stageprof

    program.prepare(stageprof.SEED)
    stream = torch.cuda.current_stream(program.device)
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record(stream)
    program.launch()
    t1.record(stream)
    program.read()
    return t0.elapsed_time(t1) / 1e3


WALL_CELLS = {
    "2pc-7": dict(chunk_size=6144, queue_capacity=1 << 20, table_capacity=1 << 22),
    "2pc-10": dict(chunk_size=12288, queue_capacity=1 << 26, table_capacity=1 << 28),
}
WALL_PIPES = ("default", "serial")


def wall_split(tree: str, runs: int) -> list:
    """The wall splits of WALL_CELLS under WALL_PIPES with the port of
    `tree` (see the module doc)."""
    sys.path.insert(0, tree)
    import torch

    from stateright_tpu_torch import TensorModelAdapter, kernels
    from stateright_tpu_torch.engines import era
    from stateright_tpu_torch.models import TwoPhaseTensor

    kernels.build_all()
    spent = {}

    def timed(name, fn):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                spent[name] = spent.get(name, 0.0) + dt
                spent[name + "_calls"] = spent.get(name + "_calls", 0) + 1
                if name == "capture":  # a capture happens inside a launch
                    spent["capture_in_launch"] = spent.get("capture_in_launch", 0.0) + dt
        return wrapper

    P = era.EraProgram
    P._capture = timed("capture", P._capture)
    P.launch = timed("launch", P.launch)
    P.result = timed("readback", P.result)
    P.seed = timed("seed", P.seed)
    P.grow = timed("grow", P.grow)
    out = []
    for label, opts in WALL_CELLS.items():
        n = int(label.split("-")[1])
        for pipe in WALL_PIPES:
            for i in range(runs + 2):  # a warm-up, the timed runs, a profiled run
                prof = i == runs + 1
                b = TensorModelAdapter(TwoPhaseTensor(n)).checker().coverage()
                if pipe == "serial":
                    b = b.pipeline(False)
                if prof:
                    b = b.stage_profile()
                torch.cuda.empty_cache()
                spent.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                c = b.spawn_gpu_bfs(device="cuda", **opts).join()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                tel = c.telemetry()
                launch = spent.get("launch", 0.0) - spent.get("capture_in_launch", 0.0)
                parts = dict(capture=spent.get("capture", 0.0), launch=launch,
                             readback=spent.get("readback", 0.0), seed=spent.get("seed", 0.0),
                             grow=spent.get("grow", 0.0))
                row = dict(tree=os.path.relpath(tree, HERE), cell=label, pipeline=pipe,
                           run="warm-up" if i == 0 else "profiled" if prof else "timed",
                           unique=c.unique_state_count(), wall_secs=wall, **{f"{k}_secs": v for k, v in parts.items()},
                           between_secs=wall - sum(parts.values()), dispatches=spent.get("launch_calls", 0),
                           readbacks=spent.get("readback_calls", 0), captures=spent.get("capture_calls", 0),
                           steps=tel["steps"] + tel.get("partial_steps", 0), eras=tel.get("eras"),
                           device_era_ms=(tel.get("phase_ms") or {}).get("device_era"))
                if prof:
                    us = tel.get("stage_us_per_step") or {}
                    row["stage_us_per_step"] = us
                    row["stage_sum_ms"] = sum(us.values()) * row["steps"] / 1e3
                print(json.dumps(row), flush=True)
                out.append(row)
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--walls", action="store_true")
    ap.add_argument("--trees", nargs="+", default=[HERE])
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--cells", nargs="+", default=["2pc-7", "paxos-3", "paxos-3 sim"])
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--timing", nargs="+", choices=["spin", "events"], default=["spin"])
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("stage_split: needs a CUDA device", file=sys.stderr)
        return 2
    if args.one:
        wall_split(os.path.abspath(args.one), args.runs)
        return 0
    if args.walls:
        for tree in args.trees:
            done = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree, "--runs", str(args.runs)],
                                  text=True, capture_output=True)
            print(done.stdout.strip(), flush=True)
            if done.returncode != 0:
                print(done.stderr[-4000:], file=sys.stderr)
                return done.returncode
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip())
        return 0
    sys.path.insert(0, HERE)
    from stateright_tpu_torch import TensorModelAdapter
    from stateright_tpu_torch.obs import stageprof

    timers = dict(spin=stageprof.time_dispatch, events=events_dispatch)
    table = cells()
    for label in args.cells:
        make, spawn = table[label]
        seen = {t: [] for t in args.timing}
        runs = [(None, False)] + [(args.timing[i % len(args.timing)], True)
                                  for i in range(args.runs * len(args.timing))]
        for timing, prof in runs:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            b = TensorModelAdapter(make()).checker()
            if prof:
                b = b.stage_profile(iters=args.iters)
                stageprof.time_dispatch = timers[timing]
            torch.cuda.synchronize()
            t0 = time.monotonic()
            try:
                c = spawn(b).join()
            finally:
                stageprof.time_dispatch = timers["spin"]
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            tel = c.telemetry()
            out = dict(
                cell=label, stage_profile=prof, timing=timing, states=c.unique_state_count(), wall_secs=wall,
                steps=tel["steps"], steps_run=tel.get("steps_run"),
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                phase_ms=tel.get("phase_ms"), stage_us_per_step=tel.get("stage_us_per_step"),
                stage_profile_model_pct=tel.get("stage_profile_model_pct"),
                stage_profile_error=tel.get("stage_profile_error"),
            )
            print(json.dumps(out), flush=True)
            if prof:
                seen[timing].append(out)
        for timing, outs in seen.items():
            if not outs:
                continue
            empty = sum(1 for o in outs if not any(k.startswith("stage_") for k in o["phase_ms"]))
            us = {}
            for o in outs:
                for name, v in (o["stage_us_per_step"] or {}).items():
                    us.setdefault(name, []).append(v)
            spread = {name: [min(v), statistics.median(v), max(v)] for name, v in us.items()}
            print(json.dumps(dict(cell=label, timing=timing, profiled_runs=len(outs), empty_splits=empty,
                                  stage_us_min_median_max=spread)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
