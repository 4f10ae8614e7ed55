#!/usr/bin/env python3
"""Wall times of the port's headline runs on the card, to hold checkouts
of the port against each other within one call.

    python3 scripts/solo_walls.py [--trees DIR ...] [--reps N] [--full]
                                  [--cells NAME ...] [--profile]

For each tree, in the order given (to compare two: parent, change,
change, parent), a fresh process imports `stateright_tpu_torch` from
that tree, builds its kernels, then runs each cell once to warm up and
N times timed (2pc-10 once, unwarmed). The cells (`--cells`, by name or
group; default `bfs`):

  bfs    2pc-7 at the bench options (bench.py:798), paxos-3 at
         bench.py:1305-1307's options and, with --full, 2pc-10 at the
         reference's `2pc check 10` options, sampling and coverage on,
         each at its golden unique count;
  sim    paxos-3 simulation (seed 0, 16,384 walks, walk_cap 256, eras of
         64 steps) to 2,000,000 generated states, 2pc-10 simulation
         (seed 0, 65,536 walks, walk_cap 256, eras of 64) to 20,000,000,
         and increment-2's time to its "fin" counterexample (seed 7, 256
         walks, walk_cap 32; the JAX bench's run);
  lanes  the 1,024-lane 2pc-5 sweep (lane i at target_max_depth
         1 + i % 18, the default lane shape), 256 lanes of paxos-2
         (table 2^17, ring 2^14) and 32 lanes of increment-2, each lane
         at its solo golden count;
  mesh   2pc-7 and paxos-3 at 8 shards on one card (`chip_smoke.py`
         phase 18's options), each at its golden unique count; a step
         is a lockstep step, one exchange launch. `2pc-10 x8` (by name:
         2pc-10 at 8 shards, phase 18's options, 15.8 GB) is not in the
         group.

A simulation cell's result (states, steps, eras, max depth and the
discoveries) and a lane cell's per-lane counts are printed with it:
`--trees` runs of one cell must agree (the script checks it). With
--profile each cell then runs in a fresh process, once to warm up and
once measured under torch.profiler (2pc-10: its first 4,000,000 states;
the others whole), for the measured run's device
busy share, device kernels and host launch calls a step: one profiler
session a process, which also traces a lane cell's warm-up, since a
graph captured before the session started loses its kernel records. Prints one JSON line a
tree: the walls in seconds, the steps, the wall per step, the graph
captures, their seconds and the host readbacks where the tree reports
them, the peak memory, the busy shares, and the card's name and power
limit; then, for two or more trees, one line of the cells' agreement.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUNS = {
    # label: (model class, its argument, options, golden unique count)
    "2pc-7": ("TwoPhaseTensor", 7, dict(chunk_size=6144, queue_capacity=1 << 20, table_capacity=1 << 22), 296_448),
    "paxos-3": ("PaxosTensorExhaustive", 3, dict(chunk_size=16384, queue_capacity=1 << 21, table_capacity=1 << 26),
                1_194_428),
    "2pc-10": ("TwoPhaseTensor", 10, dict(chunk_size=12288, queue_capacity=1 << 26, table_capacity=1 << 28),
               61_515_776),
}
# The profiled run's generated-states target where it is shorter than
# the timed one: 2pc-10's first 4,000,000 states. The paxos-3 simulation
# is profiled whole: the illegal address inside the profiler's stop that
# its ~490,000 kernel records a run once raised was not seen again once
# K11's WALK made its model step one launch (ROADMAP Queue 3).
PROFILE_TARGETS = {"2pc-10": 4_000_000}

# label: (model class, its argument, seed, options, generated-states
# target or None, finish-on-any property or None, safety properties that
# must never be discovered)
SIMS = {
    "paxos-3 sim": ("PaxosTensor", 3, 0, dict(walks=16384, walk_cap=256, sync_steps=64), 2_000_000, None,
                    ("linearizable", "network within capacity", "ballot rounds within range")),
    "2pc-10 sim": ("TwoPhaseTensor", 10, 0, dict(walks=65536, walk_cap=256, sync_steps=64), 20_000_000, None,
                   ("consistent",)),
    "increment-2 ttc": ("IncrementTensor", 2, 7, dict(walks=256, walk_cap=32), None, "fin", ()),
}

LANE_SHAPE = dict(chunk=256, queue_capacity=1 << 13, table_capacity=1 << 16)
# label: (model class, its argument, lanes, shape, configure(i, builder),
# golden unique count of lane i or None)
LANES = {
    "2pc-5 sweep": ("TwoPhaseTensor", 5, 1024, LANE_SHAPE, lambda i, b: b.target_max_depth(1 + i % 18),
                    lambda i: 8_832 if i % 18 == 17 else None),
    "paxos-2 sweep": ("PaxosTensor", 2, 256, dict(table_capacity=1 << 17, queue_capacity=1 << 14),
                      lambda i, b: b, lambda i: 16_668),
    "increment-2 lanes": ("IncrementTensor", 2, 32, LANE_SHAPE, lambda i, b: b, lambda i: 13),
}
# label: (model class, its argument, shards on one card, options, golden
# unique count): chip_smoke.py phase 18's runs at 8 shards.
MESHES = {
    "2pc-7 x8": ("TwoPhaseTensor", 7, 8,
                 dict(chunk_size=1024, queue_capacity_per_shard=1 << 17, table_capacity_per_shard=1 << 18), 296_448),
    "paxos-3 x8": ("PaxosTensorExhaustive", 3, 8,
                   dict(chunk_size=2048, queue_capacity_per_shard=1 << 18, table_capacity_per_shard=1 << 20),
                   1_194_428),
    "2pc-10 x8": ("TwoPhaseTensor", 10, 8,
                  dict(chunk_size=1024, queue_capacity_per_shard=1 << 23, table_capacity_per_shard=1 << 25),
                  61_515_776),
}
GROUPS = {"bfs": ["2pc-7", "paxos-3"], "sim": list(SIMS), "lanes": list(LANES), "mesh": ["2pc-7 x8", "paxos-3 x8"]}


def _digest(lanes) -> list:
    """A lane cell's per-lane counts, short: their sums and a digest."""
    return [sum(lanes[0]), sum(lanes[1]), hashlib.sha256(json.dumps(lanes).encode()).hexdigest()[:16]]


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]


def _setup(tree: str):
    """Import the port from `tree` and build its kernels; returns (torch,
    run(label, target=None) -> dict of the run's numbers and result)."""
    sys.path.insert(0, tree)
    import torch

    from stateright_tpu_torch import TensorModelAdapter, kernels, models

    kernels.build_all()

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        return out, time.monotonic() - t0, torch.cuda.max_memory_allocated()

    def bfs(label, target):
        cls, n, opts, golden = RUNS[label]
        b = TensorModelAdapter(getattr(models, cls)(n)).checker().coverage()
        if target is not None:
            b = b.target_state_count(target)
        c, secs, peak = timed(lambda: b.spawn_gpu_bfs(device="cuda", **opts).join())
        if target is None and c.unique_state_count() != golden:
            raise AssertionError(f"{label}: {c.unique_state_count()} != {golden}")
        tel = c.telemetry()
        return dict(secs=secs, steps=tel["steps"] + tel.get("partial_steps", 0),
                    capture_secs=tel.get("capture_secs"), graph_captures=tel.get("graph_captures"),
                    peak=peak, result=c.unique_state_count())

    def sim(label, target):
        from stateright_tpu_torch.has_discoveries import HasDiscoveries

        cls, n, seed, opts, goal, fin, safety = SIMS[label]
        b = TensorModelAdapter(getattr(models, cls)(n)).checker()
        if target is not None or goal is not None:
            b = b.target_state_count(target or goal)
        if fin is not None:
            b = b.finish_when(HasDiscoveries.any_of([fin]))
        c, secs, peak = timed(lambda: b.spawn_gpu_simulation(seed, device="cuda", **opts).join())
        found = sorted(c._discovery_paths)
        for name in safety:
            if name in found:
                raise AssertionError(f"{label}: {name!r} discovered")
        if fin is not None and fin not in found:
            raise AssertionError(f"{label}: {fin!r} not found")
        for name, path in c.discoveries().items():
            path.into_states()  # every discovery replays
        tel = c.telemetry()
        return dict(secs=secs, steps=tel["steps"], steps_run=tel.get("steps_run"), eras=tel["eras"],
                    capture_secs=tel.get("capture_secs"), graph_captures=tel.get("graph_captures"),
                    readbacks=tel.get("readbacks"), peak=peak, generated=c.state_count(),
                    result=[c.state_count(), tel["steps"], tel["eras"], c.max_depth(), found])

    def lanes(label, _target):
        from stateright_tpu_torch.engines.multiplex import run_multiplexed

        cls, n, N, shape, configure, golden = LANES[label]
        tm = getattr(models, cls)(n)
        builders = [configure(i, TensorModelAdapter(tm).checker()) for i in range(N)]
        out, secs, peak = timed(lambda: run_multiplexed(builders, lanes=N, device="cuda", **shape))
        uniq = [c.unique_state_count() for c in out]
        for i, u in enumerate(uniq):
            if golden(i) is not None and u != golden(i):
                raise AssertionError(f"{label}: lane {i} {u} != {golden(i)}")
        tel = out[0].telemetry()
        return dict(secs=secs, steps=tel["batch_steps"], batches=1, checks=N,
                    batch_secs=tel["device_era_secs"], batch_readbacks=tel.get("batch_readbacks"),
                    capture_secs=tel.get("capture_secs"), graph_captures=tel.get("graph_captures"),
                    peak=peak, generated=sum(c.state_count() for c in out),
                    result=_digest([uniq, [c.telemetry()["steps"] for c in out]]))

    def sharded(label, _target):
        cls, n, shards, opts, golden = MESHES[label]
        b = TensorModelAdapter(getattr(models, cls)(n)).checker().coverage()
        kernels.reset_launches()
        c, secs, peak = timed(lambda: b.spawn_sharded_bfs(devices=shards, device="cuda", **opts).join())
        if c.unique_state_count() != golden:
            raise AssertionError(f"{label}: {c.unique_state_count()} != {golden}")
        tel = c.telemetry()
        # A lockstep step is one exchange launch (chip_smoke.py phase 18).
        return dict(secs=secs, steps=kernels.launch_counts()["exchange"],
                    capture_secs=tel.get("capture_secs"), graph_captures=tel.get("graph_captures"),
                    peak=peak, result=c.unique_state_count())

    def run(label, target=None):
        if label in RUNS:
            return bfs(label, target)
        if label in MESHES:
            return sharded(label, target)
        if label in SIMS:
            return sim(label, target)
        return lanes(label, target)

    return torch, run


def one_tree(tree: str, reps: int, cells) -> dict:
    torch, run = _setup(tree)
    out = {"tree": os.path.relpath(tree, HERE), "walls_secs": {}, "steps": {},
           "wall_ms_per_step": {}, "capture_secs": {}, "cells": {}}
    for label in cells:
        if label == "2pc-10":
            torch.cuda.empty_cache()
            timed = [run(label)]
        else:
            run(label)  # warm-up
            timed = [run(label) for _ in range(reps)]
        walls = [t["secs"] for t in timed]
        med = sorted(walls)[len(walls) // 2]
        first = timed[0]
        out["walls_secs"][label] = walls
        out["steps"][label] = first["steps"]
        out["wall_ms_per_step"][label] = med * 1e3 / max(1, first["steps"])
        out["capture_secs"][label] = [t["capture_secs"] for t in timed]
        cell = {k: v for k, v in first.items() if k not in ("secs", "capture_secs")}
        if "generated" in first:
            cell["generated_states_per_sec"] = first["generated"] / med
        if "checks" in first:
            cell["checks_per_sec"] = first["checks"] / med
        if label in SIMS:
            cell["steps_per_sec"] = first["steps"] / med
        out["cells"][label] = cell
        torch.cuda.empty_cache()
    out["card"] = card_line()
    return out


def profiled(tree: str, label: str) -> dict:
    """A warm-up run and the measured run, the measured one under
    torch.profiler inside a `record_function` window: the device busy ms
    is the union of the kernel intervals that start in the window, the
    kernels and host launch calls a step are those in it. A graph
    captured before the profiler starts loses its kernel records, so a
    lane cell's warm-up (which captures the warm program's graph) runs
    traced too; every other run captures its own graphs."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch, run = _setup(tree)
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from profile_gpu_bfs import busy_union

    target = PROFILE_TARGETS.get(label)
    if label not in LANES:
        run(label, target)  # warm-up; each run captures its own graphs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        if label in LANES:
            run(label, target)  # warm-up: the warm program's graph, traced
        with record_function("measured run"):
            r = run(label, target)
    secs, steps = r["secs"], r.get("steps_run") or r["steps"]
    events = p.events()
    window = next(e.time_range for e in events if e.name == "measured run")

    def inside(e):
        return window.start <= e.time_range.start <= window.end

    kern = [e for e in events if e.device_type.name == "CUDA" and e.time_range.end > e.time_range.start
            and inside(e)]
    host = [e for e in events if e.device_type.name == "CPU" and "Launch" in e.name and inside(e)]
    busy = busy_union([(e.time_range.start, e.time_range.end) for e in kern]) / 1e3
    return dict(busy_ms=busy, profiled_wall_secs=secs, steps=steps, device_kernels=len(kern),
                device_kernels_per_step=len(kern) / max(1, steps),
                host_launch_calls_per_step=len(host) / max(1, steps),
                share=busy / (secs * 1e3) if kern else "not measured", target=target)


def _child(args, env=None):
    """Run this script in a fresh process: (exit code, its last JSON line
    or None, the tail of its standard error)."""
    cmd = [sys.executable, os.path.abspath(__file__)] + args
    done = subprocess.run(cmd, text=True, capture_output=True, env=env)
    lines = [ln for ln in done.stdout.splitlines() if ln.startswith("{")]
    return done.returncode, (json.loads(lines[-1]) if lines else None), done.stderr[-4000:]


def checked_child(args) -> dict:
    rc, out, err = _child(args)
    sys.stderr.write(err)
    if rc != 0 or out is None:
        raise RuntimeError(f"solo_walls: {' '.join(args)} failed with exit code {rc}")
    return out


def profile_child(tree: str, label: str) -> dict:
    """`profiled` in a fresh process. A failed child is reported, not
    hidden: its exit code rides the numbers, which read "not measured"
    when it printed none (a child that faults after printing them keeps
    them, with its exit code and the fault's line)."""
    rc, out, err = _child(["--one", tree, "--profile-label", label])
    if out is None:
        out = dict(share="not measured")
    if rc != 0:
        out["exit_code"] = rc
        out["fault"] = next((ln.strip() for ln in err.splitlines() if "error" in ln.lower()), err[-300:])
    return out


def expand_cells(names, full: bool):
    cells = []
    for name in names:
        for label in GROUPS.get(name, [name]):
            if label not in RUNS and label not in SIMS and label not in LANES and label not in MESHES:
                raise SystemExit(f"solo_walls: unknown cell {label!r}")
            cells.append(label)
    if full and "paxos-3" in cells:
        cells.insert(cells.index("paxos-3") + 1, "2pc-10")
    return cells


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=[HERE])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--cells", nargs="+", default=["bfs"])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--profile-label", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    cells = expand_cells(args.cells, args.full)
    if args.one:
        import torch

        if not torch.cuda.is_available():
            print("solo_walls: no CUDA device", file=sys.stderr)
            return 2
        tree = os.path.abspath(args.one)
        if args.profile_label:
            print(json.dumps(profiled(tree, args.profile_label)), flush=True)
        else:
            print(json.dumps(one_tree(tree, args.reps, cells)), flush=True)
        return 0
    results = {}
    for tree in args.trees:
        tree = os.path.abspath(tree)
        out = checked_child(["--one", tree, "--reps", str(args.reps), "--cells"] + cells)
        if args.profile:
            out["device_busy_share"] = {label: profile_child(tree, label) for label in cells}
        print(json.dumps(out), flush=True)
        results.setdefault(out["tree"], out)
    if len(results) > 1:
        agree = {label: len({json.dumps(r["cells"][label]["result"]) for r in results.values()}) == 1
                 for label in cells}
        print(json.dumps({"cells_agree": agree}), flush=True)
        if not all(agree.values()):
            print("solo_walls: the trees disagree on a cell's result", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
