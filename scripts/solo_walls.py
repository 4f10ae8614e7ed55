#!/usr/bin/env python3
"""Wall times of the solo BFS engine's headline runs on the card, to hold
checkouts of the port against each other within one call.

    python3 scripts/solo_walls.py [--trees DIR ...] [--reps N] [--full] [--profile]

For each tree, in the order given (to compare two: parent, change,
change, parent), a fresh process imports `stateright_tpu_torch` from
that tree, builds its kernels, then runs 2pc-7 at the bench options
(bench.py:798) and paxos-3 at bench.py:1305-1307's options, and with
--full 2pc-10 at the reference's `2pc check 10` options, each with
sampling and coverage on (as `chip_smoke.py` runs them), once to warm up
and N times timed (2pc-10 once, unwarmed), each at its golden unique
count. With --profile each model then runs in a fresh process once to
warm up and once under torch.profiler (2pc-10: its first 4,000,000
states) for the device's busy share: one traced run a process, since a
long process's later traced runs were seen to lose kernel records
of graph launches. Prints one JSON line a tree: the walls in seconds, the steps,
the wall per step, the era graph's capture seconds where the tree has
one, the busy shares, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
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
PROFILE_TARGET_10 = 4_000_000


def _setup(tree: str):
    sys.path.insert(0, tree)
    import torch

    from stateright_tpu_torch import TensorModelAdapter, kernels, models

    kernels.build_all()

    def run(label, target=None):
        cls, n, opts, golden = RUNS[label]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        b = TensorModelAdapter(getattr(models, cls)(n)).checker().coverage()
        if target is not None:
            b = b.target_state_count(target)
        c = b.spawn_gpu_bfs(device="cuda", **opts).join()
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        if target is None and c.unique_state_count() != golden:
            raise AssertionError(f"{label}: {c.unique_state_count()} != {golden}")
        tel = c.telemetry()
        return secs, tel["steps"] + tel.get("partial_steps", 0), tel.get("capture_secs")

    return torch, run


def one_tree(tree: str, reps: int, full: bool) -> dict:
    torch, run = _setup(tree)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    out = {"tree": os.path.relpath(tree, HERE), "walls_secs": {}, "steps": {},
           "wall_ms_per_step": {}, "capture_secs": {}}
    for label in ["2pc-7", "paxos-3"] + (["2pc-10"] if full else []):
        if label == "2pc-10":
            torch.cuda.empty_cache()
            timed = [run(label)]
        else:
            run(label)  # warm-up
            timed = [run(label) for _ in range(reps)]
        walls = [t[0] for t in timed]
        out["walls_secs"][label] = walls
        out["steps"][label] = timed[0][1]
        out["wall_ms_per_step"][label] = sorted(walls)[len(walls) // 2] * 1e3 / timed[0][1]
        out["capture_secs"][label] = [t[2] for t in timed]
    out["card"] = card
    return out


def profiled(tree: str, label: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    torch, run = _setup(tree)
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from profile_gpu_bfs import busy_union

    target = PROFILE_TARGET_10 if label == "2pc-10" else None
    run(label, target)  # warm-up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        secs, steps, _cap = run(label, target)
    kern = [e for e in p.events() if e.device_type.name == "CUDA" and e.time_range.end > e.time_range.start]
    busy = busy_union([(e.time_range.start, e.time_range.end) for e in kern]) / 1e3
    return dict(busy_ms=busy, profiled_wall_secs=secs, steps=steps, device_kernels=len(kern),
                share=busy / (secs * 1e3) if kern else "not measured", target=target)


def _child(args) -> dict:
    cmd = [sys.executable, os.path.abspath(__file__)] + args
    done = subprocess.run(cmd, text=True, capture_output=True)
    sys.stderr.write(done.stderr[-4000:])
    if done.returncode != 0:
        raise RuntimeError(f"solo_walls: {' '.join(args)} failed with exit code {done.returncode}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=[HERE])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--profile-label", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        import torch

        if not torch.cuda.is_available():
            print("solo_walls: no CUDA device", file=sys.stderr)
            return 2
        tree = os.path.abspath(args.one)
        if args.profile_label:
            print(json.dumps(profiled(tree, args.profile_label)), flush=True)
        else:
            print(json.dumps(one_tree(tree, args.reps, args.full)), flush=True)
        return 0
    for tree in args.trees:
        tree = os.path.abspath(tree)
        out = _child(["--one", tree, "--reps", str(args.reps)] + ["--full"] * args.full)
        if args.profile:
            out["device_busy_share"] = {
                label: _child(["--one", tree, "--profile-label", label]) for label in out["walls_secs"]
            }
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
