#!/usr/bin/env python3
"""Wall times of the solo BFS engine's headline runs on the card, to hold
one checkout of the port against another within one call.

    python3 scripts/solo_walls.py [--tree DIR] [--reps N] [--full]

Imports `stateright_tpu_torch` from DIR (default: this checkout), builds
its kernels, then runs 2pc-7 at the bench options (bench.py:798) and
paxos-3 at bench.py:1305-1307's options (serial eras), and with --full
2pc-10 at the reference's `2pc check 10` options, each with sampling and
coverage on (as `chip_smoke.py` runs them), once to warm up and N times
timed (2pc-10 once, unwarmed), each at its golden unique count. Prints
one JSON line: the tree, the walls in seconds and the card's name and
power limit. To compare two trees, run it parent, change, change, parent.
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


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("solo_walls: no CUDA device", file=sys.stderr)
        return 2
    from stateright_tpu_torch import TensorModelAdapter, kernels, models

    kernels.build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]

    def run(label):
        cls, n, opts, golden = RUNS[label]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        c = TensorModelAdapter(getattr(models, cls)(n)).checker().coverage().spawn_gpu_bfs(
            device="cuda", **opts).join()
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        if c.unique_state_count() != golden:
            raise AssertionError(f"{label}: {c.unique_state_count()} != {golden}")
        return secs

    walls = {}
    for label in ("2pc-7", "paxos-3"):
        run(label)  # warm-up
        walls[label] = [run(label) for _ in range(args.reps)]
    if args.full:
        torch.cuda.empty_cache()
        walls["2pc-10"] = [run("2pc-10")]
    print(json.dumps({"tree": os.path.relpath(tree, HERE), "walls_secs": walls, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
