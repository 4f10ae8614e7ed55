#!/usr/bin/env python3
"""The per-stage split of the port's device eras (`.stage_profile()`) for
the speed cells, on one card:

    python3 scripts/stage_split.py [--cells 2pc-7 paxos-3 "paxos-3 sim"] [--iters 32]

Each cell runs once without and once with the stage profiler, at the
options chip_smoke.py runs it with (2pc-7 at bench.py:798's, paxos-3 at
bench.py:1305-1307's, the paxos-3 simulation with 16,384 walks to
2,000,000 states), and prints for each run its unique or generated
states, wall seconds, steps, peak device memory and the telemetry's
stage keys (`phase_ms`: `device_era`, `profiler_overhead`, `stage_*`;
`stage_us_per_step`, `stage_profile_model_pct`), then the card's name
and power limit. The first run of a process pays its warm-up.
"""

from __future__ import annotations

import argparse
import json
import os
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
    }


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", nargs="+", default=["2pc-7", "paxos-3", "paxos-3 sim"])
    ap.add_argument("--iters", type=int, default=32)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("stage_split: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from stateright_tpu_torch import TensorModelAdapter

    table = cells()
    for label in args.cells:
        make, spawn = table[label]
        for prof in (False, True):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            b = TensorModelAdapter(make()).checker()
            if prof:
                b = b.stage_profile(iters=args.iters)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            c = spawn(b).join()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            tel = c.telemetry()
            out = dict(
                cell=label, stage_profile=prof, states=c.unique_state_count(), wall_secs=wall,
                steps=tel["steps"], steps_run=tel.get("steps_run"),
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                phase_ms=tel.get("phase_ms"), stage_us_per_step=tel.get("stage_us_per_step"),
                stage_profile_model_pct=tel.get("stage_profile_model_pct"),
                stage_profile_error=tel.get("stage_profile_error"),
            )
            print(json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
