#!/usr/bin/env python3
"""Where a step of the port's simulation spends its time on the card.

    python3 scripts/profile_gpu_simulation.py     # needs one CUDA device

Runs the two full-width simulation cells of `chip_smoke.py` to a state
target instead of a timeout, so that every run does the same work:
paxos-3 (seed 0, 16,384 walks, walk_cap 256, eras of 64 steps, the
steps a 10 s timeout gives) to 2,000,000 generated states, and 2pc-10
(seed 0, 65,536 walks, walk_cap 256, sync_steps 64) to 20,000,000. Each
runs once to warm up, once timed and once under torch.profiler, and the
script prints for each the wall time, the device-busy share, the kernel
time by name, and the launches and wall time per step run (the
`profile_gpu_bfs.profile_run` measurement).
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_gpu_simulation: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from profile_gpu_bfs import profile_run

    from stateright_tpu_torch.models import PaxosTensor, TwoPhaseTensor

    def simulate(b, opts):
        return b.spawn_gpu_simulation(0, **opts)

    card = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    print("card:", card, "| torch", torch.__version__)
    profile_run("paxos-3 simulation, 2M states", lambda: PaxosTensor(3),
                dict(walks=16384, walk_cap=256, sync_steps=64), target=2_000_000, spawn=simulate)
    profile_run("2pc-10 simulation, 20M states", lambda: TwoPhaseTensor(10),
                dict(walks=65536, walk_cap=256, sync_steps=64), target=20_000_000, spawn=simulate)
    return 0


if __name__ == "__main__":
    sys.exit(main())
