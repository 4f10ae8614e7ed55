#!/usr/bin/env python3
"""How many simulated states 2PC's random walks take to reach "commit
agreement" (every RM committed), which needs every RM to prepare before
any RM or the TM aborts.

    python3 scripts/sim_reach.py                 # the port, on the card
    python3 scripts/sim_reach.py --cpu           # the port, the kernels' plain versions
    python3 scripts/sim_reach.py --jax           # the JAX reference on the CPU
    python3 scripts/sim_reach.py --jax --n 5 --walks 8192 65536

For each 2pc-N (``--n``, default 5 6 7 8 10; 10 only on the card) and each
walk count (``--walks``, default 65,536 on the card, 8,192 elsewhere) it
runs the engine's simulation (seed 0, walk_cap 256, sync_steps 64) until
"commit agreement" is found or N's state budget is spent, and prints the
generated states, the steps and whether it was found. The port's walks
are the JAX engine's bit for bit, so the two must print the same numbers;
``--jax`` is the reference side of that comparison (it imports JAX and
the JAX package, which the port itself never does).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# 2pc-N -> state budget
BUDGETS = {5: 5_000_000, 6: 10_000_000, 7: 20_000_000, 8: 40_000_000, 10: 1_000_000_000}


def spawner(mode: str):
    """(device label, run(n, walks, budget) -> checker) for the engine of
    `mode`: the port on cuda or cpu, or the JAX reference."""
    if mode == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        from stateright_tpu import HasDiscoveries, TensorModelAdapter
        from stateright_tpu.models import TwoPhaseTensor

        def spawn(b, walks):
            return b.spawn_tpu_simulation(0, walks=walks, walk_cap=256, sync_steps=64)
    else:
        from stateright_tpu_torch import TensorModelAdapter
        from stateright_tpu_torch.has_discoveries import HasDiscoveries
        from stateright_tpu_torch.models import TwoPhaseTensor

        def spawn(b, walks):
            return b.spawn_gpu_simulation(0, device=mode, walks=walks, walk_cap=256, sync_steps=64)

    def run(n, walks, budget):
        b = (
            TensorModelAdapter(TwoPhaseTensor(n)).checker()
            .finish_when(HasDiscoveries.any_of(["commit agreement"]))
            .target_state_count(budget)
        )
        return spawn(b, walks).join()

    return run


def main(argv) -> int:
    sys.path.insert(0, HERE)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    where = ap.add_mutually_exclusive_group()
    where.add_argument("--cpu", action="store_true", help="the port on the CPU")
    where.add_argument("--jax", action="store_true", help="the JAX reference on the CPU")
    ap.add_argument("--n", type=int, nargs="+", choices=sorted(BUDGETS))
    ap.add_argument("--walks", type=int, nargs="+")
    args = ap.parse_args(argv)
    mode = "jax" if args.jax else "cpu" if args.cpu else "cuda"
    card = mode == "cuda"
    ns = args.n or [n for n in BUDGETS if card or n != 10]
    walk_counts = args.walks or [65536 if card else 8192]
    run = spawner(mode)
    if card:
        import subprocess

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip(), flush=True)
    for n in ns:
        for walks in walk_counts:
            budget = BUDGETS[n]
            t0 = time.monotonic()
            c = run(n, walks, budget)
            if card:
                import torch

                torch.cuda.synchronize()
            tel = c.telemetry()
            found = "commit agreement" in c.discoveries()
            print(f"2pc-{n} walks={walks}: commit agreement {'found' if found else 'not found'} "
                  f"after {c.state_count()} generated states (budget {budget}), steps={tel['steps']} "
                  f"eras={tel['eras']} discoveries={sorted(c.discoveries())} "
                  f"wall_secs={time.monotonic() - t0:.3f} engine={mode}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
