#!/usr/bin/env python3
"""The sharded engine across ranks (`spawn_sharded_bfs(group=...)`), one
process a rank, against the same run on one rank.

    python3 scripts/mesh_ranks.py --world 4                  # NCCL, one card a rank
    python3 scripts/mesh_ranks.py --world 4 --device cpu     # gloo on the CPU

Starts `--world` processes of this script (`--rank r`), each running
`--shards` / `--world` shards on its own device (`cuda:r`, or the CPU)
in one process group (NCCL on cards, gloo on the CPU; a `file://`
rendezvous in a fresh temporary directory, a collective timeout, and a
join limit). Every rank runs the same cases: 2pc-5 at the test options
(partial commits), 2pc-7 at chunk 1,024 (sampled; one more with
`.stage_profile()`, whose exchange stage crosses ranks) and paxos-2.
Then the launcher runs each case on one rank (world size 1) on
`cuda:0` or the CPU and checks that the results are equal: counts,
discoveries, coverage, the bottom-k sample and the discovery paths.
It prints one JSON line a case (walls, eras, steps, dispatches) and
exits non-zero on any difference. A rank logs each case's start and end;
15 s before the limit it dumps every thread's stack to its log, which
the launcher prints when a rank fails or runs past the limit (with
`NCCL_DEBUG=WARN` in the environment, NCCL's warnings too). It imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# name -> (model, args, spawn options, stage profile)
CASES = {
    "2pc-5": ("TwoPhaseTensor", (5,), dict(chunk_size=64, sync_steps=4), False),
    "2pc-7": ("TwoPhaseTensor", (7,), dict(chunk_size=1024, queue_capacity_per_shard=1 << 17), False),
    "2pc-7 profiled": ("TwoPhaseTensor", (7,), dict(chunk_size=1024, queue_capacity_per_shard=1 << 17),
                       True),
    "paxos-2": ("PaxosTensor", (2,), dict(chunk_size=256), False),
}


def run_case(name, shards, device, group=None):
    """One case; returns (result dict, numbers)."""
    import torch

    import stateright_tpu_torch.models as models
    from stateright_tpu_torch import TensorModelAdapter

    model, args, opts, profiled = CASES[name]
    b = TensorModelAdapter(getattr(models, model)(*args)).checker().coverage()
    if profiled:
        b = b.stage_profile(iters=4)
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    t0 = time.monotonic()
    c = b.spawn_sharded_bfs(devices=shards, device=device, group=group, **opts).join()
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    cov = c.coverage()
    result = dict(
        unique=c.unique_state_count(), states=c.state_count(), max_depth=c.max_depth(),
        discovery_fps={k: str(v) for k, v in c._discovery_fps.items()},
        coverage_actions=cov["actions"], coverage_depths={str(k): v for k, v in cov["depths"].items()},
        sample=[str(f) for f in c._sampler.fingerprints()],
        paths={k: p.encode(c.model()) for k, p in c.discoveries().items()},
    )
    tel = c.telemetry()
    numbers = dict(wall_secs=wall, eras=tel["eras"], steps=tel["steps"], dispatches=tel["dispatches"],
                   partial_steps=tel["partial_steps"], world_size=tel["world_size"])
    if profiled:
        numbers["stage_ms"] = {k: v for k, v in tel.get("phase_ms", {}).items() if k.startswith("stage_")}
        numbers["stage_profile_error"] = tel.get("stage_profile_error")
    return result, numbers


def rank_main(a) -> int:
    import faulthandler

    import torch
    import torch.distributed as dist

    # Past the launcher's limit the log shows where each rank waits.
    faulthandler.dump_traceback_later(a.stack_after, exit=False)
    torch.set_num_threads(1)
    on_card = a.device == "cuda"
    if on_card:
        torch.cuda.set_device(a.rank)
    device = f"cuda:{a.rank}" if on_card else "cpu"
    dist.init_process_group("nccl" if on_card else "gloo", init_method=f"file://{a.init}",
                            world_size=a.world, rank=a.rank, timeout=timedelta(seconds=120))
    try:
        out = {}
        t0 = time.monotonic()
        for name in CASES:
            print(f"rank {a.rank}: {name} starts at {time.monotonic() - t0:.1f} s", flush=True)
            out[name] = run_case(name, a.shards, device, dist.group.WORLD)
            print(f"rank {a.rank}: {name} done at {time.monotonic() - t0:.1f} s", flush=True)
        if a.rank == 0:
            with open(a.out, "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", type=int, default=4)
    p.add_argument("--shards", type=int, default=8)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--limit", type=float, default=600.0, help="seconds the ranks may take")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--init", default=None, help=argparse.SUPPRESS)
    p.add_argument("--out", default=None, help=argparse.SUPPRESS)
    p.add_argument("--stack-after", type=float, default=None, help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    if a.rank is not None:
        return rank_main(a)
    import torch

    if a.device == "cuda" and torch.cuda.device_count() < a.world:
        print(f"mesh_ranks: {a.world} ranks need {a.world} cards, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    if a.device == "cuda":
        from stateright_tpu_torch import kernels

        print(f"build_secs={kernels.build_all():.2f}", flush=True)  # once, before the ranks
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip().splitlines()
        print("cards:", card, flush=True)
    work = tempfile.mkdtemp(prefix="mesh_ranks_")
    init, out = os.path.join(work, "rendezvous"), os.path.join(work, "result.json")
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--world", str(a.world), "--shards", str(a.shards),
         "--device", a.device, "--rank", str(r), "--init", init, "--out", out,
         "--stack-after", str(max(1.0, a.limit - 15))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ) for r in range(a.world)]
    logs, failed = [], False
    try:
        for r, proc in enumerate(procs):
            logs.append(proc.communicate(timeout=max(1.0, a.limit - (time.monotonic() - t0)))[0])
            failed |= proc.returncode != 0
    except subprocess.TimeoutExpired:
        # Past the limit: every rank's log so far, after the kill.
        print(f"mesh_ranks: the ranks ran past {a.limit:.0f} s", file=sys.stderr)
        failed = True
        for proc in procs:
            proc.kill()
        logs += [proc.communicate()[0] for proc in procs[len(logs):]]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed or not os.path.exists(out):
        for r, log in enumerate(logs):
            print(f"rank {r}:\n{log[-4000:]}", file=sys.stderr)
        shutil.rmtree(work, ignore_errors=True)
        return 1
    with open(out) as f:
        ranks = json.load(f)
    shutil.rmtree(work, ignore_errors=True)
    torch.set_num_threads(1)
    ok = True
    for name in CASES:
        got, numbers = ranks[name]
        want, one = run_case(name, a.shards, "cuda:0" if a.device == "cuda" else "cpu")
        equal = got == want
        ok &= equal and numbers.get("stage_profile_error") is None
        print(json.dumps(dict(case=name, shards=a.shards, world=a.world, device=a.device,
                              equal_to_one_rank=equal, unique=got["unique"], ranks=numbers,
                              one_rank=one)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
