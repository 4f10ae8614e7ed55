#!/usr/bin/env python3
"""Where a step of the port's BFS spends its time on the card.

    python3 scripts/profile_gpu_bfs.py        # needs one CUDA device

Runs 2pc-7 at the bench options (bench.py:798), the first 4M states of
2pc-10 at chunk 12288 and paxos-3 at bench.py:1305-1307's options (serial
eras), all with sampling on (the default), each once to warm up, once
timed and once under torch.profiler, and prints for each: the wall time,
the device-busy share (the union of kernel intervals over the wall), the
kernel time by name, and the launches and wall time per step.
"""

from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def busy_union(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profile_run(label, make_model, opts, target=None,
                spawn=lambda b, opts: b.spawn_gpu_bfs(**opts)):
    """Warm up, time, then profile one run of `spawn` on a fresh builder
    of make_model() (with the state target, if any); prints and returns
    the wall, the device-busy share, the kernels by time and the launches
    and wall per step (steps run, where an engine counts them apart)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stateright_tpu_torch import TensorModelAdapter

    def run():
        b = TensorModelAdapter(make_model()).checker()
        if target:
            b = b.target_state_count(target)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        c = spawn(b, opts).join()
        torch.cuda.synchronize()
        return c, time.monotonic() - t0

    run()  # warm-up
    _c, plain_wall = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        c, wall = run()
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    kern = [e for e in events if e.time_range.end > e.time_range.start]
    by_name = {}
    for e in kern:
        d = by_name.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += (e.time_range.end - e.time_range.start) / 1e3
    busy_ms = busy_union([(e.time_range.start, e.time_range.end) for e in kern]) / 1e3
    tel = c.telemetry()
    steps = tel.get("steps_run", tel.get("steps", 0) + tel.get("partial_steps", 0))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    out = dict(
        label=label,
        unique=c.unique_state_count(),
        states=c.state_count(),
        wall_ms_unprofiled=plain_wall * 1e3,
        wall_ms_profiled=wall * 1e3,
        steps=steps,
        device_kernels=len(kern),
        device_busy_ms=busy_ms,
        device_busy_share=busy_ms / (wall * 1e3),
        kernel_launches_per_step=len(kern) / max(1, steps),
        wall_ms_per_step_unprofiled=plain_wall * 1e3 / max(1, steps),
        top_kernels_ms=[(name, cnt, round(ms, 3)) for name, (cnt, ms) in top],
    )
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_gpu_bfs: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from stateright_tpu_torch.models import PaxosTensorExhaustive, TwoPhaseTensor

    card = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    print("card:", card, "| torch", torch.__version__)
    profile_run(
        "2pc-7 bench options", lambda: TwoPhaseTensor(7),
        dict(chunk_size=6144, queue_capacity=1 << 20, table_capacity=1 << 22),
    )
    profile_run(
        "2pc-10 first 4M states", lambda: TwoPhaseTensor(10),
        dict(chunk_size=12288, queue_capacity=1 << 26, table_capacity=1 << 28), target=4_000_000,
    )
    profile_run(
        "paxos-3", lambda: PaxosTensorExhaustive(3),
        dict(chunk_size=16384, queue_capacity=1 << 21, table_capacity=1 << 26),
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
