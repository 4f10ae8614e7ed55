#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (stateright_tpu_torch) on one card.

    python3 chip_smoke.py            # every phase; needs one CUDA device

Phases, each printing its own lines; any failure raises and the script
exits non-zero:

  0. environment: torch, CUDA, nvcc, the card's name and power limit;
  1. build: every kernel from kernels/csrc with nvcc, in parallel;
  2. kernel parity: each hand-written kernel against its plain torch
     version on the same card tensors, at the 2pc-7 bench widths
     (C=6144, A=37), compared bit for bit, with CUDA-event timings;
  3. a small engine run (2pc-5) on cuda and on the cpu: equal results;
  4. the headline: 2pc-7 exhaustive at the bench options, with and
     without table growth; the launch counts of that run show the main
     path went through every kernel;
  5. full size: 2pc-10 exhaustive (61,515,776 states).

Before the last line it prints the `kernels` JSON line and the card's
name and power limit; the last line is the JSON result. It imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# 2pc-7 bench options (bench.py:798) and the test options of the
# engine-parity tests (tests/test_pipeline.py:25).
BENCH7 = dict(chunk_size=6144, queue_capacity=1 << 20, table_capacity=1 << 22)
TEST_OPTS = dict(chunk_size=64, queue_capacity=1 << 12, table_capacity=1 << 11, sync_steps=4)
FULL10 = dict(chunk_size=12288, queue_capacity=1 << 26, table_capacity=1 << 28)
GOLDEN = {5: 8_832, 7: 296_448, 10: 61_515_776}

# 3-lane rows whose raw hash halves are both 0 (tests/test_torch_fingerprint.py).
BOTH_ZERO_ROWS = ((2392970816, 0, 4120996650), (2503669636, 0, 1754888951))

# Published H100 SXM peaks: HBM bytes/s, and
# the CUDA-core 32-bit rate used for the integer work of these kernels.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12


def phase(name):
    print(f"== phase {name}", flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def card_line():
    return run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).splitlines()[0]


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def fingerprint_dict(c):
    cov = c.coverage()
    return dict(
        unique=c.unique_state_count(),
        states=c.state_count(),
        max_depth=c.max_depth(),
        discovery_fps=dict(c._discovery_fps),
        coverage_actions=cov["actions"],
        coverage_depths=cov["depths"],
    )


# -- phase 2 ----------------------------------------------------------------

def time_ms(torch, fn, prep=None, reps=20):
    """Median CUDA-event time of fn(prep()) over `reps` launches after a
    warm-up; prep runs outside the timed window."""
    times = []
    for r in range(reps + 1):
        arg = prep() if prep is not None else None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        torch.cuda.synchronize()
        if r:
            times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def max_abs_err(torch, pairs):
    err = 0
    for a, b in pairs:
        check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))
    return err


def kernel_parity(torch, np):
    from stateright_tpu_torch import kernels
    from stateright_tpu_torch.engines.gpu_bfs import widths
    from stateright_tpu_torch.fingerprint import hash_lanes, hash_lanes_plain
    from stateright_tpu_torch.ops import frontier as fr
    from stateright_tpu_torch.ops import visited_set as vs

    dev = torch.device("cuda")
    C, A, S = 6144, 37, 3
    CA = C * A
    vcap, rcap, dedup_cap = widths(A, C)
    print(f"widths: C*A={CA} vcap={vcap} rcap={rcap} dedup_cap={dedup_cap}")
    rng = np.random.default_rng(7)
    results = {}

    def gpu(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def u32(*shape):
        x = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.int64)
        x.flat[: min(x.size, 64)] = 0xFFFFFFFF - np.arange(min(x.size, 64))
        return x

    # K1 at the two widths the step hashes: the popped rows and the
    # compacted candidates.
    errs = []
    for n in (C, vcap):
        lanes = gpu(u32(S, n))
        lanes[:, :2] = gpu(np.asarray(BOTH_ZERO_ROWS, dtype=np.int64).T)
        lanes[:, 2:8] = 0
        errs.append(max_abs_err(torch, zip(hash_lanes(lanes), hash_lanes_plain(lanes))))
    lanes = gpu(u32(S, vcap))
    n = vcap
    results["hash_lanes"] = dict(
        max_abs_err=max(errs),
        ms=time_ms(torch, lambda _: hash_lanes(lanes)),
        plain_ms=time_ms(torch, lambda _: hash_lanes_plain(lanes)),
        bytes=S * n * 8 + 2 * n * 8,
        ops=n * (2 * S * 4 + 2 * 6),
        library_ms=None,
        shape=f"[{S}, {n}]",
    )

    # K2: the validity mask [C*A] -> vcap (about a third valid, as on
    # 2pc-7), an overflowing mask, and the dedup mask [vcap] -> rcap.
    errs = []
    cases = [
        (gpu(rng.random(CA) < 0.3), vcap),
        (gpu(rng.random(CA) < 0.6), vcap),
        (gpu(rng.random(vcap) < 0.35), rcap),
    ]
    for mask, cap in cases:
        a = vs.compact_ids(mask, cap)
        b = vs.compact_ids_plain(mask, cap)
        errs.append(max_abs_err(torch, zip(a, b)))
    mask, cap = cases[0]
    results["compact_ids"] = dict(
        max_abs_err=max(errs),
        ms=time_ms(torch, lambda _: vs.compact_ids(mask, cap)),
        plain_ms=time_ms(torch, lambda _: vs.compact_ids_plain(mask, cap)),
        bytes=CA + cap * 9 + 8,
        ops=CA,
        library_ms=time_ms(torch, lambda _: torch.nonzero(mask)),
        shape=f"[{CA}] -> [{cap}]",
    )

    # K3: [vcap] candidates drawn from a small key pool (many duplicates)
    # with forced slot collisions.
    pool = u32(2, vcap // 8)
    pick = rng.integers(0, pool.shape[1], size=vcap)
    h1, h2 = gpu(pool[0, pick]), gpu(pool[1, pick])
    h1[:32] = 5
    h2[:32] = torch.arange(32)  # one h1, many h2: shared slots when mixed
    valid = gpu(rng.random(vcap) < 0.9)
    keep = fr.claim_dedup(h1, h2, valid, dedup_cap)
    keep_plain = fr.claim_dedup_plain(h1, h2, valid, dedup_cap)
    results["claim_dedup"] = dict(
        max_abs_err=max_abs_err(torch, [(keep, keep_plain)]),
        ms=time_ms(torch, lambda _: fr.claim_dedup(h1, h2, valid, dedup_cap)),
        plain_ms=time_ms(torch, lambda _: fr.claim_dedup_plain(h1, h2, valid, dedup_cap)),
        bytes=vcap * (8 + 8 + 1 + 1),
        ops=vcap * 8,
        library_ms=None,
        shape=f"[{vcap}]",
    )

    # K4: a 2^22-slot table filled to ~0.25 load, then an [rcap] batch of
    # found keys, new keys and in-batch duplicates; and a duplicate-heavy
    # batch (64 copies of one key, distinct parents) for the winner rule.
    tcap = 1 << 22
    base = vs.empty_table(tcap, dev)
    fill = tcap // 4 - rcap
    k = gpu(u32(2, fill))
    vs.insert(base, k[0], k[1], k[0], k[1], torch.ones(fill, dtype=torch.bool, device=dev))
    old = rng.integers(0, fill, size=rcap // 3)
    fresh = u32(2, rcap - len(old))
    bh = np.concatenate([k.cpu().numpy()[:, old], fresh], axis=1)
    perm = rng.permutation(rcap)
    bh = bh[:, perm]
    bh[:, rcap - 200:] = bh[:, rcap - 400:rcap - 200]  # in-batch duplicates
    b1, b2 = gpu(bh[0]), gpu(bh[1])
    p1, p2 = gpu(u32(2, rcap))
    act = gpu(rng.random(rcap) < 0.95)

    def dump(t):
        order = torch.argsort(t.keys)
        return t.keys[order], t.parents[order]

    def clone(t):
        return vs.VisitedTable(t.keys.clone(), t.parents.clone(), t.stamps.clone(), t.epoch)

    ta, tb = clone(base), clone(base)
    out_a = vs.insert(ta, b1, b2, p1, p2, act)
    out_b = vs.insert_plain(tb, b1, b2, p1, p2, act)
    errs = [max_abs_err(torch, list(zip(out_a, out_b)) + list(zip(dump(ta), dump(tb))))]
    n_new = int(out_a[0].sum())
    n_act = int(act.sum())
    check(n_new > 0 and int(out_a[1].sum()) == 0, "insert parity batch: expected new keys and no unresolved")

    dup = 64
    w1 = np.concatenate([[0xDEADBEEF] * dup, fresh[0, :dup]])
    w2 = np.concatenate([[0x12345678] * dup, fresh[1, :dup]])
    order = rng.permutation(2 * dup)
    w1, w2 = gpu(w1[order].astype(np.int64)), gpu(w2[order].astype(np.int64))
    wp = gpu(np.arange(1, 2 * dup + 1, dtype=np.int64))
    on = torch.ones(2 * dup, dtype=torch.bool, device=dev)
    ta, tb = clone(base), clone(base)
    wa = vs.insert(ta, w1, w2, wp, wp, on)
    wb = vs.insert_plain(tb, w1, w2, wp, wp, on)
    errs.append(max_abs_err(torch, list(zip(wa, wb)) + list(zip(dump(ta), dump(tb)))))
    top = int(np.flatnonzero(order < dup).max())
    check(bool(wa[0][top]) and int(wa[0][(w1 == 0xDEADBEEF)].sum()) == 1,
          "winner rule: the highest-index copy must be the new one")
    dup_key = int(np.array([0xDEADBEEF12345678], dtype=np.uint64).view(np.int64)[0])
    check(int(ta.parents[ta.keys == dup_key].item()) & 0xFFFFFFFF == top + 1,
          "winner rule: the stored parent must be the highest-index copy's")
    results["visited_insert"] = dict(
        max_abs_err=max(errs),
        ms=time_ms(torch, lambda t: vs.insert(t, b1, b2, p1, p2, act), prep=lambda: clone(base)),
        plain_ms=time_ms(torch, lambda t: vs.insert_plain(t, b1, b2, p1, p2, act), prep=lambda: clone(base), reps=5),
        bytes=rcap * (4 * 8 + 1 + 2) + n_act * 8 + n_new * 16,
        ops=n_act * 8,
        library_ms=None,
        shape=f"[{rcap}] into 2^22 slots at load {(fill / tcap):.3f}",
    )
    for name, r in results.items():
        bound_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        bound_ops = r["ops"] / INT32_OPS_PER_S * 1e3
        r["bound_ms"] = max(bound_bytes, bound_ops)
        r["bound_by"] = "bytes" if bound_bytes >= bound_ops else "operations"
        print(f"kernel {name} {r['shape']}: max_abs_err={r['max_abs_err']} "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
              f"library_ms={r['library_ms']}", flush=True)
        check(r["max_abs_err"] == 0, f"kernel {name} disagrees with its plain version")
    return results


# -- phases 3 to 5 ----------------------------------------------------------

def bfs(n, device, opts):
    from stateright_tpu_torch import TensorModelAdapter
    from stateright_tpu_torch.models import TwoPhaseTensor

    import torch

    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.monotonic()
    c = TensorModelAdapter(TwoPhaseTensor(n)).checker().coverage().spawn_gpu_bfs(device=device, **opts).join()
    if device == "cuda":
        torch.cuda.synchronize()
    return c, time.monotonic() - t0


def check_2pc(c, n):
    from stateright_tpu_torch.path import Path

    check(c.unique_state_count() == GOLDEN[n], f"2pc-{n}: {c.unique_state_count()} != {GOLDEN[n]}")
    c.assert_no_discovery("consistent")
    model = c.model()
    for name in ("abort agreement", "commit agreement"):
        path = c.assert_any_discovery(name)
        replay = Path.from_actions(model, path.into_states()[0], path.into_actions())
        check(replay is not None and replay.last_state() == path.last_state(), f"{name} path does not replay")
        check(model.property(name).condition(model, path.last_state()), f"{name} path ends elsewhere")


def main(argv) -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "stateright_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    skip_full = "--skip-full" in argv
    from stateright_tpu_torch import kernels

    phase("0 environment")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    print("nvcc:", run([kernels._nvcc(), "--version"]).splitlines()[-1])
    card = card_line()
    print("card:", card, "| devices:", torch.cuda.device_count())

    phase("1 build")
    secs = kernels.build_all(verbose=True)
    print(f"build_secs={secs:.2f}", flush=True)

    phase("2 kernel parity (2pc-7 widths)")
    results = kernel_parity(torch, np)

    phase("3 2pc-5 on cuda and on cpu")
    c_gpu, t_gpu = bfs(5, "cuda", TEST_OPTS)
    c_cpu, t_cpu = bfs(5, "cpu", TEST_OPTS)
    d_gpu, d_cpu = fingerprint_dict(c_gpu), fingerprint_dict(c_cpu)
    check(d_gpu == d_cpu, f"2pc-5 cuda {d_gpu} != cpu {d_cpu}")
    check(d_gpu["unique"] == GOLDEN[5], "2pc-5 golden")
    check({k: v.encode(c_gpu.model()) for k, v in c_gpu.discoveries().items()}
          == {k: v.encode(c_cpu.model()) for k, v in c_cpu.discoveries().items()}, "2pc-5 paths")
    print(f"2pc-5 equal on cuda ({t_gpu:.2f}s) and cpu ({t_cpu:.2f}s): {c_gpu.telemetry()}", flush=True)

    phase("4 2pc-7 headline")
    bfs(7, "cuda", BENCH7)  # warm-up
    kernels.reset_launches()
    c7, t7 = bfs(7, "cuda", BENCH7)
    launches = kernels.launch_counts()
    check_2pc(c7, 7)
    d7 = fingerprint_dict(c7)
    print(f"2pc-7: unique={c7.unique_state_count()} states={c7.state_count()} wall_secs={t7:.3f} "
          f"generated_states_per_sec={c7.state_count() / t7:.1f} unique_per_sec={c7.unique_state_count() / t7:.1f} "
          f"telemetry={c7.telemetry()} launches={launches} card={card}", flush=True)
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")
    c7g, t7g = bfs(7, "cuda", dict(BENCH7, table_capacity=1 << 16))
    check(fingerprint_dict(c7g) == d7, "2pc-7 with growth differs from the run without")
    print(f"2pc-7 with growth from 2^16: equal, wall_secs={t7g:.3f} telemetry={c7g.telemetry()}", flush=True)

    if not skip_full:
        phase("5 2pc-10 full size")
        torch.cuda.reset_peak_memory_stats()
        c10, t10 = bfs(10, "cuda", FULL10)
        check(c10.unique_state_count() == GOLDEN[10], f"2pc-10: {c10.unique_state_count()}")
        print(f"2pc-10: unique={c10.unique_state_count()} states={c10.state_count()} wall_secs={t10:.3f} "
              f"generated_states_per_sec={c10.state_count() / t10:.1f} "
              f"max_memory_allocated={torch.cuda.max_memory_allocated()} telemetry={c10.telemetry()} card={card}",
              flush=True)

    line = {"kernels": []}
    for k in kernels.KERNELS:
        r = results[k.name]
        line["kernels"].append(dict(
            name=k.name, route="cuda", source=os.path.relpath(k.source_path, HERE),
            replaces=k.replaces, launches=launches[k.name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
        ))
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
