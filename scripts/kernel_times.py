#!/usr/bin/env python3
"""Device times of K2, K4, K7, K7s, K9b and K15a on the card, to hold
checkouts of the port against each other with one yardstick within one
call.

    python3 scripts/kernel_times.py [--trees DIR ...] [--reps N] [--rows GROUP ...]

For each tree, in the order given (to compare two: parent, change,
change, parent), a fresh process imports `stateright_tpu_torch` from that
tree, builds its kernels and times, at the 2pc-7 (C=6144, A=37, S=3,
ring 2^20) and paxos-3 (C=16384, A=21, S=30, ring 2^21) BFS widths of
`chip_smoke.py` phase 2, with this checkout's `chip_smoke.time_device_ms`
(CUDA events around back-to-back calls queued behind a spin kernel, so
the host's share is left out):

  compact_ids      K2 over the step's validity mask [C*A] -> vcap;
  ring_pop         K7's pop of C rows at a head that wraps;
  ring_append      K7's append of rcap candidates (40% valid) at a tail
                   that wraps, K2's compaction included where the tree
                   launches it;
  pop_append       the two, as one BFS step runs them;
  slab_bottomk     K9b over a 1,024-row slab at occupancy 700 -> 128;
  insert           K4 (solo) of rcap candidates (a third found, 200 in-batch
                   duplicates, 95% active) into phase 2's table (2^22 /
                   2^26 slots) filled to a quarter, each call on a fresh
                   copy of it;

and, once a tree:

  mesh_tail        K9b over 8 shards' slabs at phase 18's 2pc-7 widths
                   (one launch, or one a shard where the tree has no
                   lane form);
  compact_lanes    K2's lane form at phase 12's 2pc-5 sweep widths (1,024
                   lanes of [A=27, C=151] read from the [A, N, C] mask);
  insert_lanes     K4's lane form at phase 12's sweep widths: 1,024 lanes
                   of rcap = 3,456 candidates into tables of 2^16 slots
                   filled to 8,832 (1.61 GB), each call on a fresh copy;
  exchange         K15a at phase 18's mesh widths, 2pc-7 (chunk 1,024: V =
                   12,629, X = 7) and paxos-3 (chunk 2,048: V = 14,336, X
                   = 34), at N = 8 and N = 1 shards with the engine's quota;
  spill            K7s DRAIN and REFILL at phase 20's widths: 2,416,640
                   rows x 5 of a 2^22 ring from a head that wraps, and 8
                   rings of 2^15 with ragged counts; each also with its
                   copy to or from a pinned buffer (`host`), as a spill
                   makes the trip, and, where the tree has both, with
                   the runtime-W kernel in place of the W = 5 one
                   (`*_runtime_w`);

beside the library calls that do the same work (index_select; cumsum +
where + index_copy_; torch.topk; torch.nonzero, which waits for the
host; index_select / index_copy_ over the flat ring; for K15a a stable
argsort of the owners and a gather of the lanes) and the kernels a
call (`*_kernels`: the kernel and memset nodes of one captured call,
`by: graph`, where the tree has `engines.graph.captured_nodes`; else
torch.profiler's kernel records of one call, `by: profiler`, which can
miss a call's kernels; K2's and K7's appends also as the hand-written
kernels' counted calls; K4 and K15a by graph only).
`--rows` names the groups to time (default all: bfs, the rows of K2,
K7 and K9b at the two BFS widths; insert; mesh_tail; compact_lanes;
insert_lanes; exchange; spill). Prints one JSON line a tree with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WIDTHS = {"2pc-7": (6144, 37, 3, 1 << 20), "paxos-3": (16384, 21, 30, 1 << 21)}
MESH_N, MESH_C, MESH_A = 8, 1024, 37
LANES = (1024, 151, 27)  # phase 12: the 2pc-5 sweep's lanes, chunk and actions
# Phase 20's ragged rings: capacity, rows a ring, start positions.
# The groups of rows, all timed unless --rows names some.
ROWS = ("bfs", "insert", "mesh_tail", "compact_lanes", "insert_lanes", "exchange", "spill")
SPILL_RAGGED = (1 << 15, [0, 17, 1 << 15, 4_096, 1, 30_000, 12_345, 999],
                [(1 << 15) - 5, 3, 0, (1 << 15) - 2_000, 77, 10, (1 << 15) - 1, 31_000])


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one_tree(tree: str, reps: int, groups=None) -> dict:
    groups = groups or ROWS
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from stateright_tpu_torch import kernels
    from stateright_tpu_torch.engines.gpu_bfs import widths
    from stateright_tpu_torch.obs.sample import slab_entries, slab_high_water
    from stateright_tpu_torch.ops import frontier as fr
    from stateright_tpu_torch.ops import slab as sl
    from stateright_tpu_torch.ops import visited_set as vs
    from stateright_tpu_torch.parallel import mesh

    smoke = _smoke()
    kernels.build_all()
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)

    def dev_ms(fn):
        return smoke.time_device_ms(torch, lambda _: fn(), reps=reps)

    def counted(fn):
        torch.cuda.synchronize()
        kernels.reset_launches()
        fn()
        torch.cuda.synchronize()
        return {k: n for k, n in kernels.launch_counts().items() if n}

    def u32(*shape):
        return torch.from_numpy(rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.int64)).to(dev)

    out = dict(tree=tree, card=smoke.card_line())
    for label, (C, A, S, qcap) in WIDTHS.items():
        W = S + 2
        vcap, rcap, _dedup = widths(A, C)
        mask = torch.from_numpy(rng.random(C * A) < 0.3).to(dev)
        ring = fr.empty_ring(W, qcap, dev)
        ring[:, :qcap] = u32(W, qcap)
        head = qcap - C // 3
        cand = u32(W, rcap)
        cvalid = torch.from_numpy(rng.random(rcap) < 0.4).to(dev)
        idx = fr.ring_indices(head, C, qcap, dev)

        def append():
            fr.ring_scatter(ring, head, cand, cvalid)

        def library_append():
            rank = torch.cumsum(cvalid, 0) - 1
            ring.index_copy_(1, torch.where(cvalid, (head + rank) & (qcap - 1), qcap), cand)

        scap, sk2 = 1024, 128
        slab = sl.Slab(*(u32(scap + 1) for _ in range(4)), torch.tensor([700, 0], device=dev))
        skey = torch.where(torch.arange(scap, device=dev) < 700, (~slab.fp1[:scap]) & 0xFFFFFFFF, 0)
        out[label] = {} if "bfs" not in groups else dict(
            compact_ids=dev_ms(lambda: vs.compact_ids(mask, vcap)),
            compact_ids_launches=counted(lambda: vs.compact_ids(mask, vcap)),
            ring_pop=dev_ms(lambda: fr.ring_pop(ring, head, C)),
            ring_pop_library=dev_ms(lambda: ring.index_select(1, idx)),
            ring_append=dev_ms(append),
            ring_append_library=dev_ms(library_append),
            ring_append_launches=counted(append),
            pop_append=dev_ms(lambda: (fr.ring_pop(ring, head, C), append())),
            pop_append_library=dev_ms(lambda: (ring.index_select(1, idx), library_append())),
            slab_bottomk=dev_ms(lambda: sl.bottom_k(slab, sk2)),
            slab_bottomk_library=dev_ms(lambda: torch.topk(skey, sk2)),
            shape=dict(C=C, A=A, S=S, vcap=vcap, rcap=rcap, qcap=qcap, n_app=int(cvalid.sum())),
        )
        tcap = 1 << 22 if label == "2pc-7" else 1 << 26
        if "insert" in groups:
            out[label].update(insert_times(torch, np, rng, vs, smoke, 1, rcap, tcap, tcap // 4 - rcap))
        del ring, cand
        torch.cuda.empty_cache()

    if "mesh_tail" in groups:
        # The sharded tail at phase 18's 2pc-7 widths: 8 slabs of s_high + R
        # rows (R = 8 x the quota of chunk 1,024).
        n, k = MESH_N, 64
        scap, sk2 = slab_high_water(k) + n * mesh.quota_for(MESH_C, MESH_A, n), slab_entries(k)
        slabs = u32(4, n, scap + 1)
        counts = torch.from_numpy(np.stack([rng.integers(0, scap + 1, size=n), np.zeros(n, dtype=np.int64)], 1)).to(dev)
        lanes = getattr(sl, "bottom_k_lanes", None)

        def tail():
            if lanes is not None:
                return lanes(slabs, counts, sk2)
            return [sl.bottom_k(sl.Slab(*slabs[:, s], counts[s]), sk2) for s in range(n)]

        skey = torch.where(torch.arange(scap, device=dev)[None, :] < counts[:, :1], (~slabs[0, :, :scap]) & 0xFFFFFFFF, 0)
        out["mesh_tail"] = dict(
            ms=dev_ms(tail), library=dev_ms(lambda: torch.topk(skey, sk2, dim=1)), launches=counted(tail),
            shape=dict(shards=n, scap=scap, sk2=sk2),
        )
        del slabs, skey

    if "compact_lanes" in groups:
        # K2's lane form at the 2pc-5 sweep's widths (phase 12).
        N, C, A = LANES
        vcap = widths(A, C)[0]
        view = torch.from_numpy(rng.random((A, N, C)) < 0.3).to(dev).transpose(0, 1)
        out["compact_lanes"] = dict(
            ms=dev_ms(lambda: vs.compact_ids_lanes(view, vcap)),
            library=smoke.time_device_ms(torch, lambda _: torch.nonzero(view), reps=reps, syncs=True),
            kernels=call_kernels(torch, lambda: vs.compact_ids_lanes(view, vcap)),
            shape=dict(N=N, A=A, C=C, vcap=vcap),
        )
        for label in WIDTHS if "bfs" in groups else ():
            C, A = WIDTHS[label][:2]
            mask = torch.from_numpy(rng.random(C * A) < 0.3).to(dev)
            out[label]["compact_ids_kernels"] = call_kernels(torch, lambda: vs.compact_ids(mask, widths(A, C)[0]))
        del view
        torch.cuda.empty_cache()
    if "insert_lanes" in groups:
        N, C, A = LANES
        rcap = widths(A, C)[1]
        out["insert_lanes"] = insert_times(torch, np, rng, vs, smoke, N, rcap, 1 << 16, 8832 - rcap)
        torch.cuda.empty_cache()

    if "exchange" in groups:
        # K15a at phase 18's mesh widths.
        from stateright_tpu_torch.ops import exchange as xc

        for label, C, A, S in (("2pc-7", 1024, 37, 3), ("paxos-3", 2048, 21, 30)):
            V, X = widths(A, C)[0], S + 4
            for n in (MESH_N, 1):
                quota = mesh.quota_for(C, A, n)
                h1 = u32(n * V)
                keep = torch.from_numpy(rng.random((n, V)) < 0.75).to(dev)
                vals = u32(X, n * V)
                key = torch.where(keep, h1.view(n, V) % n, n)

                def library():
                    order = torch.argsort(key, dim=1, stable=True)
                    return vals.view(X, n, V).gather(2, order[None].expand(X, n, V))

                out[f"exchange_{label}_n{n}"] = dict(
                    ms=dev_ms(lambda: xc.exchange(h1, keep, vals, n, quota)), library=dev_ms(library),
                    kernels=call_kernels(torch, lambda: xc.exchange(h1, keep, vals, n, quota)),
                    shape=dict(N=n, V=V, X=X, quota=quota),
                )

    if "spill" in groups:
        # K7s at phase 20's widths: 2pc-10's largest drain of a 2^22 ring,
        # and 8 ragged rings of 2^15.
        W, qcap, k, start = spill_widths()
        gen = torch.Generator(device=dev).manual_seed(20)
        ring = torch.randint(0, 1 << 32, (W, qcap + 1), dtype=torch.int64, device=dev, generator=gen)
        buf = torch.empty((k, W), dtype=torch.int32, device=dev)
        pinned = torch.empty((k, W), dtype=torch.int32, pin_memory=True)
        rows = fr.ring_drain(ring, start, k, buf).clone()
        rows64 = fr.from_u32_bits(rows).T.contiguous()
        tail = start + 777
        idx, idx_t = fr.ring_indices(start, k, qcap, dev), fr.ring_indices(tail, k, qcap, dev)
        q8, ks, starts = SPILL_RAGGED
        rings = torch.randint(0, 1 << 32, (len(ks), W, q8 + 1), dtype=torch.int64, device=dev, generator=gen)
        tails = [s + 100 for s in starts]
        lrows = fr.ring_drain_lanes(rings, starts, ks).clone()
        flat, flat_t = fr._flat_rows(rings, starts, ks).reshape(-1), fr._flat_rows(rings, tails, ks).reshape(-1)
        vals = fr.from_u32_bits(lrows).reshape(-1)

        def drain_host():
            fr.ring_drain(ring, start, k, buf)
            pinned.copy_(buf, non_blocking=True)

        def refill_host():
            buf.copy_(pinned, non_blocking=True)
            fr.ring_refill(ring, tail, buf)

        runtime_w = {}
        if "specialise" in inspect.signature(fr._spill_launch).parameters:
            runtime_w = dict(
                drain_runtime_w=dev_ms(lambda: fr._spill_launch(kernels.RING_DRAIN, ring[None], [start], [k], buf,
                                                                specialise=False)),
                refill_runtime_w=dev_ms(lambda: fr._spill_launch(kernels.RING_REFILL, ring[None], [tail], [k], rows,
                                                                 specialise=False)),
            )
        out["spill"] = dict(
            **runtime_w,
            drain=dev_ms(lambda: fr.ring_drain(ring, start, k, buf)),
            drain_library=dev_ms(lambda: ring.index_select(1, idx)),
            drain_host=dev_ms(drain_host),
            refill=dev_ms(lambda: fr.ring_refill(ring, tail, rows)),
            refill_library=dev_ms(lambda: ring.index_copy_(1, idx_t, rows64)),
            refill_host=dev_ms(refill_host),
            lanes_drain=dev_ms(lambda: fr.ring_drain_lanes(rings, starts, ks, buf)),
            lanes_drain_library=dev_ms(lambda: rings.view(-1).index_select(0, flat)),
            lanes_refill=dev_ms(lambda: fr.ring_refill_lanes(rings, tails, ks, lrows)),
            lanes_refill_library=dev_ms(lambda: rings.view(-1).index_copy_(0, flat_t, vals)),
            drain_kernels=call_kernels(torch, lambda: fr.ring_drain(ring, start, k, buf)),
            lanes_drain_kernels=call_kernels(torch, lambda: fr.ring_drain_lanes(rings, starts, ks, buf)),
            shape=dict(W=W, qcap=qcap, k=k, start=start, ragged_rows=sum(ks), ragged_qcap=q8),
        )
    return out


def insert_times(torch, np, rng, vs, smoke, N, rcap, tcap, fill) -> dict:
    """K4 as phase 2 (N = 1: the solo call) and phase 12 (the lane form)
    time it: [N, tcap] tables filled with `fill` random keys a lane, then
    a batch of rcap a lane (a third of them found keys, 200 in-batch
    duplicates, 95% active), each call on a fresh copy of the table."""
    dev = torch.device("cuda")

    def u32(*shape):
        return torch.from_numpy(rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.int64)).to(dev)

    base = vs.empty_table(tcap, dev, lanes=N)
    k = u32(2, N, fill)
    vs.insert_lanes(base, k[0], k[1], k[0], k[1], torch.ones((N, fill), dtype=torch.bool, device=dev))
    old = torch.from_numpy(rng.integers(0, fill, size=(N, rcap // 3))).to(dev)
    bh = torch.cat([k.gather(2, old[None].expand(2, N, -1)), u32(2, N, rcap - rcap // 3)], dim=2)
    bh = bh[:, :, torch.from_numpy(rng.permutation(rcap)).to(dev)].contiguous()
    bh[:, :, rcap - 200:] = bh[:, :, rcap - 400:rcap - 200]
    p = u32(2, N, rcap)
    act = torch.from_numpy(rng.random((N, rcap)) < 0.95).to(dev)

    def clone():
        return vs.VisitedTable(base.keys.clone(), base.parents.clone(), base.stamps.clone(), base.epoch)

    if N == 1:
        def call(t):
            return vs.insert(vs.VisitedTable(t.keys[0], t.parents[0], t.stamps[0], t.epoch),
                             bh[0, 0], bh[1, 0], p[0, 0], p[1, 0], act[0])
    else:
        def call(t):
            return vs.insert_lanes(t, bh[0], bh[1], p[0], p[1], act)
    ms = smoke.time_device_ms(torch, call, prep=clone)
    spare = clone()
    r = dict(ms=ms, kernels=call_kernels(torch, lambda: call(spare)), shape=dict(N=N, rcap=rcap, tcap=tcap, fill=fill))
    if N == 1:
        return dict(insert=r["ms"], insert_kernels=r["kernels"], insert_shape=r["shape"])
    return r


def spill_widths():
    """(W, qcap, k, start) of phase 20's solo drain: 2pc-10 at its chunk
    through a 2^22 ring, its largest drain, from a head that wraps."""
    from stateright_tpu_torch.models import TwoPhaseTensor

    tm = TwoPhaseTensor(10)
    qcap = 1 << 22
    C = min(12288, qcap // (2 * tm.max_actions))
    hw = qcap - C * tm.max_actions
    return tm.state_width + 2, qcap, qcap - max(hw // 2, hw - 64 * C * tm.max_actions), qcap - 12_345


def call_kernels(torch, fn) -> dict:
    """Kernels one call of fn runs on the card: the nodes of one captured
    call where the tree can count them (`by: graph`), else torch.profiler's
    device records of one call, copies and fills left out (`by:
    profiler`)."""
    from stateright_tpu_torch.engines import graph

    fn()
    torch.cuda.synchronize()
    if hasattr(graph, "captured_nodes"):
        return dict(graph.captured_nodes(fn), by="graph")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return dict(kernels=sum(1 for e in prof.events() if e.device_type.name == "CUDA"
                            and not e.name.startswith(("Memcpy", "Memset"))), by="profiler")


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=[HERE])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rows", nargs="+", choices=ROWS, default=list(ROWS))
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one_tree(args.one, args.reps, args.rows)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    for tree in args.trees:
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree, "--reps", str(args.reps),
                               "--rows", *args.rows],
                              capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stderr[-4000:], file=sys.stderr)
            return done.returncode
        print(done.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
