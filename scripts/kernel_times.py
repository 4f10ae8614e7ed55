#!/usr/bin/env python3
"""Device times of K2, K7 and K9b on the card, to hold checkouts of the
port against each other with one yardstick within one call.

    python3 scripts/kernel_times.py [--trees DIR ...] [--reps N]

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
  mesh_tail        K9b over 8 shards' slabs at phase 18's 2pc-7 widths
                   (one launch, or one a shard where the tree has no
                   lane form);

beside the library calls that do the same work (index_select; cumsum +
where + index_copy_; torch.topk) and the hand-written kernels' counted
launches a call. Prints one JSON line a tree with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WIDTHS = {"2pc-7": (6144, 37, 3, 1 << 20), "paxos-3": (16384, 21, 30, 1 << 21)}
MESH_N, MESH_C, MESH_A = 8, 1024, 37


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one_tree(tree: str, reps: int) -> dict:
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
        out[label] = dict(
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
        del ring, cand
        torch.cuda.empty_cache()

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
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=[HERE])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one_tree(args.one, args.reps)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    for tree in args.trees:
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree, "--reps", str(args.reps)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stderr[-4000:], file=sys.stderr)
            return done.returncode
        print(done.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
