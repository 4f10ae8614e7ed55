#!/usr/bin/env python3
"""Device times of K2, K3, K4, K7, K7s, K8f, K9, K14f, K15a and K15f on the card, to hold
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
  era              K8f's COMMIT at the 2pc-7 / paxos-3 BFS widths (bench
                   chunk, sampled, coverage, fuse 4): the kernel alone
                   (`commit`) and with the torch launches the step made
                   before it where the tree has them (`commit_with_glue`:
                   the first hits, the hs and pa sums, the depth
                   histogram; a tree whose COMMIT folds them times the
                   same call twice); K8f's epilogue; K9a at rcap with a
                   tight threshold and with nothing below it (`empty`),
                   each with its nodes a call;
  lane_era         K14f's COMMIT (with its glue, as above) and epilogue at
                   the 2pc-5 sweep's 1,024 lanes (C = 151, A = 27);
  capture_lanes    K9a for every shard at phase 18's 8-shard 2pc-7 (chunk
                   1,024) and paxos-3 (chunk 2,048) receive widths: one
                   launch where the tree has the lane form, else the
                   per-shard loop;
  dedup            K3 in its three forms: solo at the 2pc-7 and paxos-3
                   BFS widths (vcap candidates, a valid prefix of 0.8
                   vcap), lanes at the 2pc-5 sweep's 1,024 lanes (each
                   lane's prefix drawn from 0 to vcap, a third of them
                   empty, as a sweep's finished lanes are), and over the
                   8 shards of phase 18's 2pc-7 and paxos-3 widths; on a
                   scratch the program owns where the tree takes one (its
                   memset otherwise), with its nodes a call;
  mesh_commit      K15f's COMMIT at the 8-shard 2pc-7 (chunk 1,024),
                   paxos-3 (chunk 2,048) and 2pc-10 (chunk 1,024) widths:
                   the kernel alone (`commit`, the sums made once outside
                   where the tree's COMMIT takes them) and with the torch
                   launches the mesh step made before it where the tree
                   has them (`commit_with_glue`: the first hits, hs, pa,
                   generated and the owner's depth histogram; a tree whose
                   COMMIT folds them times the same call twice), each with
                   its nodes a call;
  step_nodes       the kernel nodes of one captured step of the solo
                   2pc-7 and paxos-3 programs (bench chunks), of a 2pc-5
                   lane program (32 lanes) and of the 2pc-7 and paxos-3
                   meshes at 8 shards;
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
insert_lanes; exchange; spill; era; lane_era; capture_lanes;
step_nodes). Prints one JSON line a tree with the
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
ROWS = ("bfs", "insert", "mesh_tail", "compact_lanes", "insert_lanes", "exchange", "spill", "era",
        "lane_era", "capture_lanes", "dedup", "mesh_commit", "step_nodes")
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
    if "era" in groups:
        out["era"] = era_times(torch, np, smoke, reps)
    if "lane_era" in groups:
        out["lane_era"] = lane_era_times(torch, np, smoke, reps)
    if "capture_lanes" in groups:
        out["capture_lanes"] = capture_lanes_times(torch, np, smoke, reps)
    if "dedup" in groups:
        out["dedup"] = dedup_times(torch, np, smoke)
    if "mesh_commit" in groups:
        out["mesh_commit"] = mesh_commit_times(torch, np, smoke)
    if "step_nodes" in groups:
        out["step_nodes"] = step_nodes()
    return out


def _fold_api():
    """Whether this tree's COMMIT folds the step's first hits and sums."""
    from stateright_tpu_torch.ops import era as eo

    return hasattr(eo, "FirstHits")


class _Step:
    """One step's COMMIT operands at N lanes of chunk C (numpy seed 18),
    and the call each tree makes: the fused COMMIT, or the parent's
    torch launches (stack, first hits, hs, pa, the histogram) then its
    COMMIT."""

    def __init__(self, torch, np, cfg, N, C, A, P, m, gen):
        self.torch, self.cfg, self.N, self.C, self.A, self.P, self.m = torch, cfg, N, C, A, P, m
        dev = torch.device("cuda")
        rng = np.random.default_rng(18)

        def t(a):
            return torch.from_numpy(a).to(dev)

        self.n_val = t(rng.integers(0, cfg.vcap, N))
        self.n_d = t(rng.integers(0, m, N))
        self.unres = t(np.zeros((N, m), dtype=bool))
        self.c_new = t(rng.random((N, m)) < 0.3)
        self.ddepth = t((rng.integers(2, 40, N)[:, None] + rng.integers(0, 2, (N, m))).reshape(-1))  # a BFS step's
        self.hits = [t(rng.random(N * C) < 0.002) for _ in range(P)]
        self.valid = t(rng.random(A * N * C) < 0.3)
        self.rows = tuple(t(rng.integers(0, 1 << 32, N * C)) for _ in range(3))
        self.gen = t(rng.integers(0, C * A, N)) if gen else None
        self.first0 = [t(rng.random((P, N * C)) < 0.3)] + [t(rng.integers(0, 1 << 32, (P, N * C)))
                                                          for _ in range(3)]
        if N == 1:
            self.n_val, self.n_d, self.unres, self.c_new = self.n_val[0], self.n_d[0], self.unres[0], self.c_new[0]
            self.gen = None if self.gen is None else self.gen[0]

    def first(self):
        return [x.clone() for x in self.first0]

    def commit(self, st, first, slab=None, epoch=None, scratch=None, glue=True):
        """The tree's COMMIT; on a tree whose COMMIT takes the sums, with
        the torch launches its step made before it (`glue`), else with the
        sums made once, outside."""
        torch, eo = self.torch, __import__("stateright_tpu_torch.ops.era", fromlist=["era"])
        N, C, A, P, c, m = self.N, self.C, self.A, self.P, self.cfg, self.m
        if _fold_api():
            op = eo.StepOperands(self.n_val, self.n_d, self.unres, self.c_new, self.gen, self.hits, self.valid,
                                 self.ddepth, self.rows, eo.FirstHits(*first))
            return eo.era_step(eo.COMMIT, c, st, op, slab, epoch, scratch=scratch)
        dbase = c.cov_base + A + P + 1
        if glue:
            # engines/era.py's and engines/multiplex.py's step, before COMMIT
            hseen, f1, f2, fd = first
            hits = torch.stack(self.hits)
            fresh = hits & ~hseen
            f1.copy_(torch.where(fresh, self.rows[0], f1))
            f2.copy_(torch.where(fresh, self.rows[1], f2))
            fd.copy_(torch.where(fresh, self.rows[2], fd))
            hseen |= hits
            if N == 1:
                hs = hits.sum(1)
                pa = self.valid.view(A, C).sum(1)
                st[dbase:dbase + 128].index_add_(0, self.ddepth.clamp(max=127), self.c_new.to(torch.int64))
                gen = self.gen
            else:
                hs = hits.view(P, N, C).sum(2)
                pa = self.valid.view(A, N, C).sum(2).T.contiguous()
                at = (torch.arange(N, device=st.device) * st.shape[1] + dbase)[:, None]
                st.view(-1).index_add_(0, (at + self.ddepth.view(N, m).clamp(max=127)).view(-1),
                                       self.c_new.view(-1).to(torch.int64))
                gen = self.valid.view(A, N, C).sum((0, 2))
        else:
            if not hasattr(self, "_sums"):
                hits = torch.stack(self.hits).view(P, N, C)
                v = self.valid.view(A, N, C)
                self._sums = (hits.sum(2), v.sum(2).T.contiguous(),
                              self.gen if self.gen is not None else v.sum((0, 2)))
                if N == 1:
                    self._sums = (self._sums[0][:, 0], self._sums[1][0], self._sums[2])
            hs, pa, gen = self._sums
        op = eo.StepOperands(self.n_val, self.n_d, self.unres, self.c_new, gen, hs, pa)
        if N == 1:
            return eo.era_step(eo.COMMIT, c, st, op, slab, epoch)
        return eo.era_step(eo.COMMIT, c, st, op, epoch=epoch, ticket=scratch)


def era_times(torch, np, smoke, reps) -> dict:
    """K8f's COMMIT and epilogue and K9a at the 2pc-7 and paxos-3 BFS widths."""
    from stateright_tpu_torch import kernels
    from stateright_tpu_torch.engines import era
    from stateright_tpu_torch.models import PaxosTensorExhaustive, TwoPhaseTensor
    from stateright_tpu_torch.obs.sample import DEVICE_STEP_CAP
    from stateright_tpu_torch.ops import era as eo
    from stateright_tpu_torch.ops import slab as sl

    dev = torch.device("cuda")
    rng = np.random.default_rng(19)
    fold = _fold_api()
    out = {}
    for label, tm in (("2pc-7", TwoPhaseTensor(7)), ("paxos-3", PaxosTensorExhaustive(3))):
        C, _A, _S, qcap = WIDTHS[label]
        props = tm.tensor_properties()
        A, P = tm.max_actions, len(props)
        prog = era.EraProgram(tm, props, C, qcap, 1 << 12, False, True, 64, 4, dev)
        c, x, m = prog.cfg, prog.plen, prog.rcap
        step = _Step(torch, np, c, 1, C, A, P, m, True)
        st = prog.state.clone()
        st[eo.P_COUNT], st[eo.P_HIGH_WATER], st[eo.P_GROW_LIMIT], st[eo.P_MAX_STEPS] = 3 * C, qcap, 1 << 30, 64
        st[eo.P_TAKE_CAP], st[x + eo.X_OPEN], st[x + eo.X_TAKE] = C, 1, C
        scratch = eo.step_scratch(1, P, A, dev) if fold else None
        slab, epoch = prog.slab, prog.epoch

        def prep():
            return st.clone(), step.first()

        def commit(glue):
            return lambda a: step.commit(a[0], a[1], slab, epoch, scratch, glue)

        idle = prep()
        r = dict(
            commit=smoke.time_device_ms(torch, commit(False), prep=prep),
            commit_with_glue=smoke.time_device_ms(torch, commit(True), prep=prep),
            commit_kernels=call_kernels(torch, lambda: commit(False)(idle)),
            commit_with_glue_kernels=call_kernels(torch, lambda: commit(True)(idle)),
        )
        ring_depth = prog.ring[tm.state_width + 1]
        est = st.clone()
        est[x + eo.X_ESTEPS] = est[eo.P_MAX_STEPS] = 64
        est[eo.P_BUDGET_CAP] = 64
        est[prog.f_base] = 4
        first_epi = [torch.from_numpy(rng.random((P, C)) < 0.01).to(dev)] + [
            torch.from_numpy(rng.integers(5, 9, (P, C))).to(dev) for _ in range(3)]

        def eprep():
            return [est.clone()] + [t.clone() for t in first_epi]

        epi = eo.epilogue_scratch(1, P, C, dev) if fold else None

        def epilogue(a):
            kw = dict(scratch=epi) if fold else {}
            eo.era_epilogue(c, a[0], *a[1:], ring_depth, prog.slab.counts, **kw)

        eidle = eprep()
        r.update(epilogue=smoke.time_device_ms(torch, epilogue, prep=eprep),
                 epilogue_kernels=call_kernels(torch, lambda: epilogue(eidle)))
        # K9a at rcap: phase 2's inputs.
        new = torch.from_numpy(rng.random(m) < 0.5).to(dev)
        hh = torch.from_numpy(rng.integers(0, 1 << 32, (4, m))).to(dev)
        hh[0, :40] = 0x00800000
        tight = torch.tensor([0x00800000, 0x40000000], device=dev)
        none = torch.tensor([0, 0], device=dev)

        def fresh_slab():
            return sl.empty_slab(c.scap, dev)

        cap_scratch = sl.capture_scratch(1, m, dev) if fold else None

        def capture(thresh):
            kw = dict(scratch=cap_scratch) if fold else {}
            return lambda sb: sl.capture(sb, new, hh[0], hh[1], hh[2], hh[3], thresh, DEVICE_STEP_CAP, **kw)

        spare = fresh_slab()
        r.update(
            capture=smoke.time_device_ms(torch, capture(tight), prep=fresh_slab),
            capture_empty=smoke.time_device_ms(torch, capture(none), prep=fresh_slab),
            capture_kernels=call_kernels(torch, lambda: capture(tight)(spare)),
            shape=dict(C=C, A=A, P=P, rcap=m, vcap=prog.vcap, state=x + eo.X_LEN, scap=c.scap,
                       n_new=int(new.sum()), n_below=int(sl.below_threshold(new, hh[0], hh[1], tight).sum())),
        )
        out[label] = r
        del prog
        torch.cuda.empty_cache()
    return out


def lane_era_times(torch, np, smoke, reps) -> dict:
    """K14f's COMMIT and epilogue at the 2pc-5 sweep's lanes."""
    from stateright_tpu_torch.engines.gpu_bfs import widths
    from stateright_tpu_torch.models import TwoPhaseTensor
    from stateright_tpu_torch.ops import era as eo

    dev = torch.device("cuda")
    rng = np.random.default_rng(20)
    N, C, A = LANES
    tm = TwoPhaseTensor(5)
    P, qcap = len(tm.tensor_properties()), 1 << 13
    vcap, rcap, _d = widths(A, C)
    plen = eo.params_len(A, P, True, 0)
    cfg = eo.EraConfig(chunk=C, qmask=qcap - 1, vcap=vcap, rcap=rcap, P=P, A=A, cov_base=eo.P_LEN + 2 * P,
                       s_base=-1, s_high=0, s_take=C, f_base=-1, fuse=1, x=plen, regrow=max(1, C // 16),
                       budget_min=eo.BUDGET_MIN, n_cov=eo.cov_len(A, P), scap=0)
    L = plen + eo.X_LEN
    s = rng.integers(0, 1 << 20, size=(N, L)).astype(np.int64)
    s[:, eo.P_COUNT] = rng.choice([0, 5, 3 * C], size=N)
    s[:, eo.P_HIGH_WATER], s[:, eo.P_GROW_LIMIT], s[:, eo.P_MAX_STEPS] = qcap - C * A, 1 << 30, 1 << 20
    s[:, eo.P_ERR] = s[:, eo.P_FIN_ANY] = s[:, eo.P_FIN_ALL_EN] = s[:, eo.P_BUDGET_CAP] = s[:, eo.P_REC] = 0
    s[:, plen + eo.X_OPEN] = s[:, eo.P_COUNT] > 0
    s[:, plen + eo.X_TAKE] = np.minimum(s[:, eo.P_COUNT], C)
    st = torch.from_numpy(s).to(dev)
    step = _Step(torch, np, cfg, N, C, A, P, rcap, False)
    fold = _fold_api()
    scratch = eo.step_scratch(N, P, A, dev) if fold else torch.zeros(1, dtype=torch.int64, device=dev)

    def prep():
        return st.clone(), step.first()

    def commit(glue):
        return lambda a: step.commit(a[0], a[1], None, None, scratch, glue)

    idle = prep()
    rings = torch.from_numpy(rng.integers(0, 30, (N, qcap + 1))).to(dev)
    first_epi = [torch.from_numpy(rng.random((P, N * C)) < 0.002).to(dev)] + [
        torch.from_numpy(rng.integers(1, 9, (P, N * C))).to(dev) for _ in range(3)]

    def eprep():
        return [st.clone()] + [t.clone() for t in first_epi]

    epi = eo.epilogue_scratch(N, P, C, dev) if fold else None

    def epilogue(a):
        kw = dict(scratch=epi) if fold else {}
        eo.era_epilogue(cfg, a[0], *a[1:], rings, **kw)

    eidle = eprep()
    return dict(
        commit=smoke.time_device_ms(torch, commit(False), prep=prep),
        commit_with_glue=smoke.time_device_ms(torch, commit(True), prep=prep),
        commit_kernels=call_kernels(torch, lambda: commit(False)(idle)),
        commit_with_glue_kernels=call_kernels(torch, lambda: commit(True)(idle)),
        epilogue=smoke.time_device_ms(torch, epilogue, prep=eprep),
        epilogue_kernels=call_kernels(torch, lambda: epilogue(eidle)),
        shape=dict(N=N, C=C, A=A, P=P, rcap=rcap, state=L),
    )


def capture_lanes_times(torch, np, smoke, reps) -> dict:
    """K9a for every shard at phase 18's 8-shard receive widths."""
    from stateright_tpu_torch.obs.sample import slab_high_water
    from stateright_tpu_torch.ops import slab as sl
    from stateright_tpu_torch.parallel import mesh

    dev = torch.device("cuda")
    rng = np.random.default_rng(21)
    lanes = getattr(sl, "capture_lanes", None)
    out = {}
    for label, C, A in (("2pc-7", 1024, 37), ("paxos-3", 2048, 21)):
        n = MESH_N
        R = n * mesh.quota_for(C, A, n)
        scap = slab_high_water(64) + R
        new = torch.from_numpy(rng.random((n, R)) < 0.7).to(dev)
        hr = torch.from_numpy(rng.integers(0, 1 << 32, (3, n, R))).to(dev)
        hr[0, :, :40] = 0x00800000
        act = torch.zeros(R, dtype=torch.int64, device=dev)
        scratch = sl.capture_scratch(n, R, dev) if lanes is not None else None

        def fresh():
            return (torch.zeros((4, n, scap + 1), dtype=torch.int64, device=dev),
                    torch.zeros((n, 2), dtype=torch.int64, device=dev))

        def call(thresh):
            def go(t):
                if lanes is not None:
                    return lanes(t[0], t[1], new, hr[0], hr[1], hr[2], act, thresh, R, scratch)
                for s in range(n):
                    sl.capture(sl.Slab(*t[0][:, s], t[1][s]), new[s], hr[0, s], hr[1, s], hr[2, s], act,
                               thresh, R)
            return go

        tight = torch.tensor([0x00800000, 0x40000000], device=dev)
        idle = fresh()
        out[label] = dict(
            ms=smoke.time_device_ms(torch, call(tight), prep=fresh),
            empty=smoke.time_device_ms(torch, call(torch.tensor([0, 0], device=dev)), prep=fresh),
            kernels=call_kernels(torch, lambda: call(tight)(idle)),
            by="lane form" if lanes is not None else "per-shard loop",
            shape=dict(shards=n, R=R, scap=scap, n_new=int(new.sum())),
        )
    return out


def dedup_times(torch, np, smoke) -> dict:
    """K3 at the solo BFS widths, the 2pc-5 sweep's lanes and the 8-shard
    mesh widths: each lane's valid prefix as the compaction leaves it."""
    import inspect

    from stateright_tpu_torch.engines.gpu_bfs import widths
    from stateright_tpu_torch.ops import frontier as fr
    from stateright_tpu_torch.parallel import mesh

    dev = torch.device("cuda")
    rng = np.random.default_rng(22)
    owned = "n_val" in inspect.signature(fr.claim_dedup_lanes).parameters
    cells = [("2pc-7 solo", 1, 6144, 37, False), ("paxos-3 solo", 1, 16384, 21, False),
             ("2pc-5 sweep lanes", LANES[0], LANES[1], LANES[2], False),
             ("2pc-7 8 shards", MESH_N, 1024, 37, True), ("paxos-3 8 shards", MESH_N, 2048, 21, True)]
    out = {}
    for label, N, C, A, sharded in cells:
        vcap, _rcap, cap = widths(A, C)
        if sharded:
            cap = mesh.dedup_cap_for(vcap)
        if N == 1:
            nv = np.array([int(0.8 * vcap)])
        else:
            nv = rng.integers(0, vcap + 1, size=N)
            nv[rng.random(N) < 1 / 3] = 0
        pool = rng.integers(0, 1 << 32, size=(2, vcap // 4))
        pick = rng.integers(0, pool.shape[1], size=(N, vcap))
        h1, h2 = (torch.from_numpy(pool[i, pick]).to(dev) for i in range(2))
        n_val = torch.from_numpy(nv).to(dev)
        valid = torch.arange(vcap, device=dev)[None, :] < n_val[:, None]
        if owned:
            scratch = fr.dedup_scratch(N, cap, dev)
            if N == 1:
                def call():
                    return fr.claim_dedup(h1[0], h2[0], valid[0], cap, n_val[0], scratch)
            else:
                def call():
                    return fr.claim_dedup_lanes(h1, h2, valid, cap, n_val, scratch)
        elif N == 1:
            def call():
                return fr.claim_dedup(h1[0], h2[0], valid[0], cap)
        else:
            def call():
                return fr.claim_dedup_lanes(h1, h2, valid, cap)
        out[label] = dict(
            ms=smoke.time_device_ms(torch, lambda _: call()), kernels=call_kernels(torch, call),
            shape=dict(N=N, vcap=vcap, scratch_cap=cap, prefix=int(n_val.clamp(max=vcap).sum()),
                       owned_scratch=owned),
        )
        del h1, h2, valid
        torch.cuda.empty_cache()
    return out


class _MeshStep:
    """One 8-shard step's COMMIT operands (numpy seed 23) and the call
    each tree makes: the COMMIT grid that folds the step, or the parent's
    torch launches (stack, first hits, hs, pa, generated, the owner's
    depth histogram) then its COMMIT."""

    def __init__(self, torch, np, prog):
        self.torch, self.prog = torch, prog
        dev = torch.device("cuda")
        rng = np.random.default_rng(23)
        n, C, A, P, R = prog.NL, prog.C, prog.A, prog.P, prog.R

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        self.is_new = t(rng.random((n, R)) < 0.3)
        self.unres = t(np.zeros((n, R), dtype=bool))
        self.rdepth = t(rng.integers(2, 40, n)[:, None] + rng.integers(0, 2, (n, R)))  # a BFS step's
        self.n_ovf = t(np.zeros(n, dtype=np.int64))
        self.n_val = t(rng.integers(0, prog.vcap, n))
        self.hits = [t(rng.random(n * C) < 0.002) for _ in range(P)]
        self.valid = t(rng.random(A * n * C) < 0.3)
        self.rows = tuple(t(rng.integers(0, 1 << 32, n * C)) for _ in range(3))
        st = prog.state.clone()
        st[:, 1] = 3 * C  # P_COUNT
        st[:, 6], st[:, 5], st[:, 7] = prog.qcap, 1 << 30, 64  # P_HIGH_WATER, P_GROW_LIMIT, P_MAX_STEPS
        st[:, 12] = C  # P_TAKE_CAP
        st[:, prog.x + 1], st[:, prog.x] = 1, C  # X_OPEN, X_TAKE
        self.st = st

    def prep(self):
        p = self.prog
        return self.st.clone(), self.torch.zeros_like(p.sums), [t.clone() for t in (p.hseen, p.facc1, p.facc2,
                                                                                      p.faccd)]

    def commit(self, a, glue=True):
        torch, p = self.torch, self.prog
        me = __import__("stateright_tpu_torch.ops.mesh_era", fromlist=["mesh_era"])
        st, sums, (hseen, f1, f2, fd) = a
        n, C, A, P = p.NL, p.C, p.A, p.P
        if hasattr(me, "commit_scratch"):
            ops = me.MeshOperands(
                is_new=self.is_new, unresolved=self.unres, rdepth=self.rdepth, n_ovf=self.n_ovf, n_val=self.n_val,
                hits=self.hits, valid=self.valid, rows=self.rows, hseen=hseen, facc1=f1, facc2=f2, faccd=fd,
                slab_counts=p.slab_counts)
            return me.mesh_era(me.COMMIT, p.cfg, st, sums, ops, scratch=p.commit_scratch)
        if glue:
            # parallel/mesh.py's step before the fold, then its COMMIT
            hits = torch.stack(self.hits)
            first = hits & ~hseen
            f1.copy_(torch.where(first, self.rows[0], f1))
            f2.copy_(torch.where(first, self.rows[1], f2))
            fd.copy_(torch.where(first, self.rows[2], fd))
            hseen |= hits
            hs = hits.view(P, n, C).sum(2)
            valid = self.valid.view(A, n, C)
            pa = valid.sum(2).T.contiguous()
            dbase = p.cov_base + A + P + 1
            at = (torch.arange(n, device=st.device) * p.L + dbase)[:, None]
            st.view(-1).index_add_(0, (at + self.rdepth.clamp(max=127)).view(-1), self.is_new.view(-1).to(torch.int64))
            gen = valid.sum((0, 2))
        else:
            if not hasattr(self, "_sums"):
                valid = self.valid.view(A, n, C)
                self._sums = (torch.stack(self.hits).view(P, n, C).sum(2), valid.sum(2).T.contiguous(),
                              valid.sum((0, 2)))
            hs, pa, gen = self._sums
        ops = me.MeshOperands(is_new=self.is_new, unresolved=self.unres, n_ovf=self.n_ovf, n_val=self.n_val,
                              generated=gen, hs=hs, pa=pa, hseen=hseen, slab_counts=p.slab_counts)
        return me.mesh_era(me.COMMIT, p.cfg, st, sums, ops)


def mesh_commit_times(torch, np, smoke) -> dict:
    """K15f's COMMIT, alone and with the glue before it, at the 8-shard
    widths of phase 18 (2pc-7, paxos-3) and of 2pc-10 at 8 shards."""
    from stateright_tpu_torch.models import PaxosTensorExhaustive, TwoPhaseTensor
    from stateright_tpu_torch.parallel import mesh

    dev = torch.device("cuda")
    out = {}
    for label, tm, C in (("2pc-7", TwoPhaseTensor(7), 1024), ("paxos-3", PaxosTensorExhaustive(3), 2048),
                         ("2pc-10", TwoPhaseTensor(10), 1024)):
        prog = mesh.MeshProgram(tm, tm.tensor_properties(), C, 1 << 16, 1 << 12, MESH_N,
                                mesh.quota_for(C, tm.max_actions, MESH_N), True, 64, 1, dev)
        step = _MeshStep(torch, np, prog)
        idle = step.prep()
        out[label] = dict(
            commit=smoke.time_device_ms(torch, lambda a: step.commit(a, False), prep=step.prep),
            commit_with_glue=smoke.time_device_ms(torch, lambda a: step.commit(a, True), prep=step.prep),
            commit_kernels=call_kernels(torch, lambda: step.commit(idle, False)),
            commit_with_glue_kernels=call_kernels(torch, lambda: step.commit(idle, True)),
            shape=dict(N=MESH_N, C=C, A=prog.A, P=prog.P, R=prog.R, L=prog.L),
        )
        del prog, step
        torch.cuda.empty_cache()
    return out


def step_nodes() -> dict:
    """Kernel nodes of one captured step of each program (gates closed,
    after one eager step: every lazy initialisation)."""
    import torch

    from stateright_tpu_torch.engines import era, graph
    from stateright_tpu_torch.engines.multiplex import warm_lane_program
    from stateright_tpu_torch.models import PaxosTensorExhaustive, TwoPhaseTensor
    from stateright_tpu_torch.parallel import mesh

    dev = torch.device("cuda")
    out = {}

    def closed(prog, x):
        st = prog.state
        st[..., x + 1] = 0  # X_OPEN
        st[..., x] = 0  # X_TAKE
        prog._step()
        return dict(graph.captured_nodes(prog._step))

    for label, tm, C, qcap in (("2pc-7", TwoPhaseTensor(7), 6144, 1 << 20),
                               ("paxos-3", PaxosTensorExhaustive(3), 16384, 1 << 21)):
        prog = era.EraProgram(tm, tm.tensor_properties(), C, qcap, 1 << 12, False, True, 64, 4, dev)
        out[label] = closed(prog, prog.plen)
        del prog
    lanes = warm_lane_program(TwoPhaseTensor(5), device="cuda")
    out["2pc-5 lanes (32)"] = closed(lanes, lanes.plen)
    del lanes
    for label, tm, C in (("2pc-7", TwoPhaseTensor(7), 1024), ("paxos-3", PaxosTensorExhaustive(3), 2048)):
        prog = mesh.MeshProgram(tm, tm.tensor_properties(), C, 1 << 17, 1 << 14, MESH_N,
                                mesh.quota_for(C, tm.max_actions, MESH_N), True, 64, 1, dev)
        out[f"{label} mesh (8 shards)"] = closed(prog, prog.x)
        del prog
        torch.cuda.empty_cache()
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
