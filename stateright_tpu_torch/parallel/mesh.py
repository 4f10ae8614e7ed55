"""Sharded exhaustive BFS: the port of `stateright_tpu/parallel/mesh.py`
(K15, `_build_block:152`; its grow, `_build_grow:1089`; the host engine
`ShardedBfsChecker:1148`).

Shard `h1 % N` owns a fingerprint: its visited table and its ring hold
only the states it owns. In one sharded step every shard pops a chunk,
expands it, compacts, dedups, and sends each candidate to its owner
(K15a, ops/exchange.py); the owner recomputes the fingerprint, inserts
and appends. The era's gate is a sum over all N shards, identical on
every shard (K15f, ops/mesh_era.py), so the shards run in lockstep, and
a shard that cannot consume (its bucket for some owner overflowed its
quota, or an owner anywhere left an insert unresolved) re-delivers its
pops next step with half the take.

**Layout.** A rank holds its NL = N / W shards as a leading shard axis
on ONE device: the kernels' lane axis (the multiplexed engine's) is the
shard axis. The tables are [NL, tcap], the rings [NL, S + 2, qcap + 1],
the state [NL, L] (one JAX params row a shard, ops/mesh_era.py).

    START                                 K15f START
    while another inner era runs:         (at most fuse_lim)
        BEGIN                             K15f BEGIN: the global gate
        while the gate is open:
            1. pop each shard's take                   K7, lane form
            2. fingerprints of the rows [S, NL*C]      K1
            3. properties + successors, ONCE at NL*C   K11 expand
            4. validity compaction per shard           K2, lane form
            5. fingerprints of the candidates          K1
            6. in-batch dedup per shard                K3, lane form
            7. owner buckets into the receive layout   K15a
               (W > 1: one all_to_all_single)
            8. owner-side fingerprints                 K1
            9. insert at R = N * quota rows per owner  K4, lane form
           10. sample capture, every shard at once    K9a, lane form
           11. ring append per owner                   K7, lane form
           12. the fold (first hits, counts, depth     K15f COMMIT (one
               histogram), COMMIT and the gate         grid)
        EPILOGUE                          K15f EPILOGUE
    TAIL                                  K15f TAIL, K9b over every shard

**One rank (W = 1).** On the card a dispatch is ONE CUDA graph
(engines/graph.py), the step captured once in a conditional WHILE node
and the fused eras in another, as the solo era graph (engines/era.py):
every moving word stays on the card and the host reads back the shards'
state once. On the CPU the same segments run eagerly.

**Several ranks (`group=`).** Each rank runs its shards on its own
device and the host drives every step: K15f's phases run one launch each
with an `all_reduce` of the sums vector between them, the exchange is one
`all_to_all_single`, and a dispatch's rows are all-gathered, so every
rank's host sees the JAX engine's [N, params] readback and makes the same
decisions. Capturing the collectives in the graph is left for later.
Every rank must call `discoveries()` and `space_profile()` (their walks
are collective).

Symmetry: as the JAX sharded engine, this engine does not canonicalize;
under `.symmetry()` it explores the full space, as JAX does.

**Spill and checkpoints** (mesh.py:1229-1245, :1776-1800, :1952-1985,
:2281-2410). Past a shard's high water its newest rows go to that
shard's host LIFO (ops/tiering.py, the host budget split across the
shards): one K7s DRAIN launch over every shard past high water and one
download, kept in blocks of N * quota rows; before each dispatch one
K7s REFILL launch puts whole blocks back at every shard's tail. Spill
is local to a rank, and the ranks exchange the rows each shard took back
(one all_reduce). A checkpoint gathers every rank's shards to rank 0,
which writes the one file in the JAX layout; a resume gives each rank
its shards of the file. A probe error with a checkpoint on disk reloads
it and doubles every shard's table (the degraded regrow, K15g).

Not ported: the proactive reshard, which needs the memory ledger
(slice 4b).
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..checker import CheckerBuilder
from ..core import Expectation
from ..engines import graph as gr
from ..engines.common import (
    HostEngineBase, checkpoint_generations, checkpoint_meta, load_checkpoint_folded,
    register_signal_checkpoint_flush, save_checkpoint_tiered, validate_checkpoint_cadence,
    validate_checkpoint_meta,
)
from ..engines.era import widths
from ..engines.gpu_bfs import (
    GpuBfsChecker, ProbeBudgetExhausted, adapt_budget_cap, poll_target_of, resolve_device, run_chain,
)
from ..fingerprint import combine64, hash_lanes, hash_words_np, split64
from ..obs.sample import slab_entries, slab_high_water
from ..ops import exchange as xc
from ..ops import frontier as fr
from ..ops import mesh_era as me
from ..ops import slab as sl
from ..ops import visited_set as vs
from ..ops.expand import build_expand_lean
from ..ops.tiering import TieredSpillStore, spill_host_budget_bytes
from ..ops.mesh_era import (
    P_COUNT, P_ERR, P_GEN, P_HEAD, P_MAX_STEPS, P_MAXD, P_REC, P_STEPS, P_TAKE_CAP, P_UNIQUE,
)
from ..path import Path
from ..tensor import TensorModel, TensorModelAdapter
from ..xp import TorchXP

M32 = 0xFFFFFFFF


def quota_for(chunk: int, A: int, n_shards: int) -> int:
    """Per-destination exchange quota (mesh.py:1196): the receive width
    N * quota also caps a shard's inserts a step."""
    return max(64, (chunk * max(1, A)) // (4 * n_shards))


def dedup_cap_for(vcap: int) -> int:
    """The pre-exchange dedup scratch, at the compacted width (mesh.py:175)."""
    return 1 << max(1, (2 * vcap - 1).bit_length())


def world_of(group):
    """(world size, rank) of a process group, (1, 0) without one."""
    if group is None:
        return 1, 0
    import torch.distributed as dist

    return dist.get_world_size(group), dist.get_rank(group)


class MeshProgram:
    """One run's sharded era program and workspace on a rank's device
    (see the module doc): `NL` local shards of `n_total`, the tables,
    rings, per-shard state and sums, the sample slabs, the first-hit
    lanes, the exchange buffer and the expand closure at width NL *
    chunk."""

    def __init__(self, tm, props, chunk: int, qcap: int, tcap: int, n_total: int, quota: int,
                 cov: bool, sample_k: int, fuse: int, device, group=None, in_flight: int = 1,
                 table: Optional[vs.VisitedTable] = None):
        self.tm, self.props = tm, list(props)
        self.device = dev = torch.device(device)
        self.group = group
        self.world, self.rank = world_of(group)
        if n_total % self.world:
            raise ValueError(f"the world size {self.world} must divide the {n_total} shards")
        NL = self.NL = n_total // self.world
        self.n_total, self.quota = n_total, quota
        S, A, P, C = tm.state_width, tm.max_actions, len(self.props), chunk
        self.S, self.A, self.P, self.C = S, A, P, C
        self.qcap, self.cov, self.sample_k = qcap, cov, sample_k
        self.fuse = max(1, int(fuse))
        self.vcap = widths(A, C)[0]
        self.dedup_cap = dedup_cap_for(self.vcap)
        R = self.R = n_total * quota
        X = self.X = S + 4
        self.plen = me.shard_params_len(A, P, cov, sample_k, self.fuse)
        ncov = me.cov_len(A, P) if cov else 0
        nsamp = me.sample_tail_len(sample_k)
        self.cov_base = me.P_LEN if cov else -1
        self.s_base = me.P_LEN + ncov if sample_k else -1
        self.f_base = me.P_LEN + ncov + nsamp if self.fuse > 1 else -1
        self.d_base = self.plen
        self.x = self.plen + 3 * P
        self.L = self.x + me.X_LEN
        self.sk2 = slab_entries(sample_k) if sample_k else 0
        s_high = slab_high_water(sample_k) if sample_k else 0
        self.scap = s_high + R if sample_k else 0
        if sample_k and dev.type == "cuda" and self.scap > sl.SLAB_MAX_ROWS:
            raise ValueError(
                f"the per-shard sample slab ({self.scap:,} rows: its high water plus the receive "
                f"width {R:,}) exceeds the {sl.SLAB_MAX_ROWS:,} rows K9b holds; lower chunk_size "
                "or turn sampling off with .sample(False)"
            )
        self.cfg = me.MeshConfig(
            chunk=C, qmask=qcap - 1, P=P, A=A, cov_base=self.cov_base, s_base=self.s_base,
            s_high=s_high, f_base=self.f_base, fuse=self.fuse, d_base=self.d_base, x=self.x,
            regrow=max(1, C // 16), budget_min=me.BUDGET_MIN, n_cov=ncov, scap=self.scap,
            sum_cov=me.S_GATE + 4 + P, vcap=self.vcap,
        )
        z = torch.zeros
        self.state = z((NL, self.L), dtype=torch.int64, device=dev)
        self.sums = z(me.sums_len(A, P, cov), dtype=torch.int64, device=dev)
        self.rings = fr.empty_ring(S + 2, qcap, dev, lanes=NL)
        # `table`: the local shards' tables to run on (a resumed run's).
        self.table = vs.empty_table(tcap, dev, lanes=NL) if table is None else table
        self.epoch = torch.full((1,), self.table.epoch + 1, dtype=torch.int64, device=dev)
        self.slab = self.slab_counts = None
        if sample_k:
            self.slab = z((4, NL, self.scap + 1), dtype=torch.int64, device=dev)
            self.slab_counts = z((NL, 2), dtype=torch.int64, device=dev)
            self._no_action = z(R, dtype=torch.int64, device=dev)
            self._capture_scratch = sl.capture_scratch(NL, R, dev)
        self.dedup_scratch = fr.dedup_scratch(NL, self.dedup_cap, dev) if dev.type == "cuda" else None
        self.commit_scratch = me.commit_scratch(NL, P, A, dev) if dev.type == "cuda" else None
        self.hseen = z((P, NL * C), dtype=torch.bool, device=dev)
        self.facc1, self.facc2, self.faccd = (
            z((P, NL * C), dtype=torch.int64, device=dev) for _ in range(3)
        )
        self.send = z(xc.send_shape(self.world, X, NL, quota), dtype=torch.int64, device=dev)
        self.delivered = torch.empty_like(self.send) if self.world > 1 else None
        self.xp = TorchXP(dev)
        self.expand = build_expand_lean(tm, self.props, NL * C, self.xp)
        self.lane_c = torch.arange(NL, device=dev) * C
        self.arange_c = torch.arange(C, device=dev)
        self._depth_limit = self.state[0, me.P_DEPTH_LIMIT]
        self._reduce = None
        if self.world > 1:
            import torch.distributed as dist

            self._reduce = lambda t: dist.all_reduce(t, group=group)
        self._graph: Optional[gr.Graph] = None
        self.graph_captures = 0
        self.capture_secs = 0.0
        # One rank on the card: the dispatch is a graph. Several ranks:
        # the host drives it, on any device.
        self._graphed = dev.type == "cuda" and self.world == 1
        if self._graphed:
            self._readback = gr.Readback(self.state, in_flight + 1)

    # -- the workspace -------------------------------------------------------

    def set_table(self, table: vs.VisitedTable) -> None:
        """Run on `table` ([NL, capacity]) from the next dispatch on."""
        self.table = table
        self.epoch.fill_(table.epoch + 1)
        self.free_graph()

    def grow(self) -> int:
        """Double every local shard's table, rehashing on the device (K5:
        K4's lane form over the occupied rows, mesh.py:1089); returns the
        new capacity. Every rank grows together."""
        old = self.table
        new = vs.empty_table(old.capacity * 2, self.device, lanes=self.NL)
        k1, k2 = vs.unpack64(old.keys)
        v1, v2 = vs.unpack64(old.parents)
        _new, unres = vs.insert_lanes(new, k1, k2, v1, v2, vs.occupied_mask(old))
        bad = unres.sum().reshape(1)
        if self._reduce is not None:
            self._reduce(bad)
        if int(bad):
            raise RuntimeError("rehash failed; table pathologically full")
        self.set_table(new)
        return new.capacity

    def upload(self, vals: np.ndarray) -> None:
        """Overwrite this rank's shard rows from the mesh's [N, L] rows."""
        rows = vals[self.rank * self.NL:(self.rank + 1) * self.NL]
        self.state.copy_(torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int64)))

    def seed(self, slots, rows: np.ndarray) -> None:
        """Seed the mesh's empty tables and rings with the host's: `slots`
        maps each shard's filled slots to their keys (`host_insert`; parents
        0), `rows` [N, n, S + 2] holds each shard's first ring rows. This
        rank keeps its shards."""
        lo = self.rank * self.NL
        self.set_table(vs.empty_table(self.table.capacity, self.device, lanes=self.NL))
        at = [(l, slot, h1, h2) for l in range(self.NL) for slot, (h1, h2) in slots[lo + l].items()]
        if at:
            l, slot, h1, h2 = (torch.tensor(v, dtype=torch.int64) for v in zip(*at))
            keys = vs.pack64(h1, h2).to(self.device)
            self.table.keys.view(-1).index_copy_(0, (l * self.table.capacity + slot).to(self.device), keys)
        self.rings.zero_()
        local = torch.from_numpy(np.ascontiguousarray(rows[lo:lo + self.NL].transpose(0, 2, 1)))
        self.rings[:, :, :local.shape[2]].copy_(local)

    # -- the segments (each a child graph on the card) -----------------------

    def _era(self, mode, ops=me.MeshOperands(), handle: int = 0) -> None:
        me.mesh_era(mode, self.cfg, self.state, self.sums, ops, self._reduce, handle, self.commit_scratch)

    def _start(self, handle: int = 0) -> None:
        self._era(me.START, me.MeshOperands(slab=self.slab, slab_counts=self.slab_counts), handle)

    def _begin(self, handle: int = 0) -> None:
        self._era(me.BEGIN, me.MeshOperands(hseen=self.hseen, slab_counts=self.slab_counts), handle)

    def _deliver(self, send: torch.Tensor) -> torch.Tensor:
        """The receive buffer [X, NL, R]: on one rank the send buffer
        itself; across ranks one all_to_all_single, then `receive`."""
        if self.world == 1:
            return send.view(self.X, self.NL, self.R)
        import torch.distributed as dist

        dist.all_to_all_single(self.delivered.view(-1), send.view(-1), group=self.group)
        return xc.receive(self.delivered)

    def _step(self, handle: int = 0) -> None:
        """One sharded step of every local shard (mesh.py:303-500) at the
        takes the gate set, then K15f COMMIT."""
        NL, C, S, A, P, R = self.NL, self.C, self.S, self.A, self.P, self.R
        vcap = self.vcap
        st, x = self.state, self.x
        take = st[:, x + me.X_TAKE]
        active = (self.arange_c[None, :] < take[:, None]).view(-1)
        popped = fr.ring_pop_lanes(self.rings, st[:, P_HEAD].contiguous(), C)
        rows, ebits, depth = popped[:S], popped[S], popped[S + 1]
        row_h1, row_h2 = hash_lanes(rows)
        ex = self.expand(rows, ebits, depth, active, self._depth_limit)
        valid = ex.valid.view(A, NL, C)
        # Shard l's candidates in the solo order a*C + c (engines/multiplex.py).
        vids, vvalid, n_val = vs.compact_ids_lanes(valid.transpose(0, 1), vcap)
        lane_c = self.lane_c[:, None]
        cl = ex.flat.index_select(1, ((vids // C) * (NL * C) + lane_c + vids % C).view(-1))
        ch1, ch2 = hash_lanes(cl)
        src = (lane_c + vids % C).view(-1)  # the candidate's parent row
        vv = vvalid.view(-1)
        reps = fr.claim_dedup_lanes(ch1.view(NL, vcap), ch2.view(NL, vcap), vvalid, self.dedup_cap, n_val,
                                    self.dedup_scratch)
        vals = torch.cat([
            cl, ex.ebits.index_select(0, src)[None], (depth.index_select(0, src) + 1)[None],
            torch.where(vv, row_h1.index_select(0, src), 0)[None],
            torch.where(vv, row_h2.index_select(0, src), 0)[None],
        ])
        send, n_ovf = xc.exchange(ch1, reps, vals, self.n_total, self.quota, self.world, out=self.send)
        recv = self._deliver(send)
        rh1, rh2 = hash_lanes(recv[:S].reshape(S, NL * R))  # the owner's recompute
        rh1, rh2 = rh1.view(NL, R), rh2.view(NL, R)
        rp1, rp2 = recv[S + 2], recv[S + 3]
        rdepth = recv[S + 1]
        on_card = self.device.type == "cuda"
        is_new, unres = vs.insert_lanes(
            self.table, rh1, rh2, rp1, rp2, (rp1 | rp2) != 0, epoch=self.epoch if on_card else None,
        )
        if on_card:
            self.epoch += 1  # the insert's stamp epoch rises after every call
        if self.slab is not None:
            # Every shard's capture in one launch, under the shared threshold.
            sl.capture_lanes(self.slab, self.slab_counts, is_new, rh1, rh2, rdepth, self._no_action,
                             st[0, self.s_base:self.s_base + 2], R, self._capture_scratch)
        fr.ring_scatter_lanes(self.rings, st[:, x + me.X_TAIL].contiguous(),
                              recv[:S + 2].reshape(S + 2, NL * R), is_new)
        # COMMIT folds the first hits, the hit and action counts and the
        # owner's depth histogram (every step) in (ops/mesh_era.py).
        ops = me.MeshOperands(
            is_new=is_new, unresolved=unres, rdepth=rdepth if self.cov else None, n_ovf=n_ovf,
            n_val=n_val, hits=ex.prop_hits if P else None, valid=ex.valid,
            rows=(row_h1, row_h2, depth) if P else None, hseen=self.hseen, facc1=self.facc1,
            facc2=self.facc2, faccd=self.faccd, slab_counts=self.slab_counts,
        )
        self._era(me.COMMIT, ops, handle)

    def _epilogue(self, handle: int = 0) -> None:
        self._era(me.EPILOGUE, me.MeshOperands(
            hseen=self.hseen, facc1=self.facc1, facc2=self.facc2, faccd=self.faccd,
            ring_depth=self.rings[:, self.S + 1], slab_counts=self.slab_counts,
        ), handle)

    def _tail(self) -> None:
        """The dispatch's output rows (mesh.py:762-810): the coverage tail
        summed over the mesh, the error word, the sample tail — each
        shard's sk2 smallest slab rows by fp1 (K9b, one launch over every
        shard's slab)."""
        self._era(me.TAIL, me.MeshOperands(slab_counts=self.slab_counts))
        if self.slab is None:
            return
        b, k = self.s_base + 4, self.sk2
        fp1, fp2, depth, _action, valid = sl.bottom_k_lanes(self.slab, self.slab_counts, k)
        self.state[:, b:b + 4 * k].view(self.NL, 4, k).copy_(
            torch.stack([fp1, fp2, depth, valid.to(torch.int64)], dim=1)
        )

    # -- dispatch ------------------------------------------------------------

    def run_eager(self) -> None:
        """One dispatch, segment by segment, reading the uniform gate and
        the fused loop's continuation from shard 0's row."""
        x = self.x
        self._start()
        while True:
            self._begin()
            while int(self.state[0, x + me.X_OPEN]):
                self._step()
            self._epilogue()
            if not int(self.state[0, x + me.X_MORE]):
                break
        self._tail()

    def launch(self):
        """Start one dispatch; returns a handle for `result`. On one rank
        on the card: one graph launch and the readback queued behind it;
        otherwise the dispatch itself."""
        if not self._graphed:
            self.run_eager()
            return self.state.cpu().numpy().copy()
        if self._graph is None:
            self._capture()
        main = torch.cuda.current_stream(self.device)
        self._readback.before_launch(main)
        self._graph.launch(main)
        return self._readback.after_launch(main), self._graph

    def result(self, handle) -> np.ndarray:
        """The mesh's rows [N, L] after a dispatch: across ranks every
        rank's rows, all-gathered. On the card this also counts the
        launches of the graph."""
        if not self._graphed:
            if self.world == 1:
                return handle
            import torch.distributed as dist

            parts = [torch.empty_like(self.state) for _ in range(self.world)]
            dist.all_gather(parts, self.state, group=self.group)
            return torch.cat(parts).cpu().numpy()
        read, g = handle
        vals = self._readback.wait(read)
        gr.count_era(g, int(vals[0, self.x + me.X_ITER]), int(vals[0, self.x + me.X_K]))
        return vals

    def ran(self, vals: np.ndarray) -> bool:
        """Whether the dispatch that left the mesh's rows `vals` ran a step."""
        return vals[0, self.x + me.X_ITER] != 0

    def _capture(self) -> None:
        """Capture the five segments into the era graph (`gr.build_era`,
        the solo era's shape). A failure raises."""
        x = self.x
        saved = self.state.clone()
        # Run the step once with the gate closed: it changes nothing but
        # the exchange buffer, and every lazy initialisation happens first.
        self.state[:, x + me.X_OPEN] = 0
        self.state[:, x + me.X_TAKE] = 0
        self._step()
        self.state.copy_(saved)
        self._graph = gr.build_era(self.device, self._start, self._begin, self._step, self._epilogue,
                                   self._tail)
        self.graph_captures += 1
        self.capture_secs += self._graph.secs

    def free_graph(self) -> None:
        if self._graph is not None:
            self._readback.drain()
            self._graph.free()
            self._graph = None


# -- path reconstruction ---------------------------------------------------------

def mesh_parent_chains(table: vs.VisitedTable, fps: Sequence[int], n_total: int,
                       rank: int = 0, group=None) -> List[List[int]]:
    """Walk the parent fingerprints of every fp at once across the shard
    tables, hopping to owner h1 % N at each step (mesh.py:2481): one K6
    lane-form launch a hop on this rank's shards ([NL, tcap]); across
    ranks each rank answers the queries it owns and an all_reduce joins
    the answers, so every rank must call it with the same fps. Returns
    each chain, leaf first."""
    chains = [[int(fp)] for fp in fps]
    live = list(range(len(chains)))
    dev = table.device
    nl = table.keys.shape[0]
    lo = rank * nl
    limit = n_total * table.capacity + 1
    hops = 0
    while live:
        hops += 1
        if hops > limit:
            raise RuntimeError("parent chain longer than the state count")
        pairs = [split64(chains[i][-1]) for i in live]
        h = torch.tensor(pairs, dtype=torch.int64).reshape(-1, 2).T.to(dev)
        h1, h2 = h[0].contiguous(), h[1].contiguous()
        owner = h1 % n_total
        mine = (owner >= lo) & (owner < lo + nl)
        found, p1, p2 = vs.lookup_parent_lanes(table, (owner - lo).clamp(0, nl - 1), h1, h2)
        ans = torch.stack([(found & mine).to(torch.int64), torch.where(mine, p1, 0),
                           torch.where(mine, p2, 0)])
        if group is not None:
            import torch.distributed as dist

            dist.all_reduce(ans, group=group)
        f, a, b = ans.tolist()
        keep = []
        for j, i in enumerate(live):
            if not f[j]:
                s = split64(chains[i][-1])[0] % n_total
                raise RuntimeError(
                    f"fingerprint {chains[i][-1]} missing from shard {s} during path reconstruction"
                )
            if a[j] or b[j]:
                chains[i].append(combine64(a[j], b[j]))
                keep.append(i)
        live = keep
    return chains


def host_insert(slots: Dict[int, tuple], cap: int, h1: int, h2: int) -> None:
    """Seed one shard's table on the host with the device insert's probe
    sequence (mesh.py:2416): `slots` maps a filled slot to its key."""
    stride = (h2 | 1) & M32
    idx = h1 & (cap - 1)
    while idx in slots:
        if slots[idx] == (h1, h2):
            return
        idx = (idx + stride) & (cap - 1)
    slots[idx] = (h1, h2)


# -- the host engine ---------------------------------------------------------------

class ShardedGpuBfsChecker(HostEngineBase):
    """Sharded batched BFS over a TensorModel behind the Checker API
    (spawn with `CheckerBuilder.spawn_sharded_bfs()`; see the module doc).

    `devices`: the shard count N (an int) or a list of N devices; the
    shards of one rank must share one device (`device`, CUDA by default,
    when `devices` is an int). `group`: an initialized
    `torch.distributed` process group over which the N shards are
    spread, N / W a rank."""

    def __init__(
        self,
        builder: CheckerBuilder,
        *,
        devices=None,
        chunk_size: int = 1024,
        queue_capacity_per_shard: int = 1 << 16,
        table_capacity_per_shard: int = 1 << 18,
        sync_steps: int = 4096,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: Optional[float] = None,
        resume_from: Optional[str] = None,
        keep_checkpoints: int = 2,
        device=None,
        group=None,
    ):
        model = builder.model
        if isinstance(model, TensorModel):
            model = TensorModelAdapter(model)
        if not isinstance(model, TensorModelAdapter):
            raise TypeError("spawn_sharded_bfs requires a TensorModel (or its adapter)")
        self._group = group
        self._world, self._rank = world_of(group)
        self.n_shards, self.device = self._placement(devices, device)
        super().__init__(builder, model=model, device=self.device)
        self.tm: TensorModel = model.tm
        self._tprops = self.tm.tensor_properties()
        if len(self._tprops) > 32:
            raise ValueError("at most 32 tensor properties supported")
        if self.n_shards % self._world:
            raise ValueError(
                f"the world size {self._world} must divide the shard count {self.n_shards}"
            )
        if queue_capacity_per_shard & (queue_capacity_per_shard - 1):
            raise ValueError("queue capacity must be a power of two")
        A = max(1, self.tm.max_actions)
        self._chunk = min(chunk_size, queue_capacity_per_shard // (2 * A))
        if self._chunk == 0:
            raise ValueError("queue capacity too small for this model's fanout")
        self._qcap = queue_capacity_per_shard
        self._tcap = table_capacity_per_shard
        self._max_sync_steps = sync_steps
        self._quota = quota_for(self._chunk, A, self.n_shards)
        if self._qcap < 4 * self.n_shards * self._quota:
            raise ValueError(
                "queue_capacity_per_shard must be at least 4 * n_shards * "
                f"quota (= {4 * self.n_shards * self._quota}); got "
                f"{self._qcap}. Raise the queue capacity or lower chunk_size."
            )
        self._cov = self._coverage.enabled
        self._sample_k = self._sampler.k if self._sampler is not None else 0
        self._pipeline = builder.pipeline_
        self._chain_depth = max(1, int(builder.pipeline_depth_ or 2))
        self._fuse = max(1, int(builder.fuse_eras_ or 1))
        self._unique = 0
        self._discovery_fps: Dict[str, int] = {}
        self._prog: Optional[MeshProgram] = None
        # One spill LIFO a local shard, the host budget split evenly across
        # all N shards (mesh.py:1229-1245).
        budget = spill_host_budget_bytes()
        if budget is not None:
            budget = max(1, budget // self.n_shards)
        nl = self.n_shards // self._world
        self._spill: List[TieredSpillStore] = [
            TieredSpillStore(host_budget_bytes=budget, on_tier=self._on_spill_tier,
                             label=f"spill-s{self._rank * nl + s}")
            for s in range(nl)
        ]
        # Checkpoints: the solo engine's protocol over the shards' state
        # (mesh.py:1247-1276).
        validate_checkpoint_cadence(checkpoint_every, checkpoint_path, keep_checkpoints)
        self._ckpt_path = checkpoint_path
        self._ckpt_every = checkpoint_every
        self._ckpt_keep = keep_checkpoints
        self._resume_from = resume_from
        self._last_ckpt = time.monotonic()
        self._ckpt_delta = None
        self._chaos_probe_error_era: Optional[int] = None
        if checkpoint_path is not None:
            register_signal_checkpoint_flush(self)
        self._init_ebits = 0
        e = 0
        for p in self._tprops:
            if p.expectation == Expectation.EVENTUALLY:
                self._init_ebits |= 1 << e
                e += 1
        self._start()

    def _placement(self, devices, device):
        if devices is None:
            return 1, resolve_device(device)
        if isinstance(devices, int):
            if devices < 1:
                raise ValueError("the shard count must be positive")
            return devices, resolve_device(device)
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("devices is empty")
        n = len(devs)
        nl = n // self._world if n % self._world == 0 else n
        local = devs[self._rank * nl:(self._rank + 1) * nl]
        if len(set(local)) > 1:
            raise NotImplementedError(
                "distinct devices in one process are not supported: one rank runs its "
                "shards on one device; spread shards over devices with group= (one "
                "torch.distributed rank a device)"
            )
        return n, resolve_device(local[0])

    def _timed_out(self) -> bool:
        return bool(self._host_flags()[0])

    def _host_flags(self, ckpt_frac: float = 1.0, *extra: float) -> np.ndarray:
        """[timed out, stop requested, checkpoint due at `ckpt_frac` of its
        cadence, *extra], each the largest over every rank, in one
        collective: a host decision that reads the wall clock or a signal
        must come out the same on every rank, or the ranks' dispatches
        (and collectives) part."""
        due = self._ckpt_every is not None and (
            time.monotonic() - self._last_ckpt >= self._ckpt_every * ckpt_frac)
        return self._all_max(np.array(
            [float(super()._timed_out()), float(self._ckpt_stop.is_set()), float(due), *extra]))

    # -- the run ---------------------------------------------------------------

    def _run(self) -> None:
        try:
            self._run_engine()
        finally:
            for store in self._spill:
                store.close()

    def _run_engine(self) -> None:
        tm = self.tm
        S, N = tm.state_width, self.n_shards
        # The host drives every step across ranks: nothing to chain there.
        pipeline = self._pipeline and self._target_state_count is None and self._world == 1
        depth = self._chain_depth if pipeline else 0

        def program(table=None):
            prog = MeshProgram(
                tm, self._tprops, self._chunk, self._qcap, self._tcap, N, self._quota, self._cov,
                self._sample_k, self._fuse, self.device, self._group, in_flight=depth + 1,
                table=table,
            )
            self._gauge("expand_route", prog.expand.route)
            return prog

        if self._resume_from is not None:
            data, meta = self._read_checkpoint(self._resume_from)
            prog = self._prog = program(self._table_of(data))
            start = self._install_checkpoint(prog, data, meta, table_set=True)
        else:
            inits = np.asarray(tm.init_states_array(), dtype=np.uint32)
            inb = np.asarray(
                tm.within_boundary_lanes(np, tuple(inits[:, i] for i in range(S))), dtype=bool
            )
            inits = inits[inb]
            self._state_count = len(inits)
            if len(inits) == 0:
                return
            h1, h2 = hash_words_np(inits)
            # Route the inits to their owners (every row, duplicates too) and
            # seed the tables on the host with the device insert's probe
            # sequence (mesh.py:1323-1370), keeping only the slots it fills.
            owners = h1.astype(np.int64) % N
            counts = np.bincount(owners, minlength=N).astype(np.int64)
            if counts.max() > self._qcap:
                raise ValueError(
                    f"shard {int(counts.argmax())} would receive {int(counts.max())} initial "
                    f"states, exceeding queue_capacity_per_shard={self._qcap}"
                )
            rows = np.zeros((N, int(counts.max()), S + 2), dtype=np.int64)
            filled = np.zeros(N, dtype=np.int64)
            slots: List[Dict[int, tuple]] = [{} for _ in range(N)]
            for i in range(len(inits)):
                o = int(owners[i])
                rows[o, filled[o], :S] = inits[i]
                rows[o, filled[o], S] = self._init_ebits
                rows[o, filled[o], S + 1] = 1
                filled[o] += 1
                host_insert(slots[o], self._tcap, int(h1[i]), int(h2[i]))
            per_shard_unique = [len(t) for t in slots]
            self._unique = sum(per_shard_unique)
            self._coverage.record_depth(1, self._unique)
            if self._sampler is not None:
                fps = (h1.astype(np.uint64) << np.uint64(32)) | h2.astype(np.uint64)
                self._sampler.offer_array(fps, depths=np.ones(len(inits), dtype=np.int64), states=inits)
            prog = self._prog = program()
            prog.seed(slots, rows)
            start = dict(heads=np.zeros(N, dtype=np.int64), counts=counts, take_caps=[self._chunk] * N,
                         per_shard_unique=per_shard_unique, rec_bits=0, disc_depth_best={},
                         spilled=np.zeros(N, dtype=np.int64))
        try:
            self._run_loop(prog, start, depth)
        finally:
            prog.free_graph()

        def stage_programs():
            from ..engines import stages

            progs = stages.mesh_stages(tm, self._tprops, self._chunk, self._qcap, N, self._quota,
                                       self._stage_iters, self.device, self._group)
            return progs, (prog.table, prog.rings)

        # The stage programs run every shard in lockstep: a step of the
        # attribution is a lockstep step (mesh.py:2246).
        self._profile_stages(stage_programs, self._counters.get("steps", 0) // N)

    def _run_loop(self, prog: MeshProgram, start: dict, depth: int) -> None:
        """The JAX engine's `_run_loop` (mesh.py:1498) without resharding
        and the flight recorder; the chain is `gpu_bfs.run_chain`."""
        tm = self.tm
        S, A, C, N, P = tm.state_width, tm.max_actions, self._chunk, self.n_shards, len(self._tprops)
        NL, lo = prog.NL, self._rank * prog.NL
        L, x = prog.L, prog.x
        d_base, s_base, f_base, sk2 = prog.d_base, prog.s_base, prog.f_base, prog.sk2
        cov_base = prog.cov_base
        depth_limit = self._target_max_depth if self._target_max_depth is not None else M32
        reserve = N * self._quota  # a step's receive width: its most inserts a shard
        high_water = self._qcap - reserve
        # Spill hysteresis (mesh.py:1543): blocks of N * quota rows; the
        # target is >= 1.5 blocks (qcap >= 4 N quota), so an empty shard
        # always refills at least one.
        spill_target = max(high_water // 2, high_water - 64 * reserve)
        block = reserve
        fin_any, fin_all, fin_all_en = self._finish_when.device_masks(self._tprops)
        adaptive = self._timeout is not None or self._ckpt_every is not None
        max_sync = self._max_sync_steps if not adaptive else min(me.BUDGET_MIN, self._max_sync_steps)
        budget = max_sync
        budget_cap = min(me.BUDGET_MIN, max_sync) if adaptive else 0
        cap_limit = min(self._max_sync_steps, 1 << 30)
        poll_target = poll_target_of(self._timeout, self._ckpt_every)
        sampler = self._sampler
        heads, counts = start["heads"], start["counts"]
        take_caps, per_shard_unique = start["take_caps"], start["per_shard_unique"]
        rec_bits, disc_depth_best = start["rec_bits"], start["disc_depth_best"]
        # Rows each shard holds in its spill, known on every rank.
        spilled = start["spilled"]
        # A shard drains at most qcap - spill_target rows; a larger refill
        # goes up in pieces of that size.
        staging = fr.SpillStaging(S + 2, self.device, NL * (self._qcap - spill_target))
        last_thresh = None
        stop = False
        imbalance_warned = False
        chain_max = 0
        regrow_budget = 8  # each degraded regrow doubles every table

        def fuse_lim_now() -> int:
            # mesh.py:1585 without auto-N (it reads the flight recorder).
            if self._fuse <= 1 or spilled.any() or self._target_state_count is not None:
                return 1
            near_deadline = self._deadline is not None and (
                time.monotonic() >= self._deadline - self._timeout / 2)
            _, _, half_due, late = self._host_flags(0.5, float(near_deadline))
            return 1 if half_due or late else self._fuse

        def consume(vals, era_wall, in_flight) -> None:
            """One dispatch's rows [N, L] (mesh.py:1612)."""
            nonlocal heads, counts, take_caps, per_shard_unique, rec_bits, budget, budget_cap
            nonlocal stop, imbalance_warned, spilled
            n_inner = max(1, min(int(vals[0, f_base + 1]), self._fuse)) if f_base >= 0 else 1
            err = bool(vals[:, P_ERR].any())
            if not err and self._chaos_probe_error_era is not None and (
                self._counters.get("eras", 0) >= self._chaos_probe_error_era
            ):
                self._chaos_probe_error_era = None
                err = True
            if err:
                raise ProbeBudgetExhausted("visited-table probe budget exhausted despite headroom")
            heads = vals[:, P_HEAD].astype(np.int64)
            counts = vals[:, P_COUNT].astype(np.int64)
            take_caps = list(vals[:, P_TAKE_CAP].astype(np.int64))
            budget = int(vals[0, P_MAX_STEPS])
            # The budget moves alike on every rank: the era wall rides the
            # boundary's one collective.
            timed_out, stop_req, due, era_wall = self._host_flags(1.0, era_wall)
            self._metrics.add_phase("device_era", era_wall)
            budget_cap = adapt_budget_cap(budget_cap, era_wall, n_inner, poll_target, cap_limit)
            per_shard_unique = list(vals[:, P_UNIQUE].astype(np.int64))
            self._unique = int(sum(per_shard_unique))
            gen = int(vals[:, P_GEN].sum())
            self._state_count += gen
            self._max_depth = max(self._max_depth, int(vals[:, P_MAXD].max()))
            self._inc("eras", n_inner)
            self._inc("steps", int(vals[:, P_STEPS].sum()))
            self._inc("states_generated", gen)
            self._inc("partial_steps", int(vals[:, x + me.X_PARTIAL].sum()))
            self._gauge("take_cap", int(min(take_caps)))
            if self._cov:
                row = vals[0]  # the tail is summed over the mesh
                cov = self._coverage
                cov.record_action_counts(row[cov_base:cov_base + A].tolist())
                expanded = int(row[cov_base + A + P])
                for i, p in enumerate(self._tprops):
                    cov.record_property_eval(p.name, expanded)
                    cov.record_property_hit(p.name, int(row[cov_base + A + i]))
                cov.record_depth_counts(row[cov_base + A + P + 1:cov_base + me.cov_len(A, P)].tolist())
            if sampler is not None:
                # The union of the per-shard drains is the global bottom-k.
                for s in range(N):
                    row = vals[s]
                    occupied = int(row[s_base + 2])
                    if occupied:
                        off = s_base + 4
                        sampler.drain_slab(
                            row[off:off + sk2], row[off + sk2:off + 2 * sk2],
                            row[off + 2 * sk2:off + 3 * sk2], row[off + 3 * sk2:off + 4 * sk2],
                            occupied,
                        )
            block_bits = int(np.bitwise_or.reduce(vals[:, P_REC]))
            if block_bits:
                fp1 = vals[:, d_base:d_base + P]
                fp2 = vals[:, d_base + P:d_base + 2 * P]
                depths = vals[:, d_base + 2 * P:d_base + 3 * P]
                if f_base >= 0:
                    e_off = f_base + 2 + 4 * self._fuse
                    disc_era = vals[:, e_off:e_off + P]
                for i, p in enumerate(self._tprops):
                    if not (block_bits >> i) & 1:
                        continue
                    if f_base >= 0:
                        # The serial driver's (depth, era, shard) tie-break.
                        s = int(np.lexsort((np.arange(N), disc_era[:, i], depths[:, i]))[0])
                    else:
                        s = int(np.argmin(depths[:, i]))
                    d = int(depths[s, i])
                    if p.name not in self._discovery_fps or d < disc_depth_best.get(p.name, 1 << 62):
                        disc_depth_best[p.name] = d
                        self._discovery_fps[p.name] = combine64(int(fp1[s, i]), int(fp2[s, i]))
                rec_bits |= block_bits
            ks = np.where(counts > high_water, counts - spill_target, 0).astype(np.int64)
            if ks.any():
                # S3 (mesh.py:1776-1800): every local shard past high water
                # in one K7s launch and one download; every rank takes the
                # same decision from the all-gathered counts. A chained
                # dispatch past this boundary ran no step.
                local = ks[lo:lo + NL]
                with self._metrics.phase("spill"):
                    big = staging.drain(prog.rings, (heads + counts - ks)[lo:lo + NL].tolist(),
                                        local.tolist())
                off = 0
                for j in range(NL):
                    for b in range(0, int(local[j]), block):
                        self._spill[j].append(big[off + b:off + min(int(local[j]), b + block)])
                    off += int(local[j])
                counts = counts - ks
                spilled += ks
                self._inc("spill_rows", int(ks.sum()))
                deepest = float(big[:, S + 1].max()) if len(big) else 0.0
                self._max_depth = max(self._max_depth, int(self._all_max(deepest)))
                self._gauge("spill_host_peak_bytes", max(
                    sum(st.host_bytes() for st in self._spill),
                    self._counters.get("spill_host_peak_bytes", 0)))
            occ_mean = float(counts.mean())
            imbalance = float(counts.max()) / occ_mean if occ_mean > 0 else 1.0
            self._gauge("shard_imbalance", round(imbalance, 4))
            self._gauge("shard_imbalance_max",
                        max(imbalance, self._counters.get("shard_imbalance_max", 0.0)))
            self._gauge("shard_frontier_rows", {str(s): int(counts[s]) for s in range(N)})
            if imbalance > me.SHARD_IMBALANCE_WARN and occ_mean >= C and not imbalance_warned:
                imbalance_warned = True
                warnings.warn(
                    f"cross-shard frontier imbalance {imbalance:.2f}: the busiest shard holds "
                    "several times the mean occupancy (ownership hashing is skewed for this "
                    "model)", RuntimeWarning, stacklevel=2,
                )
            if not in_flight and self._ckpt_path is not None and due:
                self._save_checkpoint(prog, heads, counts, rec_bits, take_caps, disc_depth_best,
                                      per_shard_unique)
            if self._finish_matched(self._discovery_fps):
                stop = True
            elif (
                self._target_state_count is not None
                and self._state_count >= self._target_state_count
            ):
                stop = True
            elif timed_out:
                stop = True
            elif stop_req:
                self._gauge("interrupted", 1)
                stop = True

        def quiet() -> bool:
            # No host-only concern could fire (mesh.py:2084-2096).
            return not (spilled.any() or self._host_flags().any())

        def clean() -> bool:
            # No host work due at this boundary (mesh.py:2120-2135): a
            # tightened sample threshold breaks the chain too.
            return (
                not stop and counts.sum() > 0 and not spilled.any()
                and max(per_shard_unique) + reserve <= vs.MAX_LOAD * self._tcap
                and (sampler is None or sampler.threshold_parts() == last_thresh)
            )

        while not stop and (counts.sum() > 0 or spilled.any()):
            # S4 (mesh.py:1952-1985): whole LIFO blocks back to each local
            # shard while they fit under the target, one upload and one
            # K7s launch for every shard; the ranks exchange the rows taken.
            local_k = np.zeros(NL, dtype=np.int64)
            blocks: List[np.ndarray] = []
            for j in range(NL):
                s = lo + j
                while self._spill[j] and (
                    counts[s] + local_k[j] + self._spill[j].peek_rows() <= spill_target
                ):
                    blocks.append(self._spill[j].pop())
                    local_k[j] += len(blocks[-1])
            if blocks:
                with self._metrics.phase("refill"):
                    staging.refill(prog.rings, (heads + counts)[lo:lo + NL].tolist(), local_k.tolist(),
                                   np.concatenate(blocks, axis=0))
            refilled = np.zeros(N, dtype=np.int64)
            refilled[lo:lo + NL] = local_k
            # `spilled` comes from the all-gathered counts, so every rank
            # takes this branch alike.
            if self._world > 1 and spilled.any():
                import torch.distributed as dist

                t = torch.from_numpy(refilled)
                if dist.get_backend(self._group) != "gloo":
                    t = t.to(self.device)
                dist.all_reduce(t, group=self._group)
                refilled = t.cpu().numpy()
            if refilled.any():
                counts = counts + refilled
                spilled -= refilled
                self._inc("refill_rows", int(refilled.sum()))
            if counts.sum() == 0:
                if spilled.any():
                    # Unreachable by the block-size invariant above; loud
                    # beats silently dropping spilled states.
                    raise RuntimeError("empty frontier with stranded spill")
                break
            while max(per_shard_unique) + reserve > vs.MAX_LOAD * self._tcap:
                with self._metrics.phase("table_grow"):
                    self._tcap = prog.grow()
                self._inc("table_growths")
            grow_limit = max(0, int(vs.MAX_LOAD * self._tcap) - reserve)
            max_steps = min(budget, budget_cap) if adaptive else budget
            if self._target_state_count is not None:
                remaining = max(0, self._target_state_count - self._state_count)
                max_steps = max(1, min(max_steps, 1 + remaining // max(1, N * C * A)))
            # Every serial dispatch starts from rows the host builds
            # (mesh.py:2030-2052); a chained one from the rows on the card.
            params = np.zeros((N, L), dtype=np.int64)
            for s in range(N):
                params[s, :me.P_LEN] = [
                    heads[s], counts[s], per_shard_unique[s], rec_bits, depth_limit,
                    grow_limit, high_water, max_steps, 0, 0, 0, 0, take_caps[s],
                    fin_any, fin_all, fin_all_en, budget_cap,
                ]
            if sampler is not None:
                last_thresh = sampler.threshold_parts()
                params[:, s_base:s_base + 2] = last_thresh
            if f_base >= 0:
                params[:, f_base] = fuse_lim_now()
            prog.upload(params)
            t0 = time.monotonic()
            pending = prog.launch()
            self._inc("dispatches")
            try:
                chain_max = max(chain_max, run_chain(self, prog, pending, t0, depth, consume, clean,
                                                     lambda: None, quiet))
            except ProbeBudgetExhausted:
                # The degraded regrow (mesh.py:1636-1685): reload the last
                # checkpoint and double every shard's table (K15g).
                if (
                    self._ckpt_path is None or regrow_budget == 0
                    or not checkpoint_generations(self._ckpt_path)
                ):
                    raise
                regrow_budget -= 1
                data, meta = self._read_checkpoint(self._ckpt_path)
                st = self._install_checkpoint(prog, data, meta)
                heads, counts, take_caps = st["heads"], st["counts"], st["take_caps"]
                per_shard_unique, rec_bits = st["per_shard_unique"], st["rec_bits"]
                disc_depth_best, spilled = st["disc_depth_best"], st["spilled"]
                with self._metrics.phase("table_grow"):
                    self._tcap = prog.grow()
                self._inc("degraded_regrow")
                self._inc("table_growths")

        if self._ckpt_path is not None:
            self._save_checkpoint(prog, heads, counts, rec_bits, take_caps, disc_depth_best,
                                  per_shard_unique)
        self._gauge("spec_chain_depth", chain_max)
        self._gauge(
            "fused_eras_per_dispatch",
            round(self._counters.get("eras", 0) / max(1, self._counters.get("dispatches", 0)), 3),
        )
        self._gauge("graph_captures", prog.graph_captures)
        self._gauge("capture_secs", prog.capture_secs)

    # -- spill tiers and checkpoints --------------------------------------------

    def _on_spill_tier(self, direction, rows, nbytes, disk_bytes) -> None:
        """The shards' tier moves: the reference's counters, the disk
        gauge over this rank's shards (mesh.py:1391-1414)."""
        self._inc("spill_tier_rows" if direction == "ram_to_disk" else "spill_tier_refill_rows", rows)
        self._gauge("spill_disk_bytes", sum(st.disk_bytes() for st in self._spill))

    def _gather(self, obj):
        """Every rank's `obj`, in rank order, on rank 0 (None elsewhere)."""
        if self._world == 1:
            return [obj]
        import torch.distributed as dist

        out = [None] * self._world if self._rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self._group)
        return out

    def _save_checkpoint(self, prog, heads, counts, rec_bits, take_caps, disc_depth_best,
                         per_shard_unique) -> None:
        """The sharded engine state (mesh.py:2281-2352): the shards'
        tables as four [N, tcap] uint32 lanes, the rings [N, qcap] a lane,
        each shard's spill blocks and the meta, one crash-safe npz (a full
        base or a table delta). Rank 0 gathers every rank's shards and
        writes it."""
        P = len(self._tprops)
        k1, k2, v1, v2 = (lane.reshape(prog.NL, -1) for lane in vs.table_to_lanes(prog.table))
        state = prog.state.cpu().numpy()
        local = dict(
            tables=(k1, k2, v1, v2),
            rings=prog.rings[:, :, :self._qcap].cpu().numpy().astype(np.uint32),
            rec=state[:, prog.d_base:prog.d_base + 2 * P].astype(np.uint32),
            spill=[list(st.iter_blocks()) for st in self._spill],
        )
        parts = self._gather(local)
        if parts is not None:
            self._write_checkpoint(parts, heads, counts, rec_bits, take_caps, disc_depth_best,
                                   per_shard_unique, prog.rings.shape[1])
        if self._world > 1:
            import torch.distributed as dist

            dist.barrier(group=self._group)  # the file is whole before any rank reads it
        self._last_ckpt = time.monotonic()

    def _write_checkpoint(self, parts, heads, counts, rec_bits, take_caps, disc_depth_best,
                          per_shard_unique, ring_lanes: int) -> None:
        P = len(self._tprops)
        meta = checkpoint_meta(
            self.tm,
            self._tprops,
            n_shards=self.n_shards,
            ring_lanes=ring_lanes,
            qcap=self._qcap,
            tcap=self._tcap,
            chunk=self._chunk,
            quota=self._quota,
            max_probes=vs.MAX_PROBES,
            rec_bits=rec_bits,
            state_count=self._state_count,
            unique=self._unique,
            max_depth=self._max_depth,
            discovery_fps={k: str(v) for k, v in self._discovery_fps.items()},
            disc_depth_best={k: int(v) for k, v in disc_depth_best.items()},
            per_shard_unique=[int(u) for u in per_shard_unique],
            take_caps=[int(t) for t in take_caps],
            sampler=self._sampler.export_state() if self._sampler is not None else None,
        )
        rec = np.concatenate([p["rec"] for p in parts])
        arrays = {
            "heads": np.asarray(heads, dtype=np.int64),
            "counts": np.asarray(counts, dtype=np.int64),
            "rec_fp1": rec[:, :P],
            "rec_fp2": rec[:, P:],
        }
        for t in range(4):
            arrays[f"table{t}"] = np.concatenate([p["tables"][t] for p in parts])
        rings = np.concatenate([p["rings"] for p in parts])
        for w in range(rings.shape[1]):
            arrays[f"queue{w}"] = np.ascontiguousarray(rings[:, w])
        shard_blocks = [blocks for p in parts for blocks in p["spill"]]
        for s, blocks in enumerate(shard_blocks):
            for i, blk in enumerate(blocks):
                arrays[f"spill_{s}_{i}"] = blk
        self._ckpt_delta = save_checkpoint_tiered(
            self._ckpt_path, meta, arrays, state=self._ckpt_delta, tcap=self._tcap,
            keep=self._ckpt_keep, metrics=self._counted(),
        )

    def _read_checkpoint(self, path: str):
        """Load and verify the newest good checkpoint (every rank reads
        the one file), check it belongs to this checker and restore the
        host's side: counters, discoveries, the sample and this rank's
        shards' spill (mesh.py:2354-2410)."""
        with self._metrics.phase("checkpoint_load"):
            data, meta = load_checkpoint_folded(path, metrics=self._counted())
        validate_checkpoint_meta(
            meta, self.tm, self._tprops,
            exact={
                "n_shards": self.n_shards,
                "qcap": self._qcap,
                "state_width": self.tm.state_width,
                "chunk": self._chunk,
                "quota": self._quota,
                "ring_lanes": self.tm.state_width + 2,
                "max_probes": vs.MAX_PROBES,
            },
        )
        self._tcap = meta["tcap"]
        self._state_count = meta["state_count"]
        self._unique = meta["unique"]
        self._max_depth = meta["max_depth"]
        self._discovery_fps = {k: int(v) for k, v in meta["discovery_fps"].items()}
        if self._sampler is not None and meta.get("sampler"):
            self._sampler.restore_state(meta["sampler"])
        lo = self._rank * len(self._spill)
        for j, store in enumerate(self._spill):
            store.reset(data[k] for k in self._spill_keys(data, lo + j))
        self._ckpt_delta = None  # the next save is a fresh base
        return data, meta

    @staticmethod
    def _spill_keys(data, s: int) -> List[str]:
        return sorted((k for k in data if k.startswith(f"spill_{s}_")),
                      key=lambda n: int(n.rsplit("_", 1)[1]))

    def _table_of(self, data) -> vs.VisitedTable:
        """This rank's shards' tables from a checkpoint's [N, tcap] lanes."""
        nl = self.n_shards // self._world
        lo = self._rank * nl
        return vs.table_from_lanes(*(np.asarray(data[f"table{t}"])[lo:lo + nl] for t in range(4)),
                                   device=self.device)

    def _install_checkpoint(self, prog, data, meta, table_set: bool = False) -> dict:
        """Put a read checkpoint's shards (this rank's) on the device;
        returns the loop's starting host state."""
        if not table_set:
            prog.set_table(self._table_of(data))
        lo, nl = self._rank * prog.NL, prog.NL
        W = prog.rings.shape[1]
        q = np.stack([np.asarray(data[f"queue{w}"], dtype=np.uint32)[lo:lo + nl] for w in range(W)], 1)
        prog.rings.zero_()
        prog.rings[:, :, :self._qcap].copy_(torch.from_numpy(q.astype(np.int64)))
        # The discovery outputs as the reference's carried operands hold them.
        P = len(self._tprops)
        rows = prog.state.cpu().numpy()
        rows[:, prog.d_base:prog.d_base + P] = np.asarray(data["rec_fp1"])[lo:lo + nl]
        rows[:, prog.d_base + P:prog.d_base + 2 * P] = np.asarray(data["rec_fp2"])[lo:lo + nl]
        prog.state.copy_(torch.from_numpy(rows))
        spilled = np.array([sum(len(data[k]) for k in self._spill_keys(data, s))
                            for s in range(self.n_shards)], dtype=np.int64)
        return dict(
            heads=data["heads"].astype(np.int64), counts=data["counts"].astype(np.int64),
            take_caps=list(meta["take_caps"]), per_shard_unique=list(meta["per_shard_unique"]),
            rec_bits=meta["rec_bits"],
            disc_depth_best={k: int(v) for k, v in meta["disc_depth_best"].items()},
            spilled=spilled,
        )

    def _all_max(self, value):
        """The largest of every rank's `value` (a float, or a float64 array
        taken element by element), in one collective."""
        if self._world == 1:
            return value
        import torch.distributed as dist

        t = torch.from_numpy(np.array(value, dtype=np.float64).reshape(-1))
        if dist.get_backend(self._group) != "gloo":
            t = t.to(self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._group)
        out = t.cpu().numpy()
        return out if isinstance(value, np.ndarray) else float(out[0])

    # -- accessors -------------------------------------------------------------

    def telemetry(self):
        tel = super().telemetry()
        tel.update(
            n_shards=self.n_shards, world_size=self._world, quota=self._quota,
            chunk=self._chunk, table_capacity=self._tcap,
            load_factor=round(self._unique / max(1, self.n_shards * self._tcap), 4),
        )
        return tel

    def unique_state_count(self) -> int:
        return self._unique

    # The solo engine's: both walk every chain at once and re-execute the
    # model along it (`_reconstruct_many`).
    discoveries = GpuBfsChecker.discoveries
    _sample_resolver = GpuBfsChecker._sample_resolver

    def _reconstruct_many(self, fps) -> List[Path]:
        """Walk every fp's parent chain across the shard tables on the
        device (`mesh_parent_chains`), then re-execute the model along it."""
        if not fps:
            return []
        chains = mesh_parent_chains(self._prog.table, fps, self.n_shards, self._rank, self._group)
        return [Path.from_fingerprints(self._model, chain[::-1]) for chain in chains]


class ShardedBfs:
    """Build a ShardedGpuBfsChecker from a bare TensorModel (mesh.py:2518)."""

    def __init__(self, tm: TensorModel, devices=None, **kw):
        self._tm = tm
        self._devices = devices
        self._kw = kw
        self.checker: Optional[ShardedGpuBfsChecker] = None

    def run(self) -> "ShardedBfs":
        builder = TensorModelAdapter(self._tm).checker()
        self.checker = ShardedGpuBfsChecker(builder, devices=self._devices, **self._kw)
        self.checker.join()
        return self

    @property
    def state_count(self):
        return self.checker.state_count()

    @property
    def unique_state_count(self):
        return self.checker.unique_state_count()

    @property
    def max_depth(self):
        return self.checker.max_depth()

    @property
    def discovery_fps(self):
        return self.checker._discovery_fps


# -- the JAX block's operands, for the parity tests ---------------------------------

def state_from_jax(prog: MeshProgram, table, queue, params) -> None:
    """Load the JAX block's operands (numpy, the whole mesh): table =
    (keys [N, 2 tcap], parents1 [N, tcap], parents2 [N, tcap]), queue =
    the S + 2 lanes [N, qcap], params [N, params_len]; this rank keeps
    its shards. The discovery outputs and the port's words start zero."""
    lo, hi = prog.rank * prog.NL, (prog.rank + 1) * prog.NL
    keys = np.asarray(table[0], dtype=np.uint32)[lo:hi]
    tcap = keys.shape[1] // 2
    prog.set_table(vs.table_from_lanes(keys[:, :tcap], keys[:, tcap:], table[1][lo:hi], table[2][lo:hi],
                                       prog.device))
    q = np.stack([np.asarray(lane, dtype=np.uint32)[lo:hi] for lane in queue], 1).astype(np.int64)
    prog.rings.zero_()
    prog.rings[:, :, :prog.qcap].copy_(torch.from_numpy(q))
    vals = np.zeros((prog.n_total, prog.L), dtype=np.int64)
    vals[:, :prog.plen] = np.asarray(params, dtype=np.uint32)
    prog.upload(vals)


def state_to_jax(prog: MeshProgram):
    """This rank's workspace as the JAX block's outputs (numpy uint32):
    (keys, parents1, parents2), the queue lanes, rec_fp1, rec_fp2, params
    and disc_depth, each [NL, ...]."""
    vals = prog.state.cpu().numpy().astype(np.uint64).astype(np.uint32)
    P, d = prog.P, prog.d_base
    k = prog.table.keys.cpu().numpy().view(np.uint64)
    v = prog.table.parents.cpu().numpy().view(np.uint64)
    lo = np.uint64(M32)
    keys = np.concatenate([(k >> np.uint64(32)).astype(np.uint32), (k & lo).astype(np.uint32)], 1)
    ring = prog.rings[:, :, :prog.qcap].cpu().numpy().astype(np.uint32)
    return (
        (keys, (v >> np.uint64(32)).astype(np.uint32), (v & lo).astype(np.uint32)),
        tuple(ring[:, w] for w in range(ring.shape[1])),
        vals[:, d:d + P].copy(), vals[:, d + P:d + 2 * P].copy(),
        vals[:, :prog.plen].copy(), vals[:, d + 2 * P:d + 3 * P].copy(),
    )
