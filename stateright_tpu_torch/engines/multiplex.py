"""Multiplexed lanes on the card: N same-signature BFS checks as lanes of
ONE device program — the port of `stateright_tpu/engines/multiplex.py`
(K14, `_build_lane_program:86`, which runs `jax.vmap` over the K10 seed
and the raw era loop).

A lane here is one check, as in the reference; a state's columns stay
its state lanes, and the ring's W rows its state-row lanes. Each lane
seeds its own table from the shared init rows (K10's lane form), then
runs ONE era of the raw BFS loop (`tpu_bfs.py:247 _build_loop(...,
raw=True)`): no sampling, no symmetry, no growth. Every lane keeps its
JAX params row, word for word, in the lanes' state [N, params_len +
X_LEN] on the card (ops/era.py), and a batch is (K14f):

  seed       zero the tables and rings; K10's lane form; each lane's head,
             count, unique and error words; K8f START and BEGIN over the
             lane axis (every lane's gate, OR-ed into the loop's)
  while any lane's gate is open:
    1. ring pop of each lane's take                 K7 ring, lane form
    2. fingerprints of the popped rows [S, N*C]     K1 hash_lanes
    3. properties + successors, ONCE at width N*C   K11 expand (depth limit per row)
    4. validity compaction per lane                 K2, lane form, over the
                                                    [A, N, C] mask read as [N, A, C]
    5. fingerprints of the candidates               K1
    6. in-batch dedup per lane                      K3, lane form
    7. compaction to rcap per lane                  K2, lane form
    8. insert into each lane's table                K4, lane form
    9. ring append per lane                         K2 + K7, lane forms
   10. COMMIT and the gate of every lane, with the   K8f step kernel, lane axis
       first hits and the depth histogram
  epilogue   each lane's discoveries and max depth  K8f epilogue, lane axis

The take, head and tail of a lane are words of its row, so nothing of a
step leaves the card. The expand's candidates are action-major over all
lanes (candidate a*N*C + l*C + c), while K2's stable order, K3's and
K4's winner (the highest index) and the ring order follow the solo order
a*C + c within a lane: step 4 reads each lane's [A, C] slice through a
strided view, never a global compaction split afterwards.

The lane COMMIT applies the solo rules per lane: an overflow commits the
inserted prefix, consumes nothing and halves take_cap. A lane's gate is
the solo gate (empty frontier, ring past high water, table past its
growth limit, `_LANE_MAX_STEPS`, a probe error, its finish masks); a
lane whose gate closed takes 0 rows, so nothing of it changes — its
ring, table, counters, coverage and take_cap stay as they were, which is
what vmap's select-mask gives the reference. Padding lanes (params all
zero) start closed. Each lane keeps its own `target_max_depth`, partial
commits and coverage. Its result equals, bit for bit, the JAX lane with
the same builder: the lanes' params rows are the JAX `params_out`.

On the card a batch is ONE graph launch (engines/graph.py: the seed
segment, a conditional WHILE node over the step, the epilogue) and ONE
readback of the lanes' state; the discovery paths are then walked on the
card by K6 over the lanes' stacked tables, every chain of every lane in
one launch a hop. On the CPU (`device="cpu"`) the same segments run
eagerly with the plain versions, the host reading the lanes' gates after
each step.

The warm executable (`warm_lane_program`): the kernels built, the
expand closure at lane width, the lane workspace (stacked tables, rings,
the lanes' state, the init slab) allocated once and the batch's graph
captured once (by the first batch), reused by every batch: a batch
writes its inputs — the init slab, each lane's init count and params
row, the per-row depth limits — into the workspace in place. One owner
holds it: the `ExecutableCache` entry (engines/compiled.py) of its
signature and shape, so the cache's capacity bounds the workspaces on
the device and an evicted entry frees its own.

`run_multiplexed(checkpoint_path=, resume_from=)` snapshots each
completed batch and resumes from the snapshots that verify (JAX
multiplex.py:342-395). Not here: the run service that feeds this
engine (slice 4b).
"""

from __future__ import annotations

import os
import threading
import time
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..checker import Checker, CheckerBuilder
from ..core import Expectation
from ..fingerprint import combine64, hash_lanes
from ..obs.coverage import Coverage
from ..ops import era as eo
from ..ops import frontier as fr
from ..ops import visited_set as vs
from ..ops.expand import build_expand_lean
from ..path import Path
from ..tensor import TensorModel, TensorModelAdapter
from ..xp import TorchXP
from . import graph as gr
from .common import (
    CheckpointCorruptError, checkpoint_meta, load_checkpoint_verified, save_checkpoint_atomic,
    validate_checkpoint_meta,
)
from .compiled import ExecutableCache, intern_model, model_signature
from .gpu_bfs import U32_MAX, parent_chains, resolve_device, seed_lanes, widths

__all__ = ["LANE_PROGRAMS", "MultiplexLaneChecker", "lane_options", "run_multiplexed", "warm_lane_program"]

# Step budget of a lane's one era (the reference's): small checks finish
# in tens to hundreds of steps; the budget only backstops a runaway model.
_LANE_MAX_STEPS = 1 << 20

# The cache that owns the warm lane programs when the caller of
# run_multiplexed passes none. A program holds its workspace on the
# device (1.95 GB at 1,024 lanes of 2pc-5), so the capacity is small.
LANE_PROGRAMS = ExecutableCache(capacity=2)


def lane_options(tm: TensorModel, *, lanes: int = 32, chunk: int = 256,
                 queue_capacity: int = 1 << 13, table_capacity: int = 1 << 16,
                 init_capacity: int = 64, coverage: bool = True,
                 device=None) -> Dict[str, Any]:
    """The lane shape, validated and clamped like the solo engine's, with
    the defaults filled in and the device resolved: the options a warm
    lane program is built from and cached under."""
    if queue_capacity & (queue_capacity - 1):
        raise ValueError("queue_capacity must be a power of two")
    chunk = min(chunk, queue_capacity // (2 * max(1, tm.max_actions)))
    if chunk == 0:
        raise ValueError("queue_capacity too small for this model's fanout")
    return dict(lanes=lanes, chunk=chunk, queue_capacity=queue_capacity,
                table_capacity=table_capacity, init_capacity=init_capacity,
                coverage=bool(coverage), device=str(resolve_device(device)))


class LaneProgram:
    """The warm lane executable of one model instance and shape: kernels
    built (on the card), the expand closure at width lanes*chunk, the
    workspace — `lanes` tables of tcap slots, rings of qcap rows, the
    lanes' state [N, params_len + X_LEN], the init slab and the era's
    first-hit lanes — reused by every batch, and on the card the batch's
    graph, captured once (a batch writes its inputs into the workspace
    in place and launches it)."""

    def __init__(self, tm: TensorModel, props, lanes: int, chunk: int,
                 qcap: int, tcap: int, icap: int, cov: bool, device):
        self.tm = tm
        self.props = props
        self.lanes, self.chunk, self.qcap, self.tcap, self.icap = lanes, chunk, qcap, tcap, icap
        self.cov = cov
        self.device = dev = torch.device(device)
        self._on_card = dev.type == "cuda"
        if self._on_card:
            kernels.build_all(kernels.LANE_KERNELS + (kernels.ERA_STEP_LANES, kernels.ERA_EPILOGUE_LANES))
        N, C = lanes, chunk
        S, A, P = tm.state_width, tm.max_actions, len(props)
        self.S, self.A, self.P = S, A, P
        self.vcap, self.rcap, self.dedup_cap = widths(A, C)
        self.plen = eo.params_len(A, P, cov, 0)
        ncov = eo.cov_len(A, P) if cov else 0
        self.cov_base = eo.P_LEN + 2 * P if cov else -1
        self.cfg = eo.EraConfig(
            chunk=C, qmask=qcap - 1, vcap=self.vcap, rcap=self.rcap, P=P, A=A,
            cov_base=self.cov_base, s_base=-1, s_high=0, s_take=C, f_base=-1, fuse=1,
            x=self.plen, regrow=max(1, C // 16), budget_min=eo.BUDGET_MIN, n_cov=ncov, scap=0,
        )
        self.init_ebits = sum(1 << e for e in range(sum(
            p.expectation == Expectation.EVENTUALLY for p in props)))
        self.expand = build_expand_lean(tm, props, N * C, TorchXP(dev))
        self.table = vs.empty_table(tcap, dev, lanes=N)
        self.rings = fr.empty_ring(S + 2, qcap, dev, lanes=N)
        self.state = torch.zeros((N, self.plen + eo.X_LEN), dtype=torch.int64, device=dev)
        self.init_slab = torch.zeros((S, icap), dtype=torch.int64, device=dev)
        self.n_init = torch.zeros(N, dtype=torch.int64, device=dev)
        self.dl_rows = torch.zeros(N * C, dtype=torch.int64, device=dev)
        self.first = eo.FirstHits.zeros(P, N * C, dev)
        self.lane_c = torch.arange(N, device=dev) * C
        self.lane_v = (torch.arange(N, device=dev) * self.vcap)[:, None]
        self.arange_c = torch.arange(C, device=dev)
        # The insert's stamp epoch and the era kernels' scratch (the lanes'
        # accumulators and tickets), on the card.
        self.epoch = torch.ones(1, dtype=torch.int64, device=dev) if self._on_card else None
        self.step_scratch = eo.step_scratch(N, P, A, dev) if self._on_card else None
        self.epilogue_scratch = eo.epilogue_scratch(N, P, C, dev) if self._on_card else None
        self.dedup_scratch = fr.dedup_scratch(N, self.dedup_cap, dev) if self._on_card else None
        self.lock = threading.Lock()
        self._graph: Optional[gr.Graph] = None
        # Builds of the batch program: on the card its graph captures; on
        # the CPU the eager segments, set up with the first batch.
        self.builds = 0
        self.readbacks = 0
        self.graph_captures = 0
        self.capture_secs = 0.0
        if self._on_card:
            self._readback = gr.Readback(self.state)

    # -- the segments (each a child graph on the card) -----------------------

    def _seed(self, handle: int = 0) -> None:
        """K10's lane form (multiplex.py:117-143) into emptied tables and
        rings, the seed's counts into each lane's params (head 0, count
        n_init, unique, the unresolved inits as the error word), then the
        era's START and BEGIN: the gate of every lane."""
        st = self.state
        self.table.keys.zero_()
        self.table.parents.zero_()
        self.rings.zero_()
        unique, unres = seed_lanes(self.table, self.rings, self.init_slab, self.n_init,
                                   self.init_ebits, epoch=self.epoch)
        if self.epoch is not None:
            self.epoch += 1
        st[:, eo.P_HEAD] = 0
        st[:, eo.P_COUNT] = self.n_init
        st[:, eo.P_UNIQUE] = unique
        st[:, eo.P_ERR] = unres
        eo.era_step(eo.START, self.cfg, st)
        eo.era_step(eo.BEGIN, self.cfg, st, handle=handle, scratch=self.step_scratch)

    def _step(self, handle: int = 0) -> None:
        """One step of every lane (tpu_bfs.py:428 body under vmap) at the
        takes the gate set, then the lanes' COMMIT; every scalar it reads
        or writes stays on the device."""
        N, C, S, A, P = self.lanes, self.chunk, self.S, self.A, self.P
        vcap, rcap = self.vcap, self.rcap
        st, x = self.state, self.plen
        take = st[:, x + eo.X_TAKE]
        active = (self.arange_c[None, :] < take[:, None]).view(-1)
        popped = fr.ring_pop_lanes(self.rings, st[:, eo.P_HEAD].contiguous(), C)
        rows, ebits, depth = popped[:S], popped[S], popped[S + 1]
        row_h1, row_h2 = hash_lanes(rows)
        ex = self.expand(rows, ebits, depth, active, self.dl_rows)
        valid = ex.valid.view(A, N, C)
        # Lane l's candidates in the solo order a*C + c.
        vids, vvalid, n_val = vs.compact_ids_lanes(valid.transpose(0, 1), vcap)
        lane_c = self.lane_c
        cl = ex.flat.index_select(1, ((vids // C) * (N * C) + lane_c[:, None] + vids % C).view(-1))
        ch1, ch2 = hash_lanes(cl)
        reps = fr.claim_dedup_lanes(ch1.view(N, vcap), ch2.view(N, vcap), vvalid, self.dedup_cap, n_val,
                                    self.dedup_scratch)
        dids, dvalid, n_d = vs.compact_ids_lanes(reps, rcap)
        src = (lane_c[:, None] + vids.gather(1, dids) % C).view(-1)  # parent row
        gd = (self.lane_v + dids).view(-1)
        dp1 = torch.where(dvalid, row_h1.index_select(0, src).view(N, rcap), 0)
        dp2 = torch.where(dvalid, row_h2.index_select(0, src).view(N, rcap), 0)
        ddepth = depth.index_select(0, src) + 1
        dh1 = ch1.index_select(0, gd).view(N, rcap)
        dh2 = ch2.index_select(0, gd).view(N, rcap)
        c_new, unresolved = vs.insert_lanes(self.table, dh1, dh2, dp1, dp2, dvalid, epoch=self.epoch)
        # The inserted prefix is enqueued even on an overflow step, as in
        # the solo engine.
        fr.ring_scatter_lanes(
            self.rings, st[:, x + eo.X_TAIL].contiguous(),
            torch.cat([cl.index_select(1, gd), ex.ebits.index_select(0, src)[None], ddepth[None]]),
            c_new,
        )
        # COMMIT folds the first hits, the coverage counts, each lane's
        # generated count and the depth histogram (an overflowing lane's
        # inserts too) in (ops/era.py StepOperands).
        step = eo.StepOperands(
            n_val, n_d, unresolved, c_new, None, ex.prop_hits if P else None, ex.valid,
            ddepth if self.cov else None, (row_h1, row_h2, depth) if P else None,
            self.first if P else None,
        )
        eo.era_step(eo.COMMIT, self.cfg, st, step, epoch=self.epoch, handle=handle,
                    scratch=self.step_scratch)

    def _epilogue(self) -> None:
        eo.era_epilogue(self.cfg, self.state, *self.first, self.rings[:, self.S + 1],
                        scratch=self.epilogue_scratch)

    # -- a batch -------------------------------------------------------------

    def lane_params(self, n: int, depth_limit, fin_any, fin_all, fin_all_en) -> np.ndarray:
        """The lanes' params rows (JAX multiplex.py:479-491 `lane_params`):
        the first n from the [n] vectors, the padding lanes all zero."""
        t = np.zeros((self.lanes, self.plen), dtype=np.int64)
        t[:n, eo.P_DEPTH_LIMIT] = depth_limit
        t[:n, eo.P_HIGH_WATER] = self.qcap - self.chunk * self.A
        t[:n, eo.P_MAX_STEPS] = _LANE_MAX_STEPS
        t[:n, eo.P_TAKE_CAP] = self.chunk
        t[:n, eo.P_FIN_ANY] = fin_any
        t[:n, eo.P_FIN_ALL] = fin_all
        t[:n, eo.P_FIN_ALL_EN] = fin_all_en
        t[:n, eo.P_GROW_LIMIT] = max(0, int(vs.MAX_LOAD * self.tcap) - self.vcap)
        return t

    def load(self, inits: np.ndarray, n_init, params: np.ndarray) -> None:
        """Write one batch's inputs into the workspace in place: the init
        slab ([n_init, S] rows), each lane's init count ([N]) and params
        rows ([N, params_len]), and the expand's per-row depth limits."""
        slab = np.zeros((self.S, self.icap), dtype=np.int64)
        slab[:, :len(inits)] = np.asarray(inits, dtype=np.int64).T
        self.init_slab.copy_(torch.from_numpy(slab))
        self.n_init.copy_(torch.from_numpy(np.asarray(n_init, dtype=np.int64)))
        self.state[:, :self.plen].copy_(torch.from_numpy(params))
        self.dl_rows.copy_(torch.from_numpy(np.repeat(params[:, eo.P_DEPTH_LIMIT], self.chunk)))

    def launch_batch(self) -> np.ndarray:
        """Seed every lane and run its era to the end; returns the lanes'
        state [N, params_len + X_LEN] read back. On the card: one graph
        launch and one readback (`capture` must have run before the
        batch's `load`); on the CPU the segments run eagerly and the host
        reads the lanes' gates after each step."""
        self.readbacks += 1
        if not self._on_card:
            x = self.plen
            self._seed()
            while bool(self.state[:, x + eo.X_OPEN].any()):
                self._step()
            self._epilogue()
            return self.state.numpy().copy()
        main = torch.cuda.current_stream(self.device)
        self._readback.before_launch(main)
        self._graph.launch(main)
        vals = self._readback.wait(self._readback.after_launch(main))
        iters = int(vals[:, self.plen + eo.X_ITER].max())
        self._graph.count(dict(seed=1, step=iters, epilogue=1))
        return vals

    def capture(self) -> None:
        """Build the batch program, once: on the card, capture the seed
        (+ START + BEGIN), the step (+ COMMIT) and the epilogue into one
        graph, the step inside a WHILE node on the lanes' OR-ed gate. It
        overwrites the workspace, so it runs before a batch is loaded. A
        failure raises; nothing falls back."""
        if self.builds:
            return
        self.builds += 1
        if not self._on_card:
            return
        # Run every segment once eagerly on an empty batch (every lane
        # closed: nothing changes) so that every lazy initialisation
        # happens before the capture.
        self.n_init.zero_()
        self.state.zero_()
        self._seed()
        self._step()
        self._epilogue()

        def describe(g: gr.Graph) -> None:
            h = g.handle(g.root)
            seed = g.child(g.root, None, g.capture("seed", lambda: self._seed(h.value)))
            loop, body = g.loop(g.root, seed, h)
            g.child(body, None, g.capture("step", lambda: self._step(h.value)))
            g.child(g.root, loop, g.capture("epilogue", self._epilogue))

        self._graph = gr.build(self.device, describe)
        self.graph_captures += 1
        self.capture_secs += self._graph.secs

    def run(self, inits: np.ndarray, n: int, depth_limit: np.ndarray,
            fin_any: np.ndarray, fin_all: np.ndarray, fin_all_en: np.ndarray) -> SimpleNamespace:
        """Seed the first n lanes with `inits` [n_init, S] (the rest are
        padding) and run every lane's era to its end; the per-lane gate
        inputs are [n] vectors. Returns the batch's per-lane outcome as
        numpy [N] vectors ([N, ...] for coverage), each lane's params row
        (`params`, the JAX lane program's `params_out`) and each lane's
        discovery fingerprints. The caller holds `lock` from here until
        it has walked the batch's paths (`walk`): the next run reuses the
        tables."""
        N, P, A = self.lanes, self.P, self.A
        self.capture()
        n_init = np.zeros(N, dtype=np.int64)
        n_init[:n] = len(inits)
        self.load(inits, n_init, self.lane_params(n, depth_limit, fin_any, fin_all, fin_all_en))
        t0 = time.monotonic()
        vals = self.launch_batch()
        return self.result(vals, time.monotonic() - t0)

    def result(self, vals: np.ndarray, secs: float) -> SimpleNamespace:
        """The batch's outcome from its state rows [N, plen + X_LEN] (a
        run's readback, or a batch snapshot's)."""
        N, P, A = self.lanes, self.P, self.A
        x = self.plen
        rec = vals[:, eo.P_REC]
        fp1 = vals[:, eo.P_LEN:eo.P_LEN + P]
        fp2 = vals[:, eo.P_LEN + P:eo.P_LEN + 2 * P]
        discovery_fps = [
            {p.name: combine64(int(fp1[l, i]), int(fp2[l, i]))
             for i, p in enumerate(self.props) if (rec[l] >> i) & 1}
            for l in range(N)
        ]
        res = SimpleNamespace(
            params=vals[:, :x], unique=vals[:, eo.P_UNIQUE], count=vals[:, eo.P_COUNT],
            steps=vals[:, eo.P_STEPS], partial=vals[:, x + eo.X_PARTIAL], gen=vals[:, eo.P_GEN],
            err=vals[:, eo.P_ERR], secs=secs, iterations=int(vals[:, x + eo.X_ITER].max()),
            max_depth=vals[:, eo.P_MAXD], discovery_fps=discovery_fps,
            graph_captures=self.graph_captures, capture_secs=self.capture_secs,
            readbacks=self.readbacks, rows=vals, expand_route=self.expand.route,
        )
        if self.cov:
            b = self.cov_base
            res.act = vals[:, b:b + A]
            res.covp = vals[:, b + A:b + A + P].T
            res.expanded = vals[:, b + A + P]
            res.dhist = vals[:, b + A + P + 1:b + eo.cov_len(A, P)]
        return res

    def walk(self, lane_fps: List[Tuple[int, int]], table: Optional[vs.VisitedTable] = None
             ) -> List[List[int]]:
        """The parent chains (leaf first) of (lane, fp) pairs of the last
        run (or in `table`, a snapshot's [N, tcap] tables), walked in the
        lanes' stacked tables by K6, every chain in one launch a hop."""
        if not lane_fps:
            return []
        lanes, fps = zip(*lane_fps)
        return parent_chains(self.table if table is None else table, fps, lanes)


def warm_lane_program(tm: TensorModel, **options) -> LaneProgram:
    """Build a warm lane program for this model and the shape of
    `lane_options(tm, **options)` without running anything —
    `CompiledCheck.warm()`'s hook; the CompiledCheck keeps it."""
    o = lane_options(tm, **options)
    return LaneProgram(
        tm, tm.tensor_properties(), o["lanes"], o["chunk"], o["queue_capacity"],
        o["table_capacity"], o["init_capacity"], o["coverage"], torch.device(o["device"]),
    )


class MultiplexLaneChecker(Checker):
    """One lane's results, behind the standard `Checker` query API.

    Constructed done (the batch ran synchronously); `join()` is a no-op.
    Discovery paths re-execute the model along the parent chains the
    batch walked on the card when it ended.
    """

    def __init__(self, model: TensorModelAdapter, tprops, res: SimpleNamespace, lane: int,
                 n_init: int, init_rows, cov_enabled: bool, lanes: int, chunk: int,
                 tcap: int, chains: Dict[str, List[int]]):
        self._model = model
        self._tprops = tprops
        A = model.tm.max_actions
        self._state_count = n_init + int(res.gen[lane])
        self._unique = int(res.unique[lane])
        self._max_depth = int(res.max_depth[lane])
        self._discovery_fps: Dict[str, int] = dict(res.discovery_fps[lane])
        self._chains = chains
        self._paths: Optional[Dict[str, Path]] = None
        self._telemetry = {
            "eras": 1,  # the lane's share of the batch: one era
            "steps": int(res.steps[lane]),
            "partial_steps": int(res.partial[lane]),
            "states_generated": int(res.gen[lane]),
            "chunk": chunk,
            "table_capacity": tcap,
            "load_factor": round(self._unique / tcap, 4),
            "max_depth": self._max_depth,
            "frontier_size": int(res.count[lane]),
            "multiplexed_lanes": lanes,
            # The batch's: its step-loop iterations and their wall time.
            "batch_steps": res.iterations,
            "device_era_secs": res.secs,
            # The warm program's graph captures so far (one on the card).
            "graph_captures": res.graph_captures,
            "capture_secs": res.capture_secs,
            "batch_readbacks": res.readbacks,
            "expand_route": res.expand_route,
        }
        self._coverage = Coverage(enabled=cov_enabled)
        self._coverage.register_properties(p.name for p in tprops)
        self._coverage.register_actions(model.tm.format_action(a) for a in range(A))
        if cov_enabled:
            if len(init_rows):
                # Unique inits insert at depth 1 in the seeder, before the
                # loop histogram counts (as in the solo engine).
                self._coverage.record_depth(1, len(np.unique(init_rows, axis=0)))
            self._coverage.record_action_counts(res.act[lane])
            for i, p in enumerate(tprops):
                self._coverage.record_property_eval(p.name, int(res.expanded[lane]))
                self._coverage.record_property_hit(p.name, int(res.covp[i, lane]))
            self._coverage.record_depth_counts(res.dhist[lane])

    # -- Checker API ---------------------------------------------------------

    def state_count(self) -> int:
        return self._state_count

    def unique_state_count(self) -> int:
        return self._unique

    def max_depth(self) -> int:
        return self._max_depth

    def is_done(self) -> bool:
        return True

    def join(self) -> "MultiplexLaneChecker":
        return self

    def telemetry(self) -> Dict[str, Any]:
        return dict(self._telemetry, engine=type(self).__name__)

    def coverage(self) -> Dict[str, Any]:
        return self._coverage.snapshot()

    def discoveries(self) -> Dict[str, Path]:
        if self._paths is None:
            self._paths = {
                name: Path.from_fingerprints(self._model, self._chains[name][::-1])
                for name in self._discovery_fps
            }
        return dict(self._paths)


def _reject_unsupported(builder: CheckerBuilder) -> None:
    for attr, what in (
        ("symmetry_fn_", "symmetry reduction"),
        ("timeout_", "timeouts"),
        ("target_state_count_", "state-count targets"),
    ):
        if getattr(builder, attr) is not None:
            raise ValueError(
                f"multiplexed lanes do not support {what}; run this check "
                "solo via spawn_gpu_bfs"
            )
    if builder.stage_profile_:
        raise ValueError(
            "multiplexed lanes do not support stage profiling; run solo"
        )


def run_multiplexed(
    builders: List[CheckerBuilder],
    *,
    lanes: int = 32,
    chunk: int = 256,
    queue_capacity: int = 1 << 13,
    table_capacity: int = 1 << 16,
    init_capacity: int = 64,
    device=None,
    checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None,
    cache: Optional[ExecutableCache] = None,
) -> List[MultiplexLaneChecker]:
    """Run every builder's check as one lane of a shared step loop.

    All builders must carry models with the SAME shape signature
    (engines/compiled.py): that is what makes one warm program serve them
    all. Batches larger than `lanes` run one after another on the same
    (padded) program; smaller batches pad with empty lanes. Returns one
    `MultiplexLaneChecker` per builder, in order. Runs on the card unless
    `device="cpu"`, which runs each kernel's plain version. The warm lane
    program is `cache`'s "multiplex" entry for this signature and shape
    (default: `LANE_PROGRAMS`), built on a miss.

    `checkpoint_path` writes one crash-safe snapshot a completed batch
    (`<path>.batch<off>.npz`: each lane's params row, the JAX layout, the
    port's own step words and the lanes' tables as uint32 [N, 4, tcap]);
    `resume_from` rebuilds the lanes of every snapshot that verifies and
    runs only the other batches (JAX multiplex.py:342-395, :495-583). A
    missing or corrupt snapshot re-runs its batch.
    """
    if not builders:
        return []
    tm, sig = intern_model(builders[0].model)
    for b in builders:
        _reject_unsupported(b)
        if model_signature(b.model) != sig:
            raise ValueError(
                "multiplexed lanes must share one model shape signature; "
                f"got {model_signature(b.model)!r} != {sig!r}"
            )
    tprops = tm.tensor_properties()
    P = len(tprops)
    if P > 32:
        raise ValueError("at most 32 tensor properties supported")
    shape = lane_options(
        tm, lanes=lanes, chunk=chunk, queue_capacity=queue_capacity,
        table_capacity=table_capacity, init_capacity=init_capacity,
        coverage=all(b.coverage_ for b in builders), device=device,
    )
    chunk, tcap, icap, cov = shape["chunk"], shape["table_capacity"], shape["init_capacity"], shape["coverage"]
    S, A = tm.state_width, tm.max_actions
    vcap = widths(A, chunk)[0]

    # Shared init prep: signature-equal models generate identical inits.
    inits = np.asarray(tm.init_states_array(), dtype=np.uint32)
    inb = np.asarray(
        tm.within_boundary_lanes(np, tuple(inits[:, i] for i in range(S))), dtype=bool
    )
    inits = inits[inb]
    n_init = len(inits)
    if n_init > icap:
        raise ValueError(
            f"{n_init} initial states exceed the lane init capacity "
            f"({icap}); raise init_capacity"
        )
    if n_init + vcap > vs.MAX_LOAD * tcap:
        raise ValueError(
            "lane table_capacity too small for this model's init count + "
            "insert batch; raise table_capacity"
        )
    program = (LANE_PROGRAMS if cache is None else cache).get(tm, "multiplex", **shape)[0].program
    model = TensorModelAdapter(tm)
    # A snapshot resumes only under the lane shape that wrote it.
    snap_shape = dict(lanes=lanes, chunk=chunk, qcap=shape["queue_capacity"], tcap=tcap, icap=icap,
                      cov=cov)
    out: List[MultiplexLaneChecker] = []
    for off in range(0, len(builders), lanes):
        batch = builders[off: off + lanes]
        snap = None
        if resume_from is not None:
            snap = _load_batch_snapshot(resume_from, off, len(batch), tm, tprops, snap_shape)
        if snap is not None:
            rows = np.zeros((lanes, program.plen + eo.X_LEN), dtype=np.int64)
            rows[:, :program.plen] = snap["vals"]
            if "x_words" in snap:
                rows[:, program.plen:] = snap["x_words"]
            res = program.result(rows, 0.0)
            # uint32 [N, 4, tcap]: key halves, parent halves.
            table = vs.table_from_lanes(*np.asarray(snap["tables"]).swapaxes(0, 1), device=program.device)
            with program.lock:
                chains = _validate_and_walk(program, res, batch, off, model, table)
            tables = snap["tables"]
        else:
            masks = np.array([b.finish_when_.device_masks(tprops) for b in batch], dtype=np.int64)
            with program.lock:
                res = program.run(
                    inits.astype(np.int64), len(batch),
                    np.array([U32_MAX if b.target_max_depth_ is None else b.target_max_depth_
                              for b in batch], dtype=np.int64),
                    masks[:, 0], masks[:, 1], masks[:, 2],
                )
                chains = _validate_and_walk(program, res, batch, off, model)
                tables = None
                if checkpoint_path is not None:
                    tables = np.stack([lane.reshape(lanes, -1) for lane in vs.table_to_lanes(program.table)], 1)
        # Snapshot only after every lane of the batch validated: a snapshot
        # says "this batch is done and correct", never partial work.
        if checkpoint_path is not None and not (snap is not None and checkpoint_path == resume_from):
            save_checkpoint_atomic(
                _batch_snapshot_path(checkpoint_path, off),
                checkpoint_meta(tm, tprops, batch_off=off, batch_n=len(batch), **snap_shape),
                {"vals": res.params.astype(np.uint32), "x_words": res.rows[:, program.plen:],
                 "tables": tables},
            )
        by_lane: List[Dict[str, List[int]]] = [{} for _ in batch]
        for (i, name), chain in chains:
            by_lane[i][name] = chain
        for i in range(len(batch)):
            out.append(MultiplexLaneChecker(
                model, tprops, res, i, n_init, inits, cov,
                lanes=lanes, chunk=chunk, tcap=tcap, chains=by_lane[i],
            ))
    return out


def _batch_snapshot_path(base: str, off: int) -> str:
    return f"{base}.batch{off}.npz"


def _load_batch_snapshot(base: str, off: int, n: int, tm: TensorModel, tprops, shape: dict):
    """A verifiable snapshot of this exact batch, or None: a missing or
    corrupt snapshot re-runs the batch (snapshots save work, they are
    never needed for a right answer)."""
    path = _batch_snapshot_path(base, off)
    if not os.path.exists(path):
        return None
    try:
        arrays, meta = load_checkpoint_verified(path)
        validate_checkpoint_meta(
            meta, tm, tprops,
            exact={"batch_off": off, "batch_n": n, "state_width": tm.state_width, **shape},
        )
    except (CheckpointCorruptError, ValueError):
        return None
    return arrays


def _validate_and_walk(program: LaneProgram, res, batch, off: int, model, table=None):
    """Raise the reference's error for the first lane (in order) that hit
    a probe error or left its era unfinished; then walk every lane's
    discovery paths in the batch's tables (`table`: a snapshot's):
    [((lane, name), chain)]."""
    for i, b in enumerate(batch):
        if res.err[i]:
            raise RuntimeError(
                f"lane {off + i}: visited-table probe budget exhausted; "
                "raise table_capacity"
            )
        if res.count[i] > 0 and not b.finish_when_.matches(
            set(res.discovery_fps[i]), model.properties()
        ):
            # The lane left its era with work left and no finish: it
            # hit the ring/table/step budget. Lanes are sized for
            # small checks; anything bigger runs solo.
            raise RuntimeError(
                f"lane {off + i} did not complete within the lane "
                f"budget (frontier={int(res.count[i])}, "
                f"unique={int(res.unique[i])}); raise "
                "queue_capacity/table_capacity or run it solo via "
                "spawn_gpu_bfs"
            )
    found = [((i, name), fp) for i in range(len(batch)) for name, fp in res.discovery_fps[i].items()]
    chains = program.walk([(i, fp) for (i, _name), fp in found], table)
    return [(key, chain) for (key, _fp), chain in zip(found, chains)]
