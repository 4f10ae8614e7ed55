"""Multiplexed lanes on the card: N same-signature BFS checks as lanes of
ONE step loop — the port of `stateright_tpu/engines/multiplex.py` (K14,
`_build_lane_program:86`, which runs `jax.vmap` over the raw era loop).

A lane here is one check, as in the reference; a state's columns stay
its state lanes, and the ring's W rows its state-row lanes. Each lane
seeds its own table from the shared init rows (K10's lane form), then
runs ONE era of the raw BFS loop (`tpu_bfs.py:247 _build_loop(...,
raw=True)`): no sampling, no symmetry, no growth. Every scalar of the
solo step (engines/gpu_bfs.py) is a numpy [N] vector on the host — head,
count, take_cap, unique, steps, the probe-error count, the discovery
bits and the gate — and a step runs, for all lanes at once:

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
 10. discovery snapshots and coverage counts      (torch)

with one upload of the lanes' take, head and tail and ONE readback of an
[k, N] counts tensor, as the solo engine reads one vector. The expand's
candidates are action-major over all lanes (candidate a*N*C + l*C + c),
while K2's stable order, K3's and K4's winner (the highest index) and
the ring order follow the solo order a*C + c within a lane: step 4 reads
each lane's [A, C] slice through a strided view, never a global
compaction split afterwards.

The host applies the solo rules per lane: an overflow commits the
inserted prefix, consumes nothing and halves take_cap. A lane's gate is
the solo gate (empty frontier, ring past high water, table past its
growth limit, `_LANE_MAX_STEPS`, a probe error, its finish masks); a
lane whose gate closed takes 0 rows, so nothing of it changes — its
ring, table, counters, coverage and take_cap stay as they were, which is
what vmap's select-mask gives the reference. Padding lanes start closed.
Each lane keeps its own `target_max_depth`, partial commits and coverage.
Its result equals, bit for bit, the JAX lane with the same builder.

The warm executable (`warm_lane_program`): the kernels built, the
expand closure at lane width, and the lane workspace (stacked tables,
rings) allocated once and reused by every batch. One owner holds it: the
`ExecutableCache` entry (engines/compiled.py) of its signature and
shape, so the cache's capacity bounds the workspaces on the device and
an evicted entry frees its own. Discovery paths are walked on the card by K6 over the
lanes' stacked tables, every chain of every lane in one launch a hop,
when a batch ends (the next batch reuses the tables).

Not here: the batch snapshots of `checkpoint_path` / `resume_from`
(slice 7) and the run service that feeds this engine (slice 4b).
"""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..checker import SLICE_CHECKPOINTS, Checker, CheckerBuilder, not_ported
from ..core import Expectation
from ..fingerprint import combine64, hash_lanes
from ..obs.coverage import DEPTH_CAP, Coverage
from ..ops import frontier as fr
from ..ops import visited_set as vs
from ..ops.expand import build_expand_lean
from ..path import Path
from ..tensor import TensorModel, TensorModelAdapter
from ..xp import TorchXP
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
    built (on the card), the expand closure at width lanes*chunk, and the
    workspace — `lanes` tables of tcap slots and rings of qcap rows —
    reused by every batch (a batch zeroes them first)."""

    def __init__(self, tm: TensorModel, props, lanes: int, chunk: int,
                 qcap: int, tcap: int, icap: int, cov: bool, device):
        self.tm = tm
        self.props = props
        self.lanes, self.chunk, self.qcap, self.tcap, self.icap = lanes, chunk, qcap, tcap, icap
        self.cov = cov
        self.device = device
        if device.type == "cuda":
            kernels.build_all(kernels.LANE_KERNELS)
        self.expand = build_expand_lean(tm, props, lanes * chunk, TorchXP(device))
        W = tm.state_width + 2
        self.table = vs.empty_table(tcap, device, lanes=lanes)
        self.rings = fr.empty_ring(W, qcap, device, lanes=lanes)
        self.lock = threading.Lock()

    def run(self, inits: np.ndarray, init_ebits: int, n: int, depth_limit: np.ndarray,
            fin_any: np.ndarray, fin_all: np.ndarray, fin_all_en: np.ndarray) -> SimpleNamespace:
        """Seed the first n lanes with `inits` [n_init, S] (the rest are
        padding) and run every lane's era to its end; the per-lane gate
        inputs are [n] vectors. Returns the batch's per-lane outcome as
        numpy [N] vectors ([N, ...] for coverage) and each lane's
        discovery fingerprints. The caller holds `lock` from here until
        it has walked the batch's paths (`walk`): the next run reuses the
        tables."""
        tm, dev = self.tm, self.device
        N, C, qcap, tcap, icap = self.lanes, self.chunk, self.qcap, self.tcap, self.icap
        S, A, P = tm.state_width, tm.max_actions, len(self.props)
        qmask = qcap - 1
        vcap, rcap, dedup_cap = widths(A, C)
        high_water = qcap - C * A
        grow_limit = max(0, int(vs.MAX_LOAD * tcap) - vcap)
        table, rings = self.table, self.rings

        def lanes_of(x, fill):
            out = np.full(N, fill, dtype=np.int64)
            out[:n] = x
            return out

        # ---- seed (K10, multiplex.py:117-143) ----
        n_init = len(inits)
        table.keys.zero_()
        table.parents.zero_()
        rings.zero_()
        slab = np.zeros((S, icap), dtype=np.int64)
        slab[:, :n_init] = inits.T
        n_inits = lanes_of(n_init, 0)
        unique, err = seed_lanes(
            table, rings, torch.from_numpy(slab).to(dev),
            torch.from_numpy(n_inits).to(dev), init_ebits,
        )
        unique, err = torch.stack([unique, err]).cpu().numpy()
        depth_limit = lanes_of(depth_limit, U32_MAX)
        fin_any, fin_all, fin_all_en = (lanes_of(x, 0) for x in (fin_any, fin_all, fin_all_en))

        head = np.zeros(N, dtype=np.int64)
        count = n_inits.copy()
        take_cap = np.full(N, C, dtype=np.int64)
        steps = np.zeros(N, dtype=np.int64)
        partial = np.zeros(N, dtype=np.int64)
        gen = np.zeros(N, dtype=np.int64)
        expanded = np.zeros(N, dtype=np.int64)
        rec_acc = np.zeros(N, dtype=np.int64)

        lane_c = torch.arange(N, device=dev) * C
        lane_v = (torch.arange(N, device=dev) * vcap)[:, None]
        lane_d = (torch.arange(N, device=dev) * DEPTH_CAP)[:, None]
        arange_c = torch.arange(C, device=dev)
        dl_rows = torch.from_numpy(np.repeat(depth_limit, C)).to(dev)
        hseen = torch.zeros((P, N * C), dtype=torch.bool, device=dev)
        facc1 = torch.zeros((P, N * C), dtype=torch.int64, device=dev)
        facc2 = torch.zeros_like(facc1)
        faccd = torch.zeros_like(facc1)
        act = torch.zeros((N, A), dtype=torch.int64, device=dev)
        covp = torch.zeros((P, N), dtype=torch.int64, device=dev)
        dhist = torch.zeros(N * DEPTH_CAP, dtype=torch.int64, device=dev)

        t0 = time.monotonic()
        iterations = 0
        while True:
            # ---- the gate of each lane (tpu_bfs.py:403 cond) ----
            fin_hit = ((rec_acc & fin_any) != 0) | (
                (fin_all_en != 0) & ((rec_acc & fin_all) == fin_all)
            )
            gate = (
                (count > 0) & (count <= high_water) & (unique <= grow_limit)
                & (steps < _LANE_MAX_STEPS) & (err == 0) & ~fin_hit
            )
            if not gate.any():
                break
            # ---- one step of every lane (tpu_bfs.py:428 body) ----
            iterations += 1
            take = np.where(gate, np.minimum(np.minimum(count, C), take_cap), 0)
            pos = torch.from_numpy(np.stack([take, head, (head + count) & qmask])).to(dev)
            take_t, head_t, tail_t = pos[0], pos[1], pos[2]
            active = (arange_c[None, :] < take_t[:, None]).view(-1)
            popped = fr.ring_pop_lanes(rings, head_t, C)
            rows, ebits, depth = popped[:S], popped[S], popped[S + 1]
            row_h1, row_h2 = hash_lanes(rows)
            ex = self.expand(rows, ebits, depth, active, dl_rows)
            valid = ex.valid.view(A, N, C)
            # Lane l's candidates in the solo order a*C + c.
            vids, vvalid, n_val = vs.compact_ids_lanes(valid.transpose(0, 1), vcap)
            cl = ex.flat.index_select(1, ((vids // C) * (N * C) + lane_c[:, None] + vids % C).view(-1))
            ch1, ch2 = hash_lanes(cl)
            reps = fr.claim_dedup_lanes(ch1.view(N, vcap), ch2.view(N, vcap), vvalid, dedup_cap)
            dids, dvalid, n_d = vs.compact_ids_lanes(reps, rcap)
            src = (lane_c[:, None] + vids.gather(1, dids) % C).view(-1)  # parent row
            gd = (lane_v + dids).view(-1)
            dp1 = torch.where(dvalid, row_h1.index_select(0, src).view(N, rcap), 0)
            dp2 = torch.where(dvalid, row_h2.index_select(0, src).view(N, rcap), 0)
            ddepth = depth.index_select(0, src) + 1
            dh1 = ch1.index_select(0, gd).view(N, rcap)
            dh2 = ch2.index_select(0, gd).view(N, rcap)
            c_new, unresolved = vs.insert_lanes(table, dh1, dh2, dp1, dp2, dvalid)
            # The inserted prefix is enqueued even on an overflow step, as
            # in the solo engine.
            fr.ring_scatter_lanes(
                rings, tail_t,
                torch.cat([cl.index_select(1, gd), ex.ebits.index_select(0, src)[None], ddepth[None]]),
                c_new,
            )
            unres = unresolved.sum(1)
            stats = [n_val, n_d, unres, c_new.sum(1), valid.sum((0, 2))]
            if P:
                hits = torch.stack(ex.prop_hits)
                new_hit = hits & ~hseen
                facc1 = torch.where(new_hit, row_h1, facc1)
                facc2 = torch.where(new_hit, row_h2, facc2)
                faccd = torch.where(new_hit, depth, faccd)
                hseen |= hits
                hs = hits.view(P, N, C).sum(2)
                stats.append(hs.view(-1))
            if self.cov:
                # Per-action and per-property counts skip an overflowing
                # lane's step (it re-runs); inserts count always.
                ovf = (n_val > vcap) | (n_d > rcap) | (unres > 0)
                act += torch.where(ovf[:, None], 0, valid.sum(2).T)
                if P:
                    covp += torch.where(ovf[None, :], 0, hs)
                dhist.index_add_(
                    0, (lane_d + ddepth.view(N, rcap).clamp(max=DEPTH_CAP - 1)).view(-1),
                    c_new.view(-1).to(torch.int64),
                )
            vals = torch.cat(stats).cpu().numpy()  # the one sync
            n_val, n_d, unres_n, new_count, generated = vals[: 5 * N].reshape(5, N)
            hs_np = vals[5 * N:].reshape(P, N)

            # ---- the host's rules, per lane; a closed lane took 0 rows ----
            err += np.where(gate & (take <= 1), unres_n, 0)
            ovf = (n_val > vcap) | (n_d > rcap) | (unres_n > 0)
            consumed = np.where(ovf, 0, take)
            head = (head + consumed) & qmask
            count = count - consumed + new_count
            unique += new_count
            partial += gate & ovf
            gen += np.where(ovf, 0, generated)
            steps += gate & ~ovf
            take_cap = np.where(
                gate,
                np.where(ovf, np.maximum(take >> 1, 1), np.minimum(take_cap + max(1, C // 16), C)),
                take_cap,
            )
            expanded += consumed
            for i in range(P):
                rec_acc |= (hs_np[i] > 0).astype(np.int64) << i

        # ---- epilogue, per lane (tpu_bfs.py:781-810) ----
        last = rings[torch.arange(N, device=dev), S + 1, torch.from_numpy((head - 1) & qmask).to(dev)]
        parts = [last]
        if P:
            sel = torch.where(hseen, faccd, U32_MAX).view(P, N, C).argmin(2, keepdim=True)
            parts += [
                hseen.view(P, N, C).any(2).to(torch.int64).view(-1),
                facc1.view(P, N, C).gather(2, sel).view(-1),
                facc2.view(P, N, C).gather(2, sel).view(-1),
            ]
        if self.cov:
            parts += [act.view(-1), covp.view(-1), dhist]
        out = torch.cat(parts).cpu().numpy()
        secs = time.monotonic() - t0
        last, out = out[:N], out[N:]
        found = out[: P * N].reshape(P, N)
        fp1 = out[P * N: 2 * P * N].reshape(P, N)
        fp2 = out[2 * P * N: 3 * P * N].reshape(P, N)
        out = out[3 * P * N:]
        discovery_fps = [
            {p.name: combine64(int(fp1[i, l]), int(fp2[i, l]))
             for i, p in enumerate(self.props) if found[i, l]}
            for l in range(N)
        ]
        res = SimpleNamespace(
            unique=unique, count=count, steps=steps, partial=partial, gen=gen,
            expanded=expanded, err=err, secs=secs, iterations=iterations,
            max_depth=np.where(steps > 0, last, 0),
            discovery_fps=discovery_fps,
        )
        if self.cov:
            res.act = out[: N * A].reshape(N, A)
            res.covp = out[N * A: N * A + P * N].reshape(P, N)
            res.dhist = out[N * A + P * N:].reshape(N, DEPTH_CAP)
        return res

    def walk(self, lane_fps: List[Tuple[int, int]]) -> List[List[int]]:
        """The parent chains (leaf first) of (lane, fp) pairs of the last
        run, walked in the lanes' stacked tables by K6, every chain in one
        launch a hop."""
        if not lane_fps:
            return []
        lanes, fps = zip(*lane_fps)
        return parent_chains(self.table, fps, lanes)


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
    """
    for name, value in (("checkpoint_path", checkpoint_path), ("resume_from", resume_from)):
        if value is not None:
            raise not_ported(f"run_multiplexed({name}=) batch snapshots", SLICE_CHECKPOINTS)
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
    init_ebits = 0
    e = 0
    for p in tprops:
        if p.expectation == Expectation.EVENTUALLY:
            init_ebits |= 1 << e
            e += 1

    program = (LANE_PROGRAMS if cache is None else cache).get(tm, "multiplex", **shape)[0].program
    model = TensorModelAdapter(tm)
    out: List[MultiplexLaneChecker] = []
    for off in range(0, len(builders), lanes):
        batch = builders[off: off + lanes]
        masks = np.array([b.finish_when_.device_masks(tprops) for b in batch], dtype=np.int64)
        with program.lock:
            res = program.run(
                inits.astype(np.int64), init_ebits, len(batch),
                np.array([U32_MAX if b.target_max_depth_ is None else b.target_max_depth_
                          for b in batch], dtype=np.int64),
                masks[:, 0], masks[:, 1], masks[:, 2],
            )
            chains = _validate_and_walk(program, res, batch, off, model)
        by_lane: List[Dict[str, List[int]]] = [{} for _ in batch]
        for (i, name), chain in chains:
            by_lane[i][name] = chain
        for i in range(len(batch)):
            out.append(MultiplexLaneChecker(
                model, tprops, res, i, n_init, inits, cov,
                lanes=lanes, chunk=chunk, tcap=tcap, chains=by_lane[i],
            ))
    return out


def _validate_and_walk(program: LaneProgram, res, batch, off: int, model):
    """Raise the reference's error for the first lane (in order) that hit
    a probe error or left its era unfinished; then walk every lane's
    discovery paths in the batch's tables: [((lane, name), chain)]."""
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
    chains = program.walk([(i, fp) for (i, _name), fp in found])
    return [(key, chain) for (key, _fp), chain in zip(found, chains)]
