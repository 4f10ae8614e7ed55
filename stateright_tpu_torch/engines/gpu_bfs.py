"""Exhaustive batched BFS on the card: the port of
`stateright_tpu/engines/tpu_bfs.py` (eras on the device, pipelined and
fused as the JAX engine runs them, with bottom-k sampling, symmetry
reduction, run timeouts, the host spill and its disk tier, checkpoints,
resume and the degraded regrow).

The era program (engines/era.py) runs BFS steps on the device until its
gate closes — empty frontier, ring past its high-water mark, table past
its growth limit, step budget spent, a probe error, the finish policy
met, or (sampling on) the sample slab past its high-water mark — and,
with `.pipeline(fuse=N)`, up to N such eras in one dispatch; on the card
a dispatch is one CUDA-graph launch and one readback of the era's
packed params (the JAX layout, word for word). This module is the host
loop around it, the counterpart of `TpuBfsChecker._run`
(tpu_bfs.py:1540-2301): the fused seed and first era (K10f), the
per-era host work between dispatches (table growth, the step budget and
its target clamp, a fresh params upload only when something the host
owns changed), the speculative K-deep chain of dispatches off the
still-on-device state, and `process_result`: counters, discoveries,
coverage, the sample drain, the spill and the stop conditions.

Spill (tpu_bfs.py:1769, :1924-1948, :2060-2087): past the ring's high
water the newest rows go to a host LIFO (ops/tiering.py) in one K7s
DRAIN launch and one download into pinned memory, and come back, whole
blocks at a time, in one upload and one K7s REFILL launch before the
next era. Both run between dispatches, never inside a graph, and force a
fresh params upload. Checkpoints (:2548-2659) are the reference's files
(engines/common.py): a checkpoint written by either package resumes on
the other. A probe error with a checkpoint on disk reloads it, doubles
the table and goes on (the degraded regrow, :2302-2347).

Eras end exactly where the JAX engine's do (the same gate, budgets and
chain), because discoveries are extracted per era (the shallowest first
hit at the lowest chunk position) and the ring order follows the take
clamp, so the results — counts, discovery fingerprints, coverage, the
sample, the eras and steps — are the JAX engine's, bit for bit.

Discovery paths (and sample rows) are walked on the card, every chain
at once, one K6 lookup_parent launch per hop; the model then re-executes
along each chain on the host.

On `device="cpu"` every kernel call runs its plain torch version; that is
the only place the plain versions run on this path.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..checker import CheckerBuilder
from ..core import Expectation
from ..fingerprint import combine64, hash_lanes, hash_words_np, split64
from ..ops import era as eo
from ..ops import frontier as fr
from ..ops import visited_set as vs
from ..ops.tiering import TieredSpillStore, spill_host_budget_bytes
from ..path import Path
from ..tensor import CanonicalTensorAdapter, TensorModel, TensorModelAdapter
from . import era, stages
from .common import (
    HostEngineBase, checkpoint_generations, checkpoint_meta, load_checkpoint_folded,
    register_signal_checkpoint_flush, save_checkpoint_tiered, validate_checkpoint_cadence,
    validate_checkpoint_meta,
)
from .era import widths

U32_MAX = 0xFFFFFFFF
# The JAX engine's message for an init row the seed left unresolved
# (tpu_bfs.py:1824-1829).
SEED_ERROR = (
    "init-state seeding exhausted the visited-table probe budget "
    "(duplicate-heavy or adversarial initial fingerprints); raise "
    "table_capacity"
)


def resolve_device(device) -> torch.device:
    """The engine's device: CUDA unless the caller asks for the CPU. No
    card and no explicit CPU request is an error, never a silent CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "kernels' plain versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def seed_lanes(table, rings, init_rows: torch.Tensor, n_init: torch.Tensor, init_ebits: int,
               epoch=None):
    """K10's lane form (multiplex.py:117-143): seed each lane's table
    ([N, tcap], empty) and ring ([N, W, qcap + 1], zero) in place from one
    icap-wide init slab [S, icap]: lane l takes its first n_init[l] rows
    (n_init int64 [N] on the device; 0 for a padding lane), K1 over the
    slab and lane K4 over [N, icap]. Every taken row is enqueued at depth
    1; each table keeps one per fingerprint. Returns device tensors
    (unique [N], unresolved [N]). `epoch`: the insert's stamp epoch on
    the card, for a call that a CUDA graph replays (`vs.insert`)."""
    S, icap = init_rows.shape
    N = rings.shape[0]
    valid = torch.arange(icap, device=init_rows.device) < n_init[:, None]
    h1, h2 = hash_lanes(init_rows)
    zero = torch.zeros((N, icap), dtype=torch.int64, device=init_rows.device)
    is_new, unres = vs.insert_lanes(
        table, h1.expand(N, icap).contiguous(), h2.expand(N, icap).contiguous(), zero, zero, valid,
        epoch=epoch,
    )
    rings[:, :S, :icap] = torch.where(valid[:, None, :], init_rows[None], 0)
    rings[:, S, :icap] = torch.where(valid, init_ebits, 0)
    rings[:, S + 1, :icap] = valid.to(torch.int64)
    return is_new.sum(1), unres.sum(1)


def parent_chains(table, fps, lanes=None) -> List[List[int]]:
    """Walk the table's parent fingerprints from every fp at once on the
    table's device — one K6 launch and one small readback per hop, the
    table never copied — and return each chain, leaf first. With `lanes`
    (one lane index per fp) the walks run in the lanes' stacked tables
    (`lookup_parent_lanes`), every chain of every lane in one launch a
    hop."""
    chains = [[int(fp)] for fp in fps]
    live = list(range(len(chains)))
    dev = table.device
    h = torch.tensor(
        [split64(c[0]) for c in chains], dtype=torch.int64
    ).reshape(-1, 2).T.to(dev)
    h1, h2 = h[0].contiguous(), h[1].contiguous()
    lane = None if lanes is None else torch.tensor(list(lanes), dtype=torch.int64, device=dev)
    limit = table.keys.numel() + 1
    hops = 0
    while live:
        hops += 1
        if hops > limit:
            raise RuntimeError("parent chain longer than the state count")
        if lane is None:
            found, p1, p2 = vs.lookup_parent(table, h1, h2)
        else:
            found, p1, p2 = vs.lookup_parent_lanes(table, lane, h1, h2)
        f, a, b = torch.stack([found.to(torch.int64), p1, p2]).tolist()
        keep = []
        for j, i in enumerate(live):
            if not f[j]:
                where = "" if lanes is None else f"lane {lanes[i]}'s "
                raise RuntimeError(
                    f"fingerprint {chains[i][-1]} missing from {where}visited "
                    "table during path reconstruction"
                )
            if a[j] or b[j]:
                chains[i].append(combine64(a[j], b[j]))
                keep.append(j)
        live = [live[j] for j in keep]
        sel = torch.tensor(keep, dtype=torch.int64, device=dev)
        h1, h2 = p1.index_select(0, sel), p2.index_select(0, sel)
        if lane is not None:
            lane = lane.index_select(0, sel)
    return chains


def poll_target_of(timeout, checkpoint_every):
    """The wall time an era should stay under while a wall-clock concern
    polls (tpu_bfs.py:1603-1609): a quarter of the tighter of the timeout
    and the checkpoint cadence; None when neither is set."""
    targets = [t / 4.0 for t in (timeout, checkpoint_every) if t is not None]
    return min(targets) if targets else None


def adapt_budget_cap(cap: int, era_dt: float, n_inner: int, poll_target, cap_limit: int) -> int:
    """The host's move of the adaptive step budget's cap after a dispatch
    of `n_inner` eras that took `era_dt` seconds (tpu_bfs.py:1790-1806,
    mesh.py:1690-1697): doubled while an era takes under half the poll
    target, halved (to BUDGET_MIN at least) above it."""
    if poll_target is None or era_dt <= 0.0:
        return cap
    per_era = era_dt / n_inner
    if per_era < poll_target / 2 and cap < cap_limit:
        return min(cap * 2, cap_limit)
    if per_era > poll_target and cap > eo.BUDGET_MIN:
        return max(cap // 2, eo.BUDGET_MIN)
    return cap


def run_chain(engine, prog, pending, t0: float, depth: int, consume, clean, advance,
              quiet=None) -> int:
    """Read back the dispatch `pending` (launched at `t0`) and drive the
    K-deep speculative chain behind it (tpu_bfs.py:2204-2301,
    mesh.py:2048-2160): up to `depth` dispatches launched off the
    still-on-device state while earlier readbacks are in flight, while
    `quiet()` says no host-only concern could fire (default: no
    timeout). Sound because the device gate re-derives every exit from
    the state: a dispatch chained past a boundary that needs the host
    runs no step.

    `consume(vals, secs, in_flight)` takes each readback in order
    (`in_flight`: a chained dispatch is still running); while `clean()`
    says the boundary needs no host work, the oldest chained dispatch is
    the next one; otherwise the chain is drained in order — a dispatch
    that ran no step (`prog.ran`) was wasted speculation, one that ran
    steps (partial ones included, or a timeout landing mid-chain) is real
    work and is consumed. `advance()` runs before the host moves on to a
    chained dispatch. A probe error waits for every chained dispatch
    (counted wasted: the regrow discards them) and re-raises. Returns the
    deepest chain reached."""
    if quiet is None:
        def quiet():
            return not engine._timed_out()
    chain = []
    deepest = 0
    try:
        while True:
            while len(chain) < depth and quiet():
                chain.append((prog.launch(), time.monotonic()))
                engine._inc("dispatches")
                engine._inc("spec_dispatch")
                deepest = max(deepest, len(chain))
            consume(prog.result(pending), time.monotonic() - t0, bool(chain))
            if not chain:
                return deepest
            if clean():
                pending, _launched = chain.pop(0)
                t0 = time.monotonic()
                advance()
                continue
            while chain:
                spec, spec_t0 = chain.pop(0)
                vals = prog.result(spec)
                if not prog.ran(vals):
                    engine._inc("spec_wasted")
                    continue
                advance()
                consume(vals, time.monotonic() - spec_t0, bool(chain))
            return deepest
    except ProbeBudgetExhausted:
        for spec, _launched in chain:
            prog.result(spec)
            engine._inc("spec_wasted")
        raise


class ProbeBudgetExhausted(RuntimeError):
    """An era left an insert unresolved (tpu_bfs.py `_ProbeBudgetExhausted`):
    recoverable by a degraded regrow when a checkpoint exists."""


class GpuBfsChecker(HostEngineBase):
    """Batched BFS over a TensorModel on one CUDA device."""

    def __init__(
        self,
        builder: CheckerBuilder,
        *,
        chunk_size: int = 8192,
        queue_capacity: int = 1 << 20,
        table_capacity: int = 1 << 22,
        sync_steps: int = 4096,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: Optional[float] = None,
        resume_from: Optional[str] = None,
        keep_checkpoints: int = 2,
        device=None,
        compiled=None,
    ):
        model = builder.model
        if isinstance(model, TensorModel):
            model = TensorModelAdapter(model)
        if not isinstance(model, TensorModelAdapter):
            raise TypeError("spawn_gpu_bfs requires a TensorModel (or its adapter)")
        if compiled is not None:
            # The build/run split (engines/compiled.py): run the compiled
            # check's interned model instance.
            from .compiled import model_signature

            if model_signature(model.tm) != compiled.signature:
                raise ValueError(
                    "CompiledCheck signature mismatch: executable was built "
                    f"for {compiled.signature!r}, builder model is "
                    f"{model_signature(model.tm)!r}"
                )
            if model.tm is not compiled.tm:
                model = TensorModelAdapter(compiled.tm)
        self.device = resolve_device(device)
        super().__init__(builder, model=model, device=self.device)
        self.tm: TensorModel = model.tm
        # Symmetry reduction on the card: candidates are canonicalized by
        # the model's batched representative_lanes before hashing, so the
        # ring and the table live in representative space (2pc-5: 8,832
        # -> 1,092 states). A host `symmetry_fn` is not run: a tensor
        # model without the lane program is refused, as in JAX.
        self._canon = self._symmetry is not None
        if self._canon and self.tm.representative_lanes is None:
            raise ValueError(
                f"symmetry requested but {type(self.tm).__name__} defines "
                "no representative_lanes canonicalizer"
            )
        self._tprops = self.tm.tensor_properties()
        n_event = sum(
            1 for p in self._tprops if p.expectation == Expectation.EVENTUALLY
        )
        if n_event > 32 or len(self._tprops) > 32:
            raise ValueError("at most 32 tensor properties supported")
        if queue_capacity & (queue_capacity - 1):
            raise ValueError("queue_capacity must be a power of two")
        # qcap >= 2*C*A keeps the ring append from wrapping over
        # unconsumed rows while count <= high_water, and lets a spill
        # block (<= C*A rows) always fit during a refill (tpu_bfs.py:1429).
        self._chunk = min(
            chunk_size, queue_capacity // (2 * max(1, self.tm.max_actions))
        )
        if self._chunk == 0:
            raise ValueError("queue_capacity too small for this model's fanout")
        self._qcap = queue_capacity
        self._tcap = table_capacity
        self._max_sync_steps = sync_steps
        # Checkpoints (the reference's file format, engines/common.py):
        # crash-safe generations with a content digest, delta saves of the
        # table, checkpoint_every in wall-clock seconds polled at era
        # boundaries, and a final checkpoint at the end of every run.
        validate_checkpoint_cadence(checkpoint_every, checkpoint_path, keep_checkpoints)
        self._ckpt_path = checkpoint_path
        self._ckpt_every = checkpoint_every
        self._ckpt_keep = keep_checkpoints
        self._resume_from = resume_from
        self._last_ckpt = time.monotonic()
        self._ckpt_delta = None  # the delta chain's state: None = next save is a base
        # Fakes a probe error once this many eras ran (tpu_bfs.py:1450):
        # the degraded regrow's test hook.
        self._chaos_probe_error_era: Optional[int] = None
        if checkpoint_path is not None:
            register_signal_checkpoint_flush(self)
        # The host spill (ops/tiering.py): a LIFO of refill-sized uint32
        # blocks in RAM, with an npz disk tier below a budget.
        self._spill = TieredSpillStore(
            host_budget_bytes=spill_host_budget_bytes(), on_tier=self._on_spill_tier
        )
        self._cov = self._coverage.enabled
        # Era pipelining (CheckerBuilder.pipeline, on by default with a
        # chain of depth 2 and no fusion, as in JAX: tpu_bfs.py:1517-1524).
        self._pipeline = builder.pipeline_
        self._chain_depth = builder.pipeline_depth_ or 2
        self._fuse = builder.fuse_eras_ or 1
        self._unique = 0
        self._discovery_fps: Dict[str, int] = {}
        self._table = None
        self._init_ebits = 0
        e = 0
        for p in self._tprops:
            if p.expectation == Expectation.EVENTUALLY:
                self._init_ebits |= 1 << e
                e += 1
        self._start()

    # -- the run -------------------------------------------------------------

    def _run(self) -> None:
        """The JAX engine's host loop (tpu_bfs.py:1540-2301) without
        resharding and the flight recorder."""
        try:
            self._run_engine()
        finally:
            # A resume rebuilds the stack from the checkpoint's blocks:
            # a disk spool is dead weight past the run.
            self._spill.close()

    def _run_engine(self) -> None:
        tm = self.tm
        dev = self.device
        S, A, C = tm.state_width, tm.max_actions, self._chunk
        vcap = widths(A, C)[0]
        high_water = self._qcap - C * A
        depth_limit = (
            self._target_max_depth if self._target_max_depth is not None else U32_MAX
        )
        fin = self._finish_when.device_masks(self._tprops)
        sampler = self._sampler
        sample_k = sampler.k if sampler is not None else 0
        # The era budget (tpu_bfs.py:1583-1612): the full sync_steps
        # allowance, or when a wall-clock concern (a timeout, the
        # checkpoint cadence) polls, the adaptive budget — the device
        # emits the next era's budget (doubling after budget-only exits,
        # halving under pressure) and the host moves only its cap.
        adaptive = self._timeout is not None or self._ckpt_every is not None
        max_sync = self._max_sync_steps if not adaptive else min(eo.BUDGET_MIN, self._max_sync_steps)
        pipeline = self._pipeline and self._target_state_count is None
        depth = self._chain_depth if pipeline else 0  # 0: no chain

        inits = resumed = table = None
        if self._resume_from is not None:
            data, meta = self._read_checkpoint(self._resume_from)
            table = self._table_of(data)
        else:
            inits = np.asarray(tm.init_states_array(), dtype=np.uint32)
            inb = np.asarray(
                tm.within_boundary_lanes(np, tuple(inits[:, i] for i in range(S))),
                dtype=bool,
            )
            inits = inits[inb]
            if self._canon:
                # Distinct inits can share a representative: dedupe the rows
                # so the ring and the counters agree with the table
                # (tpu_bfs.py:1655-1680; np.unique also sorts them).
                canon = tm.representative_lanes(np, tuple(inits[:, i] for i in range(S)))
                inits = np.stack([np.asarray(lane, dtype=np.uint32) for lane in canon], axis=1)
                inits = np.unique(inits, axis=0)
            n_init = len(inits)
            self._state_count = n_init
            if n_init == 0:
                return
            if self._cov:
                self._coverage.record_depth(1, len(np.unique(inits, axis=0)))
            if n_init > self._qcap:
                raise ValueError("more initial states than queue capacity")
            while n_init + vcap > vs.MAX_LOAD * self._tcap:
                self._tcap *= 2
            if sampler is not None:
                # The seed inserts before the era loop's slab captures: offer
                # the inits host-side, rows and all (tpu_bfs.py:1701-1710).
                ih1, ih2 = hash_words_np(inits)
                sampler.offer_array(
                    (ih1.astype(np.uint64) << np.uint64(32)) | ih2.astype(np.uint64),
                    depths=np.ones(n_init, dtype=np.int64),
                    states=inits,
                )

        prog = era.EraProgram(
            tm, self._tprops, C, self._qcap, self._tcap, self._canon, self._cov,
            sample_k, self._fuse, dev, in_flight=depth + 1, table=table,
        )
        self._gauge("expand_route", prog.expand.route)
        self._gauge("canon_route", prog.canon_fn.route if self._canon else None)
        if table is not None:
            resumed = self._install_checkpoint(prog, data, meta, table=table)
        try:
            self._run_eras(prog, inits, resumed, vcap, high_water, depth_limit, fin,
                           adaptive, max_sync, depth)
        finally:
            prog.free_graph()
        self._table = prog.table

        def stage_programs():
            progs = stages.bfs_stages(tm, self._tprops, C, self._qcap, self._canon,
                                      self._stage_iters, dev)
            return progs, (prog.table, prog.ring)

        self._profile_stages(stage_programs, self._counters.get("steps", 0))

    def _run_eras(self, prog, inits, resumed, vcap, high_water, depth_limit, fin, adaptive,
                  max_sync, depth) -> None:
        tm, dev = self.tm, self.device
        S, A, C, P = tm.state_width, tm.max_actions, self._chunk, len(self._tprops)
        fin_any, fin_all, fin_all_en = fin
        sampler = self._sampler
        budget = max_sync
        budget_cap = min(eo.BUDGET_MIN, max_sync) if adaptive else 0
        cap_limit = min(self._max_sync_steps, 1 << 30)
        poll_target = poll_target_of(self._timeout, self._ckpt_every)
        x = prog.plen
        fb, sb, sk2 = prog.f_base, prog.s_base, prog.sk2
        cb = prog.cov_base
        # Spill hysteresis (tpu_bfs.py:1769): drain down to, and refill up
        # to, a margin below high water, so that a spilling run still gets
        # long eras between host round trips. At least one block of room:
        # qcap >= 2*C*A.
        spill_target = max(high_water // 2, high_water - 64 * C * A)
        # A drain takes at most qcap - spill_target rows; a larger refill
        # goes up in pieces of that size.
        staging = fr.SpillStaging(S + 2, dev, self._qcap - spill_target)

        def ckpt_due(frac: float = 1.0) -> bool:
            return (
                self._ckpt_every is not None
                and time.monotonic() - self._last_ckpt >= self._ckpt_every * frac
            )

        def fuse_lim_now() -> int:
            # tpu_bfs.py:1628-1647 without auto-N (it reads the flight
            # recorder, which the port does not have): one era a dispatch
            # while spill is pending or a checkpoint is half due.
            if self._fuse <= 1 or self._spill or self._target_state_count is not None:
                return 1
            if ckpt_due(0.5):
                return 1
            if self._deadline is not None and time.monotonic() >= self._deadline - self._timeout / 2:
                return 1
            return self._fuse

        def template_with(rec_fp1, rec_fp2) -> np.ndarray:
            t = np.zeros(prog.plen + eo.X_LEN, dtype=np.int64)
            t[eo.P_LEN:eo.P_LEN + P] = rec_fp1
            t[eo.P_LEN + P:eo.P_LEN + 2 * P] = rec_fp2
            return t

        last_fuse_lim = last_thresh = None
        last_budget_cap = budget_cap
        take_cap = C
        chain_max = 0
        stop = False
        first = inits is not None
        if first:
            n_init = len(inits)
            max_steps0 = max_sync
            if self._target_state_count is not None:
                remaining = max(0, self._target_state_count - n_init)
                max_steps0 = max(1, min(max_steps0, 1 + remaining // (C * A)))
            template = template_with(0, 0)
            if fb >= 0:
                last_fuse_lim = template[fb] = fuse_lim_now()
            if sampler is not None:
                last_thresh = sampler.threshold_parts()
                template[sb:sb + 2] = last_thresh
            template[:eo.P_LEN] = [
                0, n_init, 0, 0, depth_limit, max(0, int(vs.MAX_LOAD * self._tcap) - vcap),
                high_water, max_steps0, 0, 0, 0, 0, C, fin_any, fin_all, fin_all_en, budget_cap,
            ]
            # K10f: the seed and the first era, with no readback between them.
            init_t = torch.from_numpy(inits.T.astype(np.int64)).to(dev).contiguous()
            prog.seed(init_t, self._init_ebits, template)
            era_t0 = time.monotonic()
            pending = prog.launch()
            self._inc("dispatches")
            head, count, rec_bits = 0, n_init, 0
            self._unique = n_init  # provisional; exact at the first readback
            last_max_steps = max_steps0
            dirty = False
        else:
            # A resume: the checkpoint's boundary, uploaded before the
            # first dispatch (tpu_bfs.py:1649-1653).
            head, count, rec_bits, rec_fp1, rec_fp2 = resumed
            template = template_with(rec_fp1, rec_fp2)
            prog.upload(template)  # the carried discovery fingerprints
            last_max_steps = None
            dirty = True
        mirror = template  # the state vector as last read back

        def process_result(vals, era_dt: float, in_flight: bool) -> None:
            """Consume one dispatch's readback (tpu_bfs.py:1776-2035). With
            `in_flight` a chained dispatch is still running on the
            buffers, so a checkpoint waits for the next serial boundary."""
            nonlocal head, count, take_cap, rec_bits, stop, dirty, budget, budget_cap, last_thresh
            n_inner = max(1, min(int(vals[fb + 1]), self._fuse)) if fb >= 0 else 1
            err = int(vals[eo.P_ERR])
            eras = self._counters.get("eras", 0)
            if not err and self._chaos_probe_error_era is not None and eras >= self._chaos_probe_error_era:
                self._chaos_probe_error_era = None
                err = 1
            if err:
                # An error with zero steps on the first readback came in
                # from the seed (tpu_bfs.py:1824-1829).
                if eras == 0 and vals[eo.P_STEPS] == 0:
                    raise RuntimeError(SEED_ERROR)
                raise ProbeBudgetExhausted("visited-table probe budget exhausted despite headroom")
            head, count = int(vals[eo.P_HEAD]), int(vals[eo.P_COUNT])
            take_cap = int(vals[eo.P_TAKE_CAP])
            budget = int(vals[eo.P_MAX_STEPS])
            if last_max_steps is not None:
                self._gauge("era_step_budget", last_max_steps)
            if era_dt > 0.0:
                # The era's time from dispatch through its readback
                # (tpu_bfs.py:1790-1796).
                self._metrics.add_phase("device_era", era_dt)
            budget_cap = adapt_budget_cap(budget_cap, era_dt, n_inner, poll_target, cap_limit)
            self._inc("eras", n_inner)
            self._inc("steps", vals[eo.P_STEPS])
            self._inc("states_generated", vals[eo.P_GEN])
            self._inc("partial_steps", vals[x + eo.X_PARTIAL])
            self._unique = int(vals[eo.P_UNIQUE])
            self._state_count += int(vals[eo.P_GEN])
            self._max_depth = max(self._max_depth, int(vals[eo.P_MAXD]))
            new_bits = int(vals[eo.P_REC])
            if new_bits != rec_bits:
                fp1 = vals[eo.P_LEN:eo.P_LEN + P]
                fp2 = vals[eo.P_LEN + P:eo.P_LEN + 2 * P]
                for i, p in enumerate(self._tprops):
                    if (new_bits >> i) & 1 and p.name not in self._discovery_fps:
                        self._discovery_fps[p.name] = combine64(int(fp1[i]), int(fp2[i]))
                rec_bits = new_bits
            if self._cov:
                cov = self._coverage
                cov.record_action_counts(vals[cb:cb + A].tolist())
                expanded = int(vals[cb + A + P])
                for i, p in enumerate(self._tprops):
                    cov.record_property_eval(p.name, expanded)
                    cov.record_property_hit(p.name, int(vals[cb + A + i]))
                cov.record_depth_counts(vals[cb + A + P + 1:cb + eo.cov_len(A, P)].tolist())
            if sampler is not None:
                occupied, dropped = int(vals[sb + 2]), int(vals[sb + 3])
                if occupied or dropped:
                    rows = vals[sb + 4:sb + 4 + 5 * sk2].reshape(5, sk2)
                    sampler.drain_slab(
                        rows[0], rows[1], rows[2], rows[4], occupied,
                        dropped=dropped, actions=rows[3],
                    )
                if sampler.threshold_parts() != last_thresh:
                    # The drain tightened the threshold: upload it before
                    # the next era (tpu_bfs.py:1909-1916).
                    dirty = True
            if count > high_water:
                # S1 (tpu_bfs.py:1924-1948): the newest k ring rows to the
                # host in one K7s launch and one download, kept in blocks of
                # C*A rows so that partial refills stay possible. Their
                # depth folds into max_depth: a refill can place them after
                # deeper rows. A chained dispatch past this boundary ran no
                # step (the device gate closed on the same count).
                k = count - spill_target
                with self._metrics.phase("spill"):
                    big = staging.drain(prog.ring[None], [head + count - k], [k])
                for off in range(0, k, C * A):
                    self._spill.append(big[off:off + C * A])
                count -= k
                self._inc("spill_rows", k)
                self._max_depth = max(self._max_depth, int(big[:, S + 1].max()))
                self._gauge("spill_host_peak_bytes",
                            max(self._spill.host_bytes(), self._counters.get("spill_host_peak_bytes", 0)))
                dirty = True  # the host's count changed
            if not in_flight and self._ckpt_path is not None and ckpt_due():
                self._save_checkpoint(prog, head, count, rec_bits)
            if self._finish_matched(self._discovery_fps):
                stop = True
            elif (
                self._target_state_count is not None
                and self._state_count >= self._target_state_count
            ):
                stop = True
            elif self._timed_out():
                stop = True
            elif self._ckpt_stop.is_set():
                # A graceful-stop request: the final checkpoint below takes
                # this boundary.
                self._gauge("interrupted", 1)
                stop = True

        def consume(vals, era_dt: float, in_flight: bool) -> None:
            nonlocal mirror
            mirror = vals  # the state vector as last read back
            process_result(vals, era_dt, in_flight)

        def quiet() -> bool:
            # No host-only concern could fire: a chained era may start
            # (tpu_bfs.py:2216-2228).
            return not (self._spill or self._ckpt_stop.is_set() or self._timed_out() or ckpt_due())

        def clean() -> bool:
            # The era ended inside every gate: the oldest chained era is
            # the next era.
            return (
                not stop and count > 0 and not dirty and not self._spill
                and self._unique + vcap <= vs.MAX_LOAD * self._tcap
            )

        def advance() -> None:
            # A chained era's output is the state the next era starts
            # from, as JAX takes it (params_dev = spec): only its own
            # drain can ask for a fresh upload.
            nonlocal dirty, last_max_steps
            dirty = False
            last_max_steps = budget

        if first:
            consume(prog.result(pending), time.monotonic() - era_t0, False)
        # Each degraded regrow doubles the table (tpu_bfs.py:2196).
        regrow_budget = 8

        while not stop and (count > 0 or self._spill):
            host_dirty = dirty
            # S2 (tpu_bfs.py:2060-2087): refill whole LIFO blocks while they
            # fit under the hysteresis target; an empty ring takes at least
            # one (a block is <= C*A <= high_water rows), so spill is never
            # stranded. One upload and one K7s launch for all of them.
            refill: List[np.ndarray] = []
            refill_rows = 0
            while self._spill and (
                count + refill_rows + self._spill.peek_rows() <= spill_target
                or (count == 0 and not refill)
            ):
                refill.append(self._spill.pop())
                refill_rows += len(refill[-1])
            if refill:
                rows = np.concatenate(refill, axis=0)
                with self._metrics.phase("refill"):
                    staging.refill(prog.ring[None], [head + count], [len(rows)], rows)
                count += len(rows)
                self._inc("refill_rows", len(rows))
                host_dirty = True
            if count == 0:
                break
            # Proactive growth between eras, the graph captured anew.
            while self._unique + vcap > vs.MAX_LOAD * self._tcap:
                with self._metrics.phase("table_grow"):
                    self._tcap = prog.grow()
                self._inc("table_growths")
                host_dirty = True
            grow_limit = max(0, int(vs.MAX_LOAD * self._tcap) - vcap)
            max_steps = min(budget, budget_cap) if adaptive else budget
            if self._target_state_count is not None:
                # Bound the overshoot past the target: a step generates at
                # most C*A states (tpu_bfs.py:2079).
                remaining = max(0, self._target_state_count - self._state_count)
                max_steps = max(1, min(max_steps, 1 + remaining // (C * A)))
            if max_steps != budget or budget_cap != last_budget_cap:
                host_dirty = True
            fuse_lim = fuse_lim_now()
            if fb >= 0 and fuse_lim != last_fuse_lim:
                host_dirty = True
            if host_dirty:
                vals = mirror.copy()
                vals[:eo.P_LEN] = [
                    head, count, self._unique, rec_bits, depth_limit, grow_limit, high_water,
                    max_steps, 0, 0, 0, 0, take_cap, fin_any, fin_all, fin_all_en, budget_cap,
                ]
                if fb >= 0:
                    last_fuse_lim = vals[fb] = fuse_lim
                if sampler is not None:
                    last_thresh = sampler.threshold_parts()
                    vals[sb:sb + 2] = last_thresh
                prog.upload(vals)
                dirty = False
            last_max_steps, last_budget_cap = max_steps, budget_cap
            era_t0 = time.monotonic()
            pending = prog.launch()
            self._inc("dispatches")
            # Each chained era carries the threshold of the era it chains
            # off. A chained era of partial steps only is consumed: its
            # delivered rows were inserted and enqueued (the JAX driver
            # reads the clean steps, P_STEPS, there, tpu_bfs.py:2289, and
            # drops such an era with its states).
            try:
                chain_max = max(chain_max, run_chain(self, prog, pending, era_t0, depth, consume,
                                                     clean, advance, quiet))
            except ProbeBudgetExhausted:
                # The degraded regrow (tpu_bfs.py:2302-2347): discard the
                # failed era, reload the last checkpoint (the chained
                # dispatches were quiesced by run_chain), double the table
                # and go on. Without a checkpoint the consumed frontier
                # rows are gone: the error stands.
                if (
                    self._ckpt_path is None or regrow_budget == 0
                    or not checkpoint_generations(self._ckpt_path)
                ):
                    raise
                regrow_budget -= 1
                data, meta = self._read_checkpoint(self._ckpt_path)
                head, count, rec_bits, rec_fp1, rec_fp2 = self._install_checkpoint(prog, data, meta)
                mirror = template_with(rec_fp1, rec_fp2)
                prog.upload(mirror)
                with self._metrics.phase("table_grow"):
                    self._tcap = prog.grow()
                self._inc("degraded_regrow")
                self._inc("table_growths")
                dirty = True

        # A final checkpoint makes a stopped run (a target, a timeout, a
        # stop request) resumable from its exact boundary.
        if self._ckpt_path is not None:
            self._save_checkpoint(prog, head, count, rec_bits)
        self._gauge("spec_chain_depth", chain_max)
        self._gauge(
            "fused_eras_per_dispatch",
            round(self._counters.get("eras", 0) / max(1, self._counters.get("dispatches", 0)), 3),
        )
        self._gauge("graph_captures", prog.graph_captures)
        self._gauge("capture_secs", prog.capture_secs)

    # -- spill tiers and checkpoints ------------------------------------------

    def _on_spill_tier(self, direction, rows, nbytes, disk_bytes) -> None:
        """TieredSpillStore's tier moves: the reference's counters."""
        self._inc("spill_tier_rows" if direction == "ram_to_disk" else "spill_tier_refill_rows", rows)
        self._gauge("spill_disk_bytes", int(disk_bytes))

    def _save_checkpoint(self, prog, head: int, count: int, rec_bits: int) -> None:
        """The engine state at an era boundary (tpu_bfs.py:2548-2598), no
        dispatch in flight: the table as its four uint32 lanes, the ring
        lanes without the trash column, the discovery fingerprints (in
        the state vector), the spill blocks and the meta, one crash-safe
        npz (a full base or a table delta)."""
        P = len(self._tprops)
        meta = checkpoint_meta(
            self.tm,
            self._tprops,
            ring_lanes=prog.ring.shape[0],
            head=head,
            count=count,
            rec_bits=rec_bits,
            state_count=self._state_count,
            unique=self._unique,
            max_depth=self._max_depth,
            tcap=self._tcap,
            qcap=self._qcap,
            chunk=self._chunk,
            max_probes=vs.MAX_PROBES,
            discovery_fps={k: str(v) for k, v in self._discovery_fps.items()},
            sampler=self._sampler.export_state() if self._sampler is not None else None,
        )
        rec = prog.state[eo.P_LEN:eo.P_LEN + 2 * P].cpu().numpy().astype(np.uint32)
        arrays = {"rec_fp1": rec[:P], "rec_fp2": rec[P:]}
        for t, lane in enumerate(vs.table_to_lanes(prog.table)):
            arrays[f"table{t}"] = lane
        ring = prog.ring[:, :self._qcap].cpu().numpy().astype(np.uint32)
        for w in range(ring.shape[0]):
            arrays[f"queue{w}"] = ring[w]
        for i, blk in enumerate(self._spill.iter_blocks()):
            arrays[f"spill{i}"] = blk
        self._ckpt_delta = save_checkpoint_tiered(
            self._ckpt_path, meta, arrays, state=self._ckpt_delta, tcap=self._tcap,
            keep=self._ckpt_keep, metrics=self._counted(),
        )
        self._last_ckpt = time.monotonic()

    def _read_checkpoint(self, path: str):
        """Load and verify the newest good checkpoint (generations and
        deltas folded, engines/common.py), check it belongs to this
        checker, and restore the host's side: counters, discoveries, the
        sample and the spill stack (tpu_bfs.py:2600-2659)."""
        with self._metrics.phase("checkpoint_load"):
            data, meta = load_checkpoint_folded(path, metrics=self._counted())
        validate_checkpoint_meta(
            meta, self.tm, self._tprops,
            exact={
                "qcap": self._qcap,
                "state_width": self.tm.state_width,
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
        self._spill.reset(
            data[k] for k in sorted((k for k in data if k.startswith("spill")), key=lambda s: int(s[5:]))
        )
        self._ckpt_delta = None  # the next save is a fresh base
        return data, meta

    def _table_of(self, data) -> vs.VisitedTable:
        return vs.table_from_lanes(*(data[f"table{t}"] for t in range(4)), device=self.device)

    def _install_checkpoint(self, prog, data, meta, table=None):
        """Put a read checkpoint's table and ring on the device; returns
        (head, count, rec_bits, rec_fp1, rec_fp2)."""
        if table is None:
            prog.set_table(self._table_of(data))
        W = prog.ring.shape[0]
        q = np.stack([np.asarray(data[f"queue{w}"], dtype=np.uint32) for w in range(W)])
        prog.ring.zero_()
        prog.ring[:, :self._qcap] = torch.from_numpy(q.astype(np.int64)).to(self.device)
        return (
            meta["head"], meta["count"], meta["rec_bits"],
            np.asarray(data["rec_fp1"], dtype=np.int64), np.asarray(data["rec_fp2"], dtype=np.int64),
        )

    # -- accessors -----------------------------------------------------------

    def unique_state_count(self) -> int:
        return self._unique

    def telemetry(self):
        tel = super().telemetry()
        tel.update(table_capacity=self._tcap, chunk=self._chunk)
        return tel

    def discoveries(self) -> Dict[str, Path]:
        self.join()
        items = list(self._discovery_fps.items())
        paths = self._reconstruct_many([fp for _name, fp in items])
        return {name: path for (name, _fp), path in zip(items, paths)}

    def _sample_resolver(self):
        """Sample rows drain fingerprint-only: resolve them all with one
        batched walk (the path's last state is the sample, its last step
        the exemplar transition, its length the depth)."""
        fps = self._sampler.fingerprints()
        paths = dict(zip(fps, self._reconstruct_many(fps)))

        def resolve(fp: int):
            pairs = paths[fp].into_vec()
            out = {"state": pairs[-1][0], "depth": len(pairs)}
            if len(pairs) >= 2:
                out["pred"], out["action"] = pairs[-2]
            return out

        return resolve

    def _reconstruct_many(self, fps) -> List[Path]:
        """Walk every fp's parent chain on the card (`parent_chains`),
        then re-execute the model along each chain (tpu_bfs.py:2686).
        Under symmetry the chains are walked in representative space."""
        chains = parent_chains(self._table, fps)
        model = CanonicalTensorAdapter(self.tm) if self._canon else self._model
        return [Path.from_fingerprints(model, chain[::-1]) for chain in chains]
