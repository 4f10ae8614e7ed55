"""Exhaustive batched BFS on the card: the port of
`stateright_tpu/engines/tpu_bfs.py` (eras on the device, pipelined and
fused as the JAX engine runs them, with bottom-k sampling, symmetry
reduction and run timeouts; no spill, no checkpoints).

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
coverage, the sample drain and the stop conditions.

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
from typing import Dict, List

import numpy as np
import torch

from ..checker import SLICE_CHECKPOINTS, CheckerBuilder, not_ported
from ..core import Expectation
from ..fingerprint import combine64, hash_lanes, hash_words_np, split64
from ..ops import era as eo
from ..ops import visited_set as vs
from ..path import Path
from ..tensor import CanonicalTensorAdapter, TensorModel, TensorModelAdapter
from . import era, stages
from .common import HostEngineBase
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


def run_chain(engine, prog, pending, t0: float, depth: int, consume, clean, advance) -> int:
    """Read back the dispatch `pending` (launched at `t0`) and drive the
    K-deep speculative chain behind it (tpu_bfs.py:2204-2301,
    mesh.py:2048-2160): up to `depth` dispatches launched off the
    still-on-device state while earlier readbacks are in flight. Sound
    because the device gate re-derives every exit from the state: a
    dispatch chained past a boundary that needs the host runs no step.

    `consume(vals, secs)` takes each readback in order; while `clean()`
    says the boundary needs no host work, the oldest chained dispatch is
    the next one; otherwise the chain is drained in order — a dispatch
    that ran no step (`prog.ran`) was wasted speculation, one that ran
    steps (partial ones included, or a timeout landing mid-chain) is real
    work and is consumed. `advance()` runs before the host moves on to a
    chained dispatch. Returns the deepest chain reached."""
    chain = []
    deepest = 0
    while True:
        while len(chain) < depth and not engine._timed_out():
            chain.append((prog.launch(), time.monotonic()))
            engine._inc("dispatches")
            engine._inc("spec_dispatch")
            deepest = max(deepest, len(chain))
        consume(prog.result(pending), time.monotonic() - t0)
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
            consume(vals, time.monotonic() - spec_t0)
        return deepest


class GpuBfsChecker(HostEngineBase):
    """Batched BFS over a TensorModel on one CUDA device."""

    _NOT_PORTED = (
        "checkpoint_path", "checkpoint_every", "resume_from",
        "keep_checkpoints",
    )

    def __init__(
        self,
        builder: CheckerBuilder,
        *,
        chunk_size: int = 8192,
        queue_capacity: int = 1 << 20,
        table_capacity: int = 1 << 22,
        sync_steps: int = 4096,
        device=None,
        compiled=None,
        **kw,
    ):
        for name in kw:
            if name in self._NOT_PORTED:
                raise not_ported(f"{name}=", SLICE_CHECKPOINTS)
            raise TypeError(f"unexpected keyword argument {name!r}")
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
        # unconsumed rows while count <= high_water (tpu_bfs.py:1429).
        self._chunk = min(
            chunk_size, queue_capacity // (2 * max(1, self.tm.max_actions))
        )
        if self._chunk == 0:
            raise ValueError("queue_capacity too small for this model's fanout")
        self._qcap = queue_capacity
        self._tcap = table_capacity
        self._max_sync_steps = sync_steps
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
        """The JAX engine's host loop (tpu_bfs.py:1540-2301) without spill, checkpoints,
        resharding and the flight recorder."""
        tm = self.tm
        dev = self.device
        S, A, C, P = tm.state_width, tm.max_actions, self._chunk, len(self._tprops)
        vcap = widths(A, C)[0]
        high_water = self._qcap - C * A
        depth_limit = (
            self._target_max_depth if self._target_max_depth is not None else U32_MAX
        )
        fin_any, fin_all, fin_all_en = self._finish_when.device_masks(self._tprops)
        sampler = self._sampler
        sample_k = sampler.k if sampler is not None else 0

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

        # The era budget (tpu_bfs.py:1583-1612): the full sync_steps
        # allowance, or under a timeout the adaptive budget — the device
        # emits the next era's budget (doubling after budget-only exits,
        # halving under pressure) and the host moves only its cap, from
        # the wall time of each era against a poll target of timeout / 4.
        adaptive = self._timeout is not None
        max_sync = self._max_sync_steps if not adaptive else min(eo.BUDGET_MIN, self._max_sync_steps)
        pipeline = self._pipeline and self._target_state_count is None
        depth = self._chain_depth if pipeline else 0  # 0: no chain

        prog = era.EraProgram(
            tm, self._tprops, C, self._qcap, self._tcap, self._canon, self._cov,
            sample_k, self._fuse, dev, in_flight=depth + 1,
        )
        try:
            self._run_eras(prog, inits, vcap, high_water, depth_limit, (fin_any, fin_all, fin_all_en),
                           adaptive, max_sync, depth)
        finally:
            prog.free_graph()
        self._table = prog.table

        def stage_programs():
            progs = stages.bfs_stages(tm, self._tprops, C, self._qcap, self._canon,
                                      self._stage_iters, dev)
            return progs, (prog.table, prog.ring)

        self._profile_stages(stage_programs, self._counters.get("steps", 0))

    def _run_eras(self, prog, inits, vcap, high_water, depth_limit, fin, adaptive, max_sync,
                  depth) -> None:
        tm, dev = self.tm, self.device
        A, C, P = tm.max_actions, self._chunk, len(self._tprops)
        n_init = len(inits)
        fin_any, fin_all, fin_all_en = fin
        sampler = self._sampler
        budget = max_sync
        budget_cap = min(eo.BUDGET_MIN, max_sync) if adaptive else 0
        cap_limit = min(self._max_sync_steps, 1 << 30)
        poll_target = self._timeout / 4.0 if adaptive else None
        x = prog.plen
        fb, sb, sk2 = prog.f_base, prog.s_base, prog.sk2
        cb = prog.cov_base

        def fuse_lim_now() -> int:
            # tpu_bfs.py:1628-1647 without auto-N (it reads the flight
            # recorder, which the port does not have).
            if self._fuse <= 1 or self._target_state_count is not None:
                return 1
            if self._deadline is not None and time.monotonic() >= self._deadline - self._timeout / 2:
                return 1
            return self._fuse

        max_steps0 = max_sync
        if self._target_state_count is not None:
            remaining = max(0, self._target_state_count - n_init)
            max_steps0 = max(1, min(max_steps0, 1 + remaining // (C * A)))
        template = np.zeros(prog.plen + eo.X_LEN, dtype=np.int64)
        last_fuse_lim = last_thresh = None
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
        head, count, take_cap, rec_bits = 0, n_init, C, 0
        self._unique = n_init  # provisional; exact at the first readback
        last_max_steps, last_budget_cap = max_steps0, budget_cap
        mirror = template  # the state vector as last read back
        dirty = stop = False
        chain_max = 0

        def process_result(vals, era_dt: float) -> None:
            """Consume one dispatch's readback (tpu_bfs.py:1776-2035)."""
            nonlocal head, count, take_cap, rec_bits, stop, dirty, budget, budget_cap, last_thresh
            n_inner = max(1, min(int(vals[fb + 1]), self._fuse)) if fb >= 0 else 1
            if vals[eo.P_ERR]:
                # An error with zero steps on the first readback came in
                # from the seed (tpu_bfs.py:1824-1829).
                if self._counters.get("eras", 0) == 0 and vals[eo.P_STEPS] == 0:
                    raise RuntimeError(SEED_ERROR)
                raise RuntimeError("visited-table probe budget exhausted despite headroom")
            head, count = int(vals[eo.P_HEAD]), int(vals[eo.P_COUNT])
            take_cap = int(vals[eo.P_TAKE_CAP])
            budget = int(vals[eo.P_MAX_STEPS])
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
                raise RuntimeError(
                    f"the frontier ({count} states) outgrew queue_capacity="
                    f"{self._qcap}: spilling the ring to the host is not "
                    "ported yet; raise queue_capacity"
                )
            if self._finish_matched(self._discovery_fps):
                stop = True
            elif (
                self._target_state_count is not None
                and self._state_count >= self._target_state_count
            ):
                stop = True
            elif self._timed_out():
                stop = True

        def consume(vals, era_dt: float) -> None:
            nonlocal mirror
            mirror = vals  # the state vector as last read back
            process_result(vals, era_dt)

        def clean() -> bool:
            # The era ended inside every gate: the oldest chained era is
            # the next era.
            return (
                not stop and count > 0 and not dirty
                and self._unique + vcap <= vs.MAX_LOAD * self._tcap
            )

        def advance() -> None:
            # A chained era's output is the state the next era starts
            # from, as JAX takes it (params_dev = spec): only its own
            # drain can ask for a fresh upload.
            nonlocal dirty, last_max_steps
            dirty = False
            last_max_steps = budget

        consume(prog.result(pending), time.monotonic() - era_t0)

        while not stop and count > 0:
            host_dirty = dirty
            # Proactive growth between eras, the graph captured anew.
            while self._unique + vcap > vs.MAX_LOAD * self._tcap:
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
            chain_max = max(chain_max, run_chain(self, prog, pending, era_t0, depth, consume, clean,
                                                 advance))

        self._gauge("spec_chain_depth", chain_max)
        self._gauge(
            "fused_eras_per_dispatch",
            round(self._counters.get("eras", 0) / max(1, self._counters.get("dispatches", 0)), 3),
        )
        self._gauge("graph_captures", prog.graph_captures)
        self._gauge("capture_secs", prog.capture_secs)

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
