"""Exhaustive batched BFS on the card: the port of
`stateright_tpu/engines/tpu_bfs.py` (serial eras, with bottom-k sampling
and symmetry reduction; no spill, no checkpoints).

One BFS step pops a chunk of C states from a ring queue on the device and
runs, at fixed widths so that no step waits on the host mid-way:

  1. ring pop                                 K7 ring           (kernel)
  2. fingerprints of the popped rows          K1 hash_lanes     (kernel)
  3. property evaluation + successors         K11 expand        (torch, model code)
  4. validity compaction to vcap              K2 compact_ids    (kernel)
  5. symmetry canonicalization (optional)     the model's representative_lanes (torch)
  6. fingerprints of the candidates           K1 hash_lanes     (kernel)
  7. in-batch dedup                           K3 claim_dedup    (kernel)
  8. compaction to rcap distinct candidates   K2 compact_ids    (kernel)
  9. visited-set insert                       K4 insert         (kernel)
 10. sample capture (sampling on)             K9a sample_capture (kernel)
 11. ring append of the new states            K2 + K7 ring      (kernels)
 12. discovery snapshots and coverage counts  (torch)

then reads back ONE small vector of counts, and the host applies the JAX
era program's rules to it (`_build_loop`, tpu_bfs.py:428-703): an
overflow (more than vcap valid or rcap distinct candidates, or an
unresolved insert) commits the inserted prefix, consumes nothing and
halves `take_cap`, which regrows by chunk/16 after each clean step. An
era runs steps until the JAX gate closes (tpu_bfs.py:403): empty
frontier, ring past its high-water mark, table past its growth limit,
step budget spent, a probe error, the finish policy met, or (sampling
on) the sample slab past its high-water mark. While the sampler is
under-full (threshold still MAX) a step pops at most 512 // A rows, as
the JAX loop clamps it (tpu_bfs.py:339-345, :449-455). At each era's end
the slab's bottom-k rows (K9b slab_bottomk) drain into the sampler and
the next era captures below the tightened threshold.

Eras end exactly where the JAX engine's serial eras do, because
discoveries are extracted per era (the shallowest first hit at the
lowest chunk position, tpu_bfs.py:781-810) and the ring order follows
the take clamp, so the results — counts, discovery fingerprints,
coverage, the sample — are the JAX engine's, bit for bit.

Discovery paths (and sample rows) are walked on the card, every chain
at once, one K6 lookup_parent launch per hop; the model then re-executes
along each chain on the host.

On `device="cpu"` every kernel call runs its plain torch version; that is
the only place the plain versions run on this path.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..checker import SLICE_CHECKPOINTS, CheckerBuilder, not_ported
from ..core import Expectation
from ..fingerprint import combine64, hash_lanes, hash_words_np, split64
from ..obs.coverage import DEPTH_CAP
from ..obs.sample import (
    DEVICE_STEP_CAP,
    slab_capacity,
    slab_entries,
    slab_high_water,
)
from ..ops import frontier as fr
from ..ops import slab as sl
from ..ops import visited_set as vs
from ..ops.expand import build_expand_lean
from ..path import Path
from ..tensor import CanonicalTensorAdapter, TensorModel, TensorModelAdapter
from ..xp import TorchXP
from .common import HostEngineBase

U32_MAX = 0xFFFFFFFF


def widths(A: int, chunk: int):
    """(vcap, rcap, dedup_cap) of the step: the compacted candidate width
    (tpu_bfs.py:162 `_vcap`, divisor 3), the distinct-candidate width and
    the dedup scratch (tpu_bfs.py:353-357)."""
    vcap = min(chunk * A, max(128 * A, (chunk * A) // 3))
    rcap = max(128 * A, (2 * vcap) // 5)
    dedup_cap = 1 << max(1, (4 * vcap - 1).bit_length())
    return vcap, rcap, dedup_cap


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


def seed(init_rows: torch.Tensor, init_ebits: int, tcap: int, qcap: int):
    """K10 (tpu_bfs.py:1080 _build_seed): a fresh table and ring on the
    rows' device, K1 + K4 over the init rows [S, n]. Every init row is
    enqueued at depth 1; the table keeps one per fingerprint. Returns
    (table, ring, unique)."""
    S, n = init_rows.shape
    dev = init_rows.device
    table = vs.empty_table(tcap, dev)
    h1, h2 = hash_lanes(init_rows)
    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    is_new, unres = vs.insert(
        table, h1, h2, zero, zero, torch.ones(n, dtype=torch.bool, device=dev)
    )
    ring = fr.empty_ring(S + 2, qcap, dev)
    ring[:S, :n] = init_rows
    ring[S, :n] = init_ebits
    ring[S + 1, :n] = 1
    new, unresolved = torch.stack([is_new.sum(), unres.sum()]).tolist()
    if unresolved:
        raise RuntimeError(
            "init-state seeding exhausted the visited-table probe budget; "
            "raise table_capacity"
        )
    return table, ring, new


def seed_lanes(table, rings, init_rows: torch.Tensor, n_init: torch.Tensor, init_ebits: int):
    """K10's lane form (multiplex.py:117-143): seed each lane's table
    ([N, tcap], empty) and ring ([N, W, qcap + 1], zero) in place from one
    icap-wide init slab [S, icap]: lane l takes its first n_init[l] rows
    (n_init int64 [N] on the device; 0 for a padding lane), K1 over the
    slab and lane K4 over [N, icap]. Every taken row is enqueued at depth
    1; each table keeps one per fingerprint. Returns device tensors
    (unique [N], unresolved [N])."""
    S, icap = init_rows.shape
    N = rings.shape[0]
    valid = torch.arange(icap, device=init_rows.device) < n_init[:, None]
    h1, h2 = hash_lanes(init_rows)
    zero = torch.zeros((N, icap), dtype=torch.int64, device=init_rows.device)
    is_new, unres = vs.insert_lanes(
        table, h1.expand(N, icap).contiguous(), h2.expand(N, icap).contiguous(), zero, zero, valid
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
        super().__init__(builder, model=model)
        self.device = resolve_device(device)
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
        tm = self.tm
        dev = self.device
        S, A, C, P = tm.state_width, tm.max_actions, self._chunk, len(self._tprops)
        qmask = self._qcap - 1
        vcap, rcap, dedup_cap = widths(A, C)
        high_water = self._qcap - C * A
        depth_limit = (
            self._target_max_depth if self._target_max_depth is not None else U32_MAX
        )
        fin_any, fin_all, fin_all_en = self._finish_when.device_masks(self._tprops)
        xp = TorchXP(dev)
        expand = build_expand_lean(tm, self._tprops, C, xp)
        arange_c = torch.arange(C, device=dev)

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
        sampler = self._sampler
        if sampler is not None:
            # The seed inserts before the era loop's slab captures: offer
            # the inits host-side, rows and all (tpu_bfs.py:1701-1710).
            ih1, ih2 = hash_words_np(inits)
            sampler.offer_array(
                (ih1.astype(np.uint64) << np.uint64(32)) | ih2.astype(np.uint64),
                depths=np.ones(n_init, dtype=np.int64),
                states=inits,
            )
            k = sampler.k
            sk2 = slab_entries(k)
            s_high = slab_high_water(k)
            slab = sl.empty_slab(slab_capacity(k, DEVICE_STEP_CAP), dev)
            # Loose-threshold take clamp (tpu_bfs.py:339-345).
            s_take = max(1, DEVICE_STEP_CAP // max(1, A))

        init_t = torch.from_numpy(inits.T.astype(np.int64)).to(dev).contiguous()
        table, ring, self._unique = seed(init_t, self._init_ebits, self._tcap, self._qcap)

        head, count, take_cap = 0, n_init, C
        rec_bits = 0
        budget = self._max_sync_steps

        first = True
        while first or count > 0:
            if not first:
                while self._unique + vcap > vs.MAX_LOAD * self._tcap:
                    table = self._grow(table)
            first = False
            grow_limit = max(0, int(vs.MAX_LOAD * self._tcap) - vcap)
            max_steps = budget
            if self._target_state_count is not None:
                # Bound the overshoot past the target: a step generates at
                # most C*A states (tpu_bfs.py:2079). The clamped budget
                # carries to the next era, as the device-emitted budget does.
                remaining = max(0, self._target_state_count - self._state_count)
                max_steps = max(1, min(max_steps, 1 + remaining // (C * A)))
            budget = max_steps
            occupied = 0
            if sampler is not None:
                t1, t2 = sampler.threshold_parts()
                loose = (t1, t2) == (U32_MAX, U32_MAX)
                for lane in slab:
                    lane.zero_()

            # ---- one era (tpu_bfs.py:361 loop) ----
            self._inc("eras")
            steps = gen = err_cnt = expanded = 0
            rec_acc = rec_bits
            hseen = torch.zeros((P, C), dtype=torch.bool, device=dev)
            facc1 = torch.zeros((P, C), dtype=torch.int64, device=dev)
            facc2 = torch.zeros_like(facc1)
            faccd = torch.zeros_like(facc1)
            act = torch.zeros(A, dtype=torch.int64, device=dev)
            dhist = torch.zeros(DEPTH_CAP, dtype=torch.int64, device=dev)
            covp = [0] * P
            while True:
                fin_hit = (rec_acc & fin_any) != 0 or (
                    fin_all_en and (rec_acc & fin_all) == fin_all
                )
                if not (
                    0 < count <= high_water
                    and self._unique <= grow_limit
                    and steps < max_steps
                    and err_cnt == 0
                    and not fin_hit
                    and (sampler is None or occupied <= s_high)
                ):
                    break
                # ---- one step (tpu_bfs.py:428 body) ----
                take = min(count, C, take_cap)
                if sampler is not None and loose:
                    take = min(take, s_take)
                active = arange_c < take
                popped = fr.ring_pop(ring, head, C)
                rows = popped[:S]
                ebits = popped[S]
                depth = popped[S + 1]
                row_h1, row_h2 = hash_lanes(rows)
                ex = expand(rows, ebits, depth, active, depth_limit)
                vids, vvalid, n_val = vs.compact_ids(ex.valid, vcap)
                cl = ex.flat.index_select(1, vids)
                if self._canon:
                    # Canonicalize at the compacted width, before hashing
                    # (tpu_bfs.py:478-482).
                    cl = torch.stack(
                        tm.representative_lanes(xp, tuple(cl[i] for i in range(S)))
                    ) & U32_MAX
                ch1, ch2 = hash_lanes(cl)
                reps = fr.claim_dedup(ch1, ch2, vvalid, dedup_cap)
                dids, dvalid, n_d = vs.compact_ids(reps, rcap)
                dflat = vids.index_select(0, dids)
                src = dflat % C  # candidate a*C + c has parent row c
                dp1 = torch.where(dvalid, row_h1.index_select(0, src), 0)
                dp2 = torch.where(dvalid, row_h2.index_select(0, src), 0)
                ddepth = depth.index_select(0, src) + 1
                dh1 = ch1.index_select(0, dids)
                dh2 = ch2.index_select(0, dids)
                c_new, unresolved = vs.insert(table, dh1, dh2, dp1, dp2, dvalid)
                if sampler is not None:
                    sl.capture(slab, c_new, dh1, dh2, ddepth, dflat // C, t1, t2, DEVICE_STEP_CAP)
                # The inserted prefix is enqueued even on an overflow step:
                # inserts are idempotent and enqueue == inserted keeps every
                # state exactly once in the ring.
                fr.ring_scatter(
                    ring, (head + count) & qmask,
                    torch.cat([
                        cl.index_select(1, dids),
                        ex.ebits.index_select(0, src)[None], ddepth[None],
                    ]),
                    c_new,
                )
                stats = [n_val, n_d, unresolved.sum(), c_new.sum(), ex.generated]
                if sampler is not None:
                    stats.append(slab.counts[0])
                if P:
                    hits = torch.stack(ex.prop_hits)
                    new_hit = hits & ~hseen
                    facc1 = torch.where(new_hit, row_h1, facc1)
                    facc2 = torch.where(new_hit, row_h2, facc2)
                    faccd = torch.where(new_hit, depth, faccd)
                    hseen |= hits
                    stats.append(hits.sum(1))
                if self._cov:
                    pa = ex.valid.view(A, C).sum(1)
                    dhist.index_add_(
                        0, ddepth.clamp(max=DEPTH_CAP - 1), c_new.to(torch.int64)
                    )
                vals = torch.cat([s.view(-1) for s in stats]).tolist()  # the one sync
                n_val, n_d, unres_n, new_count, generated = vals[:5]
                if sampler is not None:
                    occupied = vals[5]
                    hs = vals[6:]
                else:
                    hs = vals[5:]

                if take <= 1:
                    err_cnt += unres_n
                ovf = n_val > vcap or n_d > rcap or unres_n > 0
                consumed = 0 if ovf else take
                head = (head + consumed) & qmask
                count = count - consumed + new_count
                self._unique += new_count
                if ovf:
                    self._inc("partial_steps")
                    take_cap = max(take >> 1, 1)
                else:
                    gen += generated
                    steps += 1
                    take_cap = min(take_cap + max(1, C // 16), C)
                    if self._cov:
                        act += pa
                        for i in range(P):
                            covp[i] += hs[i]
                expanded += consumed
                for i in range(P):
                    if hs[i]:
                        rec_acc |= 1 << i

            # ---- era epilogue (tpu_bfs.py:781-810, :983-995) ----
            self._inc("steps", steps)
            if sampler is not None:
                self._drain(slab, sk2)
            if err_cnt:
                raise RuntimeError(
                    "visited-table probe budget exhausted despite headroom"
                )
            if P:
                found = hseen.any(1).tolist()
                sel = torch.where(hseen, faccd, U32_MAX).argmin(1)  # shallowest, lowest position
                pidx = torch.arange(P, device=dev)
                fp1 = facc1[pidx, sel].tolist()
                fp2 = facc2[pidx, sel].tolist()
                for i, p in enumerate(self._tprops):
                    if found[i] and not (rec_bits >> i) & 1:
                        if p.name not in self._discovery_fps:
                            self._discovery_fps[p.name] = combine64(fp1[i], fp2[i])
                        rec_bits |= 1 << i
            if steps > 0:
                self._max_depth = max(
                    self._max_depth, int(ring[S + 1, (head - 1) & qmask])
                )
            self._state_count += gen
            self._inc("states_generated", gen)
            if self._cov:
                cov = self._coverage
                cov.record_action_counts(act.tolist())
                for i, p in enumerate(self._tprops):
                    cov.record_property_eval(p.name, expanded)
                    cov.record_property_hit(p.name, covp[i])
                cov.record_depth_counts(dhist.tolist())

            if count > high_water:
                raise RuntimeError(
                    f"the frontier ({count} states) outgrew queue_capacity="
                    f"{self._qcap}: spilling the ring to the host is not "
                    "ported yet; raise queue_capacity"
                )
            if self._finish_matched(self._discovery_fps):
                break
            if (
                self._target_state_count is not None
                and self._state_count >= self._target_state_count
            ):
                break
        self._table = table

    def _grow(self, table):
        """Double the table and rehash on the device (K5 = K4 over the
        occupied rows)."""
        new = vs.empty_table(table.capacity * 2, self.device)
        if vs.rehash(table, new):
            raise RuntimeError("rehash failed; table pathologically full")
        self._tcap = new.capacity
        self._inc("table_growths")
        return new

    def _drain(self, slab, sk2: int) -> None:
        """Era end: the slab's sk2 rows with the smallest fp1 (K9b) go to
        the sampler with the era's occupancy and drop count, in one
        readback (tpu_bfs.py:1894-1908)."""
        fp1, fp2, depth, action, valid = sl.bottom_k(slab, sk2)
        vals = torch.cat(
            [slab.counts, fp1, fp2, depth, action, valid.to(torch.int64)]
        ).cpu().numpy()
        occupied, dropped = int(vals[0]), int(vals[1])
        if occupied or dropped:
            lanes = vals[2:].reshape(5, sk2)
            self._sampler.drain_slab(
                lanes[0], lanes[1], lanes[2], lanes[4], occupied,
                dropped=dropped, actions=lanes[3],
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
