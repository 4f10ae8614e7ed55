"""Batched random-walk simulation on the card: the port of
`stateright_tpu/engines/tpu_simulation.py` (`_build_sim_loop` :77 and
`TpuSimulationChecker` :664).

B walks advance together, one random transition a walk a step. One step
runs, at fixed widths:

  1. fingerprints of the walks' states        K1 hash_lanes    (kernel)
  2. cycle test, path record, depth counts    K13a walk_record (kernel)
  3. sample capture (sampling on)             K13c walk_capture (kernel)
  4. properties and successors                the model's checks and
                                              `step_lanes` (torch)
  5. hits, freezing, choice, advance/restart  K13b walk_step   (kernel)

then reads back ONE small counts vector (gen, occupied, recorded bits,
maxd, frozen walks), and the host applies the JAX era program's gate to
it before the next step (tpu_simulation.py:168): the step budget
(`sync_steps`, at most 64 under a timeout), the finish policy's masks,
the generated-states target and, with sampling, the slab occupancy
`<= slab_high_water(k)`. Once every walk is frozen the era's remaining
steps are no-ops in the reference; they are counted, not run.
An era starts by restarting the walks that arrived frozen (K13b's
prologue entry point) and ends with the shortest first hit of each property
(argmin over `plen`, first walk on ties), the coverage counts and the
sample slab's deduplicated bottom-k (K13d walk_slab), all in one
readback. The host then drains the sample, tightens the threshold,
harvests each newly hit property's fingerprint path from its walk's path
row, and stops on the finish policy, the target or the timeout.

The walks' choices come from the integer hash `ops.walk.prng`, which is
the JAX loop's own, so every era ends where the JAX engine's does and the
results — counts, discovery paths, coverage, the sample — are the JAX
engine's, bit for bit (below 2^32 generated states: the JAX era counts
wrap there, these do not).

On `device="cpu"` every kernel call runs its plain torch version.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..checker import CheckerBuilder
from ..fingerprint import combine64, hash_lanes
from ..obs.coverage import DEPTH_CAP
from ..obs.sample import slab_entries, slab_high_water
from ..ops import walk as wk
from ..path import Path
from ..tensor import TensorModel, TensorModelAdapter
from ..xp import TorchXP
from .common import HostEngineBase
from .gpu_bfs import resolve_device

U32_MAX = 0xFFFFFFFF


class EraResult(NamedTuple):
    rec_bits: int  # recorded-property bits after the era
    gen: int  # states generated (walks counted) in the era
    steps: int  # the era's steps, the reference's count
    steps_run: int  # ... of which run (the rest: every walk frozen)
    maxd: int  # longest walk path seen in the era
    disc_walk: List[int]  # per property: the walk of its shortest first hit
    disc_plen: List[int]  # ... and that hit's path length
    coverage: Optional[np.ndarray]  # act[A] | prop_hits[P] | depth[DEPTH_CAP]
    occupied: int  # sample slab rows captured in the era
    sample: Optional[np.ndarray]  # [3 + S, sk2]: fp1, fp2, depth, lanes
    sample_ok: Optional[np.ndarray]  # [sk2] bool


class SimProgram:
    """The walks of one model at fixed widths (B walks, paths of L) on one
    device: `seed` makes the walk state, `era` runs one era of steps behind
    the JAX gate. The counterpart of `_build_sim_loop`'s `seed_run` and
    `loop`."""

    def __init__(self, tm: TensorModel, props, B: int, L: int, cov: bool,
                 sample_k: int, device):
        self.tm, self.props = tm, props
        self.B, self.L, self.cov = B, L, cov
        self.device = torch.device(device)
        self.xp = TorchXP(self.device)
        S = tm.state_width
        inits = np.asarray(tm.init_states_array(), dtype=np.uint32)
        # Boundary-filtered init states (tpu_simulation.py:111-119).
        inb = np.asarray(
            tm.within_boundary_lanes(np, tuple(inits[:, s] for s in range(S))), dtype=bool
        )
        inits = inits[inb]
        self.n_init = len(inits)
        self.inits = torch.from_numpy(inits.T.astype(np.int64)).to(self.device).contiguous()
        self.ev_mask, self.al_mask = wk.prop_masks(props)
        self.init_ebits = (1 << bin(self.ev_mask).count("1")) - 1
        self.sample_k = sample_k
        if sample_k:
            self.sk2 = slab_entries(sample_k)
            self.s_high = slab_high_water(sample_k)
            # One more step always fits (tpu_simulation.py:102).
            self.slab = wk.empty_walk_slab(S, self.s_high + B, self.device)

    def seed(self, master: int):
        """(walk, path) of `seed_run` (tpu_simulation.py:536)."""
        walk = wk.seed_walks(master, self.B, self.inits, self.init_ebits)
        path = torch.zeros((self.B, self.L), dtype=torch.int64, device=self.device)
        return walk, path

    def _step(self, walk, path, stats, hseen, plen, cov, dhist, t1, t2) -> None:
        tm, xp = self.tm, self.xp
        S, A, B = tm.state_width, tm.max_actions, self.B
        rows = walk[:S]
        h1, h2 = hash_lanes(rows)
        counted, cycle = wk.record(h1, h2, walk, path, stats, dhist)
        if self.sample_k:
            wk.capture(self.slab, stats, counted, h1, h2, walk, t1, t2)
        lanes = tuple(rows[s] for s in range(S))
        if self.props:
            checks = torch.stack([p.check(xp, lanes) for p in self.props])
        else:
            checks = torch.zeros((0, B), dtype=torch.bool, device=self.device)
        succs, amask = tm.step_lanes(xp, lanes)
        valid = torch.stack(
            [amask[a] & tm.within_boundary_lanes(xp, succs[a]) for a in range(A)]
        )
        # One copy of the A*S successor lanes, taken before K13b rewrites
        # the walk lanes some of them are views of.
        succ = torch.stack([lane for a in range(A) for lane in succs[a]]).view(A, S, B)
        wk.step(walk, counted, cycle, checks, self.ev_mask, self.al_mask, valid, succ,
                self.inits, self.init_ebits, self.L, hseen, plen, stats, cov)

    def era(self, walk, path, *, rec_bits: int, max_steps: int, fin_any: int,
            fin_all: int, fin_all_en: int, target_gen: int, gen0: int,
            threshold=(U32_MAX, U32_MAX)) -> EraResult:
        """One era (tpu_simulation.py:149 `loop`): the prologue, steps while
        the gate holds, the epilogue. Updates walk and path in place."""
        dev = self.device
        S, A, P, B = self.tm.state_width, self.tm.max_actions, len(self.props), self.B
        wk.restart_frozen(walk, self.inits, self.init_ebits)
        stats = torch.tensor([0, 0, rec_bits, 0, 0], dtype=torch.int64, device=dev)
        hseen = torch.zeros((P, B), dtype=torch.bool, device=dev)
        plen = torch.zeros((P, B), dtype=torch.int64, device=dev)
        cov = dhist = None
        if self.cov:
            cov = torch.zeros(A + P + DEPTH_CAP, dtype=torch.int64, device=dev)
            dhist = cov[A + P:]
        t1, t2 = threshold
        steps = run = gen = occupied = frozen = 0
        rec_acc = rec_bits
        while True:
            fin_hit = (rec_acc & fin_any) != 0 or (
                fin_all_en != 0 and (rec_acc & fin_all) == fin_all
            )
            under_target = target_gen == 0 or gen0 + gen < target_gen
            if not (steps < max_steps and not fin_hit and under_target
                    and (not self.sample_k or occupied <= self.s_high)):
                break
            if frozen == B:
                # Every walk is frozen until the era ends: each step left
                # would change nothing but the step count, so the gate
                # stays open until the budget is spent. Count them unrun.
                steps = max_steps
                break
            self._step(walk, path, stats, hseen, plen, cov, dhist, t1, t2)
            steps += 1
            run += 1
            gen, occupied, rec_acc, _maxd, frozen = stats.tolist()  # the one sync a step

        # Epilogue: per property the walk of the shortest first hit
        # (first walk on ties), then everything in one readback.
        sel = torch.where(hseen, plen, U32_MAX).argmin(1)
        parts = [stats, sel, plen.gather(1, sel[:, None]).view(-1),
                 hseen.any(1).to(torch.int64)]
        if cov is not None:
            parts.append(cov)
        if self.sample_k:
            lanes, ok = wk.slab_bottom_k(self.slab, stats, self.sk2)
            parts += [lanes.reshape(-1), ok.to(torch.int64)]
        vals = torch.cat(parts).cpu().numpy()
        gen, occupied, _rec, maxd = (int(v) for v in vals[:4])
        off = stats.numel()
        disc_walk = [int(v) for v in vals[off:off + P]]
        disc_plen = [int(v) for v in vals[off + P:off + 2 * P]]
        found = vals[off + 2 * P:off + 3 * P]
        off += 3 * P
        for i in range(P):
            if found[i]:
                rec_bits |= 1 << i
        coverage = sample = sample_ok = None
        if cov is not None:
            coverage = vals[off:off + A + P + DEPTH_CAP]
            off += A + P + DEPTH_CAP
        if self.sample_k:
            n = (3 + S) * self.sk2
            sample = vals[off:off + n].reshape(3 + S, self.sk2)
            sample_ok = vals[off + n:off + n + self.sk2].astype(bool)
        return EraResult(rec_bits, gen, steps, run, maxd, disc_walk, disc_plen,
                         coverage, occupied, sample, sample_ok)


class GpuSimulationChecker(HostEngineBase):
    """B batched seeded random walks on one CUDA device."""

    def __init__(
        self,
        builder: CheckerBuilder,
        seed: int,
        *,
        walks: int = 1024,
        walk_cap: int = 256,
        sync_steps: int = 1024,
        device=None,
    ):
        model = builder.model
        if isinstance(model, TensorModel):
            model = TensorModelAdapter(model)
        if not isinstance(model, TensorModelAdapter):
            raise TypeError("spawn_gpu_simulation requires a TensorModel (or its adapter)")
        super().__init__(builder, model=model)
        if self._symmetry is not None:
            raise ValueError(
                "the device simulation engine does not support symmetry reduction"
            )
        self.device = resolve_device(device)
        self.tm: TensorModel = model.tm
        self._tprops = self.tm.tensor_properties()
        if len(self._tprops) > 32:
            raise ValueError("at most 32 tensor properties supported")
        self._seed = seed & U32_MAX
        self._B = walks
        self._L = (
            min(walk_cap, self._target_max_depth)
            if self._target_max_depth is not None
            else walk_cap
        )
        self._sync = sync_steps
        self._discovery_paths: Dict[str, List[int]] = {}
        self._counters.update(walks=self._B, walk_cap=self._L)
        self._prog = SimProgram(
            self.tm, self._tprops, self._B, self._L, self._coverage.enabled,
            self._sampler.k if self._sampler is not None else 0, self.device,
        )
        self._start()

    def _run(self) -> None:
        prog = self._prog
        S, L = self.tm.state_width, self._L
        fin_any, fin_all, fin_all_en = self._finish_when.device_masks(self._tprops)
        if prog.n_init == 0:
            return
        max_sync = self._sync if self._timeout is None else min(64, self._sync)
        target_gen = self._target_state_count or 0
        sampler = self._sampler
        threshold = sampler.threshold_parts() if sampler is not None else (U32_MAX, U32_MAX)
        walk, path = prog.seed(self._seed)
        rec_bits = gen_total = 0
        while True:
            out = prog.era(
                walk, path, rec_bits=rec_bits, max_steps=max_sync, fin_any=fin_any,
                fin_all=fin_all, fin_all_en=fin_all_en, target_gen=target_gen,
                gen0=gen_total, threshold=threshold,
            )
            self._inc("eras")
            self._inc("steps", out.steps)
            self._inc("steps_run", out.steps_run)
            self._inc("states_generated", out.gen)
            gen_prev, gen_total = gen_total, gen_total + out.gen
            self._state_count = gen_total
            self._max_depth = max(self._max_depth, out.maxd)

            if out.coverage is not None:
                A, P = self.tm.max_actions, len(self._tprops)
                cov = self._coverage
                cov.record_action_counts(out.coverage[:A])
                for i, p in enumerate(self._tprops):
                    # Every property is evaluated on every counted state.
                    cov.record_property_eval(p.name, gen_total - gen_prev)
                    cov.record_property_hit(p.name, int(out.coverage[A + i]))
                cov.record_depth_counts(out.coverage[A + P:])

            if sampler is not None:
                if out.occupied:
                    # exact=False: walks revisit states, so occupied > drained
                    # means duplicates, not truncation (obs/sample.py).
                    s = out.sample
                    sampler.drain_slab(
                        s[0], s[1], s[2], out.sample_ok, out.occupied,
                        states=s[3:].T, exact=False,
                    )
                threshold = sampler.threshold_parts()

            if out.rec_bits != rec_bits:
                self._harvest(path, out, L)
                rec_bits = out.rec_bits

            if self._finish_matched(self._discovery_paths):
                break
            if target_gen and gen_total >= target_gen:
                break
            if self._timed_out():
                break

    def _harvest(self, path, out: EraResult, L: int) -> None:
        """Read each newly hit property's fingerprint chain, the first plen
        slots of its walk's path row (tpu_simulation.py:951-971)."""
        need = [
            (i, p.name) for i, p in enumerate(self._tprops)
            if (out.rec_bits >> i) & 1 and p.name not in self._discovery_paths
        ]
        if not need:
            return
        ws = torch.tensor([out.disc_walk[i] for i, _ in need], dtype=torch.int64)
        rows = path.index_select(0, ws.to(path.device)).cpu().numpy()
        for (i, name), row in zip(need, rows):
            n = min(out.disc_plen[i], L)
            self._discovery_paths[name] = [
                combine64((int(x) >> 32) & U32_MAX, int(x) & U32_MAX) for x in row[:n]
            ]

    # -- accessors -----------------------------------------------------------

    def unique_state_count(self) -> int:
        # No global visited set is kept (reference simulation.rs:413-417).
        return self._state_count

    def discoveries(self) -> Dict[str, Path]:
        self.join()
        return {
            name: Path.from_fingerprints(self._model, chain)
            for name, chain in list(self._discovery_paths.items())
        }
