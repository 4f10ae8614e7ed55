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

then K13f's COMMIT (kernels/csrc/walk_era.cu), which counts the step and
applies the JAX era program's gate on the card (tpu_simulation.py:168):
the step budget (`sync_steps`, at most 64 under a timeout), the finish
policy's masks, the generated-states target and, with sampling, the slab
occupancy `<= slab_high_water(k)`. Once every walk is frozen the era's
remaining steps are no-ops in the reference; the gate counts them and
closes, so none runs. An era starts with K13b's prologue entry point
(restart the walks that arrived frozen) and K13f's BEGIN (the era's
inputs, zeroed counts, the gate), and ends with K13f's EPILOGUE (the
shortest first hit of each property: argmin over `plen`, first walk on
ties) and the sample slab's deduplicated bottom-k (K13d walk_slab), all
into one state vector in the JAX era's `params_out` layout
(ops/walk_era.py).

On the card an era is ONE graph launch (engines/graph.py: the prologue,
a conditional WHILE node over the step, the epilogue), captured once a
run, then ONE readback of that vector; the host uploads only the era's
head words and sample threshold. The first era follows the seeding on
the same stream with no readback in between, as the JAX `seed_run` fuses
them. The host then drains the sample, tightens the threshold, harvests
each newly hit property's fingerprint path from its walk's path row, and
stops on the finish policy, the target or the timeout.

The walks' choices come from the integer hash `ops.walk.prng`, which is
the JAX loop's own, so every era ends where the JAX engine's does and the
results — counts, discovery paths, coverage, the sample — are the JAX
engine's, bit for bit (below 2^32 generated states: the JAX era counts
wrap there, these do not).

On `device="cpu"` the same segments run eagerly with every kernel's
plain torch version, and the host reads the gate after each step.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..checker import CheckerBuilder
from ..fingerprint import combine64, hash_lanes
from ..obs.sample import slab_high_water
from ..ops import walk as wk
from ..ops.expand import build_walk_step
from ..ops import walk_era as we
from ..path import Path
from ..tensor import TensorModel, TensorModelAdapter
from ..xp import TorchXP
from . import graph as gr
from . import stages
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
    params: np.ndarray  # the JAX era's params_out, word for word


class SimProgram:
    """The walks of one model at fixed widths (B walks, paths of L) on one
    device: its workspace (walk, path, the era's state vector, the
    first-hit lanes, the sample slab), `seed` makes the walk state, `era`
    runs one era behind the device gate. The counterpart of
    `_build_sim_loop`'s `seed_run` and `loop`. On the card an era is one
    graph launch (captured once, by `seed`) and one readback."""

    def __init__(self, tm: TensorModel, props, B: int, L: int, cov: bool,
                 sample_k: int, device):
        self.tm, self.props = tm, props
        self.B, self.L, self.cov = B, L, cov
        self.device = dev = torch.device(device)
        self.xp = TorchXP(dev)
        self.model_step = build_walk_step(tm, props, self.xp)
        S, A, P = tm.state_width, tm.max_actions, len(props)
        inits = np.asarray(tm.init_states_array(), dtype=np.uint32)
        # Boundary-filtered init states (tpu_simulation.py:111-119).
        inb = np.asarray(
            tm.within_boundary_lanes(np, tuple(inits[:, s] for s in range(S))), dtype=bool
        )
        inits = inits[inb]
        self.n_init = len(inits)
        self.inits = torch.from_numpy(inits.T.astype(np.int64)).to(dev).contiguous()
        self.ev_mask, self.al_mask = wk.prop_masks(props)
        self.init_ebits = (1 << bin(self.ev_mask).count("1")) - 1
        self.sample_k = sample_k
        self.s_high = slab_high_water(sample_k) if sample_k else 0
        self.cfg = c = we.WalkEraConfig(S, A, P, B, cov, sample_k, self.s_high)
        self.sk2 = c.sk2
        self.state = torch.zeros(c.length, dtype=torch.int64, device=dev)
        self.stats = self.state[c.x:c.x + we.X_FROZEN + 1]
        self.cov_words = self.dhist = self.thresh = self.slab = None
        if cov:
            self.cov_words = self.state[c.cov_base:c.cov_base + c.n_cov]
            self.dhist = self.cov_words[A + P:]
        if sample_k:
            self.thresh = self.state[c.s_base:c.s_base + 2]
            # One more step always fits (tpu_simulation.py:102).
            self.slab = wk.empty_walk_slab(S, self.s_high + B, dev)
            rows = c.s_base + 4
            self._sample_rows = self.state[rows:rows + (3 + S) * self.sk2].view(3 + S, self.sk2)
            self._sample_ok = self.state[rows + (3 + S) * self.sk2:rows + (4 + S) * self.sk2]
        self.hseen = torch.zeros((P, B), dtype=torch.bool, device=dev)
        self.plen = torch.zeros((P, B), dtype=torch.int64, device=dev)
        self.walk = torch.zeros((S + 4, B), dtype=torch.int64, device=dev)
        self.path = torch.zeros((B, L), dtype=torch.int64, device=dev)
        self.era_in = torch.zeros(we.IN_LEN, dtype=torch.int64, device=dev)
        self.master = 0
        self._on_card = dev.type == "cuda"
        self._graph: Optional[gr.Graph] = None
        self.graph_captures = 0
        self.capture_secs = 0.0
        self.readbacks = 0
        if self._on_card:
            self._in_host = torch.zeros(we.IN_LEN, dtype=torch.int64).pin_memory()
            self._readback = gr.Readback(self.state)

    def seed(self, master: int):
        """Seed the walk lanes as `seed_run` does (tpu_simulation.py:536);
        returns the program's (walk, path). Nothing is read back: on the
        card the first era's graph launch follows on the same stream (the
        graph is captured first, on the unseeded workspace, whose warm-up
        run the seed then overwrites)."""
        self.capture()
        self.master = master & U32_MAX
        self.walk.copy_(wk.seed_walks(master, self.B, self.inits, self.init_ebits))
        return self.walk, self.path

    # -- the segments (each a child graph on the card) -----------------------

    def _prologue(self, handle: int = 0) -> None:
        """K13b's prologue (restart the walks that arrived frozen), then
        K13f BEGIN: the era's inputs, zeroed counts, the gate."""
        wk.restart_frozen(self.walk, self.inits, self.init_ebits)
        we.walk_era(we.BEGIN, self.cfg, self.state, self.era_in, self.hseen, self.plen, handle)

    def _step(self, handle: int = 0) -> None:
        walk, path = self.walk, self.path
        rows = walk[:self.tm.state_width]
        h1, h2 = hash_lanes(rows)
        counted, cycle = wk.record(h1, h2, walk, path, self.stats, self.dhist)
        if self.sample_k:
            wk.capture(self.slab, self.stats, counted, h1, h2, walk, self.thresh)
        # K11's WALK (or its plain version): a fresh copy of the successor
        # lanes, taken before K13b rewrites the walk lanes.
        checks, valid, succ = self.model_step(rows)
        wk.step(walk, counted, cycle, checks, self.ev_mask, self.al_mask, valid, succ,
                self.inits, self.init_ebits, self.L, self.hseen, self.plen, self.stats,
                self.cov_words)
        we.walk_era(we.COMMIT, self.cfg, self.state, handle=handle)

    def _epilogue(self) -> None:
        """K13f EPILOGUE, then K13d's bottom-k of the slab into the sample
        tail."""
        we.walk_era(we.EPILOGUE, self.cfg, self.state, hseen=self.hseen, plen=self.plen)
        if self.sample_k:
            lanes, ok = wk.slab_bottom_k(self.slab, self.stats, self.sk2)
            self._sample_rows.copy_(lanes)
            self._sample_ok.copy_(ok)

    def capture(self) -> None:
        """On the card, once: capture the prologue, the step (+ COMMIT)
        and the epilogue into one graph, the step inside a WHILE node on
        the gate. The warm-up run before the capture (every lazy
        initialisation happens there) overwrites the walks, so it runs
        before they are seeded. A failure raises; nothing falls back."""
        if not self._on_card or self._graph is not None:
            return
        self.era_in.zero_()
        self._prologue()
        self._step()
        self._epilogue()

        def describe(g: gr.Graph) -> None:
            h = g.handle(g.root)
            pro = g.child(g.root, None, g.capture("prologue", lambda: self._prologue(h.value)))
            loop, body = g.loop(g.root, pro, h)
            g.child(body, None, g.capture("step", lambda: self._step(h.value)))
            g.child(g.root, loop, g.capture("epilogue", self._epilogue))

        self._graph = gr.build(self.device, describe)
        self.graph_captures += 1
        self.capture_secs += self._graph.secs

    # -- an era --------------------------------------------------------------

    def _launch(self, inputs) -> np.ndarray:
        """Run one era from `inputs` (the era_in words); the state vector
        after it."""
        self.readbacks += 1
        if not self._on_card:
            self.era_in.copy_(torch.tensor(inputs, dtype=torch.int64))
            x = self.cfg.x
            self._prologue()
            while int(self.state[x + we.X_OPEN]):
                self._step()
            self._epilogue()
            return self.state.numpy().copy()
        if self._graph is None:
            raise RuntimeError("the simulation graph is captured by seed(), before the first era")
        main = torch.cuda.current_stream(self.device)
        self._readback.before_launch(main)
        self._in_host.copy_(torch.tensor(inputs, dtype=torch.int64))
        self.era_in.copy_(self._in_host, non_blocking=True)
        self._graph.launch(main)
        vals = self._readback.wait(self._readback.after_launch(main))
        # The host buffer is free again once the readback is in: the
        # upload ran before the graph.
        self._graph.count(dict(prologue=1, step=int(vals[self.cfg.x + we.X_RUN]), epilogue=1))
        return vals

    def era(self, walk, path, *, rec_bits: int, max_steps: int, fin_any: int,
            fin_all: int, fin_all_en: int, target_gen: int, gen0: int,
            threshold=(U32_MAX, U32_MAX)) -> EraResult:
        """One era (tpu_simulation.py:149 `loop`): the prologue, steps while
        the gate holds, the epilogue. Updates walk and path (the program's
        own, from `seed`) in place."""
        if walk is not self.walk or path is not self.path:
            raise ValueError("era runs on the program's own walk and path (from seed)")
        c = self.cfg
        S, A, P = self.tm.state_width, self.tm.max_actions, len(self.props)
        vals = self._launch([
            rec_bits, max_steps, fin_any, fin_all, fin_all_en, target_gen, gen0, 0, 0, 0,
            self.master, threshold[0], threshold[1],
        ])
        x = c.x
        coverage = sample = sample_ok = None
        if self.cov:
            coverage = vals[c.cov_base:c.cov_base + c.n_cov]
        if self.sample_k:
            rows = c.s_base + 4
            n = (3 + S) * self.sk2
            sample = vals[rows:rows + n].reshape(3 + S, self.sk2)
            sample_ok = vals[rows + n:rows + n + self.sk2].astype(bool)
        return EraResult(
            int(vals[we.P_REC]), int(vals[x + we.X_GEN]), int(vals[x + we.X_STEPS]),
            int(vals[x + we.X_RUN]), int(vals[x + we.X_MAXD]),
            [int(v) for v in vals[we.P_LEN:we.P_LEN + P]],
            [int(v) for v in vals[we.P_LEN + P:we.P_LEN + 2 * P]],
            coverage, int(vals[x + we.X_OCC]), sample, sample_ok, vals[:c.plen],
        )


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
        self.device = resolve_device(device)
        super().__init__(builder, model=model, device=self.device)
        if self._symmetry is not None:
            raise ValueError(
                "the device simulation engine does not support symmetry reduction"
            )
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
        self._gauge("expand_route", self._prog.model_step.route)
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
            era_t0 = time.monotonic()
            out = prog.era(
                walk, path, rec_bits=rec_bits, max_steps=max_sync, fin_any=fin_any,
                fin_all=fin_all, fin_all_en=fin_all_en, target_gen=target_gen,
                gen0=gen_total, threshold=threshold,
            )
            # The era's time: its upload, graph launch and readback
            # (tpu_simulation.py:885).
            self._metrics.add_phase("device_era", time.monotonic() - era_t0)
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
        self._gauge("graph_captures", prog.graph_captures)
        self._gauge("capture_secs", prog.capture_secs)
        self._gauge("readbacks", prog.readbacks)

        def stage_programs():
            progs = stages.sim_stages(self.tm, self._tprops, self._B, L, self._stage_iters,
                                      self.device)
            return progs, (path,)

        # The steps the card ran (steps counts an era's no-op steps too,
        # which the port skips once every walk is frozen).
        self._profile_stages(stage_programs, self._counters.get("steps_run", 0))

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
        self._inc("path_readbacks")
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
