"""The BFS era program (K8f, K10f): the port's counterpart of
`stateright_tpu/engines/tpu_bfs.py:247 _build_loop` and its `EraProgram`
(:78), and of the fused seed and first era (:1042 `_build_seed_loop`).

An `EraProgram` owns one run's workspace on its device, every tensor of
which the step updates in place: the visited table, the ring, the sample
slab, the era's first-hit lanes (hseen, facc1, facc2, faccd) and one int64
state vector — the JAX era program's packed params, word for word
(ops/era.py), then the port's own per-step words. A dispatch runs eras
until the device-side gate and the fused loop's continuation stop it:

    START                              (step kernel: zero the dispatch's outputs)
    while another inner era runs:      (at most fuse_lim, tpu_bfs.py:884-937)
        BEGIN                          (step kernel: open the era, the gate)
        while the gate is open:        (`cond`, tpu_bfs.py:403)
            one BFS step               (`body`, tpu_bfs.py:428: K7, K1, K11,
                                        K2, K1, K3, K2, K4, K9a, K7)
            COMMIT                     (step kernel: the first-hit and coverage
                                        updates, the commit, then the gate)
        epilogue                       (epilogue kernel: discoveries, max depth,
                                        the next budget, the fusion lanes)
    tail                               (K9b: the slab's bottom-k into the params)

and the host reads back the state vector once.

On the card a dispatch is ONE graph launch. Each segment above (START,
BEGIN, the step with its COMMIT, the epilogue, the tail) is captured
once with `torch.cuda.graph`, and a graph built in C (engines/graph.py,
the plumbing every device program shares) holds them as child graphs
inside two conditional WHILE nodes: the step kernel's gate sets the
inner loop's condition and the epilogue sets the outer (fusion) loop's,
so the loops run on the card like `lax.while_loop`, with no host round
trip and no no-op step. A table growth replaces the table, so the
program is captured again; a capture that fails raises. The readback is
an asynchronous copy to pinned memory on a side stream, and the next
dispatch waits only for that copy.

On the CPU (`device="cpu"`, the tests) the same segments run eagerly
with the plain versions of every kernel, and the host reads the gate
after each step.

`state_from_jax` and `state_to_jax` turn the JAX era program's operands
(table lanes, queue lanes, rec_fp1, rec_fp2, params; numpy) into the
workspace and back: the era-parity tests feed both programs with them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..fingerprint import hash_lanes
from ..obs.sample import DEVICE_STEP_CAP, slab_capacity, slab_entries, slab_high_water
from ..ops import era as eo
from ..ops import frontier as fr
from ..ops import slab as sl
from ..ops import visited_set as vs
from ..ops.canon import build_canon
from ..ops.expand import build_expand_lean
from ..xp import TorchXP
from . import graph as gr


def widths(A: int, chunk: int):
    """(vcap, rcap, dedup_cap) of the step: the compacted candidate width
    (tpu_bfs.py:162 `_vcap`, divisor 3), the distinct-candidate width and
    the dedup scratch (tpu_bfs.py:353-357)."""
    vcap = min(chunk * A, max(128 * A, (chunk * A) // 3))
    rcap = max(128 * A, (2 * vcap) // 5)
    dedup_cap = 1 << max(1, (4 * vcap - 1).bit_length())
    return vcap, rcap, dedup_cap


def seed(table: vs.VisitedTable, ring: torch.Tensor, init_rows: torch.Tensor, init_ebits: int):
    """K10 (tpu_bfs.py:1080 _build_seed): K1 + K4 over the init rows
    [S, n] into an empty table, and every row enqueued at depth 1 at ring
    slot 0 on (the table keeps one per fingerprint). Returns the new and
    unresolved counts as 0-d tensors on the device: nothing is read
    back."""
    S, n = init_rows.shape
    dev = init_rows.device
    h1, h2 = hash_lanes(init_rows)
    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    is_new, unres = vs.insert(table, h1, h2, zero, zero, torch.ones(n, dtype=torch.bool, device=dev))
    ring[:S, :n] = init_rows
    ring[S, :n] = init_ebits
    ring[S + 1, :n] = 1
    return is_new.sum(dtype=torch.int64), unres.sum(dtype=torch.int64)


class EraProgram:
    """One run's era program and workspace (see the module doc)."""

    def __init__(self, tm, props, chunk: int, qcap: int, tcap: int, canon: bool,
                 cov: bool, sample_k: int, fuse: int, device, in_flight: int = 1,
                 table: Optional[vs.VisitedTable] = None):
        self.tm, self.props = tm, list(props)
        self.device = dev = torch.device(device)
        S, A, P, C = tm.state_width, tm.max_actions, len(self.props), chunk
        self.S, self.A, self.P, self.C = S, A, P, C
        self.qcap, self.canon, self.cov = qcap, canon, cov
        self.fuse = max(1, int(fuse))
        self.sample_k = sample_k
        self.vcap, self.rcap, self.dedup_cap = widths(A, C)
        self.plen = eo.params_len(A, P, cov, sample_k, self.fuse)
        ncov = eo.cov_len(A, P) if cov else 0
        self.cov_base = eo.P_LEN + 2 * P if cov else -1
        self.s_base = eo.P_LEN + 2 * P + ncov if sample_k else -1
        self.sk2 = slab_entries(sample_k) if sample_k else 0
        self.f_base = eo.params_len(A, P, cov, sample_k) if self.fuse > 1 else -1
        scap = slab_capacity(sample_k, DEVICE_STEP_CAP) if sample_k else 0
        self.cfg = eo.EraConfig(
            chunk=C, qmask=qcap - 1, vcap=self.vcap, rcap=self.rcap, P=P, A=A,
            cov_base=self.cov_base, s_base=self.s_base,
            s_high=slab_high_water(sample_k) if sample_k else 0,
            s_take=max(1, DEVICE_STEP_CAP // max(1, A)), f_base=self.f_base,
            fuse=self.fuse, x=self.plen, regrow=max(1, C // 16),
            budget_min=eo.BUDGET_MIN, n_cov=ncov, scap=scap,
        )
        self.state = torch.zeros(self.plen + eo.X_LEN, dtype=torch.int64, device=dev)
        self.ring = fr.empty_ring(S + 2, qcap, dev)
        # `table`: a table to run on from the start (a resumed run's).
        self.table = vs.empty_table(tcap, dev) if table is None else table
        self.epoch = torch.full((1,), self.table.epoch + 1, dtype=torch.int64, device=dev)
        self.slab = sl.empty_slab(scap, dev) if sample_k else None
        self.first = eo.FirstHits.zeros(P, C, dev)
        # The kernels' scratch words (tickets, accumulators), each left as
        # it was found by every launch, so the era graph replays as it is.
        self.step_scratch = eo.step_scratch(1, P, A, dev)
        self.epilogue_scratch = eo.epilogue_scratch(1, P, C, dev)
        self.capture_scratch = sl.capture_scratch(1, self.rcap, dev) if sample_k else None
        self.dedup_scratch = fr.dedup_scratch(1, self.dedup_cap, dev) if dev.type == "cuda" else None
        self.xp = TorchXP(dev)
        self.expand = build_expand_lean(tm, self.props, C, self.xp)
        # K11c under symmetry (`canon_fn.route`), else None.
        self.canon_fn = build_canon(tm, self.xp) if canon else None
        self.arange_c = torch.arange(C, device=dev)
        x = self.plen
        self._head = self.state[eo.P_HEAD:eo.P_HEAD + 1]
        self._depth_limit = self.state[eo.P_DEPTH_LIMIT]
        self._take = self.state[x + eo.X_TAKE]
        self._append_at = self.state[x + eo.X_TAIL:x + eo.X_TAIL + 1]
        self._thresh = self.state[self.s_base:self.s_base + 2] if sample_k else None
        self._ring_depth = self.ring[S + 1]
        self._graph: Optional[gr.Graph] = None
        self.graph_captures = 0
        self.capture_secs = 0.0
        self._on_card = dev.type == "cuda"
        if self._on_card:
            # One pinned readback buffer per dispatch that can be in
            # flight at once (`in_flight`: the chain's depth + 1).
            self._readback = gr.Readback(self.state, in_flight + 1)

    # -- the workspace -------------------------------------------------------

    def set_table(self, table: vs.VisitedTable) -> None:
        """Run on `table` from the next dispatch on (its graph is captured
        again): the visited insert's epoch on the card starts above every
        host-side call's on it."""
        self.table = table
        self.epoch.fill_(table.epoch + 1)
        self.free_graph()

    def grow(self) -> int:
        """Double the table and rehash into it on the device (K5 = K4 over
        the occupied rows); returns the new capacity."""
        new = vs.empty_table(self.table.capacity * 2, self.device)
        if vs.rehash(self.table, new):
            raise RuntimeError("rehash failed; table pathologically full")
        self.set_table(new)
        return new.capacity

    def upload(self, vals: np.ndarray) -> None:
        """Overwrite the whole state vector (params and the port's words)."""
        self.state.copy_(torch.from_numpy(np.ascontiguousarray(vals, dtype=np.int64)))

    def seed(self, init_rows: torch.Tensor, init_ebits: int, template: np.ndarray) -> None:
        """K10f: upload `template` (the first era's params), seed the table
        and the ring with the init rows (K10), and write head 0, count n,
        the new count and the unresolved count into the params on the
        device, so that the first dispatch follows with no readback (an
        unresolved init shows as an error word with zero steps)."""
        self.upload(template)
        new, unres = seed(self.table, self.ring, init_rows, init_ebits)
        self.state[eo.P_HEAD] = 0
        self.state[eo.P_COUNT] = init_rows.shape[1]
        self.state[eo.P_UNIQUE].copy_(new)
        self.state[eo.P_ERR].copy_(unres)
        self.epoch.fill_(self.table.epoch + 1)

    # -- the segments (each a child graph on the card) -----------------------

    def _start(self, handle: int = 0) -> None:
        eo.era_step(eo.START, self.cfg, self.state, slab=self.slab, handle=handle)

    def _begin(self, handle: int = 0) -> None:
        eo.era_step(eo.BEGIN, self.cfg, self.state, slab=self.slab, handle=handle)

    def _step(self, handle: int = 0) -> None:
        """One BFS step (tpu_bfs.py:428 body) at the take the gate set, then
        its commit; every scalar it reads or writes stays on the device."""
        S, A, P, C = self.S, self.A, self.P, self.C
        active = self.arange_c < self._take
        popped = fr.ring_pop(self.ring, self._head, C)
        rows, ebits, depth = popped[:S], popped[S], popped[S + 1]
        row_h1, row_h2 = hash_lanes(rows)
        ex = self.expand(rows, ebits, depth, active, self._depth_limit)
        vids, vvalid, n_val = vs.compact_ids(ex.valid, self.vcap)
        cl = ex.flat.index_select(1, vids)
        if self.canon:
            # Canonicalize at the compacted width, before hashing
            # (tpu_bfs.py:478-482).
            cl = self.canon_fn(cl)
        ch1, ch2 = hash_lanes(cl)
        reps = fr.claim_dedup(ch1, ch2, vvalid, self.dedup_cap, n_val, self.dedup_scratch)
        dids, dvalid, n_d = vs.compact_ids(reps, self.rcap)
        dflat = vids.index_select(0, dids)
        src = dflat % C  # candidate a*C + c has parent row c
        dp1 = torch.where(dvalid, row_h1.index_select(0, src), 0)
        dp2 = torch.where(dvalid, row_h2.index_select(0, src), 0)
        ddepth = depth.index_select(0, src) + 1
        dh1 = ch1.index_select(0, dids)
        dh2 = ch2.index_select(0, dids)
        c_new, unresolved = vs.insert(
            self.table, dh1, dh2, dp1, dp2, dvalid, epoch=self.epoch if self._on_card else None
        )
        if self.slab is not None:
            sl.capture(self.slab, c_new, dh1, dh2, ddepth, dflat // C, self._thresh, DEVICE_STEP_CAP,
                       self.capture_scratch)
        # The inserted prefix is enqueued even on an overflow step: inserts
        # are idempotent and enqueue == inserted keeps every state exactly
        # once in the ring.
        fr.ring_scatter(
            self.ring, self._append_at,
            torch.cat([cl.index_select(1, dids), ex.ebits.index_select(0, src)[None], ddepth[None]]),
            c_new,
        )
        # COMMIT folds the first hits, the coverage counts and the depth
        # histogram in (ops/era.py StepOperands).
        step = eo.StepOperands(
            n_val, n_d, unresolved, c_new, ex.generated, ex.prop_hits if P else None,
            ex.valid if self.cov else None, ddepth if self.cov else None,
            (row_h1, row_h2, depth) if P else None, self.first if P else None,
        )
        eo.era_step(eo.COMMIT, self.cfg, self.state, step, self.slab, self.epoch, handle,
                    self.step_scratch)

    def _epilogue(self, handle: int = 0) -> None:
        eo.era_epilogue(
            self.cfg, self.state, *self.first, self._ring_depth,
            None if self.slab is None else self.slab.counts, handle, self.epilogue_scratch,
        )

    def _tail(self) -> None:
        """The sample tail (tpu_bfs.py:983-995): occupancy, drops and the
        slab's sk2 smallest rows by fp1 (K9b) into the params."""
        b, k = self.s_base, self.sk2
        fp1, fp2, depth, action, valid = sl.bottom_k(self.slab, k)
        self.state[b + 2:b + 4].copy_(self.slab.counts)
        self.state[b + 4:b + 4 + 5 * k].view(5, k).copy_(
            torch.stack([fp1, fp2, depth, action, valid.to(torch.int64)])
        )

    # -- dispatch ------------------------------------------------------------

    def run_eager(self) -> None:
        """One dispatch, segment by segment, reading the gate and the
        fused loop's continuation from the state vector (the CPU path)."""
        x = self.plen
        self._start()
        while True:
            self._begin()
            while int(self.state[x + eo.X_OPEN]):
                self._step()
            self._epilogue()
            if not int(self.state[x + eo.X_MORE]):
                break
        if self.slab is not None:
            self._tail()

    def launch(self):
        """Start one dispatch: on the card one graph launch and the
        readback's copy queued behind it; on the CPU the dispatch itself.
        Returns a handle for `result`."""
        if not self._on_card:
            self.run_eager()
            return self.state.numpy().copy()
        if self._graph is None:
            self._capture()
        main = torch.cuda.current_stream(self.device)
        self._readback.before_launch(main)
        self._graph.launch(main)
        return self._readback.after_launch(main), self._graph

    def result(self, handle) -> np.ndarray:
        """Wait for a dispatch's readback: the state vector after it. On
        the card this also counts the launches its graph made."""
        if not self._on_card:
            return handle
        read, g = handle
        vals = self._readback.wait(read)
        x = self.plen
        gr.count_era(g, int(vals[x + eo.X_ITER]), int(vals[x + eo.X_K]))
        return vals

    def ran(self, vals: np.ndarray) -> bool:
        """Whether the dispatch that left `vals` ran a step body."""
        return vals[self.plen + eo.X_ITER] != 0

    # -- the graph -----------------------------------------------------------

    def _capture(self) -> None:
        """Capture the five segments and build the era graph (see the
        module doc). A failure raises; nothing falls back."""
        # Run the step once with the gate closed: it changes nothing, and
        # every lazy initialisation happens before the capture.
        x = self.plen
        self.state[x + eo.X_OPEN] = 0
        self.state[x + eo.X_TAKE] = 0
        self._step()
        self._graph = gr.build_era(self.device, self._start, self._begin, self._step, self._epilogue,
                                   self._tail if self.slab is not None else None)
        self.graph_captures += 1
        self.capture_secs += self._graph.secs

    def free_graph(self) -> None:
        """Drop the captured graph (the next dispatch captures anew)."""
        if self._graph is not None:
            self._readback.drain()
            self._graph.free()
            self._graph = None


def state_from_jax(prog: EraProgram, table_lanes, queue_lanes, rec_fp1, rec_fp2, params) -> None:
    """Load the JAX era program's operands (numpy): the table's four flat
    lanes (k1, k2, v1, v2), the queue's S + 2 lanes [qcap], the recorded
    discovery fingerprints [P] and the packed params, into `prog`'s
    workspace. The params' rec_fp tail takes rec_fp1 and rec_fp2, the JAX
    program's separate operands."""
    dev = prog.device
    table = vs.table_from_lanes(*table_lanes, device=dev)
    table.epoch = 1
    prog.set_table(table)
    q = np.stack([np.asarray(lane, dtype=np.uint32) for lane in queue_lanes]).astype(np.int64)
    prog.ring.zero_()
    prog.ring[:, :prog.qcap] = torch.from_numpy(q).to(dev)
    vals = np.zeros(prog.plen + eo.X_LEN, dtype=np.int64)
    vals[:prog.plen] = np.asarray(params, dtype=np.uint32)
    P = prog.P
    vals[eo.P_LEN:eo.P_LEN + P] = np.asarray(rec_fp1, dtype=np.uint32)
    vals[eo.P_LEN + P:eo.P_LEN + 2 * P] = np.asarray(rec_fp2, dtype=np.uint32)
    prog.upload(vals)


def state_to_jax(prog: EraProgram) -> Tuple:
    """The workspace as the JAX era program's outputs (numpy uint32): the
    table lanes, the queue lanes, rec_fp1, rec_fp2 and the params."""
    vals = prog.state.cpu().numpy()[:prog.plen].astype(np.uint32)
    P = prog.P
    ring = prog.ring[:, :prog.qcap].cpu().numpy().astype(np.uint32)
    return (
        vs.table_to_lanes(prog.table),
        tuple(ring),
        vals[eo.P_LEN:eo.P_LEN + P].copy(),
        vals[eo.P_LEN + P:eo.P_LEN + 2 * P].copy(),
        vals,
    )
