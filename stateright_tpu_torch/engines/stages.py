"""The stage programs of `.stage_profile()` (K12): the port's counterpart of
`stateright_tpu/engines/tpu_bfs.py:1138 _build_stage_kernels`,
`stateright_tpu/engines/tpu_simulation.py:569 _build_sim_stage_kernels` and
the null loop of `stateright_tpu/obs/stageprof.py:60`.

A stage program repeats one stage of one step `iters` times at the
run's widths, each round chained to the last through a uint32
accumulator, and returns the accumulator: the JAX kernel's value, bit
for bit, for the same state and seed (tests/test_torch_stage_profile.py).
Its round is a segment of the era's own kernels at the era's widths —
BFS: chunk C, vcap, rcap and the dedup scratch (engines/era.py `widths`);
simulation: B walks, paths of L — fed with synthetic lanes made by K12a
(ops/stage.py), then K12a's FOLD, which adds the round's anchor terms to
the accumulator and decides whether another round runs.

On the card a program is one CUDA graph (engines/graph.py): K12a's
START, then a conditional WHILE node around the captured round, and,
for the probe stage, the term added after the loop. One launch and one
readback of the accumulator are one timed dispatch (obs/stageprof.py).
The null program is FOLD alone under the same WHILE node: the dispatch
floor, which the stages' times are taken from. On the CPU a program runs
the plain versions of its kernels in a Python loop of `iters` rounds.

BFS stages: expand (K11 on the run's first C ring rows), hash (K1 at C
and at vcap), probe (K4 into a fork of the run's table), claim (K3),
compact (K2 twice and the gathers of the era's step), ring (K7's pop and
append on a fork of the run's ring), canon (K11c on its route,
`ops/canon.py`, under symmetry). Simulation stages: hash (K1),
cycle, record and choose (K12b), expand (the model's `step_lanes`,
boundary and properties). The forks are taken afresh before every
dispatch, outside its timed window, as each JAX dispatch starts from the
run's unmodified table and ring.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

import torch

from ..fingerprint import hash_lanes, mul32
from ..ops import frontier as fr
from ..ops import stage as sg
from ..ops import visited_set as vs
from ..ops.canon import build_canon
from ..ops.expand import build_expand_lean, build_walk_step
from ..xp import TorchXP
from . import graph as gr
from .era import widths

M32 = 0xFFFFFFFF
NULL = "null"


class StageProgram:
    """One stage (or the null loop): `round_fn(handle)` runs one round and
    ends with K12a's FOLD on `st`; `after_fn` (optional) runs once after
    the loop; `reset_fn(seed)` (optional) re-forks the stage's state
    before a dispatch."""

    def __init__(self, name: str, device, iters: int, round_fn: Callable[[int], None],
                 after_fn: Optional[Callable[[], None]] = None,
                 reset_fn: Optional[Callable[[int], None]] = None, eager: bool = False):
        self.name = name
        self.device = torch.device(device)
        self.iters = iters
        self.st = sg.new_state(self.device)
        self._round, self._after, self._reset = round_fn, after_fn, reset_fn
        # `eager`: the host runs the rounds, also on the card (a round
        # with a collective across ranks cannot be captured).
        self._on_card = self.device.type == "cuda" and not eager
        self._graph: Optional[gr.Graph] = None
        if self._on_card:
            self._acc = torch.zeros(1, dtype=torch.int64).pin_memory()

    def prepare(self, seed: int) -> None:
        """Before a dispatch, outside its timed window: on the card, the
        first time, capture the graph; then re-fork the stage's state and
        set the accumulator to `seed`."""
        if self._on_card and self._graph is None:
            self._capture()
        if self._reset is not None:
            self._reset(seed)
        self.st.zero_()
        self.st[sg.ST_ACC] = seed & M32

    def _start(self, handle: int = 0) -> None:
        sg.start(self.st, self.iters, handle)

    def _capture(self) -> None:
        # One eager round first: every lazy initialisation happens before
        # the capture, and what it moves is re-forked before the dispatch.
        self._round(0)
        if self._after is not None:
            self._after()

        def describe(g: gr.Graph) -> None:
            h = g.handle(g.root)
            start = g.child(g.root, None, g.capture("start", lambda: self._start(h.value)))
            loop, body = g.loop(g.root, start, h)
            g.child(body, None, g.capture("round", lambda: self._round(h.value)))
            if self._after is not None:
                g.child(g.root, loop, g.capture("after", self._after))

        self._graph = gr.build(self.device, describe)

    def launch(self) -> None:
        """One dispatch: on the card one graph launch (captured at the
        first) and the accumulator's copy queued behind it on the same
        stream; on the CPU the rounds themselves."""
        if not self._on_card:
            self._start()
            while int(self.st[sg.ST_OPEN]):
                self._round(0)
            if self._after is not None:
                self._after()
            return
        main = torch.cuda.current_stream(self.device)
        self._graph.launch(main)
        self._acc.copy_(self.st[:1], non_blocking=True)

    def read(self) -> int:
        """The accumulator after the last launch (waits for it)."""
        if not self._on_card:
            return int(self.st[sg.ST_ACC])
        torch.cuda.current_stream(self.device).synchronize()
        self._graph.count(dict(start=1, round=self.iters, after=1))
        return int(self._acc[0])

    def run(self, seed: int) -> int:
        """prepare, launch, read: the JAX kernel's `fn(..., seed)`."""
        self.prepare(seed)
        self.launch()
        return self.read()

    def free(self) -> None:
        if self._graph is not None:
            torch.cuda.synchronize(self.device)
            self._graph.free()
            self._graph = None


class _Programs:
    """A set of stage programs and the null program on one device."""

    def __init__(self, device, iters: int, eager: bool = False):
        self.device = torch.device(device)
        self.iters = iters
        self.eager = eager
        self.xp = TorchXP(self.device)
        self._card = self.device.type == "cuda"
        self.stages: Dict[str, StageProgram] = {}
        self.null = self._program(NULL, self._null_round)
        # Held by a run while it loads, times and releases the programs.
        self.lock = threading.Lock()
        # The stages that fork a run's state: `release` drops their graphs
        # (which hold the forks' pointers) with the forks.
        self._forking = ()

    def _program(self, name, round_fn, after_fn=None, reset_fn=None) -> StageProgram:
        return StageProgram(name, self.device, self.iters, round_fn, after_fn, reset_fn, self.eager)

    def _add(self, name, round_fn, after_fn=None, reset_fn=None) -> None:
        self.stages[name] = self._program(name, round_fn, after_fn, reset_fn)

    def _null_round(self, handle: int) -> None:
        # The JAX null loop adds 1 a round.
        sg.fold(self.null.st, [], self.iters, add=1, handle=handle)

    def _zeros(self, *shape, dtype=torch.int64) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _lane(self, *shape, salt: int, step: int = 1, mask: int = M32, mod: int = 0) -> torch.Tensor:
        out = self._zeros(*shape)
        sg.mix_lanes(out, salt, step, mask, mod)
        return out

    def programs(self):
        return dict(self.stages), self.null

    def release(self) -> None:
        """Drop the run's state and the forks, with the graphs that hold
        their pointers: a cached set of programs keeps no run's memory."""
        for name in self._forking:
            self.stages[name].free()
        self._drop_forks()

    def free(self) -> None:
        for p in list(self.stages.values()) + [self.null]:
            p.free()


class BfsStages(_Programs):
    """The BFS stage programs at one run's widths (chunk C, ring qcap)."""

    def __init__(self, tm, props, chunk: int, qcap: int, canon: bool, iters: int, device):
        super().__init__(device, iters)
        self.tm, self.props, self.canon = tm, list(props), canon
        self.canon_route = None  # K11c's route under symmetry
        S, A, C = tm.state_width, tm.max_actions, chunk
        W = S + 2
        self.S, self.A, self.C, self.W, self.qcap = S, A, C, W, qcap
        vcap, rcap, dedup_cap = widths(A, C)
        self.vcap, self.rcap, self.dedup_cap = vcap, rcap, dedup_cap
        expand = build_expand_lean(tm, list(props), C, self.xp)
        z = self._zeros

        # The run's first C ring rows (loaded by `load`) and each stage's
        # buffers: every round rewrites them in place.
        self.rows0, self.ebits0, self.depth0 = z(S, C), z(C), z(C)
        self.active = torch.ones(C, dtype=torch.bool, device=self.device)

        ex_rows = z(S, C)

        def expand_round(h):
            st = self.stages["expand"].st
            sg.xor_lanes(ex_rows, self.rows0, st)
            ex = expand(ex_rows, self.ebits0, self.depth0, self.active, M32)
            sg.fold(st, [sg.term(ex.generated)], iters, handle=h)

        self._add("expand", expand_round)

        h_rows, cl0, cl = z(S, C), self._lane(S, vcap, salt=11), z(S, vcap)

        def hash_round(h):
            st = self.stages["hash"].st
            sg.xor_lanes(h_rows, self.rows0, st)
            h1, h2 = hash_lanes(h_rows)
            sg.xor_lanes(cl, cl0, st)
            g1, g2 = hash_lanes(cl)
            sg.fold(st, [sg.term(x[:1]) for x in (h1, h2, g1, g2)], iters, handle=h)

        self._add("hash", hash_round)

        # probe: two key pools into a fork of the run's table, the fork's
        # own insert epoch on the card (FOLD raises it a round).
        pools = self._lane(2, rcap, salt=21)
        sg.mix_lanes(pools[1], 0x6C62272E, src=pools[0])
        keys = z(2, rcap)
        ones_r = torch.ones(rcap, dtype=torch.bool, device=self.device)
        self.fork: Optional[vs.VisitedTable] = None
        self._run_table: Optional[vs.VisitedTable] = None
        self.epoch = torch.ones(1, dtype=torch.int64, device=self.device)

        def probe_round(h):
            st = self.stages["probe"].st
            sg.xor_lanes(keys, pools, st, xor_rows=2)
            c_new, _unres = vs.insert(self.fork, keys[0], keys[1], keys[0], keys[1], ones_r,
                                      epoch=self.epoch if self._card else None)
            sg.fold(st, [sg.term(c_new)], iters, epoch=self.epoch, handle=h)

        def probe_after():
            # The low bit of k1 (the key's h1 half) in slot 0.
            sg.add(self.stages["probe"].st, [sg.term(self.fork.keys[:1], shift=32, mask=1)])

        def probe_reset(_seed):
            # Keys only: the fork's parents are written, never read, and
            # its stamps stay below its epoch, which only rises.
            self.fork.keys.copy_(self._run_table.keys)

        self._add("probe", probe_round, probe_after, probe_reset)

        claim_keys, claim_h1 = self._lane(2, vcap, salt=31, step=6), z(1, vcap)
        ones_v = torch.ones(vcap, dtype=torch.bool, device=self.device)
        # Every candidate valid: the whole width is the prefix.
        n_all = torch.full((), vcap, dtype=torch.int64, device=self.device)
        claim_scratch = fr.dedup_scratch(1, dedup_cap, self.device) if self._card else None

        def claim_round(h):
            st = self.stages["claim"].st
            sg.xor_lanes(claim_h1, claim_keys[:1], st)
            reps = fr.claim_dedup(claim_h1[0], claim_keys[1], ones_v, dedup_cap, n_all, claim_scratch)
            sg.fold(st, [sg.term(reps)], iters, handle=h)

        self._add("claim", claim_round)

        flat0 = self._lane(S, C * A, salt=41)
        r1, r2, rowl = self._lane(C * A, salt=53), self._lane(vcap, salt=59), self._lane(C, salt=61)
        m1 = torch.zeros(C * A, dtype=torch.bool, device=self.device)
        m2 = torch.zeros(vcap, dtype=torch.bool, device=self.device)

        def compact_round(h):
            st = self.stages["compact"].st
            sg.mask_lanes(m1, r1, st, 3)  # ~25% valid: a protocol's fanout
            vids, _vv, n1 = vs.compact_ids(m1, vcap)
            cl_ = flat0.index_select(1, vids)
            sg.mask_lanes(m2, r2, st, 1)  # ~50% distinct after the dedup
            dids, _dv, n2 = vs.compact_ids(m2, rcap)
            dl = cl_.index_select(1, dids)
            src = vids.index_select(0, dids) % C
            g = rowl.index_select(0, src)
            sg.fold(st, [sg.term(n1), sg.term(n2), sg.term(g), sg.term(dl.view(-1))], iters,
                    handle=h)

        self._add("compact", compact_round)

        # ring: pop [C] and append [rcap] on a fork of the run's ring; the
        # head starts at the seed, as the JAX carry (queue, seed, seed).
        self.ring: Optional[torch.Tensor] = None
        self.head = z(1)
        cand = z(W, rcap)
        self._run_ring: Optional[torch.Tensor] = None

        def ring_round(h):
            st = self.stages["ring"].st
            popped = fr.ring_pop(self.ring, self.head, C)
            sg.ring_lanes(cand, popped, self.head, qcap - 1)
            fr.ring_scatter(self.ring, self.head, cand, ones_r)
            sg.fold(st, [sg.term(cand[0, :1])], iters, handle=h)

        def ring_reset(seed):
            self.ring.copy_(self._run_ring)
            self.head.fill_(seed & M32)

        self._add("ring", ring_round, reset_fn=ring_reset)

        if canon:
            ccl0, ccl = self._lane(S, vcap, salt=71, mask=7), z(S, vcap)
            canon_fn = build_canon(tm, self.xp)  # as the era runs it
            self.canon_route = canon_fn.route

            def canon_round(h):
                st = self.stages["canon"].st
                sg.xor_lanes(ccl, ccl0, st, mask=7)
                reps = canon_fn(ccl)
                sg.fold(st, [sg.term(reps.view(-1))], iters, handle=h)

            self._add("canon", canon_round)
        self._forking = ("probe", "ring")

    def load(self, table: vs.VisitedTable, ring: torch.Tensor) -> None:
        """Take the run's final table and ring [W, qcap + 1] (read, never
        written: the stages fork them)."""
        S, C = self.S, self.C
        if ring.shape != (self.W, self.qcap + 1):
            raise ValueError("the ring does not match the stage programs' widths")
        self.release()
        self.rows0.copy_(ring[:S, :C])
        self.ebits0.copy_(ring[S, :C])
        self.depth0.copy_(ring[S + 1, :C])
        self._run_ring, self._run_table = ring, table
        self.fork = vs.empty_table(table.capacity, self.device)
        self.ring = fr.empty_ring(self.W, self.qcap, self.device)

    def _drop_forks(self) -> None:
        self.fork = self.ring = None
        self._run_table = self._run_ring = None


class SimStages(_Programs):
    """The simulation stage programs at one run's widths (B walks, paths
    of L)."""

    def __init__(self, tm, props, B: int, L: int, iters: int, device):
        super().__init__(device, iters)
        S, A = tm.state_width, tm.max_actions
        self.tm, self.props, self.B, self.L = tm, list(props), B, L
        props = self.props
        z = self._zeros
        xp = self.xp

        rows0, rows = self._lane(S, B, salt=3, mask=7), z(S, B)

        def hash_round(h):
            st = self.stages["hash"].st
            sg.xor_lanes(rows, rows0, st, mask=7)
            h1, h2 = hash_lanes(rows)
            sg.fold(st, [sg.term(h1[:1]), sg.term(h2[:1])], iters, handle=h)

        self._add("hash", hash_round)

        self.path: Optional[torch.Tensor] = None  # the fork of the run's path rows
        self._run_path: Optional[torch.Tensor] = None
        h0c, g0c, ptrc = self._lane(B, salt=13), self._lane(B, salt=17), self._lane(B, salt=19, mod=L)
        in_path = torch.zeros(B, dtype=torch.bool, device=self.device)

        def cycle_round(h):
            st = self.stages["cycle"].st
            sg.cycle(st, self.path, h0c, g0c, ptrc, in_path)
            sg.fold(st, [sg.term(in_path)], iters, handle=h)

        self._add("cycle", cycle_round, reset_fn=self._fork_path)

        h0r = self._lane(B, salt=23)
        restart = torch.zeros(B, dtype=torch.bool, device=self.device)
        sg.mask_lanes(restart, self._lane(B, salt=29), None, 15)  # ~6% restarts a step

        def record_round(h):
            st = self.stages["record"].st
            sg.record(st, self.path, h0r, restart)
            sg.fold(st, [sg.term(self.path.view(-1)[:1], shift=32)], iters, handle=h)

        self._add("record", record_round, reset_fn=self._fork_path)

        erows0, erows = self._lane(S, B, salt=31, mask=7), z(S, B)
        # The walk's model step on the era's route (K11's WALK or its plain
        # version).
        model_step = build_walk_step(tm, props, xp)

        def expand_round(h):
            st = self.stages["expand"].st
            sg.xor_lanes(erows, erows0, st, mask=7)
            checks, valid, _succ = model_step(erows)
            ne = valid.sum(0)
            if props:
                ne = ne + checks.sum()
            sg.fold(st, [sg.term(ne[:1]), sg.term(ne)], iters, handle=h)

        self._add("expand", expand_round)

        crows0 = self._lane(S, B, salt=47)
        succs0 = self._lane(A * S, B, salt=101)
        valid0 = torch.zeros((A, B), dtype=torch.bool, device=self.device)
        sg.mask_lanes(valid0, self._lane(A, B, salt=211), None, 1)
        cptr, l227 = self._lane(B, salt=223, mod=L), self._lane(B, salt=227)
        new_rows = z(S, B)

        def choose_round(h):
            st = self.stages["choose"].st
            sg.choose(st, crows0, succs0, valid0, cptr, l227, new_rows)
            sg.fold(st, [sg.term(new_rows[:, 0])], iters, handle=h)

        self._add("choose", choose_round)

        self._forking = ("cycle", "record")

    def _fork_path(self, _seed) -> None:
        self.path.copy_(self._run_path)

    def load(self, path: torch.Tensor) -> None:
        """Take the run's final path rows [B, L] (read, never written: the
        stages fork them)."""
        if path.shape != (self.B, self.L):
            raise ValueError("the path rows do not match the stage programs' widths")
        self.release()
        self._run_path = path
        self.path = torch.zeros_like(path)

    def _drop_forks(self) -> None:
        self.path = self._run_path = None


class MeshStages(_Programs):
    """The sharded engine's stage programs (`parallel/mesh.py:863
    _build_mesh_stage_kernels`) at one run's widths: chunk C, the mesh's
    vcap and dedup scratch, the receive width R = N * quota, on a rank's
    NL local shards of N.

    Every shard keeps its own accumulator (`accs`, one int64 a local
    shard, seeded with SEED + its global index as the JAX kernels' seeds
    are), and each round runs the stage of every local shard at once on
    the shard axis, then adds each shard's terms to its accumulator; the
    program's value is the sum over all shards (the JAX kernel's final
    psum), mod 2^32. K12a's FOLD runs the loop. Stages: expand, hash,
    compact (one compaction to vcap and its gathers), claim (the mesh's
    dedup scratch), exchange (owner buckets of synthetic candidates by
    K15a, and across ranks the all_to_all), probe (K4 at R per shard into
    forks of the shard tables, from per-shard key pools) and ring (K7 at
    C and R per shard on forks of the rings). Across ranks the rounds
    run from the host (`eager`) and the sums are all-reduced."""

    def __init__(self, tm, props, chunk: int, qcap: int, n_total: int, quota: int, iters: int,
                 device, group=None):
        from ..ops import exchange as xc
        from ..parallel.mesh import dedup_cap_for, world_of

        world, rank = world_of(group)
        super().__init__(device, iters, eager=world > 1)
        self.tm, self.props = tm, list(props)
        self.n_total, self.quota = n_total, quota
        self.group, self.world, self.rank = group, world, rank
        NL = self.NL = n_total // world
        S, A, C = tm.state_width, tm.max_actions, chunk
        W, X = S + 2, S + 4
        self.S, self.A, self.C, self.W, self.qcap = S, A, C, W, qcap
        vcap = widths(A, C)[0]
        dedup_cap = dedup_cap_for(vcap)
        R = n_total * quota
        z = self._zeros
        dev = self.device
        # Each program's per-shard accumulators.
        self.accs: Dict[str, torch.Tensor] = {}
        first = torch.arange(NL, dtype=torch.int64, device=dev) + rank * NL
        lane_c = (torch.arange(NL, device=dev) * C)[:, None]

        def add(name, round_fn, after_fn=None, reset_fn=None):
            acc = self.accs[name] = z(NL)

            def reset(seed):
                acc.copy_((first + seed) & M32)
                if reset_fn is not None:
                    reset_fn(seed)

            def after():
                if after_fn is not None:
                    after_fn()
                total = acc.sum().reshape(1)
                if world > 1:
                    import torch.distributed as dist

                    dist.all_reduce(total, group=group)
                self.stages[name].st[sg.ST_ACC:sg.ST_ACC + 1].copy_(total & M32)

            self._add(name, round_fn, after, reset)

        def fold(name, h, *terms):
            acc = self.accs[name]
            acc.copy_((acc + sum(terms)) & M32)
            sg.fold(self.stages[name].st, [], iters, handle=h)

        def flip(name):
            return (self.accs[name] & 1)[:, None]

        # The run's first C ring rows of every shard (`load`).
        self.rows0, self.ebits0, self.depth0 = z(S, NL * C), z(NL * C), z(NL * C)
        self.lanes4 = z(min(4, W), NL * C)
        active = torch.ones(NL * C, dtype=torch.bool, device=dev)
        expand = build_expand_lean(tm, list(props), NL * C, self.xp)

        ex_rows = z(S, NL * C)

        def expand_round(h):
            ex_rows.copy_(self.rows0)
            ex_rows[0].view(NL, C).copy_(self.rows0[0].view(NL, C) ^ flip("expand"))
            ex = expand(ex_rows, self.ebits0, self.depth0, active, M32)
            fold("expand", h, ex.valid.view(A, NL, C).sum((0, 2)))

        add("expand", expand_round)

        h_rows = z(S, NL * C)
        cl0 = self._lane(S, vcap, salt=11)
        cl = z(S, NL, vcap)

        def hash_round(h):
            f = flip("hash")
            h_rows.copy_(self.rows0)
            h_rows[0].view(NL, C).copy_(self.rows0[0].view(NL, C) ^ f)
            h1, h2 = hash_lanes(h_rows)
            cl.copy_(cl0[:, None, :].expand(S, NL, vcap))
            cl[0].copy_(cl0[0][None, :] ^ f)
            g1, g2 = hash_lanes(cl.view(S, NL * vcap))
            fold("hash", h, h1.view(NL, C)[:, 0], h2.view(NL, C)[:, 0],
                 g1.view(NL, vcap)[:, 0], g2.view(NL, vcap)[:, 0])

        add("hash", hash_round)

        flat0 = self._lane(S, C * A, salt=41)
        r1 = self._lane(C * A, salt=53)
        m1 = torch.zeros((NL, C * A), dtype=torch.bool, device=dev)

        def compact_round(h):
            m1.copy_(((r1[None, :] ^ self.accs["compact"][:, None]) & 3) == 0)
            vids, _vv, n1 = vs.compact_ids_lanes(m1, vcap)
            src = (lane_c + vids % C).view(-1)
            g = flat0.index_select(1, vids.view(-1)).view(S, NL, vcap).sum((0, 2))
            r = self.lanes4.index_select(1, src).view(-1, NL, vcap).sum((0, 2))
            fold("compact", h, n1, g, r)

        add("compact", compact_round)

        p1, p2 = self._lane(vcap, salt=31), self._lane(vcap, salt=37)
        ones_v = torch.ones((NL, vcap), dtype=torch.bool, device=dev)
        n_all = torch.full((NL,), vcap, dtype=torch.int64, device=dev)
        claim_scratch = fr.dedup_scratch(NL, dedup_cap, dev) if self._card else None
        ch1 = z(NL, vcap)

        def claim_round(h):
            ch1.copy_(p1[None, :] ^ flip("claim"))
            reps = fr.claim_dedup_lanes(ch1, p2.expand(NL, vcap).contiguous(), ones_v, dedup_cap, n_all,
                                        claim_scratch)
            fold("claim", h, reps.sum(1))

        add("claim", claim_round)

        ch0 = self._lane(vcap, salt=61)
        lanes0 = self._lane(X, vcap, salt=67)
        xh1 = z(NL, vcap)
        xvals = z(X, NL, vcap)
        send = z(*xc.send_shape(world, X, NL, quota))
        delivered = torch.empty_like(send) if world > 1 else None

        def exchange_round(h):
            acc = self.accs["exchange"]
            xh1.copy_(ch0[None, :] ^ (acc & 1)[:, None])
            reps = ((xh1 >> 4) & 3) != 3  # ~75% survive the dedup
            xvals.copy_(lanes0[:, None, :] ^ acc[None, :, None])
            out, _ovf = xc.exchange(xh1.view(-1), reps, xvals.view(X, NL * vcap), n_total, quota,
                                    world, out=send)
            if world > 1:
                import torch.distributed as dist

                dist.all_to_all_single(delivered.view(-1), out.view(-1), group=group)
                recv = xc.receive(delivered)
            else:
                recv = out.view(X, NL, R)
            fold("exchange", h, recv.sum((0, 2)))

        add("exchange", exchange_round)

        # probe: per-shard key pools (the shard's global index in the
        # salt) into forks of the run's shard tables.
        pool1 = z(NL, R)
        sg.mix_lanes(pool1, (21 + rank * NL * 0x85EBCA77) & M32, 0x85EBCA77)
        pool2 = z(NL, R)
        sg.mix_lanes(pool2, 0x6C62272E, 0, src=pool1)
        k1, k2 = z(NL, R), z(NL, R)
        ones_r = torch.ones((NL, R), dtype=torch.bool, device=dev)
        self.fork: Optional[vs.VisitedTable] = None
        self._run_table: Optional[vs.VisitedTable] = None
        self.epoch = torch.ones(1, dtype=torch.int64, device=dev)

        def probe_round(h):
            f = flip("probe")
            k1.copy_(pool1 ^ f)
            k2.copy_(pool2 ^ f)
            c_new, _unres = vs.insert_lanes(self.fork, k1, k2, k1, k2, ones_r,
                                            epoch=self.epoch if self._card else None)
            acc = self.accs["probe"]
            acc.copy_((acc + c_new.sum(1)) & M32)
            sg.fold(self.stages["probe"].st, [], iters, epoch=self.epoch, handle=h)

        def probe_after():
            acc = self.accs["probe"]
            acc.copy_((acc + ((self.fork.keys[:, 0] >> 32) & 1)) & M32)

        def probe_reset(_seed):
            self.fork.keys.copy_(self._run_table.keys)

        add("probe", probe_round, probe_after, probe_reset)

        # ring: pop C and append R rows on forks of the run's rings; each
        # shard's head starts at its seed, as the JAX carry (queue, s0, s0).
        self.rings: Optional[torch.Tensor] = None
        self._run_rings: Optional[torch.Tensor] = None
        self.heads = z(NL)
        base = mul32(torch.arange(R, dtype=torch.int64, device=dev), sg.RING_MUL)[None, None, :]
        w17 = (17 * torch.arange(W, dtype=torch.int64, device=dev))[:, None, None]
        cand = z(W, NL, R)

        def ring_round(h):
            popped = fr.ring_pop_lanes(self.rings, self.heads, C)
            sums = popped.view(W, NL, C).sum(2) & M32
            cand.copy_(sg.mix((base + sums[:, :, None] + w17) & M32))
            nxt = (self.heads + C) & (qcap - 1)
            fr.ring_scatter_lanes(self.rings, nxt, cand.view(W, NL * R), ones_r)
            self.heads.copy_(nxt)
            fold("ring", h, cand[0, :, 0])

        def ring_reset(seed):
            self.rings.copy_(self._run_rings)
            self.heads.copy_((first + seed) & M32)

        add("ring", ring_round, reset_fn=ring_reset)
        self._forking = ("probe", "ring")

    def load(self, table: vs.VisitedTable, rings: torch.Tensor) -> None:
        """Take the run's final shard tables [NL, tcap] and rings [NL, W,
        qcap + 1] (read, never written: the stages fork them)."""
        S, C, NL = self.S, self.C, self.NL
        if rings.shape != (NL, self.W, self.qcap + 1):
            raise ValueError("the rings do not match the stage programs' widths")
        self.release()
        first = rings[:, :, :C].transpose(0, 1).reshape(self.W, NL * C)
        self.rows0.copy_(first[:S])
        self.ebits0.copy_(first[S])
        self.depth0.copy_(first[S + 1])
        self.lanes4.copy_(first[:self.lanes4.shape[0]])
        self._run_rings, self._run_table = rings, table
        self.fork = vs.empty_table(table.capacity, self.device, lanes=NL)
        self.rings = torch.zeros_like(rings)

    def _drop_forks(self) -> None:
        self.fork = self.rings = None
        self._run_table = self._run_rings = None


# Stage programs: (kind, id(tm), widths, P, canon, iters, device) ->
# (tm, programs), bounded like the JAX engine's _STAGE_KERNEL_CACHE and
# keyed, like it, without the table capacity (the probe fork follows the
# table it is given).
_STAGE_PROGRAMS: Dict[Tuple, Tuple[object, _Programs]] = {}
CACHE_SIZE = 8


def _cached(key: Tuple, tm, build: Callable[[], _Programs]) -> _Programs:
    hit = _STAGE_PROGRAMS.get(key)
    if hit is not None and hit[0] is tm:
        return hit[1]
    while len(_STAGE_PROGRAMS) >= CACHE_SIZE:
        _STAGE_PROGRAMS.pop(next(iter(_STAGE_PROGRAMS)))[1].free()
    progs = build()
    _STAGE_PROGRAMS[key] = (tm, progs)
    return progs


def bfs_stages(tm, props, chunk: int, qcap: int, canon: bool, iters: int, device) -> BfsStages:
    key = ("bfs", id(tm), chunk, qcap, len(props), canon, iters, str(device))
    return _cached(key, tm, lambda: BfsStages(tm, props, chunk, qcap, canon, iters, device))


def mesh_stages(tm, props, chunk: int, qcap: int, n_total: int, quota: int, iters: int, device,
                group=None) -> MeshStages:
    key = ("mesh", id(tm), chunk, qcap, n_total, quota, len(props), iters, str(device), id(group))
    return _cached(key, tm, lambda: MeshStages(tm, props, chunk, qcap, n_total, quota, iters,
                                               device, group))


def sim_stages(tm, props, B: int, L: int, iters: int, device) -> SimStages:
    key = ("sim", id(tm), B, L, len(props), iters, str(device))
    return _cached(key, tm, lambda: SimStages(tm, props, B, L, iters, device))
