#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (stateright_tpu_torch) on one card.

    python3 chip_smoke.py            # every phase; needs one CUDA device
    python3 chip_smoke.py --skip-full   # without the 2pc-10 phases (7, 11; 17's and 18's 2pc-10 runs)
    python3 chip_smoke.py --lint-only   # phases 0, 1 and 19 alone
    python3 chip_smoke.py --spill-only  # phases 0, 1 and 20 alone (with its own references)

Phases, each printing its own lines; any failure raises and the script
exits non-zero:

  0. environment: torch, CUDA, nvcc, the card's name and power limit;
  1. build: every kernel from kernels/csrc with nvcc, in parallel;
  2. kernel parity: each of the BFS step kernels (K7's pop and append
     apart; the append also at its tile edges, K9b also at 16,384 rows
     with ties) against its plain torch version on the same card tensors,
     compared bit for bit, at the 2pc-7 bench widths (C=6144, A=37) and
     at the paxos-3 widths (C=16384, A=21); each timed on the device
     alone (`time_device_ms`: CUDA events around back-to-back calls
     queued behind a spin kernel, so the host's share is left out;
     `call_ms` beside it is one call with the host's share), as is the
     library call that does the same work; beside them the times of K5
     rehash and K10 seed, which run through those kernels and torch; K2's
     kernels a call counted on the card (the kernel nodes of one captured
     call: COUNT and WRITE, no memset; K3's: CLAIM and KEEP, on a scratch
     its earlier calls left stale, each lane's valid prefix n_val). Every
     kernel row of the later
     phases is timed on the device alone too (a call that changes its
     input on fresh inputs made outside the window), with `call_ms`
     beside it;
 2b. K11 and K11c (`scripts/expand_times.py`): the hand-written EXPAND
     of 2PC, Paxos, ABD, increment, increment-lock and single-copy
     against its plain version, bit for bit, over every reachable 2pc-7
     row (296,448, in chunks of 6,144), 16,384 paxos-3 ring rows at C =
     16,384, every abd-ordered-3 row (46,516, in chunks of 2,048), every
     abd-2 row (544, chunk 512), increment-2's 13 rows, increment-lock-3's
     61, every single-copy-4 row (400,233, chunk 2,048) and every row of
     the 3x2 model (2,519, chunk 256), with depth limits read on the card
     and a limit a row, and at the lane widths with a limit a row; WALK at
     the paxos-3 (B = 16,384) and 2pc-10 (B = 65,536) simulation widths,
     for ABD, increment, increment-lock and single-copy-4 at B = 16,384
     and over the 3x2 model's 2,519 rows; the 2PC canon over the canon
     inputs of the whole 2pc-5 symmetry run and at the 2pc-10 symmetry
     width (141,994 candidates); each timed on the device beside its
     plain version in one CUDA graph (`graph_plain_ms`), eager
     (`plain_ms`) and the bound, one kernel and no memset a captured call;
  3. small engine runs (2pc-5, sampling on, and 2pc-5 with .symmetry())
     on cuda and on the cpu: equal results, sample and paths included;
     each card run's kernel launches a step (the symmetry run's canon
     on the kernel, once a step);
  4. the headline: 2pc-7 exhaustive at the bench options with sampling
     on (the default), with and without table growth, and its time with
     sampling off; the launch counts of that run show the main path went
     through every kernel; K10f (`EraProgram.seed`) timed on a finished
     run's workspace (here and in phase 5);
  5. paxos-3 exhaustive (1,194,428 states) at bench.py's options, every
     discovery path and the sample rows walked through K6;
  6. abd-ordered-3 exhaustive (46,516 states) and abd-2 on the
     unordered network (544 states, bench.py:1137-1145), "linearizable"
     held by both;
 6b. the reference bench's single-copy-register check 4 (400,233 states,
     bench.py:1472-1500) on K11's kernel route with no linearizability
     violation (its time to exhaust and wall per step), the 3x2 model's
     violation at bench.py:1205-1225's options found and replayed (its
     time), increment-lock-2 and -3 exhausted with "fin" and "mutex"
     holding; single-copy (2, 1), (3, 1), the (2, 2) violation and
     increment-lock-2 and -3 on cuda == on the cpu (the whole result
     dict, sample included); the 3x2 violation found by the simulation
     through WALK and an increment-lock-3 simulation, cuda == cpu;
  7. full size: 2pc-10 exhaustive (61,515,776 states) and 2pc-10 with
     .symmetry() (265,719 representatives);
  8. simulation kernel parity: each of the four walk kernels (K13a-d)
     against its plain version, exactly, at the paxos-3 simulation widths
     (B=16384, L=256, S=30, A=21, P=4) and the 2pc-10 ones (B=65536,
     L=256, S=3, A=52, P=3), on walk state from a real era of each model;
  9. simulation on cuda and on cpu: increment-2 (the JAX bench's run),
     2pc-5, abd-ordered-3 (seed 0, 1,024 walks, walk_cap 64) and 2pc-10
     (2,048 walks) with a target, coverage and sampling: equal results; 2pc-5 run to "commit agreement" with 8,192 and 65,536
     walks: found, or not, after the JAX reference's state, step and era
     counts (REACH_2PC5); and the increment run's time to its
     counterexample after a warm-up;
 10. paxos-3 simulation as the reference CLI runs it (seed 0, 16,384
     walks, walk_cap 256, .timeout(10.0)): "value chosen" found and
     replayed, no safety property violated;
 11. full size: 2pc-10 simulation (65,536 walks, sync_steps 64, a target
     of 100,000,000 states): "abort agreement" found and replayed,
     "consistent" never ("commit agreement" is out of the walks' reach
     there, the reference's walks too: see phase 9 and PERF.md);
 12. lane kernel parity: the lane forms of K2, K3, K4, K6 and K7 (pop and
     append) against their plain versions, exactly, device-timed as in
     phase 2, at the widths of 1,024 lanes of 2pc-5
     (the reference's default lane shape: chunk 151, ring 2^13, table
     2^16; 1.61 GB of tables), and each at one lane against its solo call;
 13. the service shape: 32 lanes of increment-2 (bench.py's service
     section) and 27 mixed 2pc-5 builders (target_max_depth 4, 9 or none,
     some finishing on a discovery) in 32 lanes: cuda equals cpu lane by
     lane, discoveries replay, each lane equals its solo run; with the
     checks/s of 8 serial solo runs (bench.py:1575-1591);
 14. the sweeps: 1,024 lanes of 2pc-5 (lane i at target_max_depth
     1 + i % 18) and 256 lanes of paxos-2 (table 2^17, ring 2^14): wall,
     checks/s, states/s, steps, launches a step and peak memory (phase
     16 profiles them); every depth equal to its solo
     run, every unbounded lane at 8,832 (paxos-2: 16,668), 64 (paxos-2:
     8) lanes equal to the port's cpu lanes; beside them the serial solo
     runs' checks/s;
 15. device-resident eras: K8f's two kernels (the era's gate and step
     commit, and its epilogue) against their plain versions at the 2pc-7
     and paxos-3 widths; 2pc-5 cuda == cpu over the (depth, fuse) sweep
     and the serial dispatch loop; 2pc-7, paxos-3 and abd-ordered-3 with the
     default pipeline, the serial dispatch loop and (depth 4, fuse 4): equal to
     each other (the bottom-k sample aside: a chained era's stale
     threshold changes the captures a step drops, in the JAX engine too)
     and to the goldens, with wall, steps, eras, dispatches,
     graph captures and capture seconds, wall a step and peak memory,
     each hand-written kernel's launches a step, and for the default
     pipeline host launch calls and device kernels a step and the
     device's busy share (torch.profiler).

 16. simulation eras and lane batches as device programs: K13f's
     walk-era kernel (BEGIN, COMMIT under every exit, EPILOGUE) against
     its plain version at the paxos-3 simulation widths, and the lane axis
     of K8f's two kernels (K14f) at 1,024 lanes of 2pc-5, each also at one
     lane against the solo kernel, all exactly; graph simulation ==
     phase 9's cpu runs (increment-2, 2pc-5 at a target, the sample
     included) with one capture a run and one readback an era; the 27
     mixed 2pc-5 builders in 4 batches of 8 lanes on one warm program ==
     their cpu lanes, with one capture and one readback a batch; and the
     speed cells of `scripts/solo_walls.py` (paxos-3 and 2pc-10
     simulation at fixed targets, increment-2's time to its
     counterexample, the 2pc-5 and paxos-2 sweeps, 32 increment-2 lanes):
     wall, steps, eras or batches, graph captures and their seconds, era
     readbacks, host launch calls and device kernels a step (one profiled
     run in a fresh process), wall a step, the busy share and peak memory.

 17. the stage profiler (K12): K12a's lanes and loop kernel
     (`stage_loop.cu`) at the 2pc-7 and paxos-3 BFS widths and K12b
     (`stage_walk.cu`: CYCLE, RECORD, CHOOSE) at the paxos-3 simulation
     widths against their plain versions, exactly; 2pc-7, paxos-3 and
     2pc-5 with .symmetry() (for the canon stage, on K11c) BFS and the paxos-3
     simulation to 2,000,000 states, each with and without
     .stage_profile(): equal results, no stage_profile_error, the stage_*
     phases summing to device_era within 10%, the split, the profiler's
     own seconds and both peaks printed; every stage program and the null
     loop of those runs' widths and state through its graph and through
     the plain versions (4 rounds): equal accumulators; and, unless
     --skip-full, 2pc-10 BFS with .stage_profile() (its probe stage forks
     the 2^28-slot table).

 18. the sharded mesh (K15): K15a (`exchange.cu`, the owner buckets),
     K15f (`mesh_era.cu`: the COMMIT grid that folds the step's first
     hits, counts and depth histogram, and the gate, epilogue and tail)
     and K9b's lane form (every shard's slab in one launch, also at
     16,384 rows with ties) against their plain versions, exactly, at
     the 2pc-7 (chunk 1,024) and paxos-3 (chunk 2,048) widths at 1 and
     8 shards, with
     buckets past the quota, vetoed, unresolved and closed-gate commits
     and every budget rule; K3's lane form at the 8 shards' widths; 2pc-5 and paxos-2 at 8 shards on cuda == cpu (the
     sample and the paths included; 2pc-5 takes partial commits); 2pc-7
     and paxos-3 at 8 shards on one card and at 1 shard: the goldens,
     the single-device run's discoveries (the same properties at the same
     depth), wall a lockstep step, kernel launches a step, peak memory
     and the cross-shard imbalance; 2pc-7 and paxos-3 at 8 shards with
     .stage_profile() (the exchange stage; 2pc-7's mesh stage programs
     through their graphs == their plain versions); and, unless
     --skip-full, 2pc-10 at 8 shards (61,515,776 states, capacities that
     need no growth and no spill). World size 1 only: two ranks cannot
     share one card under NCCL (tests/test_torch_mesh_dist.py runs ranks
     over gloo on the CPU).

 19. the speclint pre-flight (K16, K16a): K16a (`lane_agree.cu`, the
     numpy-against-card agreement table) against its plain version, bit
     for bit, at the paxos-3 (A=21, S=30, B=16,384) and 2pc-7 (A=37, S=3,
     B=6,144) widths on reachable rows from the port's own BFS, as they
     are and with a lane, a mask and high bits planted; analyze() at the
     reference defaults (256 samples, 128 device rows) of 2pc-5 (with
     symmetry), 2pc-7, paxos-3, abd-ordered-3, abd-2, increment-2,
     increment-lock-3 and single-copy-4 on the card == on the cpu (K16a
     must launch: `kernels.LINT_KERNELS`), each launching its K11 WALK
     once and 2PC's its canon once (K16 against the kernels the engines
     run, counted per model); the device
     and symmetry rules on 16,384 reachable paxos-3 and 8,192 2pc-10 rows
     (K16: the captured step_lanes replayed and timed); every fixture whose
     error comes from the card (tests/torch_lint_fixtures.py: a refused
     capture, the lane types, STR205 and STR404 through K16a) == its cpu
     report, torch's capture state clean after each; a strict 2pc-7 run
     at the bench options (296,448, `lint_*` telemetry), and a strict spawn
     of a broken fixture refused with no engine kernel launched;
 20. the host spill, checkpoints and the degraded regrow (K7s,
     `ring_spill.cu`): DRAIN and REFILL against their plain versions,
     exactly, at the 2pc-10 spilling run's widths (a 2^22 ring, its
     largest drain, from a head that wraps) and over 8 shards' rings with
     ragged counts, beside `index_select` / `index_copy_` (over the flat
     rings for the 8), and each also with its copy to or from a pinned
     buffer as a spill makes the trip (`host_ms`); 2pc-10 at phase
     7's options through a 2^22 ring (61,515,776, the unspilled run's
     states and sample), again under a host budget of a quarter of its
     peak (the disk tier gives back every row it took); paxos-3 killed at
     600,000 states with a checkpoint at every era (two deltas or more)
     and resumed to 1,194,428, equal to phase 5's unbroken run (states,
     discovery fingerprints and path lengths), its sample its table's
     exact bottom-k, each save's seconds and bytes; a probe error faked
     at era 1 of 2pc-7 (one degraded regrow, 296,448); 2pc-7 spilling
     at 8 shards and at 1 shard (chunk 55 in a 2^12 ring a shard), equal
     to each other, the sample the table's bottom-k (K7s must launch:
     `kernels.SPILL_KERNELS`).

Every device program runs as CUDA graphs (engines/graph.py): a BFS
dispatch (engines/era.py), a simulation era (engines/gpu_simulation.py),
a lane batch (engines/multiplex.py) and a sharded dispatch at world size
1 (parallel/mesh.py) are one graph launch and one readback each, so
phases 3-18 run through graphs (phase 19 captures each model's lane
programs as the era does, and replays them); the launch counts add
each captured segment's launches once per run of it on the card.

Every engine phase resets the kernels' launch counts just before its run
and checks, just after, the route of K11 the engine reports
(`telemetry()["expand_route"]`: "kernel" for every bundled model, with
its K11 kernel launched once a step; under .symmetry() also
`telemetry()["canon_route"]`: "kernel", K11c launched once a step), and
that each kernel of its path (the BFS kernels,
K1, K13a-d, K13b's prologue and K13f, or K1 and the lane entry points of
K2, K3, K4, K6, K7 and K8f, or the sharded path's `MESH_KERNELS`; with
the stage profiler, K12a and the stage programs' kernels too; for the
speclint pre-flight, K16a; with a spill, K7s) was launched. Before
the last line it prints the `kernels` JSON line and the card's name and
power limit; the last line is the JSON result. It imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# 2pc-7 bench options (bench.py:798) and the test options of the
# engine-parity tests (tests/test_pipeline.py:25).
BENCH7 = dict(chunk_size=6144, queue_capacity=1 << 20, table_capacity=1 << 22)
TEST_OPTS = dict(chunk_size=64, queue_capacity=1 << 12, table_capacity=1 << 11, sync_steps=4)
FULL10 = dict(chunk_size=12288, queue_capacity=1 << 26, table_capacity=1 << 28)
# 2pc-10 with symmetry (bench.py:1267-1272), paxos-3 (bench.py:1305-1307,
# serial eras) and abd-ordered-3 (bench.py:1159-1161).
SYM10 = dict(chunk_size=8192, queue_capacity=1 << 21, table_capacity=1 << 24, sync_steps=128)
PAXOS3 = dict(chunk_size=16384, queue_capacity=1 << 21, table_capacity=1 << 26)
ABDO3 = dict(chunk_size=2048, queue_capacity=1 << 15, table_capacity=1 << 18)
# abd-2 on the unordered network (bench.py:1137-1145).
ABD2 = dict(chunk_size=512, queue_capacity=1 << 14, table_capacity=1 << 13)
ABD2_GOLDEN = 544
GOLDEN = {5: 8_832, 7: 296_448, 10: 61_515_776}
SYM_CLOSURE = {5: 1_092, 10: 265_719}
PAXOS3_GOLDEN = 1_194_428
ABDO3_GOLDEN = 46_516
# The single-copy register: the reference bench's `single-copy-register
# check 4` (SingleCopyTensor(4), bench.py:1472-1500) and its time to a
# linearizability counterexample, SingleCopyTensor(3, 2) finishing on
# "linearizable" (bench.py:1205-1225); the 3x2 model's whole space is
# 2,519 states. The lock-protected increment at the engine-parity
# options' small table (17 and 61 states).
SC4 = dict(chunk_size=2048, queue_capacity=1 << 17, table_capacity=1 << 21)
SC4_GOLDEN = 400_233
SC32 = dict(chunk_size=256, queue_capacity=1 << 12, table_capacity=1 << 12)
SC32_SPACE = 2_519
LOCK_OPTS = dict(chunk_size=64, queue_capacity=1 << 10, table_capacity=1 << 12)
LOCK_GOLDEN = {2: 17, 3: 61}

# Simulation: paxos-3 as the reference CLI walks it (examples/_cli.py:95;
# B = the paxos-3 BFS chunk), 2pc-10 at 65,536 walks, and the cuda == cpu
# runs (the JAX bench's increment-2 run, bench.py:1228-1242, and 2pc-5).
SIM_L = 256
SIM_PAXOS3 = dict(walks=16384, walk_cap=SIM_L)
SIM_2PC10 = dict(walks=65536, walk_cap=SIM_L, sync_steps=64)
SIM_TARGET10 = 100_000_000
SIM_INC2 = dict(walks=256, walk_cap=32)
SIM_2PC5 = dict(walks=1024, walk_cap=64, sync_steps=4)
SIM_2PC10_SMALL = dict(walks=2048, walk_cap=SIM_L, sync_steps=64)
SIM_ABDO3 = dict(walks=1024, walk_cap=64)  # seed 0, a 200,000-state target: WALK for ABD
SIM_SC32 = dict(walks=256, walk_cap=64, sync_steps=8)  # seed 5, to "linearizable"
SIM_LOCK3 = dict(walks=256, walk_cap=32)  # seed 0, a 20,000-state target
# 2pc-5 walks (seed 0, walk_cap 256, sync_steps 64) run until "commit
# agreement" or 5,000,000 states, as the JAX reference takes them on the
# CPU (`scripts/sim_reach.py --jax --n 5 --walks 8192 65536`):
# walks -> (found, generated states, steps, eras).
REACH_2PC5 = {8192: (True, 4_500_923, 639, 93), 65536: (False, 5_008_016, 86, 84)}

# Multiplexed lanes: the reference's default lane shape
# (multiplex.py:390), 1,024 lanes of 2pc-5 in the sweep, and paxos-2's
# lanes (16,668 states in 73 steps a lane, the JAX lanes on the CPU).
LANE_SHAPE = dict(chunk=256, queue_capacity=1 << 13, table_capacity=1 << 16)
SWEEP_LANES = 1024
PAXOS2_LANES = dict(table_capacity=1 << 17, queue_capacity=1 << 14)
PAXOS2_GOLDEN = 16_668


def mixed_config(i, HasDiscoveries):
    """Builder i of phase 13's 27 mixed 2pc-5 checks: target_max_depth 4,
    9 or none, and every other check finishing at "abort agreement" or
    "commit agreement" (a cycle of 12)."""
    depth = (4, 9, None)[i % 3]
    finish = (None, "abort agreement", None, "commit agreement")[i % 4]

    def configure(b):
        if depth is not None:
            b = b.target_max_depth(depth)
        if finish is not None:
            b = b.finish_when(HasDiscoveries.any_of([finish]))
        return b

    return configure


# 3-lane rows whose raw hash halves are both 0 (tests/test_torch_fingerprint.py).
BOTH_ZERO_ROWS = ((2392970816, 0, 4120996650), (2503669636, 0, 1754888951))

# Published H100 SXM peaks: HBM bytes/s, and
# the CUDA-core 32-bit rate used for the integer work of these kernels.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12


T0 = time.monotonic()


def phase(name):
    print(f"== phase {name} (at {time.monotonic() - T0:.1f} s)", flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def card_line():
    return run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).splitlines()[0]


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def result_dict(c):
    """Counts, discoveries, coverage, the sample and the discovery paths
    (walked through K6): what must be equal on cuda and on cpu."""
    cov = c.coverage()
    return dict(
        unique=c.unique_state_count(),
        states=c.state_count(),
        max_depth=c.max_depth(),
        discovery_fps=dict(c._discovery_fps),
        coverage_actions=cov["actions"],
        coverage_depths=cov["depths"],
        sample=tuple(c._sampler.fingerprints()) if c._sampler is not None else (),
        paths={k: v.encode(c.model()) for k, v in c.discoveries().items()},
    )


# -- phase 2 ----------------------------------------------------------------

def time_ms(torch, fn, prep=None, reps=20, warm=True):
    """Median CUDA-event time of fn(prep()) over `reps` launches after a
    warm-up (none with warm=False, for a plain version that builds
    nothing and takes tens of seconds a call); prep runs outside the
    timed window."""
    times = []
    for r in range(reps + 1 if warm else reps):
        arg = prep() if prep is not None else None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        torch.cuda.synchronize()
        if r or not warm:
            times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


SPIN_CYCLES_PER_S = 2e9  # torch.cuda._sleep's unit: SM clock cycles (the card's is under 2 GHz)


def _spin_then_time(torch, calls, host_s):
    """CUDA events around `calls()` queued behind a spin kernel that
    holds the stream longer than the host takes to queue them, so the
    events bracket device time only. Returns the device ms, or None when
    the host took longer to queue the calls than the spin lasted (a full
    launch queue blocks the host): the events would time the host."""
    spin, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    spin.record()
    torch.cuda._sleep(int((2 * host_s + 2e-3) * SPIN_CYCLES_PER_S))
    start.record()
    t0 = time.perf_counter()
    calls()
    queued_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) if queued_ms < spin.elapsed_time(start) else None


def time_device_ms(torch, fn, prep=None, reps=50, syncs=False):
    """Device time of one call of fn(prep()), the host's share left out.
    Without prep: `reps` back-to-back calls after a warm-up, one pair of
    CUDA events around all of them behind a spin kernel, divided by reps
    (halved while the launch queue cannot hold them all, down to 5).
    With prep (a call that changes its input, so each needs a fresh one,
    made outside the window): each call alone behind its own spin, the
    median of 15. A call that synchronises the host (`syncs`, such as
    torch.nonzero) cannot be queued ahead: its reps calls run between the
    events with no spin, each paying its host round trip."""
    torch.cuda.synchronize()
    if prep is None:
        fn(None)
        torch.cuda.synchronize()
        while True:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(None)
            host_s = time.perf_counter() - t0
            torch.cuda.synchronize()

            def calls():
                for _ in range(reps):
                    fn(None)

            if syncs:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                calls()
                end.record()
                torch.cuda.synchronize()
                return start.elapsed_time(end) / reps
            ms = _spin_then_time(torch, calls, host_s)
            if ms is not None:
                return ms / reps
            check(reps > 5, "the host cannot queue 5 calls ahead of the card: the events would time the host")
            reps = max(5, reps // 2)
    times = []
    for r in range(16):
        arg = prep()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if r and syncs:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(arg)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        elif r:
            ms = _spin_then_time(torch, lambda: fn(arg), host_s)
            check(ms is not None, "the host took longer to queue one call than the spin lasted")
            times.append(ms)
        else:
            fn(arg)  # the warm-up, which also times the host's share
            host_s = time.perf_counter() - t0
            torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2]


def kernels_a_call(torch, what, fn, most):
    """A kernel's launches a call, counted on the card: the kernel nodes of
    one captured call (at most `most`: K2's and K15a's COUNT and WRITE,
    K4's PROBE, STAMP and COMMIT), and no memset node."""
    from stateright_tpu_torch.engines import graph

    nodes = graph.captured_nodes(fn)
    check(nodes["memsets"] == 0 and nodes["kernels"] <= most, f"{what} captured as {nodes}")
    print(f"{what}: {nodes['kernels']} kernels a captured call, no memset", flush=True)
    return nodes["kernels"]


def max_abs_err(torch, pairs):
    err = 0
    for a, b in pairs:
        check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))
    return err


def k3_case(torch, np, rng, N, n, dedup_cap, lanes):
    """K3 against its plain version on [N, n] candidates from one key pool
    (many duplicates a lane, slot contenders), each lane's valid prefix
    n_val as the compaction gives it (0, partial, the full width, past
    it; about 0.8 n in the timed call), on one program-owned scratch that
    earlier calls left stale winners and epochs in; also a mask with
    holes inside the prefix, and a fresh scratch. `lanes`: the lane form
    (else the solo call, N = 1). Returns the timing dict."""
    from stateright_tpu_torch.ops import frontier as fr

    dev = torch.device("cuda")

    def gpu(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    pool = rng.integers(0, 1 << 32, size=(2, max(8, n // 8)))
    scratch = fr.dedup_scratch(N, dedup_cap, dev)

    def call(h1, h2, valid, n_val, s=scratch):
        if lanes:
            return fr.claim_dedup_lanes(h1, h2, valid, dedup_cap, n_val, s)
        return fr.claim_dedup(h1[0], h2[0], valid[0], dedup_cap, n_val[0], s)[None]

    errs = []
    for case in range(4):
        pick = rng.integers(0, pool.shape[1], size=(N, n))
        h1, h2 = gpu(pool[0, pick]), gpu(pool[1, pick])
        h1[:, :32] = 5
        h2[:, :32] = torch.arange(32, device=dev)  # one h1, many h2: shared slots when mixed
        nv = (rng.random(N) * 0.4 + 0.6) * n if case == 3 else rng.integers(0, n + 1, size=N)
        nv = nv.astype(np.int64)
        if case == 0:
            nv[:] = n  # the whole width first: later calls find stale winners above them
        elif N > 2:
            nv[:3] = [0, n, n + 9]
        n_val = gpu(nv)
        valid = torch.arange(n, device=dev)[None, :] < n_val[:, None]
        if case == 1:
            valid &= gpu(rng.random((N, n)) < 0.7)  # holes inside the prefix
        want = fr.claim_dedup_lanes_plain(h1, h2, valid, dedup_cap, n_val)
        errs.append(max_abs_err(torch, [(call(h1, h2, valid, n_val), want)]))
        if case == 2:
            errs.append(max_abs_err(torch, [(call(h1, h2, valid, n_val, fr.dedup_scratch(N, dedup_cap, dev)), want)]))
    lim = n_val.clamp(max=n)
    p, v = int(lim.sum()), int(valid.sum())
    what = "K3 lanes" if lanes else "K3"
    return dict(
        max_abs_err=max(errs),
        ms=time_device_ms(torch, lambda _: call(h1, h2, valid, n_val)),
        call_ms=time_ms(torch, lambda _: call(h1, h2, valid, n_val)),
        plain_ms=time_ms(torch, lambda _: fr.claim_dedup_lanes_plain(h1, h2, valid, dedup_cap, n_val)),
        launches_a_call=kernels_a_call(torch, f"{what} [{N}, {n}]", lambda: call(h1, h2, valid, n_val), 2),
        # the prefix's keys and mask read once, keep written over the
        # width, each valid candidate's atomic, slot read and winner's key
        bytes=17 * p + N * n + 32 * v, ops=8 * v,
        library_ms=None,
        shape=f"[{N}, {n}], {p} in the prefixes, {v} valid, scratch [{N}, {dedup_cap}] x 8 bytes",
    )


def finish(results):
    """Bound each timed function by the larger of its bytes over the HBM
    rate and its operations over the 32-bit rate, print it, and check
    every kernel's parity."""
    for name, r in results.items():
        r["bound_ms"], r["bound_by"] = bound_of(r["bytes"], r["ops"])
        print(f"kernel {name} {r['shape']}: max_abs_err={r['max_abs_err']} "
              f"ms={r['ms']:.4f} call_ms={r.get('call_ms')} plain_ms={r['plain_ms']} bound_ms={r['bound_ms']:.5f} "
              f"bound_by={r['bound_by']} library_ms={r['library_ms']}", flush=True)
        if r["max_abs_err"] is not None:
            check(r["max_abs_err"] == 0, f"kernel {name} disagrees with its plain version")
    return results


def kernel_parity(torch, np, label, C, A, S, tcap, qcap):
    """Every kernel against its plain version at the widths one BFS step
    of a model with C, A, S gives it, with a tcap-slot table and a
    qcap-row ring; returns {kernel: timing dict}."""
    from stateright_tpu_torch import kernels
    from stateright_tpu_torch.engines.gpu_bfs import widths
    from stateright_tpu_torch.fingerprint import hash_lanes, hash_lanes_plain
    from stateright_tpu_torch.obs.sample import DEVICE_STEP_CAP, slab_capacity, slab_entries
    from stateright_tpu_torch.ops import frontier as fr
    from stateright_tpu_torch.ops import slab as sl
    from stateright_tpu_torch.ops import visited_set as vs

    dev = torch.device("cuda")
    CA = C * A
    W = S + 2
    vcap, rcap, dedup_cap = widths(A, C)
    print(f"widths ({label}): C*A={CA} vcap={vcap} rcap={rcap} dedup_cap={dedup_cap} "
          f"S={S} table=2^{tcap.bit_length() - 1} ring=2^{qcap.bit_length() - 1}x{W}")
    rng = np.random.default_rng(7)
    results = {}

    def gpu(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def u32(*shape):
        x = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.int64)
        x.flat[: min(x.size, 64)] = 0xFFFFFFFF - np.arange(min(x.size, 64))
        return x

    # K1 at the two widths the step hashes: the popped rows and the
    # compacted candidates.
    errs = []
    for n in (C, vcap):
        lanes = gpu(u32(S, n))
        if S == 3:
            lanes[:, :2] = gpu(np.asarray(BOTH_ZERO_ROWS, dtype=np.int64).T)
        lanes[:, 2:8] = 0
        errs.append(max_abs_err(torch, zip(hash_lanes(lanes), hash_lanes_plain(lanes))))
    lanes = gpu(u32(S, vcap))
    n = vcap
    results["hash_lanes"] = dict(
        max_abs_err=max(errs),
        ms=time_device_ms(torch, lambda _: hash_lanes(lanes)),
        call_ms=time_ms(torch, lambda _: hash_lanes(lanes)),
        plain_ms=time_ms(torch, lambda _: hash_lanes_plain(lanes)),
        bytes=S * n * 8 + 2 * n * 8,
        ops=n * (2 * S * 4 + 2 * 6),
        library_ms=None,
        shape=f"[{S}, {n}]",
    )

    # K2: the validity mask [C*A] -> vcap (about a third valid), an
    # overflowing mask, and the dedup mask [vcap] -> rcap.
    errs = []
    cases = [
        (gpu(rng.random(CA) < 0.3), vcap),
        (gpu(rng.random(CA) < 0.6), vcap),
        (gpu(rng.random(vcap) < 0.35), rcap),
    ]
    for mask, cap in cases:
        a = vs.compact_ids(mask, cap)
        b = vs.compact_ids_plain(mask, cap)
        errs.append(max_abs_err(torch, zip(a, b)))
    mask, cap = cases[0]
    results["compact_ids"] = dict(
        max_abs_err=max(errs),
        launches_a_call=kernels_a_call(torch, "K2", lambda: vs.compact_ids(mask, cap), 2),
        ms=time_device_ms(torch, lambda _: vs.compact_ids(mask, cap)),
        call_ms=time_ms(torch, lambda _: vs.compact_ids(mask, cap)),
        plain_ms=time_ms(torch, lambda _: vs.compact_ids_plain(mask, cap)),
        bytes=CA + cap * 9 + 8,
        ops=CA,
        library_ms=time_device_ms(torch, lambda _: torch.nonzero(mask), syncs=True),
        shape=f"[{CA}] -> [{cap}]",
    )

    # K3: [vcap] candidates, the step's valid prefix, on the era's scratch.
    results["claim_dedup"] = k3_case(torch, np, rng, 1, vcap, dedup_cap, lanes=False)

    # K4: a tcap-slot table filled to ~0.25 load, then an [rcap] batch of
    # found keys, new keys and in-batch duplicates; and a duplicate-heavy
    # batch (64 copies of one key, distinct parents) for the winner rule.
    base = vs.empty_table(tcap, dev)
    fill = tcap // 4 - rcap
    k = gpu(u32(2, fill))
    vs.insert(base, k[0], k[1], k[0], k[1], torch.ones(fill, dtype=torch.bool, device=dev))
    old = rng.integers(0, fill, size=rcap // 3)
    fresh = u32(2, rcap - len(old))
    bh = np.concatenate([k[:, torch.from_numpy(old).to(dev)].cpu().numpy(), fresh], axis=1)
    perm = rng.permutation(rcap)
    bh = bh[:, perm]
    bh[:, rcap - 200:] = bh[:, rcap - 400:rcap - 200]  # in-batch duplicates
    b1, b2 = gpu(bh[0]), gpu(bh[1])
    p1, p2 = gpu(u32(2, rcap))
    act = gpu(rng.random(rcap) < 0.95)

    def dump(t):
        order = torch.argsort(t.keys)
        return t.keys[order], t.parents[order]

    def clone(t):
        return vs.VisitedTable(t.keys.clone(), t.parents.clone(), t.stamps.clone(), t.epoch)

    ta, tb = clone(base), clone(base)
    out_a = vs.insert(ta, b1, b2, p1, p2, act)
    out_b = vs.insert_plain(tb, b1, b2, p1, p2, act)
    errs = [max_abs_err(torch, list(zip(out_a, out_b)) + list(zip(dump(ta), dump(tb))))]
    n_new = int(out_a[0].sum())
    n_act = int(act.sum())
    check(n_new > 0 and int(out_a[1].sum()) == 0, "insert parity batch: expected new keys and no unresolved")
    del tb

    dup = 64
    w1 = np.concatenate([[0xDEADBEEF] * dup, fresh[0, :dup]])
    w2 = np.concatenate([[0x12345678] * dup, fresh[1, :dup]])
    order = rng.permutation(2 * dup)
    w1, w2 = gpu(w1[order].astype(np.int64)), gpu(w2[order].astype(np.int64))
    wp = gpu(np.arange(1, 2 * dup + 1, dtype=np.int64))
    on = torch.ones(2 * dup, dtype=torch.bool, device=dev)
    ta, tb = clone(base), clone(base)
    wa = vs.insert(ta, w1, w2, wp, wp, on)
    wb = vs.insert_plain(tb, w1, w2, wp, wp, on)
    errs.append(max_abs_err(torch, list(zip(wa, wb)) + list(zip(dump(ta), dump(tb)))))
    top = int(np.flatnonzero(order < dup).max())
    check(bool(wa[0][top]) and int(wa[0][(w1 == 0xDEADBEEF)].sum()) == 1,
          "winner rule: the highest-index copy must be the new one")
    dup_key = int(np.array([0xDEADBEEF12345678], dtype=np.uint64).view(np.int64)[0])
    check(int(ta.parents[ta.keys == dup_key].item()) & 0xFFFFFFFF == top + 1,
          "winner rule: the stored parent must be the highest-index copy's")
    del ta, tb
    results["visited_insert"] = dict(
        max_abs_err=max(errs),
        ms=time_device_ms(torch, lambda t: vs.insert(t, b1, b2, p1, p2, act), prep=lambda: clone(base)),
        call_ms=time_ms(torch, lambda t: vs.insert(t, b1, b2, p1, p2, act), prep=lambda: clone(base)),
        plain_ms=time_ms(torch, lambda t: vs.insert_plain(t, b1, b2, p1, p2, act), prep=lambda: clone(base), reps=5),
        # Captured, never run: the table is not touched.
        launches_a_call=kernels_a_call(torch, f"{label} K4", lambda: vs.insert(base, b1, b2, p1, p2, act), 3),
        bytes=rcap * (4 * 8 + 1 + 2) + n_act * 8 + n_new * 16,
        ops=n_act * 8,
        library_ms=None,
        shape=f"[{rcap}] into {tcap} slots at load {(fill / tcap):.3f}",
    )

    # K7: pop C rows at a head that wraps, and append rcap candidates
    # (about 40% new) at a tail that wraps; the append also at its edges
    # (tests/test_torch_ring.py APPEND_EDGES: a tile's width -1, 0, +1,
    # many tiles, all or no column valid, a wrap inside a tile).
    ring = fr.empty_ring(W, qcap, dev)
    ring[:, :qcap] = gpu(u32(W, qcap))
    head = qcap - C // 3
    cand = gpu(u32(W, rcap))
    cvalid = gpu(rng.random(rcap) < 0.4)
    T = kernels.APPEND_TILE
    cases = [(head, cand, cvalid)] + [
        (tail, gpu(u32(W, m)), gpu(rng.random(m) < density))
        for tail, m, density in ((100, T - 1, 0.4), (5000, T, 0.4), (qcap - 9, T + 1, 0.4), (7, 5 * T + 123, 0.5),
                                 (50, T + 17, 1.0), (9, 2 * T, 0.0), (qcap - 1000, 3 * T, 0.6))
    ]
    errs = [max_abs_err(torch, [(fr.ring_pop(ring, head, C), fr.ring_pop_plain(ring, head, C))])]
    for tail, cd, cv in cases:
        ra, rb = ring.clone(), ring.clone()
        fr.ring_scatter(ra, tail, cd, cv)
        fr.ring_scatter_plain(rb, tail, cd, cv)
        errs.append(max_abs_err(torch, [(ra[:, :qcap], rb[:, :qcap])]))
    del ra, rb, cases
    n_app = int(cvalid.sum())
    idx = fr.ring_indices(head, C, qcap, dev)

    def pop_and_append(_):
        fr.ring_pop(ring, head, C)
        fr.ring_scatter(ring, head, cand, cvalid)

    def torch_append(_):
        # The same work as the append: rank the mask (cumsum), place each
        # valid column at tail + rank and every other in the trash column.
        rank = torch.cumsum(cvalid, 0) - 1
        ring.index_copy_(1, torch.where(cvalid, (head + rank) & (qcap - 1), qcap), cand)

    def torch_pop_and_append(_):
        ring.index_select(1, idx)
        torch_append(None)

    results["ring"] = dict(
        max_abs_err=errs[0],
        ms=time_device_ms(torch, lambda _: fr.ring_pop(ring, head, C)),
        call_ms=time_ms(torch, lambda _: fr.ring_pop(ring, head, C)),
        plain_ms=time_ms(torch, lambda _: fr.ring_pop_plain(ring, head, C)),
        bytes=2 * W * C * 8, ops=W * C,
        library_ms=time_device_ms(torch, lambda _: ring.index_select(1, idx)),
        # pop + append, as one BFS step runs them
        pop_append_ms=time_device_ms(torch, pop_and_append),
        pop_append_library_ms=time_device_ms(torch, torch_pop_and_append),
        shape=f"pop [{W}, {C}] from a 2^{qcap.bit_length() - 1} ring (index_select)",
    )
    results["ring_append"] = dict(
        max_abs_err=max(errs[1:]),
        ms=time_device_ms(torch, lambda _: fr.ring_scatter(ring, head, cand, cvalid)),
        call_ms=time_ms(torch, lambda _: fr.ring_scatter(ring, head, cand, cvalid)),
        plain_ms=time_ms(torch, lambda _: fr.ring_scatter_plain(ring, head, cand, cvalid)),
        # the mask once, each valid column's W values read and written
        bytes=rcap + 2 * W * n_app * 8, ops=rcap + W * n_app,
        library_ms=time_device_ms(torch, torch_append),
        shape=f"append [{W}, {rcap}] ({n_app} valid) (cumsum + where + index_copy_)",
    )
    # K9a: captures at the rcap width: a loose threshold (every new
    # insert below it; a clamped step's few hundred, then a flood past
    # the per-step cap) and a tight one with ties on its high word.
    scap, sk2 = slab_capacity(64, DEVICE_STEP_CAP), slab_entries(64)
    new = gpu(rng.random(rcap) < 0.5)
    hh = gpu(u32(4, rcap))
    hh[0, :40] = 0x00800000
    sparse = gpu(rng.random(rcap) < 400 / rcap)
    sa, sb = sl.empty_slab(scap, dev), sl.empty_slab(scap, dev)
    errs = []
    for isnew, t1, t2 in ((sparse, 0xFFFFFFFF, 0xFFFFFFFF), (new, 0x00800000, 0x40000000), (new, 0xFFFFFFFF, 0xFFFFFFFF)):
        thresh = torch.tensor([t1, t2], device=dev)
        sl.capture(sa, isnew, hh[0], hh[1], hh[2], hh[3], thresh, DEVICE_STEP_CAP)
        sl.capture_plain(sb, isnew, hh[0], hh[1], hh[2], hh[3], thresh, DEVICE_STEP_CAP)
        errs.append(max_abs_err(torch, [(x[:scap], y[:scap]) for x, y in zip(sa[:4], sb[:4])] + [(sa.counts, sb.counts)]))
    check(int(sa.counts[1]) > 0, "capture parity: the flood should drop rows")
    tight = (new, torch.tensor([0x00800000, 0x40000000], device=dev))
    n_new = int(new.sum())
    n_below = int(sl.below_threshold(new, hh[0], hh[1], tight[1]).sum())

    def fresh_slab():
        return sl.empty_slab(scap, dev)

    cap_scratch = sl.capture_scratch(1, rcap, dev)
    none = torch.tensor([0, 0], device=dev)  # the common step: nothing below it

    def cap(thresh):
        return lambda sb_: sl.capture(sb_, tight[0], hh[0], hh[1], hh[2], hh[3], thresh, DEVICE_STEP_CAP,
                                      cap_scratch)

    results["sample_capture"] = dict(
        max_abs_err=max(errs),
        ms=time_device_ms(torch, cap(tight[1]), prep=fresh_slab),
        call_ms=time_ms(torch, cap(tight[1]), prep=fresh_slab),
        plain_ms=time_ms(torch, lambda sb_: sl.capture_plain(sb_, tight[0], hh[0], hh[1], hh[2], hh[3], tight[1], DEVICE_STEP_CAP), prep=fresh_slab),
        # nothing below the threshold: one pass over is_new and the new
        # candidates' h1, h2 (most steps after the first eras)
        empty_ms=time_device_ms(torch, cap(none), prep=fresh_slab),
        launches_a_call=kernels_a_call(torch, f"{label} K9a", lambda: cap(tight[1])(sa), 1),
        # is_new once, h1 and h2 of each new candidate; a captured row
        # reads depth and action and writes its 4 slab lanes.
        bytes=rcap + n_new * 16 + min(n_below, DEVICE_STEP_CAP) * 48 + 32,
        ops=rcap + n_new * 3,
        library_ms=None,
        shape=f"[{rcap}], {n_new} new, {n_below} below a tight threshold",
    )
    check(not bool(cap_scratch.any()), "K9a left its scratch set")

    # K9b: the era epilogue over a full-width slab at several occupancies,
    # with many equal keys (top_k's tie order).
    slanes = [gpu(u32(scap + 1)) for _ in range(4)]
    slanes[0][::3] = slanes[0][5]
    errs = []
    for occ in (0, 9, 700, scap):
        slab = sl.Slab(*slanes, torch.tensor([occ, 0], device=dev))
        errs.append(max_abs_err(torch, zip(sl.bottom_k(slab, sk2), sl.bottom_k_plain(slab, sk2))))
    # The largest slab the kernel takes, 40 distinct keys in all, at the
    # occupancies around the kept count.
    big = sl.SLAB_MAX_ROWS
    blanes = [gpu(u32(big + 1)) for _ in range(4)]
    blanes[0] = gpu(rng.integers(0, 40, size=big + 1) * 0x01000001)
    for occ in (0, 1, sk2 - 1, sk2, sk2 + 1, big):
        slab = sl.Slab(*blanes, torch.tensor([occ, 0], device=dev))
        errs.append(max_abs_err(torch, zip(sl.bottom_k(slab, sk2), sl.bottom_k_plain(slab, sk2))))
    del blanes
    slab = sl.Slab(*slanes, torch.tensor([700, 0], device=dev))
    skey = torch.where(torch.arange(scap, device=dev) < 700, (~slanes[0][:scap]) & 0xFFFFFFFF, 0)
    results["slab_bottomk"] = dict(
        max_abs_err=max(errs),
        ms=time_device_ms(torch, lambda _: sl.bottom_k(slab, sk2)),
        call_ms=time_ms(torch, lambda _: sl.bottom_k(slab, sk2)),
        plain_ms=time_ms(torch, lambda _: sl.bottom_k_plain(slab, sk2)),
        bytes=scap * 8 + 16 + sk2 * 4 * 8 + sk2 * (4 * 8 + 1),
        # the words, one histogram pass and the compaction over the slab,
        # then the bitonic network over the sk2 kept words
        ops=3 * scap + sk2 * (sk2.bit_length() - 1) * sk2.bit_length() // 2,
        library_ms=time_device_ms(torch, lambda _: torch.topk(skey, sk2)),
        shape=f"[{scap}] -> [{sk2}] at occupancy 700",
    )

    # K6: a path-walk batch (64 chains, as the sample rows give) against
    # the filled table, plus absent keys.
    q = torch.cat([k[:, :64], gpu(u32(2, 16))], dim=1).contiguous()
    qa = vs.lookup_parent(base, q[0], q[1])
    qb = vs.lookup_parent_plain(base, q[0], q[1])
    check(bool(qa[0][:64].all()) and not bool(qa[0][64:].any()), "lookup_parent: found set")
    results["lookup_parent"] = dict(
        max_abs_err=max_abs_err(torch, zip(qa, qb)),
        ms=time_device_ms(torch, lambda _: vs.lookup_parent(base, q[0], q[1])),
        call_ms=time_ms(torch, lambda _: vs.lookup_parent(base, q[0], q[1])),
        plain_ms=time_ms(torch, lambda _: vs.lookup_parent_plain(base, q[0], q[1])),
        bytes=80 * (16 + 17) + 64 * 16 + 16 * 8,
        ops=80 * 8,
        library_ms=None,
        shape=f"[80] in {tcap} slots at load {(fill / tcap):.3f}",
    )
    finish(results)

    # Beside the kernels: K5 (K4 over the occupied rows of a grown table)
    # and K10 (a fresh table and ring, K1 + K4 over the init rows).
    from stateright_tpu_torch.engines.era import seed

    occ = int(vs.occupied_mask(base).sum())
    grown = {}

    def rehash_into(t):
        grown["bad"] = vs.rehash(base, t)

    def rehash_plain_into(t):
        k1, k2 = vs.unpack64(base.keys)
        v1, v2 = vs.unpack64(base.parents)
        vs.insert_plain(t, k1, k2, v1, v2, vs.occupied_mask(base))

    extra = {
        "K5 rehash": dict(
            max_abs_err=None,
            ms=time_device_ms(torch, rehash_into, prep=lambda: vs.empty_table(2 * tcap, dev), syncs=True),
            call_ms=time_ms(torch, rehash_into, prep=lambda: vs.empty_table(2 * tcap, dev), reps=5),
            plain_ms=time_ms(torch, rehash_plain_into, prep=lambda: vs.empty_table(2 * tcap, dev), reps=1, warm=False),
            library_ms=None,
            bytes=tcap * 16 + occ * 24, ops=occ * 8,
            shape=f"{occ} rows of {tcap} slots into {2 * tcap}",
        ),
    }
    check(grown["bad"] == 0, "rehash left rows unresolved")
    init = gpu(np.zeros((S, 1), dtype=np.int64))

    def seed_plain(table, ring, rows, ebits):
        # `seed` through the plain versions of K1 and K4.
        h1, h2 = hash_lanes_plain(rows)
        zero = torch.zeros_like(h1)
        vs.insert_plain(table, h1, h2, zero, zero, torch.ones_like(h1, dtype=torch.bool))
        ring[:S, :rows.shape[1]] = rows
        ring[S, :rows.shape[1]] = ebits
        ring[S + 1, :rows.shape[1]] = 1

    extra["K10 seed"] = dict(
        max_abs_err=None,
        ms=time_device_ms(torch, lambda _: seed(vs.empty_table(tcap, dev), fr.empty_ring(W, qcap, dev), init, 1),
                          reps=5),
        call_ms=time_ms(torch, lambda _: seed(vs.empty_table(tcap, dev), fr.empty_ring(W, qcap, dev), init, 1), reps=5),
        plain_ms=time_ms(torch, lambda _: seed_plain(vs.empty_table(tcap, dev), fr.empty_ring(W, qcap, dev), init, 1),
                         reps=5),
        library_ms=None,
        bytes=tcap * 24 + W * (qcap + 1) * 8, ops=S * 8,
        shape=f"1 init row, {tcap}-slot table, {qcap}-row ring",
    )
    del base
    return results, extra


def k10f_case(torch, np, label, model, opts):
    """K10f (`EraProgram.seed`: the first era's params uploaded, K10 into
    the era's own table and ring, head, count, new and unresolved counts
    written on the card) on the workspace a finished run of `model` left:
    the whole call (its upload from host memory waits for the host: timed
    with `syncs`) and its device part alone (K10 and the four state
    words, `seed_ms`). Returns the timing dict `finish` bounds."""
    from stateright_tpu_torch.engines import era

    kept = []
    free = era.EraProgram.free_graph

    def keep(self):
        kept.append(self)
        free(self)

    era.EraProgram.free_graph = keep
    try:
        c, _t = bfs(model, "cuda", opts)
    finally:
        era.EraProgram.free_graph = free
    prog = kept[-1]
    init = torch.from_numpy(np.ascontiguousarray(model.init_states_array().T.astype(np.int64))).cuda()
    template = prog.state.cpu().numpy()
    S, n, plen = model.state_width, init.shape[1], template.size

    def device_part(_):
        # `EraProgram.seed` writes head and count from Python ints (a
        # pageable copy each, which waits for the host); fill_ passes them
        # as kernel arguments, so the calls queue behind the spin.
        new, unres = era.seed(prog.table, prog.ring, init, 0)
        prog.state[era.eo.P_HEAD:era.eo.P_HEAD + 1].fill_(0)
        prog.state[era.eo.P_COUNT:era.eo.P_COUNT + 1].fill_(n)
        prog.state[era.eo.P_UNIQUE].copy_(new)
        prog.state[era.eo.P_ERR].copy_(unres)

    out = dict(
        max_abs_err=None,
        ms=time_device_ms(torch, lambda _: prog.seed(init, 0, template), reps=20, syncs=True),
        seed_ms=time_device_ms(torch, device_part, reps=20),
        call_ms=time_ms(torch, lambda _: prog.seed(init, 0, template)),
        plain_ms=None,
        library_ms=None,
        bytes=plen * 8 + n * S * 8 + n * 24 + n * (S + 2) * 8 + 4 * 8, ops=n * S * 8,
        shape=f"{label}: {n} init row(s), S={S}, a params vector of {plen} words; "
              f"the run's {c.unique_state_count()}-state table",
    )
    del prog, kept, c
    torch.cuda.empty_cache()
    return out


# -- phases 3 to 7 ----------------------------------------------------------

def bfs(model, device, opts, configure=lambda b: b):
    from stateright_tpu_torch import TensorModelAdapter

    import torch

    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.monotonic()
    b = configure(TensorModelAdapter(model).checker().coverage())
    c = b.spawn_gpu_bfs(device=device, **opts).join()
    if device == "cuda":
        torch.cuda.synchronize()
    return c, time.monotonic() - t0


def two_pc(n):
    from stateright_tpu_torch.models import TwoPhaseTensor

    return TwoPhaseTensor(n)


def check_2pc(c, n):
    from stateright_tpu_torch.path import Path

    check(c.unique_state_count() == GOLDEN[n], f"2pc-{n}: {c.unique_state_count()} != {GOLDEN[n]}")
    c.assert_no_discovery("consistent")
    model = c.model()
    for name in ("abort agreement", "commit agreement"):
        path = c.assert_any_discovery(name)
        replay = Path.from_actions(model, path.into_states()[0], path.into_actions())
        check(replay is not None and replay.last_state() == path.last_state(), f"{name} path does not replay")
        check(model.property(name).condition(model, path.last_state()), f"{name} path ends elsewhere")


def check_paths(c):
    """Every discovery path (walked through K6) replays and ends where its
    property says (in representative space under symmetry); returns
    {name: length}."""
    from stateright_tpu_torch.path import Path
    from stateright_tpu_torch.tensor import CanonicalTensorAdapter

    model = CanonicalTensorAdapter(c.tm) if getattr(c, "_canon", False) else c.model()
    out = {}
    for name, path in c.discoveries().items():
        replay = Path.from_actions(model, path.into_states()[0], path.into_actions())
        check(replay is not None and replay.last_state() == path.last_state(), f"{name} path does not replay")
        check(c.discovery_classification(name) == "counterexample"
              or model.property(name).condition(model, path.last_state()), f"{name} path ends elsewhere")
        out[name] = len(path)
    return out


def counted(torch, kernels, label, fn, path=None):
    """Run fn with the launch counts set to 0 just before and read just
    after; every kernel of the path (the BFS kernels unless named) must
    have launched."""
    path = kernels.BFS_KERNELS if path is None else path
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"launches ({label}): {launches}", flush=True)
    for k in path:
        check(launches[k.name] > 0, f"kernel {k.name} was not launched on the {label} path")
    return out, launches


def per_step(launches, steps):
    """Each launched kernel's launches a step of a counted run."""
    return {k: n / max(1, steps) for k, n in launches.items() if n}


def check_k11(kernels, label, c, launches, kern, steps_key="claim_dedup", exact=True):
    """K11 on a counted run: the route the engine reports and, on the
    kernel route, its K11 kernel `kern` launched once a step (`steps_key`
    names a kernel the path launches once a step; exact=False for a
    profiled run, whose stage programs add launches of their own: at
    least once); with kern None, the plain route and no K11 launch."""
    route = c.telemetry()["expand_route"]
    k11 = {k.name: launches[k.name] for k in kernels.EXPAND_KERNELS + kernels.WALK_KERNELS}
    steps = launches[steps_key]
    if kern is None:
        check(route == "plain" and not any(k11.values()), f"{label}: route {route}, K11 launches {k11}")
    else:
        n = launches[kern.name]
        check(route == "kernel" and steps > 0 and (n == steps if exact else n >= 1),
              f"{label}: route {route}, {kern.name} launched {n} times for {steps} steps ({steps_key})")
    print(f"{label}: expand_route={route} K11 launches {k11}, {steps} steps ({steps_key})", flush=True)


def check_canon(kernels, label, c, launches, symmetric, steps_key="claim_dedup", exact=True):
    """K11c on a counted BFS run: under .symmetry() the route the engine
    reports (`telemetry()["canon_route"]`) is the kernel, launched once a
    step (at least once with exact=False: a profiled run's canon stage
    adds launches of its own); without it, None and no launch."""
    route = c.telemetry()["canon_route"]
    n, steps = launches[kernels.CANON_2PC.name], launches[steps_key]
    if symmetric:
        check(route == "kernel" and steps > 0 and (n == steps if exact else n >= steps),
              f"{label}: canon_route {route}, canon_2pc launched {n} times for {steps} steps ({steps_key})")
    else:
        check(route is None and n == 0, f"{label}: canon_route {route}, canon_2pc launched {n} times")
    print(f"{label}: canon_route={route} canon_2pc launches {n}, {steps} steps ({steps_key})", flush=True)


# -- phases 8 to 11: simulation ---------------------------------------------

def bound_of(nbytes, ops):
    """(bound ms, bound_by) of work that moves `nbytes` and does `ops`."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return max(b, o), "bytes" if b >= o else "operations"


def walk_states(torch, tm, B, L):
    """The walk states phase 8 holds K13a and K13c on (and
    scripts/kernel_times.py times them on), at the simulation widths of
    `tm` (B walks, paths of L, sampling on), each (walk, path, h1, h2):
    `era`, after one era of 64 steps from seed 0 walked without
    properties (so that no walk freezes) under a threshold that lets about
    1 in 1,000 counted states into the slab, then a seventh of the walks
    frozen, as first hits leave them; `long`, the same walks with ptr
    drawn over 0..L (every length, L itself among them), the slots above
    the era's paths drawn at random and an eighth of the active walks on
    a cycle at a slot below ptr (slot 0, ptr - 1, or one drawn between);
    `fresh`, the seeded walks (every walk on an init state at ptr 0: a
    slab of duplicates). Returns (program, states, the era's result)."""
    from stateright_tpu_torch.engines.gpu_simulation import SimProgram
    from stateright_tpu_torch.fingerprint import hash_lanes
    from stateright_tpu_torch.ops.visited_set import pack64

    dev = torch.device("cuda")
    S = tm.state_width
    prog = SimProgram(tm, [], B, L, True, 64, dev)
    walk, path = prog.seed(0)
    fresh = walk.clone()
    era = prog.era(walk, path, rec_bits=0, max_steps=64, fin_any=0, fin_all=0, fin_all_en=0,
                   target_gen=0, gen0=0, threshold=(0x00400000, 0))
    iota = torch.arange(B, device=dev)
    walk[S + 3] = (iota % 7 == 0).to(torch.int64)
    h1, h2 = hash_lanes(walk[:S])
    g = torch.Generator(device=dev)
    g.manual_seed(8)
    lwalk, lpath = walk.clone(), path.clone()
    ptr = torch.randint(0, L + 1, (B,), device=dev, generator=g)
    ptr[1:5] = torch.tensor([0, 1, L - 1, L], device=dev)
    above = torch.arange(L, device=dev)[None, :] >= walk[S + 1][:, None]
    lpath.copy_(torch.where(above, torch.randint(-(1 << 62), 1 << 62, (B, L), device=dev, generator=g), lpath))
    lwalk[S + 1] = ptr
    at = torch.randint(0, 1 << 30, (B,), device=dev, generator=g) % ptr.clamp(min=1)
    at = torch.where(iota % 24 == 3, 0, torch.where(iota % 24 == 11, ptr - 1, at))
    cyc = ((iota % 8 == 3) & (ptr > 0) & (lwalk[S + 3] == 0)).nonzero().view(-1)
    lpath[cyc, at[cyc]] = pack64(h1, h2)[cyc]
    fh1, fh2 = hash_lanes(fresh[:S])
    states = dict(era=(walk, path, h1, h2), long=(lwalk, lpath, h1, h2), fresh=(fresh, path.clone(), fh1, fh2))
    return prog, states, era


def sim_kernel_parity(torch, np, label, tm, B, L):
    """K13a-d against their plain versions at the widths the walk step
    gives them (`walk_states`): K13a on the era's walks and on the long
    paths, K13c at the loose threshold (MAX: every counted walk), the
    tight one (0x00400000, 0: the common step) and on the fresh walks, and
    near the slab's end (its trash row); K13b and K13d on the era's
    state; returns {kernel: timing dict}."""
    from stateright_tpu_torch.engines import graph
    from stateright_tpu_torch.obs.sample import slab_entries
    from stateright_tpu_torch.ops import walk as wk
    from stateright_tpu_torch.ops.expand import build_walk_step, build_walk_step_plain
    from stateright_tpu_torch.ops.slab import capture_scratch
    from stateright_tpu_torch.xp import TorchXP

    dev = torch.device("cuda")
    props = tm.tensor_properties()
    S, A, P = tm.state_width, tm.max_actions, len(props)
    sk2 = slab_entries(64)
    prog, states, era = walk_states(torch, tm, B, L)
    walk, path, h1, h2 = states["era"]
    fresh = states["fresh"][0]
    ev_mask, al_mask = wk.prop_masks(props)
    init_ebits = (1 << bin(ev_mask).count("1")) - 1
    print(f"sim widths ({label}): B={B} L={L} S={S} A={A} P={P}; state after one era: "
          f"steps={era.steps} gen={era.gen} maxd={era.maxd} frozen={int(walk[S + 3].sum())}", flush=True)
    results = {}

    # K13a on the era's walks and on the long paths: paths of every
    # length, cycles, frozen walks; with the depth histogram, and once
    # without it.
    rec = {}
    for name in ("era", "long"):
        w0, p0, a1, a2 = states[name]

        def rec_in(w0=w0, p0=p0):
            return (w0.clone(), p0.clone(), torch.zeros(5, dtype=torch.int64, device=dev),
                    torch.zeros(128, dtype=torch.int64, device=dev))

        a, b = rec_in(), rec_in()
        ra = wk.record(a1, a2, *a)
        rb = wk.record_plain(a1, a2, *b)
        err = max_abs_err(torch, zip(a + ra, b + rb))
        c, d = rec_in()[:3], rec_in()[:3]
        err = max(err, max_abs_err(torch, zip(c + wk.record(a1, a2, *c), d + wk.record_plain(a1, a2, *d, None))))
        live = w0[S + 3] == 0
        ptr_sum = int(torch.where(live, w0[S + 1].clamp(max=L), 0).sum())
        n_counted = int(ra[0].sum())
        nbytes = B * 32 + ptr_sum * 8 + B * 2 + n_counted * 16 + 128 * 8
        rec[name] = dict(
            max_abs_err=err,
            ms=time_device_ms(torch, lambda t, a1=a1, a2=a2: wk.record(a1, a2, *t), prep=rec_in),
            call_ms=time_ms(torch, lambda t, a1=a1, a2=a2: wk.record(a1, a2, *t), prep=rec_in),
            plain_ms=time_ms(torch, lambda t, a1=a1, a2=a2: wk.record_plain(a1, a2, *t), prep=rec_in, reps=5),
            bytes=nbytes, ops=ptr_sum + B * 4, library_ms=None,
            shape=f"B={B}, L={L}, {ptr_sum} path slots below ptr, {n_counted} counted ({name})",
        )
        if name == "era":
            walk1, counted, cycle = a[0], ra[0], ra[1]
        del a, b, c, d, ra, rb
    results["walk_record"] = rec["era"]
    lb, _by = bound_of(rec["long"]["bytes"], rec["long"]["ops"])
    check(rec["long"]["max_abs_err"] == 0, f"{label}: K13a disagrees with its plain version on the long paths")
    rec["era"].update(long_ms=rec["long"]["ms"], long_plain_ms=rec["long"]["plain_ms"], long_bound_ms=lb)
    print(f"kernel walk_record {rec['long']['shape']}: max_abs_err=0 ms={rec['long']['ms']:.4f} "
          f"plain_ms={rec['long']['plain_ms']} bound_ms={lb:.5f}", flush=True)

    # K13c on K13a's output (its ptr lane incremented), at the three
    # thresholds and near the slab's end, on one scratch the way the
    # program owns it: left as found, one kernel node a call.
    scap = prog.s_high + B
    scratch = capture_scratch(1, B, dev)
    loose, tight = (0xFFFFFFFF, 0xFFFFFFFF), (0x00400000, 0)
    fresh_counted = fresh[S + 3] == 0
    fh1, fh2 = states["fresh"][2:]
    cases = {"tight": ((counted, h1, h2, walk1), tight, 0), "loose": ((counted, h1, h2, walk1), loose, 0),
             "fresh": ((fresh_counted, fh1, fh2, fresh), loose, 0),
             "near the trash row": ((counted, h1, h2, walk1), loose, scap - 1000)}
    cap, slabs = {}, {}
    for name, (args, t, occ) in cases.items():
        thresh = torch.tensor(t, device=dev)  # read on the card, as the era's state holds it

        def cap_in(occ=occ):
            st = torch.zeros(5, dtype=torch.int64, device=dev)
            st[wk.OCC] = occ
            return wk.empty_walk_slab(S, scap, dev), st

        (sa, ta), (sb, tb) = cap_in(), cap_in()
        wk.capture(sa, ta, *args, thresh, scratch)
        wk.capture_plain(sb, tb, *args, thresh)
        err = max_abs_err(torch, [(sa[:, :scap], sb[:, :scap]), (ta, tb)])
        check(not bool(scratch.any()), f"{label}: K13c left its scratch set ({name})")
        n_cap, n_sel = int(ta[wk.OCC]) - occ, int(args[0].sum())
        if occ:
            check(err == 0, f"{label}: K13c disagrees with its plain version {name}")
            continue
        cap[name] = dict(
            max_abs_err=err,
            ms=time_device_ms(torch, lambda u, args=args, th=thresh: wk.capture(u[0], u[1], *args, th, scratch),
                              prep=cap_in),
            call_ms=time_ms(torch, lambda u, args=args, th=thresh: wk.capture(u[0], u[1], *args, th, scratch),
                            prep=cap_in),
            plain_ms=time_ms(torch, lambda u, args=args, th=thresh: wk.capture_plain(u[0], u[1], *args, th),
                             prep=cap_in),
            # sel once, h1 and h2 of each selected walk; a captured walk
            # reads ptr and its S lanes and writes its 3 + S slab lanes.
            bytes=B + n_sel * 16 + n_cap * ((S + 1) + (3 + S)) * 8 + 16,
            ops=B + n_cap * (3 + S), library_ms=None,
            shape=f"B={B} into a {scap}-row slab, {n_cap} captured ({name})",
        )
        slabs[name] = (sa, ta)
    n_loose = int(slabs["loose"][1][wk.OCC])
    # The kernels line's row is the loose step, as before; the tight
    # (common) step and the fresh walks stand beside it.
    results["walk_capture"] = cap["loose"]
    sc, tc = cap_in()
    tight_t = torch.tensor(tight, device=dev)  # made before the capture: a graph copies nothing from the host
    cap["loose"]["launches_a_call"] = kernels_a_call(
        torch, f"K13c ({label})", lambda: wk.capture(sc, tc, counted, h1, h2, walk1, tight_t, scratch), 1)
    for name in ("tight", "fresh"):
        b_ms, _by = bound_of(cap[name]["bytes"], cap[name]["ops"])
        check(cap[name]["max_abs_err"] == 0, f"{label}: K13c disagrees with its plain version ({name})")
        cap["loose"].update({f"{name}_ms": cap[name]["ms"], f"{name}_plain_ms": cap[name]["plain_ms"],
                             f"{name}_bound_ms": b_ms})
        print(f"kernel walk_capture {cap[name]['shape']}: max_abs_err=0 ms={cap[name]['ms']:.4f} "
              f"plain_ms={cap[name]['plain_ms']} bound_ms={b_ms:.5f}", flush=True)
    # One captured sampled simulation step: its kernel nodes, none a memset.
    nodes = graph.captured_nodes(prog._step)
    check(nodes["memsets"] == 0, f"{label}: a captured simulation step holds {nodes['memsets']} memset nodes")
    print(f"{label} simulation step: {nodes['kernels']} kernel nodes, {nodes['memsets']} memset nodes a "
          f"captured step", flush=True)
    cap["loose"]["step_nodes"] = nodes["kernels"]

    # K13b on the same step: the model's checks and successors from K11's
    # WALK, held against its plain version on the era's walks.
    xp = TorchXP(dev)
    model_step = build_walk_step(tm, props, xp)
    check(model_step.route == "kernel", f"{label}: walk route {model_step.route}")
    checks, valid, succ = model_step(walk1[:S])
    err = max_abs_err(torch, zip((checks, valid, succ), build_walk_step_plain(tm, props, xp)(walk1[:S])))
    check(err == 0, f"{label}: K11 WALK disagrees with its plain version on the era's walks")
    print(f"K11 WALK ({label}) on the era's walks: max_abs_err={err}", flush=True)

    def step_in():
        return (walk1.clone(), torch.zeros((P, B), dtype=torch.bool, device=dev),
                torch.zeros((P, B), dtype=torch.int64, device=dev),
                torch.zeros(5, dtype=torch.int64, device=dev),
                torch.zeros(A + P + 128, dtype=torch.int64, device=dev))

    def run_step(fn, t):
        fn(t[0], counted, cycle, checks, ev_mask, al_mask, valid, succ,
           prog.inits, init_ebits, L, t[1], t[2], t[3], t[4])

    a, b = step_in(), step_in()
    run_step(wk.step, a)
    run_step(wk.step_plain, b)
    err = max_abs_err(torch, zip(a, b))
    pa, pb = walk1.clone(), walk1.clone()
    pa[S + 3] = (torch.arange(B, device=dev) % 3 == 0).to(torch.int64)
    pb.copy_(pa)
    wk.restart_frozen(pa, prog.inits, init_ebits)
    wk.restart_frozen_plain(pb, prog.inits, init_ebits)
    err = max(err, max_abs_err(torch, [(pa, pb)]))
    n_adv = int(a[4][:A].sum())
    # A restart sets ptr to 0; every restarting walk had ptr >= 1.
    n_restart = int(((walk1[S + 1] > 0) & (a[0][S + 1] == 0)).sum())
    n_hits, n_newly = int(a[1].sum()), int(a[3][wk.FROZEN])
    results["walk_step"] = dict(
        max_abs_err=err,
        ms=time_device_ms(torch, lambda t: run_step(wk.step, t), prep=step_in),
        call_ms=time_ms(torch, lambda t: run_step(wk.step, t), prep=step_in),
        plain_ms=time_ms(torch, lambda t: run_step(wk.step_plain, t), prep=step_in, reps=5),
        # Every walk reads seed, ptr, ebits, frozen, counted, cycle, its P
        # checks and A valid bytes, and writes ebits; an advancing walk
        # reads its successor row and writes its S lanes; a restarting
        # walk writes S + 3 lanes (the init rows are read once); a hit
        # reads and writes hseen and writes plen; a newly frozen walk
        # writes frozen; then the counters.
        bytes=(B * (4 * 8 + 2 + P + A + 8) + n_adv * S * 16 + n_restart * (S + 3) * 8
               + prog.inits.numel() * 8 + n_hits * 10 + n_newly * 8 + (A + P + 5) * 8),
        ops=B * (P + A + 40),
        library_ms=None,
        shape=f"B={B}, S={S}, A={A}, P={P}, {n_adv} advancing, {n_restart} restarting, {n_hits} hits",
    )
    del succ, checks, valid

    # K13d over the era's slab (distinct states, the gate's high-water
    # occupancy) and over the fresh walks' slab (one state B times).
    errs = []
    for name in ("loose", "fresh", "tight"):
        sa, ta = slabs[name]
        errs.append(max_abs_err(torch, zip(wk.slab_bottom_k(sa, ta, sk2), wk.slab_bottom_k_plain(sa, ta, sk2))))
    sa, ta = slabs["loose"]
    sorts = -(-scap // 4096)
    n = sorts * sk2
    while n > 4096:
        sorts += -(-n // 4096)
        n = -(-n // 4096) * sk2
    if scap > 4096:
        sorts += 1
    results["walk_slab"] = dict(
        max_abs_err=max(errs),
        ms=time_device_ms(torch, lambda _: wk.slab_bottom_k(sa, ta, sk2)),
        call_ms=time_ms(torch, lambda _: wk.slab_bottom_k(sa, ta, sk2)),
        plain_ms=time_ms(torch, lambda _: wk.slab_bottom_k_plain(sa, ta, sk2)),
        bytes=n_loose * 16 + sk2 * (3 + S) * 16 + sk2,
        ops=n_loose * 12 + sorts * 4096 * 12 * 13 // 2,
        library_ms=None,
        shape=f"{n_loose} used of {scap} rows -> [{3 + S}, {sk2}] ({sorts} block sorts)",
    )
    del slabs, sa, ta, sc, tc, walk, path, walk1, fresh, states, prog
    torch.cuda.empty_cache()
    return finish(results)


def simulate(model, device, seed, configure, opts):
    from stateright_tpu_torch import TensorModelAdapter

    import torch

    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.monotonic()
    c = configure(TensorModelAdapter(model).checker()).spawn_gpu_simulation(seed, device=device, **opts).join()
    if device == "cuda":
        torch.cuda.synchronize()
    return c, time.monotonic() - t0


def sim_dict(c):
    """What must be equal on cuda and on cpu: counts, every discovery path,
    coverage, the sample and the era structure."""
    tel = c.telemetry()
    return dict(
        states=c.state_count(), max_depth=c.max_depth(),
        paths={k: v.encode(c.model()) for k, v in c.discoveries().items()},
        coverage=c.coverage(), sample=tuple(c._sampler.fingerprints()),
        steps=tel["steps"], eras=tel["eras"],
    )


def sim_line(label, c, wall, card, peak=None):
    tel = c.telemetry()
    mem = f" max_memory_allocated={peak}" if peak is not None else ""
    print(f"{label}: generated={c.state_count()} wall_secs={wall:.3f} "
          f"generated_states_per_sec={c.state_count() / wall:.1f} steps_per_sec={tel['steps'] / wall:.2f} "
          f"eras={tel['eras']} steps={tel['steps']} steps_run={tel['steps_run']} "
          f"run_steps_per_sec={tel['steps_run'] / wall:.2f} max_depth={c.max_depth()}{mem} "
          f"graph_captures={tel['graph_captures']} capture_secs={tel['capture_secs']:.3f} "
          f"era_readbacks={tel['readbacks']} path_readbacks={tel.get('path_readbacks', 0)} "
          f"discoveries={sorted(c._discovery_paths)} card={card}", flush=True)



# -- phases 12 to 14: multiplexed lanes -------------------------------------

def lane_kernel_parity(torch, np, N, C, A, S, tcap, qcap, dedup_for=None):
    """The lane forms of K2, K3, K4, K6 and K7 against their plain
    versions at the widths one lane step of N lanes of a model with C, A,
    S gives them (tables [N, tcap], rings [N, S + 2, qcap]; `dedup_for`:
    the dedup scratch's width from vcap where it is not the lanes'), each
    also at one lane against its solo call; returns {entry name: timing
    dict}."""
    from stateright_tpu_torch.engines.gpu_bfs import widths
    from stateright_tpu_torch.ops import frontier as fr
    from stateright_tpu_torch.ops import visited_set as vs

    dev = torch.device("cuda")
    W = S + 2
    vcap, rcap, dedup_cap = widths(A, C)
    print(f"lane widths: N={N} C={C} A={A} S={S} vcap={vcap} rcap={rcap} dedup_cap={dedup_cap} "
          f"tables [{N}, 2^{tcap.bit_length() - 1}] ({N * tcap * 24} bytes) "
          f"rings [{N}, {W}, 2^{qcap.bit_length() - 1}] ({N * W * (qcap + 1) * 8} bytes)", flush=True)
    rng = np.random.default_rng(12)
    results = {}

    def gpu(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def u32(*shape):
        return rng.integers(1, 1 << 32, size=shape, dtype=np.uint64).astype(np.int64)

    def solo_equal(pairs):
        check(max_abs_err(torch, pairs) == 0, "a lane form at one lane differs from the solo call")

    # K2: the step's action-major validity mask [A, N, C] read as [N, A, C]
    # (about a third valid) -> vcap, and the dedup mask [N, vcap] -> rcap.
    amask = gpu(rng.random((A, N, C)) < 0.3)
    view = amask.transpose(0, 1)
    reps = gpu(rng.random((N, vcap)) < 0.35)
    errs = [max_abs_err(torch, zip(vs.compact_ids_lanes(m, cap), vs.compact_ids_lanes_plain(m, cap)))
            for m, cap in ((view, vcap), (reps, rcap))]
    solo_equal(zip(vs.compact_ids_lanes(view[:1], vcap), (x[None] for x in vs.compact_ids(view[0].reshape(-1), vcap))))
    results["compact_ids_lanes"] = dict(
        max_abs_err=max(errs),
        launches_a_call=kernels_a_call(torch, "K2 lanes", lambda: vs.compact_ids_lanes(view, vcap), 2),
        ms=time_device_ms(torch, lambda _: vs.compact_ids_lanes(view, vcap)),
        call_ms=time_ms(torch, lambda _: vs.compact_ids_lanes(view, vcap)),
        plain_ms=time_ms(torch, lambda _: vs.compact_ids_lanes_plain(view, vcap)),
        bytes=N * A * C + N * vcap * 9 + N * 8,
        ops=N * A * C,
        library_ms=time_device_ms(torch, lambda _: torch.nonzero(view), syncs=True),
        shape=f"[{A}, {N}, {C}] as [{N}, {A}*{C}] -> [{N}, {vcap}]",
    )

    # K3: [N, vcap] candidates, each lane's valid prefix, on the program's
    # scratch (the mesh's dedup scratch at its shards: mesh.dedup_cap_for);
    # at one lane against the solo call.
    if dedup_for is not None:
        dedup_cap = dedup_for(vcap)
    results["claim_dedup_lanes"] = k3_case(torch, np, rng, N, vcap, dedup_cap, lanes=True)
    pick = rng.integers(0, 64, size=(2, vcap))
    h1, h2 = gpu(pick[0]), gpu(pick[1])
    n1 = torch.tensor(vcap // 2, device=dev)
    valid = torch.arange(vcap, device=dev) < n1
    solo_equal([(fr.claim_dedup_lanes(h1[None], h2[None], valid[None], dedup_cap, n1[None])[0],
                 fr.claim_dedup(h1, h2, valid, dedup_cap, n1))])
    del h1, h2, valid, amask, view, reps

    # K4: each lane's table filled to the load a finished 2pc-5 lane has
    # (8,832 of 2^16), then an [N, rcap] batch of found keys, new keys and
    # in-batch duplicates with other parents.
    base = vs.empty_table(tcap, dev, lanes=N)
    fill = 8832 - rcap
    k = gpu(u32(2, N, fill))
    vs.insert_lanes(base, k[0], k[1], k[0], k[1], torch.ones((N, fill), dtype=torch.bool, device=dev))
    old = gpu(rng.integers(0, fill, size=(N, rcap // 3)))
    bh = torch.cat([k.gather(2, old[None].expand(2, N, -1)), gpu(u32(2, N, rcap - rcap // 3))], dim=2)
    bh = bh[:, :, gpu(rng.permutation(rcap))].contiguous()
    bh[:, :, rcap - 200:] = bh[:, :, rcap - 400:rcap - 200]
    p = gpu(u32(2, N, rcap))
    act = gpu(rng.random((N, rcap)) < 0.95)

    def clone(t):
        return vs.VisitedTable(t.keys.clone(), t.parents.clone(), t.stamps.clone(), t.epoch)

    def dump(t):
        order = torch.argsort(t.keys, dim=1)
        return t.keys.gather(1, order), t.parents.gather(1, order)

    ta, tb = clone(base), clone(base)
    out_a = vs.insert_lanes(ta, bh[0], bh[1], p[0], p[1], act)
    out_b = vs.insert_lanes_plain(tb, bh[0], bh[1], p[0], p[1], act)
    err = max_abs_err(torch, list(zip(out_a, out_b)) + list(zip(dump(ta), dump(tb))))
    n_new, n_act = int(out_a[0].sum()), int(act.sum())
    check(n_new > 0 and int(out_a[1].sum()) == 0, "lane insert batch: expected new keys and no unresolved")
    del tb
    one = vs.VisitedTable(base.keys[:1].clone(), base.parents[:1].clone(), base.stamps[:1].clone(), base.epoch)
    solo = vs.VisitedTable(base.keys[0].clone(), base.parents[0].clone(), base.stamps[0].clone(), base.epoch)
    # Same key -> parent map; which of two keys contending for one empty
    # slot takes it is the CAS order's, so the slot layout may differ.
    solo_equal(list(zip((x[0] for x in vs.insert_lanes(one, bh[0, :1], bh[1, :1], p[0, :1], p[1, :1], act[:1])),
                        vs.insert(solo, bh[0, 0], bh[1, 0], p[0, 0], p[1, 0], act[0])))
               + list(zip(dump(one), dump(vs.VisitedTable(solo.keys[None], solo.parents[None], solo.stamps[None])))))
    results["visited_insert_lanes"] = dict(
        max_abs_err=err,
        ms=time_device_ms(torch, lambda t: vs.insert_lanes(t, bh[0], bh[1], p[0], p[1], act), prep=lambda: clone(base)),
        call_ms=time_ms(torch, lambda t: vs.insert_lanes(t, bh[0], bh[1], p[0], p[1], act), prep=lambda: clone(base), reps=10),
        plain_ms=time_ms(torch, lambda t: vs.insert_lanes_plain(t, bh[0], bh[1], p[0], p[1], act),
                         prep=lambda: clone(base), reps=3),
        launches_a_call=kernels_a_call(torch, "K4 lanes", lambda: vs.insert_lanes(ta, bh[0], bh[1], p[0], p[1], act), 3),
        bytes=N * rcap * (4 * 8 + 1 + 2) + n_act * 8 + n_new * 16,
        ops=n_act * 8,
        library_ms=None,
        shape=f"[{N}, {rcap}] into [{N}, {tcap}] at load {8832 / tcap:.3f}",
    )
    del ta, one, solo

    # K6: the path walks of every lane's two discoveries (2,048 chains of
    # 1,024 lanes), plus absent keys.
    nq = 2 * N
    lane = gpu(np.repeat(np.arange(N), 2))
    q = torch.stack([k[0, :, :2].reshape(-1), k[1, :, :2].reshape(-1)])
    q = torch.cat([q, gpu(u32(2, 64))], dim=1).contiguous()
    qlane = torch.cat([lane, torch.arange(64, device=dev) % N])
    qa = vs.lookup_parent_lanes(base, qlane, q[0], q[1])
    err = max_abs_err(torch, zip(qa, vs.lookup_parent_lanes_plain(base, qlane, q[0], q[1])))
    check(bool(qa[0][:nq].all()) and not bool(qa[0][nq:].any()), "lane lookup_parent: found set")
    solo = vs.VisitedTable(base.keys[3], base.parents[3], base.stamps[3])
    solo_equal(zip(vs.lookup_parent_lanes(base, torch.full_like(qlane, 3), q[0], q[1]),
                   vs.lookup_parent(solo, q[0], q[1])))
    results["lookup_parent_lanes"] = dict(
        max_abs_err=err,
        ms=time_device_ms(torch, lambda _: vs.lookup_parent_lanes(base, qlane, q[0], q[1])),
        call_ms=time_ms(torch, lambda _: vs.lookup_parent_lanes(base, qlane, q[0], q[1])),
        plain_ms=time_ms(torch, lambda _: vs.lookup_parent_lanes_plain(base, qlane, q[0], q[1])),
        bytes=(nq + 64) * (16 + 8 + 17) + nq * 16 + 64 * 8,
        ops=(nq + 64) * 8,
        library_ms=None,
        shape=f"[{nq + 64}] queries in [{N}, {tcap}]",
    )
    del base, k, bh, p, act

    # K7: pop C rows of every lane at heads that wrap, and append [N, rcap]
    # candidates (about 40% new) at tails that wrap.
    rings = fr.empty_ring(W, qcap, dev, lanes=N)
    rings[:, :, :qcap] = torch.randint(0, 1 << 32, (N, W, qcap), device=dev)
    heads = gpu(rng.integers(qcap - C, qcap, size=N))
    cand = torch.randint(0, 1 << 32, (W, N * rcap), device=dev)
    cvalid = gpu(rng.random((N, rcap)) < 0.4)
    ra, rb = rings.clone(), rings.clone()
    fr.ring_scatter_lanes(ra, heads, cand, cvalid)
    fr.ring_scatter_lanes_plain(rb, heads, cand, cvalid)
    err = max_abs_err(torch, [(fr.ring_pop_lanes(rings, heads, C), fr.ring_pop_lanes_plain(rings, heads, C))])
    err_app = max_abs_err(torch, [(ra[..., :qcap], rb[..., :qcap])])
    del rb
    solo = rings[5].clone()
    fr.ring_scatter(solo, int(heads[5]), cand[:, 5 * rcap:6 * rcap].contiguous(), cvalid[5])
    solo_equal([(fr.ring_pop_lanes(rings[5:6], heads[5:6], C), fr.ring_pop(rings[5], int(heads[5]), C)),
                (solo[:, :qcap], ra[5, :, :qcap])])
    del ra, solo
    n_app = int(cvalid.sum())
    idx = ((heads[:, None] + torch.arange(C, device=dev)) & (qcap - 1))[:, None, :].expand(N, W, C)
    lane_w = (torch.arange(N, device=dev)[None, :, None] * (W * (qcap + 1))
              + torch.arange(W, device=dev)[:, None, None] * (qcap + 1))

    def torch_append(_):
        # The same work as the append: rank each lane's mask (cumsum),
        # valid columns to tail + rank, the others to the trash column.
        rank = torch.cumsum(cvalid, 1) - 1
        pos = torch.where(cvalid, (heads[:, None] + rank) & (qcap - 1), qcap)
        rings.view(-1).index_copy_(0, (lane_w + pos[None]).reshape(-1), cand.view(-1))

    results["ring_lanes"] = dict(
        max_abs_err=err,
        ms=time_device_ms(torch, lambda _: fr.ring_pop_lanes(rings, heads, C)),
        call_ms=time_ms(torch, lambda _: fr.ring_pop_lanes(rings, heads, C)),
        plain_ms=time_ms(torch, lambda _: fr.ring_pop_lanes_plain(rings, heads, C)),
        bytes=2 * W * N * C * 8 + N * 8, ops=W * N * C,
        library_ms=time_device_ms(torch, lambda _: rings.gather(2, idx)),
        shape=f"pop [{W}, {N}*{C}] from [{N}, {W}, 2^{qcap.bit_length() - 1}] (gather)",
    )
    results["ring_append_lanes"] = dict(
        max_abs_err=err_app,
        ms=time_device_ms(torch, lambda _: fr.ring_scatter_lanes(rings, heads, cand, cvalid)),
        call_ms=time_ms(torch, lambda _: fr.ring_scatter_lanes(rings, heads, cand, cvalid)),
        plain_ms=time_ms(torch, lambda _: fr.ring_scatter_lanes_plain(rings, heads, cand, cvalid)),
        bytes=N * rcap + 2 * W * n_app * 8 + N * 8, ops=N * rcap + W * n_app,
        library_ms=time_device_ms(torch, torch_append),
        shape=f"append [{W}, {N}*{rcap}] ({n_app} valid) (cumsum + where + index_copy_)",
    )
    del rings, cand, cvalid, idx, lane_w
    torch.cuda.empty_cache()
    return finish(results)


def lane_dict(c):
    """What must be equal lane by lane on cuda and on cpu."""
    tel = c.telemetry()
    return dict(
        unique=c.unique_state_count(), states=c.state_count(), max_depth=c.max_depth(),
        discovery_fps=dict(c._discovery_fps), coverage=c.coverage(),
        steps=tel["steps"], partial_steps=tel["partial_steps"],
        paths={k: v.encode(c.model()) for k, v in c.discoveries().items()},
    )


def lanes(model, configs, device, shape):
    """run_multiplexed over one builder a config, timed to the end of the
    card's work."""
    import torch

    from stateright_tpu_torch import TensorModelAdapter
    from stateright_tpu_torch.engines.multiplex import run_multiplexed

    builders = [cfg(TensorModelAdapter(model).checker()) for cfg in configs]
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.monotonic()
    out = run_multiplexed(builders, device=device, **shape)
    if device == "cuda":
        torch.cuda.synchronize()
    return out, time.monotonic() - t0


def cpu_lanes(torch, model, configs, shape):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return lanes(model, configs, "cpu", shape)
    finally:
        torch.set_num_threads(threads)


def solo_like(model, configure, shape, device="cuda"):
    """The solo engine on one lane's check: the lane's chunk, queue and
    table, no sampling, one era."""
    from stateright_tpu_torch import TensorModelAdapter

    return configure(TensorModelAdapter(model).checker().coverage().sample(False)).spawn_gpu_bfs(
        device=device, chunk_size=shape["chunk"], queue_capacity=shape["queue_capacity"],
        table_capacity=shape["table_capacity"], sync_steps=1 << 20,
    ).join()


def serial_solo_rate(torch, make_model, runs, opts):
    """bench.py's serial baseline (:1575-1591) on the card: one solo run
    over a fresh model instance for each (configure, golden unique count,
    weight) of `runs`, one after another; checks/s of that mix, each run
    counted `weight` times."""
    from stateright_tpu_torch import TensorModelAdapter

    secs = 0.0
    for configure, golden, weight in runs:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        c = configure(TensorModelAdapter(make_model()).checker()).spawn_gpu_bfs(**opts).join()
        torch.cuda.synchronize()
        secs += weight * (time.monotonic() - t0)
        check(c.unique_state_count() == golden, f"serial solo run: {c.unique_state_count()} != {golden}")
    return sum(w for _c, _g, w in runs) / secs


def sweep(torch, kernels, label, make_model, configs, shape, card, k11):
    """Phase 14's measurement of one lane sweep: a cold run (the warm lane
    program's build and graph capture), then a counted and timed warm run
    (launches from 0, peak memory); phase 16 profiles it in a fresh
    process. Prints and returns (lane checkers, launches, stats)."""
    _cold, t_cold = lanes(make_model(), configs, "cuda", shape)
    del _cold
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()  # the warm workspace and what earlier phases hold
    (out, wall), launches = counted(torch, kernels, label, lambda: lanes(make_model(), configs, "cuda", shape),
                                    kernels.LANE_KERNELS)
    peak = torch.cuda.max_memory_allocated()
    check_k11(kernels, label, out[0], launches, k11, "claim_dedup_lanes")
    tm = make_model()
    workspace = shape["lanes"] * (shape["table_capacity"] * 24
                                  + (tm.state_width + 2) * (shape["queue_capacity"] + 1) * 8)
    n = len(out)
    tel = out[0].telemetry()
    batch_steps = tel["batch_steps"]
    unique = sum(c.unique_state_count() for c in out)
    states = sum(c.state_count() for c in out)
    stats = dict(
        label=label, lanes=n, wall_secs=wall, cold_wall_secs=t_cold, checks_per_sec=n / wall,
        unique_states_per_sec=unique / wall, generated_states_per_sec=states / wall,
        unique=unique, states=states, batch_steps=batch_steps, batch_secs=tel["device_era_secs"],
        lane_steps_max=max(c.telemetry()["steps"] for c in out),
        partial_steps=sum(c.telemetry()["partial_steps"] for c in out),
        graph_captures=tel["graph_captures"], capture_secs=tel["capture_secs"],
        batch_readbacks=tel["batch_readbacks"],
        wall_ms_per_step=wall * 1e3 / batch_steps,
        kernel_launches_per_step=sum(launches[k.name] for k in kernels.LANE_KERNELS) / batch_steps,
        max_memory_allocated=peak, memory_allocated_before=before, run_peak_over_before=peak - before,
        lane_workspace_bytes=workspace, card=card,
    )
    print(f"{label}: {json.dumps(stats)}", flush=True)
    return out, launches, stats


# -- phase 15: device-resident eras ------------------------------------------

# The pipeline settings of phase 15's runs, and the (depth, fuse) sweep of
# tests/test_pipeline.py:161 with the serial dispatch loop (None).
PIPES = {
    "default": lambda b: b,
    "serial": lambda b: b.pipeline(False),
    "depth 4, fuse 4": lambda b: b.pipeline(depth=4, fuse=4),
}
PIPE_SWEEP = [None, (1, 1), (2, 1), (4, 1), (4, 4)]


def era_ops(torch, op, device=None):
    """K8f COMMIT's operands `op` with first-hit lanes of their own (COMMIT
    writes them), on `device` (None: where they are)."""
    from stateright_tpu_torch.ops import era as eo

    moved = op if device is None else type(op)(
        *(None if t is None else t.to(device) for t in op[:5]), [h.to(device) for h in op.hits],
        op.valid.to(device), op.ddepth.to(device), tuple(r.to(device) for r in op.rows), op.first)
    return moved._replace(first=eo.FirstHits(*(t.to(device or t.device, copy=True) for t in op.first)))


def commit_bytes(torch, op, P, C, A, m, N, L):
    """The bytes COMMIT must move on these operands: each lane's masks,
    hits and valid mask read once, the depth of each new insert, and each
    hit's hseen byte, read once, the hashes and depth of each first hit
    read and its four first-hit lanes written once, each state row read
    and written."""
    hits = firsts = 0
    if P:
        h = torch.stack(list(op.hits)).view(P, -1)
        hits, firsts = int(h.sum()), int((h & ~op.first.hseen).sum())
    return N * (2 * m + P * C + A * C + 2 * 8 * L) + 8 * int(op.c_new.sum()) + hits + 49 * firsts


# The kernel nodes of one captured step on the tree before K3 lost its
# memset and K15f's COMMIT took in the mesh step's first-hit, coverage and
# histogram launches, and how far each must have fallen since:
# `scripts/kernel_times.py --rows step_nodes` on that tree and this one,
# one H100 80GB HBM3 at 700 W. K3's memset was a memset node, not a
# kernel node: no step may hold a memset node now. The 8-shard step lost
# the 18 torch launches of its glue.
PARENT_STEP_NODES = {"solo": 35, "lanes": 42, "mesh": 60}
STEP_NODES_FALL = {"solo": 0, "lanes": 0, "mesh": 18}


def step_nodes(torch, label, program, kind):
    """The kernel nodes of one captured step of `program` (its `_step`,
    gate closed: a capture runs nothing), printed beside the parent
    tree's and checked to have fallen by STEP_NODES_FALL, with no memset
    node."""
    from stateright_tpu_torch.engines import graph

    nodes = graph.captured_nodes(program._step)
    print(f"{label}: {nodes['kernels']} kernel nodes and {nodes['memsets']} memset nodes a captured step "
          f"({nodes['nodes']} nodes; the parent tree's step: {PARENT_STEP_NODES[kind]} kernel nodes)", flush=True)
    check(nodes["kernels"] <= PARENT_STEP_NODES[kind] - STEP_NODES_FALL[kind] and nodes["memsets"] == 0,
          f"{label}: {nodes['kernels']} kernel nodes a step ({nodes['memsets']} memset nodes), not "
          f"{STEP_NODES_FALL[kind]} fewer than {PARENT_STEP_NODES[kind]} with no memset")
    return nodes["kernels"]


def era_kernel_parity(torch, np, label, tm, C, qcap):
    """K8f's two kernels against their plain versions on the same card
    tensors, at the widths one era of `tm` at chunk C gives them (the
    insert masks rcap wide, the hits [P, C], the valid mask [A, C], the
    first-hit lanes [P, C], a qcap-row ring, sampling on, fuse 4): the
    step kernel's START, BEGIN and COMMIT (clean, overflow, an unresolved
    single row; COMMIT folds the first hits, the coverage counts and the
    depth histogram) and the epilogue over sparse first hits with depth
    ties, under each budget rule; the kernel nodes of one captured step;
    returns {kernel: timing dict} (the COMMIT and the epilogue timed)."""
    from torch_era_ops import random_operands

    from stateright_tpu_torch.engines import era
    from stateright_tpu_torch.ops import era as eo

    dev = torch.device("cuda")
    rng = np.random.default_rng(15)
    props = tm.tensor_properties()
    P, A = len(props), tm.max_actions
    prog = era.EraProgram(tm, props, C, qcap, 1 << 12, False, True, 64, 4, dev)
    c, x, n = prog.cfg, prog.plen, prog.rcap
    L = x + eo.X_LEN
    print(f"era widths ({label}): C={C} A={A} P={P} vcap={prog.vcap} rcap={n} state words={L} "
          f"ring=2^{qcap.bit_length() - 1}", flush=True)

    def state(count, steps=3, max_steps=64, cap=64, rec=0, k=0, loose=True):
        s = rng.integers(0, 1 << 20, size=L).astype(np.int64)
        s[:eo.P_LEN] = [int(rng.integers(0, qcap)), count, 10 ** 6, rec, 0xFFFFFFFF, 2 * 10 ** 6,
                        qcap - C * A, max_steps, 5, 7, 2, 0, C, 1 << (P - 1), 0, 0, cap]
        s[prog.s_base:prog.s_base + 2] = 0xFFFFFFFF if loose else 1 << 20
        s[prog.f_base] = 4
        s[x + eo.X_ESTEPS], s[x + eo.X_REC0], s[x + eo.X_K] = steps, rec, k
        s[x + eo.X_OPEN], s[x + eo.X_TAKE] = 1, min(count, C)
        return torch.from_numpy(s).to(dev)

    def slab():
        sb = [torch.from_numpy(rng.integers(0, 1 << 32, size=c.scap + 1)).to(dev) for _ in range(4)]
        from stateright_tpu_torch.ops.slab import Slab

        return Slab(*sb, torch.tensor([int(rng.integers(0, 600)), 3], device=dev))

    def operands(n_val, n_d, unres):
        op = random_operands(rng, 1, C, A, P, n, 0, 0, unres=unres, hit=0.002, seen=0.3, solo=True,
                             device=dev)
        return op._replace(n_val=torch.tensor(n_val, device=dev), n_d=torch.tensor(n_d, device=dev))

    def clone_slab(sb):
        return type(sb)(*(t.clone() for t in sb))

    scratch, epi_scratch = eo.step_scratch(1, P, A, dev), eo.epilogue_scratch(1, P, C, dev)
    epi0 = epi_scratch.clone()
    errs = []
    commit_cases = [
        (state(3 * C), operands(prog.vcap // 2, n // 2, 0.0)),
        (state(3 * C), operands(prog.vcap + 1, n // 2, 0.0)),
        (state(3 * C), operands(prog.vcap // 2, n + 1, 0.0)),
        (state(1), operands(5, 5, 0.001)),
    ]
    for mode in (eo.START, eo.BEGIN, eo.COMMIT):
        for st, step in commit_cases:
            sb = slab()
            sa, sb_, ea = st.clone(), st.clone(), torch.ones(1, dtype=torch.int64, device=dev)
            eb = ea.clone()
            la, lb = clone_slab(sb), clone_slab(sb)
            oa, ob = era_ops(torch, step), era_ops(torch, step)
            eo.era_step(mode, c, sa, oa, la, ea, scratch=scratch)
            eo.era_step_plain(mode, c, sb_, ob, lb, eb)
            errs.append(max_abs_err(torch, [(sa, sb_), (ea, eb)] + list(zip(la, lb)) + list(zip(oa.first, ob.first))))
    check(not bool(scratch.any()), f"{label}: COMMIT left its scratch set")
    st, step = commit_cases[0]
    sb = slab()

    def fresh():
        return st.clone(), era_ops(torch, step)

    results = {"era_step": dict(
        max_abs_err=max(errs),
        ms=time_device_ms(torch, lambda a: eo.era_step(eo.COMMIT, c, a[0], a[1], sb, prog.epoch, scratch=scratch),
                          prep=fresh),
        call_ms=time_ms(torch, lambda a: eo.era_step(eo.COMMIT, c, a[0], a[1], sb, prog.epoch, scratch=scratch),
                        prep=fresh),
        plain_ms=time_ms(torch, lambda a: eo.era_step_plain(eo.COMMIT, c, a[0], a[1], sb, prog.epoch),
                         prep=fresh, reps=5),
        launches_a_call=kernels_a_call(torch, f"{label} K8f COMMIT",
                                       lambda: eo.era_step(eo.COMMIT, c, st, step, sb, prog.epoch,
                                                           scratch=scratch), 1),
        bytes=commit_bytes(torch, step, P, C, A, n, 1, L), ops=2 * n + (P + A) * C,
        library_ms=None, shape=f"COMMIT over [{n}] insert masks, [{P}, {C}] hits, [{A}, {C}] valid, "
                               f"{L} state words",
    )}
    prog.state[x + eo.X_OPEN] = 0
    prog.state[x + eo.X_TAKE] = 0
    prog._step()  # every lazy initialisation before the capture
    results["era_step"]["step_nodes"] = step_nodes(torch, f"{label} BFS step (sampled, coverage)", prog, "solo")

    def lanes(density):
        hseen = torch.from_numpy(rng.random((P, C)) < density).to(dev)
        depth = torch.from_numpy(rng.integers(5, 9, size=(P, C))).to(dev)
        f1, f2 = (torch.from_numpy(rng.integers(0, 1 << 32, size=(P, C))).to(dev) for _ in range(2))
        return hseen, f1, f2, depth

    errs = []
    epi_cases = [
        (state(3 * C, steps=64, max_steps=64, k=0), 0.01),          # budget-only: double, fuse on
        (state(qcap, steps=10, max_steps=64, k=1), 0.001),          # ring pressure: halve
        (state(0, steps=10, max_steps=64, cap=0, k=3), 0.0),        # frontier exhausted, cap 0
        (state(3 * C, steps=64, max_steps=64, rec=1 << (P - 1), k=2), 0.02),  # finish ANY met
    ]
    for st, density in epi_cases:
        ins = lanes(density)
        counts = torch.tensor([int(rng.integers(0, 600)), 0], device=dev)
        a = [st.clone()] + [t.clone() for t in ins]
        b = [st.clone()] + [t.clone() for t in ins]
        eo.era_epilogue(c, a[0], *a[1:], prog.ring[tm.state_width + 1], counts, scratch=epi_scratch)
        eo.era_epilogue_plain(c, b[0], *b[1:], prog.ring[tm.state_width + 1], counts)
        errs.append(max_abs_err(torch, list(zip(a, b))))
    check(torch.equal(epi_scratch[:P + 1], epi0[:P + 1]), f"{label}: the epilogue left its minima or ticket set")
    st, density = epi_cases[0]
    ins = lanes(density)
    counts = torch.tensor([100, 0], device=dev)
    depth_lane = prog.ring[tm.state_width + 1]

    def prep():
        return [st.clone()] + [t.clone() for t in ins]

    idle = prep()  # the capture that counts a call's nodes runs nothing
    results["era_epilogue"] = dict(
        max_abs_err=max(errs),
        ms=time_device_ms(torch, lambda a: eo.era_epilogue(c, a[0], *a[1:], depth_lane, counts, scratch=epi_scratch),
                          prep=prep),
        call_ms=time_ms(torch, lambda a: eo.era_epilogue(c, a[0], *a[1:], depth_lane, counts, scratch=epi_scratch),
                          prep=prep),
        plain_ms=time_ms(torch, lambda a: eo.era_epilogue_plain(c, a[0], *a[1:], depth_lane, counts),
                         prep=prep, reps=5),
        launches_a_call=kernels_a_call(torch, f"{label} K8f epilogue",
                                       lambda: eo.era_epilogue(c, *idle, depth_lane, counts,
                                                               scratch=epi_scratch), 1),
        # hseen and faccd read, the four first-hit lanes written (zeroed),
        # the state read and written
        bytes=P * C * (1 + 8) + P * C * (1 + 3 * 8) + 2 * 8 * L, ops=2 * P * C,
        library_ms=None, shape=f"[{P}, {C}] first-hit lanes, {L} state words",
    )
    del prog
    return finish(results)


# -- phase 16: simulation eras and lane batches as graphs ---------------------

def walk_era_parity(torch, np, label, tm, B, L):
    """K13f's three modes against the plain version on the same card
    tensors, at the simulation widths of `tm` (B walks, paths of L, the
    sample on), on the state and first-hit lanes of a real era (16 steps
    from seed 0): BEGIN under drawn era inputs, COMMIT under each exit
    (the budget, a finish mask, the target, the slab's high-water mark,
    every walk frozen) and the EPILOGUE; returns {"walk_era": timing
    dict} (COMMIT timed: the per-step launch; BEGIN and the EPILOGUE
    beside it)."""
    from stateright_tpu_torch.engines.gpu_simulation import SimProgram
    from stateright_tpu_torch.ops import walk_era as we

    dev = torch.device("cuda")
    props = tm.tensor_properties()
    prog = SimProgram(tm, props, B, L, True, 64, dev)
    walk, path = prog.seed(0)
    era = prog.era(walk, path, rec_bits=0, max_steps=16, fin_any=0, fin_all=0, fin_all_en=0,
                   target_gen=0, gen0=0)
    c, x = prog.cfg, prog.cfg.x
    P = len(props)
    hits = int(prog.hseen.sum())
    print(f"walk-era widths ({label}): B={B} L={L} P={P} state words={c.length}; the era: steps={era.steps} "
          f"gen={era.gen} first hits={hits}", flush=True)
    rng = np.random.default_rng(16)
    M = 0xFFFFFFFF
    errs = []

    def inputs():
        return torch.tensor([int(rng.integers(0, 1 << P)), int(rng.integers(0, 70)), int(rng.integers(0, 1 << P)),
                             int(rng.integers(0, 1 << P)), int(rng.integers(0, 2)), int(rng.choice([0, 10 ** 6])),
                             int(rng.integers(0, 10 ** 6)), 0, 0, 0, 0, M, M], device=dev)

    def both(mode, st, stats=None, era_in=None):
        a = [st.clone(), prog.hseen.clone(), prog.plen.clone()]
        b = [st.clone(), prog.hseen.clone(), prog.plen.clone()]
        for t in (a, b):
            if stats is not None:
                t[0][x:x + 5] = torch.tensor(stats, device=dev)
                t[0][x + we.X_OPEN] = 1
        we.walk_era(mode, c, a[0], era_in, a[1], a[2])
        we.walk_era_plain(mode, c, b[0], era_in, b[1], b[2])
        errs.append(max_abs_err(torch, zip(a, b)))
        return a[0]

    st = prog.state.clone()
    for _ in range(4):
        both(we.BEGIN, st, era_in=inputs())
    # The COMMIT cases: open, the slab past its high-water mark, a finish
    # mask met, every walk frozen, the target reached, the budget spent.
    commit_st = st.clone()
    commit_st[we.P_MAX_STEPS], commit_st[x + we.X_STEPS] = 16, 3
    commit_st[we.P_FIN_ANY], commit_st[we.P_TARGET_GEN], commit_st[we.P_GEN0] = 2, 5 * 10 ** 6, 0
    high = prog.s_high
    for stats in ((5, 0, 0, 3, 0), (5, high + 1, 0, 3, 0), (5, 0, 2, 3, 0), (5, 0, 0, 3, B), (10 ** 7, 0, 0, 3, 0)):
        both(we.COMMIT, commit_st, stats)
    spent = commit_st.clone()
    spent[x + we.X_STEPS] = 15
    both(we.COMMIT, spent, (5, 0, 0, 3, 0))
    both(we.EPILOGUE, st)
    commit_st[x + we.X_OPEN] = 1

    def begin(t):
        we.walk_era(we.BEGIN, c, t[0], prog.era_in, t[1], t[2])

    def prep():
        return [st.clone(), prog.hseen.clone(), prog.plen.clone()]

    results = {"walk_era": dict(
        max_abs_err=max(errs),
        ms=time_device_ms(torch, lambda s_: we.walk_era(we.COMMIT, c, s_), prep=commit_st.clone),
        call_ms=time_ms(torch, lambda s_: we.walk_era(we.COMMIT, c, s_), prep=commit_st.clone),
        plain_ms=time_ms(torch, lambda s_: we.walk_era_plain(we.COMMIT, c, s_), prep=commit_st.clone, reps=5),
        begin_ms=time_device_ms(torch, begin, prep=prep),
        epilogue_ms=time_device_ms(torch, lambda t: we.walk_era(we.EPILOGUE, c, t[0], None, t[1], t[2]), prep=prep),
        epilogue_plain_ms=time_ms(torch, lambda t: we.walk_era_plain(we.EPILOGUE, c, t[0], None, t[1], t[2]),
                                  prep=prep, reps=5),
        # COMMIT: the gate's ten words read, three written
        bytes=13 * 8, ops=20,
        epilogue_bytes=P * B * 9 + 2 * 8 * c.length,
        library_ms=None, shape=f"COMMIT on {c.length} state words (B={B}, P={P})",
    )}
    del prog
    torch.cuda.empty_cache()
    return finish(results)


def lane_era_parity(torch, np, N, tm, C, qcap):
    """The lane axis of K8f's two kernels (K14f) against their plain
    versions on the same card tensors, at the widths of N lanes of `tm`
    at chunk C (the default lane shape): START, BEGIN and COMMIT over
    lane states with open, closed, overflowing, erroring and finishing
    lanes, and the epilogue over sparse first hits; each also at one lane
    against the solo kernel; returns {entry name: timing dict}."""
    from torch_era_ops import lane as lane_of
    from torch_era_ops import random_operands

    from stateright_tpu_torch.engines.gpu_bfs import widths
    from stateright_tpu_torch.ops import era as eo

    dev = torch.device("cuda")
    rng = np.random.default_rng(14)
    props = tm.tensor_properties()
    P, A, W = len(props), tm.max_actions, tm.state_width + 2
    vcap, rcap, _d = widths(A, C)
    plen = eo.params_len(A, P, True, 0)
    cfg = eo.EraConfig(chunk=C, qmask=qcap - 1, vcap=vcap, rcap=rcap, P=P, A=A, cov_base=eo.P_LEN + 2 * P,
                       s_base=-1, s_high=0, s_take=C, f_base=-1, fuse=1, x=plen, regrow=max(1, C // 16),
                       budget_min=eo.BUDGET_MIN, n_cov=eo.cov_len(A, P), scap=0)
    L = plen + eo.X_LEN
    print(f"lane era widths: N={N} C={C} A={A} P={P} rcap={rcap} state [{N}, {L}]", flush=True)

    def state():
        s = rng.integers(0, 1 << 20, size=(N, L)).astype(np.int64)
        s[:, eo.P_COUNT] = rng.choice([0, 1, 5, 3 * C], size=N)
        s[:, eo.P_HIGH_WATER] = qcap - C * A
        s[:, eo.P_GROW_LIMIT] = 1 << 30
        s[:, eo.P_MAX_STEPS] = rng.choice([1, 1 << 20], size=N)
        s[:, eo.P_ERR] = rng.random(N) < 0.05
        s[:, eo.P_REC] = 0
        s[:, eo.P_FIN_ANY] = rng.choice([0, 0, 1], size=N)
        s[:, eo.P_FIN_ALL_EN] = 0
        s[:, eo.P_BUDGET_CAP] = 0
        return torch.from_numpy(s).to(dev)

    def operands(gen):
        return random_operands(rng, N, C, A, P, rcap, vcap + 1, rcap + 1, unres=0.0005, hit=0.002,
                               seen=0.3, gen=gen, device=dev)

    scratch = eo.step_scratch(N, P, A, dev)
    errs = []
    st, step = state(), operands(False)
    a, b = st.clone(), st.clone()
    oa, ob = era_ops(torch, step), era_ops(torch, step)
    for mode in (eo.START, eo.BEGIN, eo.COMMIT, eo.COMMIT):
        eo.era_step(mode, cfg, a, oa if mode == eo.COMMIT else None, scratch=scratch)
        eo.era_step_plain(mode, cfg, b, ob if mode == eo.COMMIT else None)
        errs.append(max_abs_err(torch, [(a, b)] + list(zip(oa.first, ob.first))))
    check(not bool(scratch.any()), "lane era step: the scratch was not left zero")
    # One lane against the solo kernel on the same row.
    with_gen = operands(True)
    for l in range(3):
        solo, lane = st[l].clone(), st[l:l + 1].clone()
        one, one_l = lane_of(with_gen, l, C, solo=True), lane_of(with_gen, l, C)
        for mode in (eo.START, eo.BEGIN, eo.COMMIT):
            e1, e2 = torch.ones(1, dtype=torch.int64, device=dev), torch.ones(1, dtype=torch.int64, device=dev)
            eo.era_step(mode, cfg, solo, one if mode == eo.COMMIT else None, epoch=e1)
            eo.era_step(mode, cfg, lane, one_l if mode == eo.COMMIT else None, epoch=e2,
                        scratch=eo.step_scratch(1, P, A, dev))
            errs.append(max_abs_err(torch, [(solo, lane[0]), (e1, e2)] + list(zip(one.first, one_l.first))))
    commit_st = a.clone()
    commit_st[:, plen + eo.X_OPEN] = 1
    commit_st[:, plen + eo.X_TAKE] = torch.clamp(commit_st[:, eo.P_COUNT], max=C)

    def fresh():
        return commit_st.clone(), era_ops(torch, step)

    results = {"era_step_lanes": dict(
        max_abs_err=max(errs),
        ms=time_device_ms(torch, lambda t: eo.era_step(eo.COMMIT, cfg, t[0], t[1], scratch=scratch), prep=fresh),
        call_ms=time_ms(torch, lambda t: eo.era_step(eo.COMMIT, cfg, t[0], t[1], scratch=scratch), prep=fresh),
        plain_ms=time_ms(torch, lambda t: eo.era_step_plain(eo.COMMIT, cfg, t[0], t[1]), prep=fresh, reps=3),
        launches_a_call=kernels_a_call(torch, "K14f COMMIT",
                                       lambda: eo.era_step(eo.COMMIT, cfg, commit_st, step, scratch=scratch), 1),
        bytes=commit_bytes(torch, step, P, C, A, rcap, N, L), ops=N * (2 * rcap + (P + A) * C),
        library_ms=None, shape=f"COMMIT of {N} lanes over [{N}, {rcap}] insert masks, [{P}, {N}*{C}] hits, "
                               f"[{A}, {N}, {C}] valid",
    )}

    errs = []
    hseen = torch.from_numpy(rng.random((P, N * C)) < 0.002).to(dev)
    f1, f2 = (torch.from_numpy(rng.integers(0, 1 << 32, size=(P, N * C))).to(dev) for _ in range(2))
    fd = torch.from_numpy(rng.integers(1, 9, size=(P, N * C))).to(dev)
    rings = torch.from_numpy(rng.integers(0, 30, size=(N, W, qcap + 1))).to(dev)
    epi = a.clone()

    def prep():
        return [epi.clone(), hseen.clone(), f1.clone(), f2.clone(), fd.clone()]

    x1, x2 = prep(), prep()
    eo.era_epilogue(cfg, x1[0], *x1[1:], rings[:, W - 1])
    eo.era_epilogue_plain(cfg, x2[0], *x2[1:], rings[:, W - 1])
    errs.append(max_abs_err(torch, zip(x1, x2)))
    for l in range(3):
        t1 = [epi[l].clone(), hseen.view(P, N, C)[:, l].contiguous(), f1.view(P, N, C)[:, l].contiguous(),
              f2.view(P, N, C)[:, l].contiguous(), fd.view(P, N, C)[:, l].contiguous()]
        t2 = [epi[l:l + 1].clone()] + [t.clone() for t in t1[1:]]
        eo.era_epilogue(cfg, t1[0], *t1[1:], rings[l, W - 1])
        eo.era_epilogue(cfg, t2[0], *t2[1:], rings[l:l + 1, W - 1])
        errs.append(max_abs_err(torch, [(t1[0], t2[0][0])]))
    epi_scratch = eo.epilogue_scratch(N, P, C, dev)
    idle = prep()  # the capture that counts a call's nodes runs nothing
    results["era_epilogue_lanes"] = dict(
        max_abs_err=max(errs),
        ms=time_device_ms(torch, lambda t: eo.era_epilogue(cfg, t[0], *t[1:], rings[:, W - 1], scratch=epi_scratch),
                          prep=prep),
        call_ms=time_ms(torch, lambda t: eo.era_epilogue(cfg, t[0], *t[1:], rings[:, W - 1], scratch=epi_scratch),
                        prep=prep),
        launches_a_call=kernels_a_call(torch, "K14f epilogue",
                                       lambda: eo.era_epilogue(cfg, idle[0], *idle[1:], rings[:, W - 1],
                                                               scratch=epi_scratch), 1),
        plain_ms=time_ms(torch, lambda t: eo.era_epilogue_plain(cfg, t[0], *t[1:], rings[:, W - 1]), prep=prep,
                         reps=3),
        # hseen and faccd read, the four first-hit lanes written, the rows
        bytes=P * N * C * (1 + 8) + P * N * C * (1 + 3 * 8) + 2 * 8 * N * L, ops=2 * P * N * C,
        library_ms=None, shape=f"[{P}, {N}*{C}] first-hit lanes, [{N}, {L}] state",
    )
    return finish(results)


def graph_cell(torch, kernels, card, run, label, path):
    """One speed cell of `scripts/solo_walls.py` through the port's entry
    points: a warm-up run, a run counted from 0 (every kernel of `path`
    launched) and timed, with its peak memory; then a profiled run in a
    fresh process (`solo_walls.profile_child`). Prints and returns the
    cell's numbers."""
    import solo_walls

    run(label)
    torch.cuda.empty_cache()
    r, launches = counted(torch, kernels, label, lambda: run(label), path)
    prof = solo_walls.profile_child(HERE, label)
    steps = r.get("steps_run") or r["steps"]
    out = dict(label=label, wall_secs=r["secs"], steps=r["steps"], steps_run=r.get("steps_run"),
               eras=r.get("eras"), batches=r.get("batches"), graph_captures=r["graph_captures"],
               capture_secs=r["capture_secs"], era_readbacks=r.get("readbacks"),
               wall_ms_per_step=r["secs"] * 1e3 / max(1, steps),
               host_launch_calls_per_step=prof.get("host_launch_calls_per_step"),
               device_kernels_per_step=prof.get("device_kernels_per_step"),
               device_busy_ms=prof.get("busy_ms"), profiled_wall_secs=prof.get("profiled_wall_secs"),
               profiled_steps=prof.get("steps"), device_busy_share=prof.get("share"),
               # busy a step (the profiled run) over wall a step (this run)
               device_busy_over_wall=(prof["busy_ms"] / prof["steps"] / (r["secs"] * 1e3 / steps))
               if prof.get("busy_ms") else "not measured",
               profile_exit_code=prof.get("exit_code", 0), profile_fault=prof.get("fault"),
               max_memory_allocated=r["peak"], result=r["result"], card=card)
    if "batch_secs" in r:
        out["batch_secs"] = r["batch_secs"]  # the graph launch and its readback
        out["batch_readbacks"] = r["batch_readbacks"]
    for key in ("generated", "checks"):
        if key in r:
            out[f"{'generated_states' if key == 'generated' else 'checks'}_per_sec"] = r[key] / r["secs"]
    print(f"{label}: {json.dumps(out)}", flush=True)
    return out, launches


def model(name, *args):
    from stateright_tpu_torch import models

    return getattr(models, name)(*args)


# Phase 15's models: (model factory, options) by label.
ERA_MODELS = {
    "2pc-7": (lambda: model("TwoPhaseTensor", 7), BENCH7),
    "paxos-3": (lambda: model("PaxosTensorExhaustive", 3), PAXOS3),
    "abd-ordered-3": (lambda: model("AbdOrderedTensor", 3), ABDO3),
}


def profiled_run(torch, label, pipe):
    """One run of `label` under `pipe` after a warm-up one, the second
    under torch.profiler: the device's busy share (the union of kernel
    intervals over the profiled wall), the device kernels and the host
    launch calls (profiler CPU events named *Launch*) a step."""
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from profile_gpu_bfs import busy_union

    make_model, opts = ERA_MODELS[label]
    bfs(make_model(), "cuda", opts, PIPES[pipe])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        c, wall = bfs(make_model(), "cuda", opts, PIPES[pipe])
    tel = c.telemetry()
    steps = tel["steps"] + tel.get("partial_steps", 0)
    kern = [e for e in prof.events() if e.device_type.name == "CUDA" and e.time_range.end > e.time_range.start]
    host = [e for e in prof.events() if e.device_type.name == "CPU" and "Launch" in e.name]
    busy_ms = busy_union([(e.time_range.start, e.time_range.end) for e in kern]) / 1e3
    return dict(
        host_launch_calls_per_step=len(host) / steps, device_kernels_per_step=len(kern) / steps,
        device_busy_ms=busy_ms, profiled_wall_secs=wall,
        device_busy_share=busy_ms / (wall * 1e3) if kern else "not measured",
    )


def profile_in_child(label, pipe):
    """`profiled_run` in a fresh process: the profiler traces one run a
    process (in one long process later traced runs were seen to lose kernel
    records of graph launches). A failed child is reported, not hidden:
    its numbers read "not measured" with its exit code."""
    done = subprocess.run([sys.executable, os.path.abspath(__file__), "--profile-one", label, pipe],
                          capture_output=True, text=True, timeout=600)
    lines = [ln for ln in done.stdout.splitlines() if ln.startswith("{")]
    if done.returncode != 0 or not lines:
        print(f"profiled run of {label}, {pipe} failed (exit {done.returncode}): {done.stderr[-2000:]}", flush=True)
        return dict(device_busy_share="not measured", profile_exit_code=done.returncode)
    return json.loads(lines[-1])


def era_runs(torch, kernels, card, label, golden, k11, checks=lambda c: None):
    """Phase 15's runs of one model at its phase 4-6 options: the default
    pipeline, the serial dispatch loop and (depth 4, fuse 4), each counted from
    0 (every BFS kernel launched, the path walks included), timed (the
    wall ends before the paths are walked), the default pipeline's run
    then once more under torch.profiler in a fresh process
    (`profile_in_child`); all three
    equal to each other (the sample aside) and to the golden. Prints and
    returns each run's numbers."""
    make_model, opts = ERA_MODELS[label]
    dicts, out = {}, {}

    def run_and_check(configure):
        c, wall = bfs(make_model(), "cuda", opts, configure)
        peak = torch.cuda.max_memory_allocated()
        return c, wall, peak, result_dict(c)  # its paths walk through K6

    for name, configure in PIPES.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        (c, wall, peak, dicts[name]), launches = counted(torch, kernels, f"{label}, {name}",
                                                         lambda: run_and_check(configure))
        check(c.unique_state_count() == golden, f"{label}, {name}: {c.unique_state_count()} != {golden}")
        checks(c)
        check_k11(kernels, f"{label}, {name}", c, launches, k11)
        tel = c.telemetry()
        del c
        # The default pipeline's run only: a profiled child is a fresh
        # process (tens of seconds on the card's host), and the script
        # must stay well inside its time limit.
        prof = profile_in_child(label, name) if name == "default" else {}
        steps = tel["steps"] + tel.get("partial_steps", 0)
        out[name] = dict(
            label=label, pipeline=name, wall_secs=wall, steps=tel["steps"],
            partial_steps=tel.get("partial_steps", 0), eras=tel["eras"], dispatches=tel["dispatches"],
            spec_dispatch=tel.get("spec_dispatch", 0), spec_wasted=tel.get("spec_wasted", 0),
            fused_eras_per_dispatch=tel["fused_eras_per_dispatch"], graph_captures=tel["graph_captures"],
            capture_secs=tel["capture_secs"], wall_ms_per_step=wall * 1e3 / steps,
            wall_ms_per_step_without_capture=(wall - tel["capture_secs"]) * 1e3 / steps,
            **prof, era_kernel_launches=launches["era_step"] + launches["era_epilogue"],
            kernel_launches_per_step=per_step(launches, steps),
            max_memory_allocated=peak, card=card,
        )
        print(f"{label}: {json.dumps(out[name])}", flush=True)
    # Counts, discoveries, coverage and the paths are the same under every
    # pipeline setting. Eras and the bottom-k sample are each setting's
    # own, in the JAX engine too: a chained era runs with the threshold of
    # the era it chains off, which moves era ends and the captures a step
    # drops past DEVICE_STEP_CAP (phase 15's 2pc-5 sweep holds each
    # setting's sample against the cpu run).
    first = {k: v for k, v in dicts["default"].items() if k != "sample"}
    for name, d in dicts.items():
        check({k: v for k, v in d.items() if k != "sample"} == first,
              f"{label}: {name} differs from the default pipeline")
    return out


# -- phase 17: the stage profiler (K12) ---------------------------------------

STAGE_ITERS = 32  # CheckerBuilder.stage_profile's default


def stage_kernel_parity(torch, np, label, S, A, C=None, B=None, L=None):
    """K12a (LANES: MIX, XOR, MASK, RING; FOLD with START and ADD) at the
    BFS widths C, A, S, or, with B and L, K12a's XOR and FOLD and K12b
    (CYCLE, RECORD, CHOOSE) at the simulation widths B walks, paths of L:
    each against its plain version on the same card tensors, exactly,
    with CUDA-event times; returns {kernel: timing dict} (K12a's FOLD as
    `stage_loop`, its lanes as `stage_lanes`, K12b as `stage_walk`)."""
    from stateright_tpu_torch.engines.gpu_bfs import widths
    from stateright_tpu_torch.ops import stage as sg

    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    M = 0xFFFFFFFF

    def u32(*shape):
        return torch.from_numpy(rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.int64)).to(dev)

    def z(*shape, dtype=torch.int64):
        return torch.zeros(shape, dtype=dtype, device=dev)

    st0 = torch.tensor([0x9E3779B1, 5, 1, 0, 0], dtype=torch.int64, device=dev)
    errs = {"stage_loop": [], "stage_lanes": [], "stage_walk": []}

    def pair(name, fn, *outs):
        """fn(kernel) on copies of `outs`, kernel then plain: equal."""
        a, b = [t.clone() for t in outs], [t.clone() for t in outs]
        fn(True, *a)
        fn(False, *b)
        errs[name].append(max_abs_err(torch, zip(a, b)))

    mods = dict(mix=(sg.mix_lanes, sg.mix_lanes_plain), xor=(sg.xor_lanes, sg.xor_lanes_plain),
                mask=(sg.mask_lanes, sg.mask_lanes_plain), ring=(sg.ring_lanes, sg.ring_lanes_plain),
                cycle=(sg.cycle, sg.cycle_plain), record=(sg.record, sg.record_plain),
                choose=(sg.choose, sg.choose_plain))

    def k(name, kern):
        return mods[name][0 if kern else 1]

    results = {}
    if C is not None:
        vcap, rcap, _dc = widths(A, C)
        W = S + 2
        print(f"stage widths ({label}): C={C} A={A} S={S} vcap={vcap} rcap={rcap}", flush=True)
        src, flat, popped = u32(S, C), u32(S, C * A), u32(W, C)
        head0 = torch.tensor([0xFFFFF0], dtype=torch.int64, device=dev)
        pair("stage_lanes", lambda kern, o: k("mix", kern)(o, 41), z(S, C * A))
        pair("stage_lanes", lambda kern, o: k("mix", kern)(o, 71, mask=7), z(S, vcap))
        pair("stage_lanes", lambda kern, o: k("mix", kern)(o, 0x6C62272E, src=flat), z(S, C * A))
        pair("stage_lanes", lambda kern, o, st: k("xor", kern)(o, src, st), z(S, C), st0)
        pair("stage_lanes", lambda kern, o, st: k("xor", kern)(o, flat[:2], st, xor_rows=2), z(2, C * A), st0)
        pair("stage_lanes", lambda kern, o, st: k("mask", kern)(o, flat[0], st, 3), z(C * A, dtype=torch.bool), st0)
        pair("stage_lanes", lambda kern, o, h: k("ring", kern)(o, popped, h, (1 << 24) - 1), z(W, rcap), head0)
        # FOLD with the compact stage's terms: two counts, a gather and the
        # S distinct lanes at rcap.
        n1, n2, g, dl = u32(1), u32(1), u32(rcap), u32(S * rcap)
        terms = [sg.term(n1), sg.term(n2), sg.term(g), sg.term(dl)]
        epoch = torch.ones(1, dtype=torch.int64, device=dev)

        def fold(kern, st, ep):
            if kern:
                sg.start(st, 3)
                sg.fold(st, terms, 3, add=1, epoch=ep)
                sg.add(st, [sg.term(dl[:1], shift=3, mask=1)])
            else:
                sg.start_plain(st, 3)
                sg.fold_plain(sg.FOLD, st, terms, 3, 1, ep)
                sg.fold_plain(sg.ADD, st, [sg.term(dl[:1], shift=3, mask=1)], 0)

        pair("stage_loop", fold, st0, epoch)
        out, ring_out, mix_out = z(S, C), z(W, rcap), z(S, C * A)
        nterm = 2 + rcap + S * rcap
        results["stage_lanes"] = dict(
            max_abs_err=max(errs["stage_lanes"]),
            ms=time_device_ms(torch, lambda st: sg.xor_lanes(out, src, st), prep=st0.clone),
            call_ms=time_ms(torch, lambda st: sg.xor_lanes(out, src, st), prep=st0.clone),
            plain_ms=time_ms(torch, lambda st: sg.xor_lanes_plain(out, src, st), prep=st0.clone),
            bytes=16 * S * C + 8, ops=3 * S * C, library_ms=None,
            shape=f"XOR [{S}, {C}] (a round's perturbed rows)",
            ring_ms=time_device_ms(torch, lambda h: sg.ring_lanes(ring_out, popped, h, M), prep=head0.clone),
            mix_ms=time_device_ms(torch, lambda _: sg.mix_lanes(mix_out, 41)),
        )
        results["stage_loop"] = dict(
            max_abs_err=max(errs["stage_loop"]),
            ms=time_device_ms(torch, lambda st: sg.fold(st, terms, 3), prep=st0.clone),
            call_ms=time_ms(torch, lambda st: sg.fold(st, terms, 3), prep=st0.clone),
            plain_ms=time_ms(torch, lambda st: sg.fold_plain(sg.FOLD, st, terms, 3), prep=st0.clone),
            bytes=8 * nterm + 16, ops=3 * nterm, library_ms=None,
            shape=f"FOLD of the compact stage's terms ({nterm} words)",
        )
    else:
        print(f"stage widths ({label}): B={B} L={L} S={S} A={A}", flush=True)
        path = u32(B, L) | (u32(B, L) << 32)
        h0, g0, l227 = u32(B), u32(B), u32(B)
        ptr = torch.from_numpy(rng.integers(0, L, size=B)).to(dev)
        # A third of the walks hold their key below ptr.
        hit = torch.from_numpy(np.flatnonzero(rng.random(B) < 0.3)).to(dev)
        col = ptr.index_select(0, hit) // 2
        path[hit, col] = ((h0.index_select(0, hit) ^ 1) << 32) | g0.index_select(0, hit)
        restart = torch.from_numpy(rng.random(B) < 1 / 16).to(dev)
        rows, succs = u32(S, B), u32(A * S, B)
        valid = torch.from_numpy(rng.random((A, B)) < 0.5).to(dev)
        stw = st0.clone()
        stw[0] = 0x12345  # acc & 1 == 1: the planted keys
        pair("stage_walk", lambda kern, o: k("cycle", kern)(stw, path, h0, g0, ptr, o), z(B, dtype=torch.bool))
        pair("stage_walk", lambda kern, p: k("record", kern)(stw, p, h0, restart), path)
        pair("stage_walk", lambda kern, o: k("choose", kern)(stw, rows, succs, valid, ptr, l227, o), z(S, B))
        pair("stage_lanes", lambda kern, o, st: k("xor", kern)(o, rows, st, mask=7), z(S, B), stw)
        cyc = z(B, dtype=torch.bool)
        # The slots CYCLE must read: up to a planted key, else all below ptr.
        need = ptr.clone()
        below = col < ptr.index_select(0, hit)
        need[hit[below]] = col[below] + 1
        scanned = int(need.sum())
        n_restart = int(restart.sum())
        out = z(S, B)
        results["stage_walk"] = dict(
            max_abs_err=max(errs["stage_walk"]),
            ms=time_device_ms(torch, lambda _: sg.cycle(stw, path, h0, g0, ptr, cyc)),
            call_ms=time_ms(torch, lambda _: sg.cycle(stw, path, h0, g0, ptr, cyc)),
            plain_ms=time_ms(torch, lambda _: sg.cycle_plain(stw, path, h0, g0, ptr, cyc)),
            # CYCLE: the slots it must read, and h0, g0, ptr and the flag.
            bytes=8 * scanned + 25 * B, ops=3 * scanned + 4 * B, library_ms=None,
            shape=f"CYCLE [{B}, {L}]",
            record_ms=time_device_ms(torch, lambda p: sg.record(stw, p, h0, restart), prep=path.clone),
            record_plain_ms=time_ms(torch, lambda p: sg.record_plain(stw, p, h0, restart), prep=path.clone),
            record_bound_ms=(9 * B + 8 * (B - n_restart) + 8 * L * n_restart) / HBM_BYTES_PER_S * 1e3,
            choose_ms=time_device_ms(torch, lambda _: sg.choose(stw, rows, succs, valid, ptr, l227, out)),
            choose_plain_ms=time_ms(torch, lambda _: sg.choose_plain(stw, rows, succs, valid, ptr, l227, out)),
            choose_bound_ms=max((B * (16 + A) + 16 * S * B) / HBM_BYTES_PER_S,
                                B * (3 * A + 20) / INT32_OPS_PER_S) * 1e3,
        )
    for name, e in errs.items():
        check(max(e or [0]) == 0, f"{name} disagrees with its plain version at the {label} widths")
    return finish(results)


def grab_stage_state(stages):
    """Wrap the stage programs' `load` to keep what each profiled run hands
    them (its final table and ring, or path rows; no stage writes them),
    for the graph against plain check."""
    grabbed = {}
    for cls, kind in ((stages.BfsStages, "bfs"), (stages.SimStages, "sim")):
        orig = cls.load

        def load(self, *state, _orig=orig, _kind=kind):
            grabbed[_kind] = (self, state)
            return _orig(self, *state)

        cls.load = load
    return grabbed


def stage_programs_match_plain(torch, label, progs, state, iters=4):
    """Every stage program and the null loop of `progs`' kind and widths
    through its CUDA graph and through the plain versions (a cpu copy of
    the run's state), `iters` rounds: the same accumulator."""
    from stateright_tpu_torch.engines import stages
    from stateright_tpu_torch.ops import visited_set as vs

    cpu = torch.device("cpu")
    built = []
    for dev in (torch.device("cuda"), cpu):
        if isinstance(progs, stages.BfsStages):
            table, ring = state
            p = stages.BfsStages(progs.tm, progs.props, progs.C, progs.qcap, progs.canon, iters, dev)
            p.load(vs.VisitedTable(*(t.to(dev) for t in (table.keys, table.parents, table.stamps))), ring.to(dev))
        else:
            (path,) = state
            p = stages.SimStages(progs.tm, progs.props, progs.B, progs.L, iters, dev)
            p.load(path.to(dev))
        built.append(p)
    accs = []
    for p in built:
        named, null = p.programs()
        accs.append({n: q.run(1) for n, q in dict(named, null=null).items()})
        p.release()
        p.free()
    check(accs[0] == accs[1], f"{label} stage programs: graph {accs[0]} != plain {accs[1]}")
    print(f"{label} stage programs, graph == plain ({iters} rounds from seed 1): {accs[0]}", flush=True)


def profiled_pair(torch, kernels, card, label, run, result, path, k11, want=None):
    """`run(profile)` -> (checker, wall) without and with .stage_profile():
    equal results (or, with `want`, the profiled run's result checked by
    it alone), no stage_profile_error, the stage phases summing to
    device_era within 10%, and every kernel of `path` (the engine's and
    the stage programs') launched in the profiled run. Prints the split,
    the profiler's own seconds and the peak memory of both runs."""
    t0 = peak0 = None
    if want is None:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        kernels.reset_launches()
        c0, t0 = run(False)
        torch.cuda.synchronize()
        check_k11(kernels, label, c0, kernels.launch_counts(), *k11)
        want, peak0 = result(c0), torch.cuda.max_memory_allocated()
        del c0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def profiled():
        c, t = run(True)
        return c, t, torch.cuda.max_memory_allocated(), result(c)

    (c, t1, peak1, got), launches = counted(torch, kernels, f"{label} profiled", profiled, path)
    check(got == want, f"{label}: the profiled run differs from the plain one")
    check_k11(kernels, f"{label} profiled", c, launches, k11[0], k11[1], exact=False)
    tel = c.telemetry()
    check("stage_profile_error" not in tel, f"{label}: stage_profile_error {tel.get('stage_profile_error')}")
    ph = tel["phase_ms"]
    split = {k[len("stage_"):]: v for k, v in ph.items() if k.startswith("stage_")}
    era = ph["device_era"]
    check(split and abs(sum(split.values()) - era) <= 0.1 * era, f"{label}: stages {split} vs device_era {era}")
    out = dict(label=label, wall_secs=t0, profiled_wall_secs=t1, steps=tel["steps"],
               steps_run=tel.get("steps_run"), device_era_ms=era, stage_ms=split,
               stage_us_per_step=tel["stage_us_per_step"], stage_profile_iters=tel["stage_profile_iters"],
               stage_profile_model_pct=tel.get("stage_profile_model_pct"),
               profiler_overhead_ms=ph["profiler_overhead"], max_memory_allocated=peak0,
               max_memory_allocated_profiled=peak1, card=card)
    print(f"stage profile {label}: {json.dumps(out)}", flush=True)
    return out, launches


def stage_phase(torch, np, kernels, card, skip_full):
    """Phase 17: K12a and K12b against their plain versions, the profiled
    runs and the stage programs' graphs against their plain versions;
    returns the kernels' timing dicts and the launches of the profiled
    2pc-7 BFS and paxos-3 simulation runs."""
    from stateright_tpu_torch.engines import stages as stage_mod
    from stateright_tpu_torch.models import PaxosTensor, PaxosTensorExhaustive

    stage_res = stage_kernel_parity(torch, np, "2pc-7", 3, 37, C=6144)
    stage_kernel_parity(torch, np, "paxos-3", 30, 21, C=16384)
    stage_res.update(stage_kernel_parity(torch, np, "paxos-3 simulation", 30, 21, B=SIM_PAXOS3["walks"], L=SIM_L))
    grabbed = grab_stage_state(stage_mod)
    bfs_stage_path = kernels.BFS_KERNELS + kernels.BFS_STAGE_KERNELS
    sim_stage_path = kernels.SIM_KERNELS + kernels.SIM_STAGE_KERNELS

    def profiled_bfs(make, opts, configure=lambda b: b):
        return lambda prof: bfs(make(), "cuda", opts, (lambda b: configure(b).stage_profile()) if prof else configure)

    _out, launches_stage = profiled_pair(
        torch, kernels, card, "2pc-7", profiled_bfs(lambda: two_pc(7), BENCH7), result_dict, bfs_stage_path,
        (kernels.EXPAND_2PC, "claim_dedup"))
    stage_programs_match_plain(torch, "2pc-7", *grabbed.pop("bfs"))
    profiled_pair(
        torch, kernels, card, "paxos-3", profiled_bfs(lambda: PaxosTensorExhaustive(3), PAXOS3), result_dict,
        bfs_stage_path, (kernels.EXPAND_PAXOS, "claim_dedup"))
    stage_programs_match_plain(torch, "paxos-3", *grabbed.pop("bfs"))
    _out, launches_sym = profiled_pair(
        torch, kernels, card, "2pc-5 symmetry", profiled_bfs(lambda: two_pc(5), TEST_OPTS, lambda b: b.symmetry()),
        result_dict, bfs_stage_path + kernels.CANON_KERNELS, (kernels.EXPAND_2PC, "claim_dedup"))
    progs, state = grabbed.pop("bfs")
    check("canon" in progs.stages, "2pc-5 symmetry: no canon stage")
    # The canon stage runs K11c (its graph's rounds add to the run's own
    # once-a-step launches); stage_programs_match_plain holds it to the plain
    # version's accumulator.
    check(progs.canon_route == "kernel", f"2pc-5 symmetry: canon stage on the {progs.canon_route} route")
    print(f"2pc-5 symmetry profiled: canon stage route {progs.canon_route}, "
          f"canon_2pc launches {launches_sym['canon_2pc']}", flush=True)
    stage_programs_match_plain(torch, "2pc-5 symmetry", progs, state)
    _out, launches_stage_sim = profiled_pair(
        torch, kernels, card, "paxos-3 simulation",
        lambda prof: simulate(PaxosTensor(3), "cuda", 0,
                              (lambda b: b.target_state_count(2_000_000).stage_profile()) if prof
                              else (lambda b: b.target_state_count(2_000_000)), SIM_PAXOS3),
        sim_dict, sim_stage_path, (kernels.WALK_PAXOS, "walk_step"))
    stage_programs_match_plain(torch, "paxos-3 simulation", *grabbed.pop("sim"))
    if not skip_full:
        # The probe stage forks the full 2^28-slot table.
        profiled_pair(
            torch, kernels, card, "2pc-10", profiled_bfs(lambda: two_pc(10), FULL10),
            lambda c: (c.unique_state_count(), sorted(check_paths(c))), bfs_stage_path,
            (kernels.EXPAND_2PC, "claim_dedup"), want=(GOLDEN[10], ["abort agreement", "commit agreement"]))
        grabbed.pop("bfs")
    del grabbed
    torch.cuda.empty_cache()

    return stage_res, launches_stage, launches_stage_sim


# -- phase 18: the sharded mesh (K15) ----------------------------------------

MESH_N = 8
# Full-width runs at N = 8 shards on one card (world size 1): per-shard
# capacities with no growth and no spill, chunks that keep each shard's
# sample slab (its high water plus the receive width N * quota) within
# the 16,384 rows K9b sorts; beside each, the same model at N = 1.
MESH_RUNS = {
    "2pc-7": (lambda: two_pc(7), GOLDEN[7], {
        MESH_N: dict(chunk_size=1024, queue_capacity_per_shard=1 << 17, table_capacity_per_shard=1 << 18),
        1: dict(chunk_size=1024, queue_capacity_per_shard=1 << 18, table_capacity_per_shard=1 << 21)}),
    "paxos-3": (None, PAXOS3_GOLDEN, {
        MESH_N: dict(chunk_size=2048, queue_capacity_per_shard=1 << 18, table_capacity_per_shard=1 << 20),
        1: dict(chunk_size=2048, queue_capacity_per_shard=1 << 21, table_capacity_per_shard=1 << 23)}),
}
MESH10 = dict(chunk_size=1024, queue_capacity_per_shard=1 << 23, table_capacity_per_shard=1 << 25)
# Phase 18's 2pc-5 at 8 shards: the test options, and tables of 2^12 a
# shard, so that the run grows them mid-run (K15g, then a new graph).
MESH_SMALL = dict(chunk_size=64, sync_steps=4, table_capacity_per_shard=1 << 12)


def mesh_bfs(model, device, n, opts, configure=lambda b: b):
    from stateright_tpu_torch import TensorModelAdapter

    import torch

    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.monotonic()
    b = configure(TensorModelAdapter(model).checker().coverage())
    c = b.spawn_sharded_bfs(devices=n, device=device, **opts).join()
    if device == "cuda":
        torch.cuda.synchronize()
    return c, time.monotonic() - t0


def mesh_kernel_parity(torch, np, label, tm, C):
    """K15a and K15f against their plain versions on the same card
    tensors, at the widths one sharded step of `tm` at chunk C gives
    them, for N = 1 and N = 8 shards: the exchange with the quota the
    engine takes and with a quarter of it (buckets overflow), and every
    mode of the mesh era kernel — START, BEGIN, COMMIT (clean, an
    overflow at some senders, unresolved inserts with takes that can
    shrink and with takes of 1), EPILOGUE (budget-only with fusion on,
    pressure on one shard, a finish mask met, sparse first hits with
    depth ties) and TAIL. Returns {kernel: timing dict} at N = 8."""
    from stateright_tpu_torch.engines.era import widths
    from stateright_tpu_torch.ops import exchange as xc
    from stateright_tpu_torch.ops import mesh_era as me
    from stateright_tpu_torch.ops import slab as sl
    from stateright_tpu_torch.ops import visited_set as vs
    from stateright_tpu_torch.parallel import mesh

    dev = torch.device("cuda")
    rng = np.random.default_rng(18)
    M32 = 0xFFFFFFFF
    S, A = tm.state_width, tm.max_actions
    props = tm.tensor_properties()
    P = len(props)
    V, X = widths(A, C)[0], S + 4
    results = {}
    for n in (1, MESH_N):
        quota = mesh.quota_for(C, A, n)
        h1 = torch.from_numpy(rng.integers(0, 1 << 32, size=n * V)).to(dev)
        reps = torch.from_numpy(rng.random((n, V)) < 0.75).to(dev)
        vals = torch.from_numpy(rng.integers(0, 1 << 32, size=(X, n * V))).to(dev)
        errs = []
        for q in (quota, max(1, quota // 4)):
            got, ovf = xc.exchange(h1, reps, vals, n, q)
            want, ovf_p = xc.exchange_plain(h1, reps, vals, n, q)
            errs.append(max_abs_err(torch, [(got, want), (ovf, ovf_p)]))
            if q < quota:
                check(int(ovf.sum()) > 0, f"{label} N={n}: no bucket overflowed at quota {q}")
        owner = h1.view(n, V) % n
        key = torch.where(reps, owner, n)

        def library(_):
            order = torch.argsort(key, dim=1, stable=True)
            return vals.view(X, n, V).gather(2, order[None].expand(X, n, V))

        r = dict(
            max_abs_err=max(errs),
            ms=time_device_ms(torch, lambda _: xc.exchange(h1, reps, vals, n, quota)),
            call_ms=time_ms(torch, lambda _: xc.exchange(h1, reps, vals, n, quota)),
            plain_ms=time_ms(torch, lambda _: xc.exchange_plain(h1, reps, vals, n, quota), reps=5),
            library_ms=time_device_ms(torch, library),
            launches_a_call=kernels_a_call(torch, f"{label} K15a N={n}",
                                           lambda: xc.exchange(h1, reps, vals, n, quota), 2),
            # h1, reps and the X lanes read once; the receive buffer written once
            bytes=n * V * (8 + 1 + 8 * X) + 8 * X * n * n * quota, ops=n * V * (X + 4),
            shape=f"N={n} V={V} X={X} quota={quota}",
        )
        print(f"{label} K15a N={n}: {r['shape']} max_abs_err={r['max_abs_err']}", flush=True)
        check(r["max_abs_err"] == 0, f"{label} N={n}: K15a disagrees with its plain version")
        results["exchange" if n == MESH_N else "exchange_n1"] = r

        prog = mesh.MeshProgram(tm, props, C, 1 << 16, 1 << 12, n, quota, True, 64, 4, dev)
        c, x, L, R = prog.cfg, prog.x, prog.L, prog.R
        qcap = prog.qcap

        # K9b over every shard's slab (the tail's one launch) at this
        # program's slab of s_high + R rows, and at the largest slab with
        # 40 distinct keys; occupancies from empty to full.
        sk2 = prog.sk2
        errs = []
        for scap, ties in ((prog.scap, False), (sl.SLAB_MAX_ROWS, True)):
            slabs = torch.from_numpy(rng.integers(0, 1 << 32, size=(4, n, scap + 1))).to(dev)
            if ties:
                slabs[0] = torch.from_numpy(rng.integers(0, 40, size=(n, scap + 1)) * 0x01000001).to(dev)
            occ = rng.integers(0, scap + 1, size=n)
            occ[:6] = [scap, sk2 + 1, sk2, sk2 - 1, 1, 0][:n]
            counts = torch.from_numpy(np.stack([occ, np.zeros(n, dtype=np.int64)], 1)).to(dev)
            errs.append(max_abs_err(torch, zip(sl.bottom_k_lanes(slabs, counts, sk2),
                                               sl.bottom_k_lanes_plain(slabs, counts, sk2))))
            if not ties:
                timed = slabs, counts
        check(max(errs) == 0, f"{label} N={n}: K9b's lane form disagrees with its plain version")
        if n == MESH_N:
            slabs, counts = timed
            scap = prog.scap
            skey = torch.where(torch.arange(scap, device=dev)[None, :] < counts[:, :1], (~slabs[0, :, :scap]) & M32, 0)
            results["slab_bottomk_lanes"] = dict(
                max_abs_err=max(errs),
                ms=time_device_ms(torch, lambda _: sl.bottom_k_lanes(slabs, counts, sk2)),
                call_ms=time_ms(torch, lambda _: sl.bottom_k_lanes(slabs, counts, sk2)),
                plain_ms=time_ms(torch, lambda _: sl.bottom_k_lanes_plain(slabs, counts, sk2)),
                library_ms=time_device_ms(torch, lambda _: torch.topk(skey, sk2, dim=1)),
                # the one-slab launch on each shard in turn, for comparison
                per_shard_ms=time_device_ms(torch, lambda _: [
                    sl.bottom_k(sl.Slab(*slabs[:, s], counts[s]), sk2) for s in range(n)]),
                bytes=n * (scap * 8 + 16 + sk2 * 4 * 8 + sk2 * (4 * 8 + 1)),
                ops=n * (3 * scap + sk2 * (sk2.bit_length() - 1) * sk2.bit_length() // 2),
                shape=f"{n} slabs [{scap}] -> [{n}, {sk2}] (torch.topk along dim 1)",
            )
            del timed, slabs, counts, skey

        # K9a over every shard's slab in one launch, at the receive width R
        # and this program's slab: a flood under the loose threshold, a
        # tight threshold with ties on its high word, nothing below it;
        # against the loop of the plain capture over the shards.
        errs = []
        scap = prog.scap
        new_r = torch.from_numpy(rng.random((n, R)) < 0.7).to(dev)
        hr = torch.from_numpy(rng.integers(0, 1 << 32, size=(3, n, R))).to(dev)
        hr[0, :, :40] = 0x00800000
        cap_scratch = sl.capture_scratch(n, R, dev)
        for t in ((M32, M32), (0x00800000, 0x40000000), (0, 0)):
            slabs = torch.from_numpy(rng.integers(0, 1 << 32, size=(4, n, scap + 1))).to(dev)
            counts = torch.from_numpy(np.stack([rng.integers(0, 200, n), np.zeros(n, dtype=np.int64)], 1)).to(dev)
            thresh = torch.tensor(t, device=dev)
            other, other_counts = slabs.clone(), counts.clone()
            sl.capture_lanes(slabs, counts, new_r, hr[0], hr[1], hr[2], prog._no_action, thresh, R, cap_scratch)
            sl.capture_lanes_plain(other, other_counts, new_r, hr[0], hr[1], hr[2], prog._no_action, thresh, R)
            errs.append(max_abs_err(torch, [(slabs[:, :, :scap], other[:, :, :scap]), (counts, other_counts)]))
        check(max(errs) == 0 and not bool(cap_scratch[:n * (2 + -(-R // sl.CAPTURE_TILE))].any()),
              f"{label} N={n}: K9a's lane form disagrees with its plain version or left its scratch set")
        if n == MESH_N:
            tight = torch.tensor([0x00800000, 0x40000000], device=dev)
            nothing = torch.tensor([0, 0], device=dev)  # the common step: nothing below it
            n_new, n_below = int(new_r.sum()), int(sl.below_threshold(new_r, hr[0], hr[1], tight).sum())

            def fresh_slabs():
                return torch.zeros((4, n, scap + 1), dtype=torch.int64, device=dev), \
                    torch.zeros((n, 2), dtype=torch.int64, device=dev)

            def lanes_call(t, thr=tight):
                sl.capture_lanes(t[0], t[1], new_r, hr[0], hr[1], hr[2], prog._no_action, thr, R, cap_scratch)

            shard_scratch = sl.capture_scratch(1, R, dev)

            def per_shard(t):
                # one launch a shard, as the mesh step's loop made them
                for s_ in range(n):
                    sl.capture(sl.Slab(*t[0][:, s_], t[1][s_]), new_r[s_], hr[0, s_], hr[1, s_], hr[2, s_],
                               prog._no_action, tight, R, shard_scratch)

            idle = fresh_slabs()
            results["sample_capture_lanes"] = dict(
                max_abs_err=max(errs),
                ms=time_device_ms(torch, lanes_call, prep=fresh_slabs),
                call_ms=time_ms(torch, lanes_call, prep=fresh_slabs),
                plain_ms=time_ms(torch, lambda t: sl.capture_lanes_plain(
                    t[0], t[1], new_r, hr[0], hr[1], hr[2], prog._no_action, tight, R), prep=fresh_slabs),
                empty_ms=time_device_ms(torch, lambda t: lanes_call(t, nothing), prep=fresh_slabs),
                per_shard_ms=time_device_ms(torch, per_shard, prep=fresh_slabs),
                launches_a_call=kernels_a_call(torch, f"{label} K9a over {n} shards", lambda: lanes_call(idle), 1),
                # is_new once, h1 and h2 of each new receive, each captured
                # row's depth and action read and its 4 lanes written
                bytes=n * R + 16 * n_new + 48 * n_below + 32 * n, ops=n * R + 3 * n_new,
                library_ms=None, shape=f"{n} shards x R={R}, {n_new} new, {n_below} below a tight threshold",
            )
            # The step's kernel nodes, after one step with the gates closed
            # (every lazy initialisation).
            prog.state[:, x + me.X_OPEN] = 0
            prog.state[:, x + me.X_TAKE] = 0
            prog._step()
            results["sample_capture_lanes"]["step_nodes"] = step_nodes(torch, f"{label} step at {n} shards", prog,
                                                                       "mesh")

        def state(count=None, its=3, max_steps=64, cap=64, rec=0, k=0, take=None, pressure=False, open_=1):
            s = rng.integers(0, 1 << 20, size=(n, L)).astype(np.int64)
            cnt = rng.integers(0, 3 * C, size=n) if count is None else np.full(n, count)
            for l in range(n):
                s[l, :me.P_LEN] = [int(rng.integers(0, qcap)), cnt[l], 10 ** 6, rec, 0xFFFFFFFF, 2 * 10 ** 6,
                                   qcap - R, max_steps, 5, 7, 2, 0, C, 1 << (P - 1), 0, 0, cap]
            if pressure:
                s[n - 1, me.P_COUNT] = qcap
            s[:, prog.s_base:prog.s_base + 2] = 0xFFFFFFFF
            s[:, prog.f_base] = 4
            s[:, prog.d_base + 2 * P:prog.d_base + 3 * P] = 0xFFFFFFFF
            s[:, x + me.X_ITS] = s[:, x + me.X_ESTEPS] = its
            s[:, x + me.X_REC0], s[:, x + me.X_K], s[:, x + me.X_OPEN] = rec, k, open_
            s[:, x + me.X_TAKE] = np.minimum(cnt, C) if take is None else take
            return torch.from_numpy(s).to(dev)

        def operands(unres=0.0, ovf=0.0, density=0.01):
            rdepth = rng.integers(1, 60, size=(n, R))
            rdepth[:, :64] = rng.integers(120, 200, size=(n, 64))  # at and past the histogram's last bin
            return me.MeshOperands(
                is_new=torch.from_numpy(rng.random((n, R)) < 0.4).to(dev),
                unresolved=torch.from_numpy(rng.random((n, R)) < unres).to(dev),
                rdepth=torch.from_numpy(rdepth).to(dev),
                n_ovf=torch.from_numpy(np.where(rng.random(n) < ovf, rng.integers(1, 9, size=n), 0)).to(dev),
                n_val=torch.from_numpy(rng.integers(0, 2 * V, size=n)).to(dev),
                hits=[torch.from_numpy(rng.random(n * C) < 0.05).to(dev) for _ in range(P)],
                valid=torch.from_numpy(rng.random(A * n * C) < 0.3).to(dev),
                rows=(torch.from_numpy(rng.integers(0, 1 << 32, size=n * C)).to(dev),
                      torch.from_numpy(rng.integers(0, 1 << 32, size=n * C)).to(dev),
                      torch.from_numpy(rng.integers(1, 40, size=n * C)).to(dev)),
                hseen=torch.from_numpy(rng.random((P, n * C)) < density).to(dev),
                facc1=torch.from_numpy(rng.integers(0, 1 << 32, size=(P, n * C))).to(dev),
                facc2=torch.from_numpy(rng.integers(0, 1 << 32, size=(P, n * C))).to(dev),
                faccd=torch.from_numpy(rng.integers(5, 9, size=(P, n * C))).to(dev),
                ring_depth=prog.rings[:, S + 1],
                slab=torch.from_numpy(rng.integers(0, 1 << 32, size=(4, n, prog.scap + 1))).to(dev),
                slab_counts=torch.from_numpy(rng.integers(0, 600, size=(n, 2))).to(dev),
            )

        def clone(ops):
            return ops._replace(
                hits=[h.clone() for h in ops.hits], rows=tuple(r.clone() for r in ops.rows),
                **{f: getattr(ops, f).clone() for f in ops._fields
                   if f not in ("ring_depth", "hits", "rows") and getattr(ops, f) is not None})

        def pairs(a, b):
            return [(getattr(a, f), getattr(b, f)) for f in a._fields
                    if f not in ("hits", "rows") and getattr(a, f) is not None]

        cases = [
            (me.START, state(), operands()),
            (me.BEGIN, state(), operands()),
            (me.COMMIT, state(), operands()),
            (me.COMMIT, state(), operands(ovf=0.5)),
            (me.COMMIT, state(), operands(unres=0.001)),
            (me.COMMIT, state(count=1, take=1), operands(unres=0.01)),
            (me.COMMIT, state(open_=0), operands()),
            (me.EPILOGUE, state(count=3 * C, its=64, k=0), operands(density=0.01)),
            (me.EPILOGUE, state(its=10, k=1, pressure=True), operands(density=0.001)),
            (me.EPILOGUE, state(count=3 * C, its=64, rec=1 << (P - 1), k=2), operands(density=0.02)),
            (me.TAIL, state(), operands()),
        ]
        errs = []
        for i, (mode, st, ops) in enumerate(cases):
            if os.environ.get("MESH_TRACE"):
                print(f"K15f case {i} mode {mode}", flush=True)
            sa, sb, oa, ob = st.clone(), st.clone(), clone(ops), clone(ops)
            za = torch.zeros_like(prog.sums)
            zb = torch.zeros_like(prog.sums)
            # COMMIT on the program's scratch, which every launch leaves zero.
            me.mesh_era(mode, c, sa, za, oa, scratch=prog.commit_scratch)
            me.mesh_era_plain(mode, c, sb, zb, ob)
            errs.append(max_abs_err(torch, [(sa, sb), (za, zb)] + pairs(oa, ob)))
        check(not bool(prog.commit_scratch.any()), f"{label} N={n}: K15f's COMMIT left its scratch set")
        print(f"{label} K15f N={n}: {len(cases)} cases, max_abs_err={max(errs)}", flush=True)
        check(max(errs) == 0, f"{label} N={n}: K15f disagrees with its plain version")
        if n == MESH_N:
            _m, st_c, ops_c = cases[2]
            _m, st_e, ops_e = cases[7]

            def run_k(mode, st_, ops_, plain):
                def go(a):
                    if plain:
                        me.mesh_era_plain(mode, c, a[0], a[1], a[2])
                    else:
                        me.mesh_era(mode, c, a[0], a[1], a[2], scratch=prog.commit_scratch)
                return go

            def prep(st_, ops_):
                return lambda: (st_.clone(), torch.zeros_like(prog.sums), clone(ops_))

            idle = prep(st_c, ops_c)()
            o = ops_c
            hit_n = sum(int(h.sum()) for h in o.hits)
            firsts = sum(int((h.view(1, -1) & ~o.hseen[i:i + 1]).sum()) for i, h in enumerate(o.hits))
            results["mesh_commit"] = dict(
                max_abs_err=max(errs),
                ms=time_device_ms(torch, run_k(me.COMMIT, st_c, ops_c, False), prep=prep(st_c, ops_c)),
                call_ms=time_ms(torch, run_k(me.COMMIT, st_c, ops_c, False), prep=prep(st_c, ops_c)),
                plain_ms=time_ms(torch, run_k(me.COMMIT, st_c, ops_c, True), prep=prep(st_c, ops_c), reps=5),
                launches_a_call=kernels_a_call(torch, f"{label} K15f COMMIT N={n}",
                                               lambda: run_k(me.COMMIT, st_c, ops_c, False)(idle), 1),
                library_ms=None,
                # the two insert masks, the hits, hseen and the valid mask
                # read once, each new insert's depth, each first hit's
                # hashes and depth read and its four lanes written, each
                # shard's 31 scalars and its coverage words read and written
                bytes=n * (2 * R + 2 * P * C + A * C) + 8 * int(o.is_new.sum()) + 49 * firsts
                + 2 * 8 * n * (31 + A + P + 1),
                ops=n * (2 * R + 2 * P * C + A * C) + hit_n,
                shape=f"COMMIT of N={n} shards: [{R}] insert masks, [{P}, {C}] hits, [{A}, {C}] valid, "
                      f"{L} state words a shard",
            )
            results["mesh_era"] = dict(
                max_abs_err=max(errs),
                ms=time_device_ms(torch, run_k(me.EPILOGUE, st_e, ops_e, False), prep=prep(st_e, ops_e)),
                call_ms=time_ms(torch, run_k(me.EPILOGUE, st_e, ops_e, False), prep=prep(st_e, ops_e)),
                plain_ms=time_ms(torch, run_k(me.EPILOGUE, st_e, ops_e, True), prep=prep(st_e, ops_e), reps=5),
                begin_ms=time_device_ms(torch, run_k(me.BEGIN, cases[1][1], cases[1][2], False),
                                        prep=prep(cases[1][1], cases[1][2])),
                library_ms=None,
                # the epilogue: each shard's state read and written, the
                # first-hit lanes read and zeroed
                bytes=2 * 8 * n * L + 2 * 25 * P * n * C, ops=P * n * C,
                shape=f"EPILOGUE of N={n} shards, [{P}, {n * C}] first-hit lanes, {L} state words a shard",
            )
        del prog
    # K15g (mesh.py:1089 _build_grow): every shard's table rehashed into
    # one twice as large, K4's lane form over the occupied rows, against
    # the plain version: the same key -> parent map in every shard.
    n, tcap = MESH_N, 1 << 16
    table = vs.empty_table(tcap, dev, lanes=n)
    keys = torch.from_numpy(rng.integers(1, 1 << 32, size=(2, n, tcap // 5))).to(dev)
    vs.insert_lanes(table, keys[0], keys[1], keys[1], keys[0], torch.ones_like(keys[0], dtype=torch.bool))
    k1, k2 = vs.unpack64(table.keys)
    v1, v2 = vs.unpack64(table.parents)
    occ = vs.occupied_mask(table)
    grown = {}

    def grow(plain):
        def go(t):
            fn = vs.insert_lanes_plain if plain else vs.insert_lanes
            grown[plain] = (t, fn(t, k1, k2, v1, v2, occ)[1])
        return go

    def table_map(t):
        order = t.keys.sort(1)
        return order.values, t.parents.gather(1, order.indices)

    fresh = lambda: vs.empty_table(2 * tcap, dev, lanes=n)  # noqa: E731
    ms = time_ms(torch, grow(False), prep=fresh, reps=5)
    plain_ms = time_ms(torch, grow(True), prep=fresh, reps=1)
    (ta, ua), (tb, ub) = grown[False], grown[True]
    n_occ = int(occ.sum())
    results["K15g grow"] = dict(
        max_abs_err=max_abs_err(torch, list(zip(table_map(ta), table_map(tb))) + [(ua, ub)]),
        ms=ms, plain_ms=plain_ms, library_ms=None,
        bytes=n * tcap * 16 + n_occ * 24, ops=n_occ * 8,
        shape=f"{n} shards x {n_occ // n} rows of {tcap} slots into {2 * tcap}",
    )
    return finish(results)


def mesh_dict(c):
    return dict(result_dict(c), eras=c.telemetry()["eras"], steps=c.telemetry()["steps"])


def grab_mesh_state(stages):
    """Wrap MeshStages.load to keep the profiled run's final tables and
    rings, for the graph against plain check."""
    grabbed = {}
    orig = stages.MeshStages.load

    def load(self, *state):
        grabbed["mesh"] = (self, state)
        return orig(self, *state)

    stages.MeshStages.load = load
    return grabbed


def mesh_stages_match_plain(torch, label, progs, state, iters=4):
    """Every mesh stage program through its CUDA graph and through the
    plain versions (a cpu copy of the run's tables and rings), `iters`
    rounds from seed 1: the same accumulator."""
    from stateright_tpu_torch.engines import stages
    from stateright_tpu_torch.ops import visited_set as vs

    table, rings = state
    accs = []
    for dev in (torch.device("cuda"), torch.device("cpu")):
        p = stages.MeshStages(progs.tm, progs.props, progs.C, progs.qcap, progs.n_total, progs.quota,
                              iters, dev)
        p.load(vs.VisitedTable(*(t.to(dev) for t in (table.keys, table.parents, table.stamps))), rings.to(dev))
        named, null = p.programs()
        accs.append({n: q.run(1) for n, q in dict(named, null=null).items()})
        p.release()
        p.free()
    check(accs[0] == accs[1], f"{label} mesh stage programs: graph {accs[0]} != plain {accs[1]}")
    check("exchange" in accs[0], f"{label}: no exchange stage")
    print(f"{label} mesh stage programs, graph == plain ({iters} rounds from seed 1): {accs[0]}", flush=True)


def mesh_phase(torch, np, kernels, card, skip_full, single):
    """Phase 18: K15a and K15f against their plain versions; 2pc-5 and
    paxos-2 at 8 shards cuda == cpu; the full-width runs at 8 shards on one
    card against the goldens and the single-device discoveries, beside
    N = 1; a profiled 2pc-7 run with its exchange stage; 2pc-10 at 8
    shards unless skip_full. Returns the kernels' timing dicts and the
    launches of the 2pc-7 run at 8 shards."""
    from stateright_tpu_torch.engines import stages as stage_mod
    from stateright_tpu_torch.models import PaxosTensor, PaxosTensorExhaustive

    res = mesh_kernel_parity(torch, np, "2pc-7", two_pc(7), 1024)
    mesh_kernel_parity(torch, np, "paxos-3", PaxosTensorExhaustive(3), 2048)
    path = kernels.MESH_KERNELS
    threads = torch.get_num_threads()
    for label, make, opts in (("2pc-5", lambda: two_pc(5), MESH_SMALL),
                              ("paxos-2", lambda: PaxosTensor(2), dict(chunk_size=256))):
        def on_card():
            c, t = mesh_bfs(make(), "cuda", MESH_N, opts)
            return c, t, mesh_dict(c)  # its paths walk through K6

        (c_gpu, t_gpu, d_gpu), launches18 = counted(torch, kernels, f"{label} at 8 shards", on_card, path)
        check_k11(kernels, f"{label} at 8 shards", c_gpu, launches18,
                  kernels.EXPAND_2PC if label == "2pc-5" else kernels.EXPAND_PAXOS, "claim_dedup_lanes")
        torch.set_num_threads(1)
        c_cpu, t_cpu = mesh_bfs(make(), "cpu", MESH_N, opts)
        torch.set_num_threads(threads)
        d_cpu = mesh_dict(c_cpu)
        check(d_gpu == d_cpu, f"{label} at 8 shards: cuda {d_gpu} != cpu {d_cpu}")
        tel = c_gpu.telemetry()
        print(f"{label} at 8 shards equal on cuda ({t_gpu:.2f}s) and cpu ({t_cpu:.2f}s): unique={d_gpu['unique']} "
              f"eras={d_gpu['eras']} steps={d_gpu['steps']} partial_steps={tel['partial_steps']} "
              f"table_growths={tel.get('table_growths', 0)} sample of {len(d_gpu['sample'])}", flush=True)
        if label == "2pc-5":
            check(tel["partial_steps"] > 0 and tel.get("table_growths", 0) > 0,
                  f"2pc-5 at 8 shards: {tel['partial_steps']} partial steps, "
                  f"{tel.get('table_growths', 0)} growths")
    launches_mesh = None
    for label, (make, golden, by_n) in MESH_RUNS.items():
        make = make or (lambda: PaxosTensorExhaustive(3))
        fps_1, lens_1 = single[label]
        # A warm-up run first: the first launch of each torch kernel the
        # mesh step uses loads its module, which no timed run should pay.
        mesh_bfs(make(), "cuda", MESH_N, by_n[MESH_N])
        for n, opts in by_n.items():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            live = torch.cuda.memory_allocated()  # what earlier phases left allocated

            def go():
                c, wall = mesh_bfs(make(), "cuda", n, opts)
                return c, wall, torch.cuda.max_memory_allocated(), check_paths(c)

            (c, wall, peak, lens), launches = counted(torch, kernels, f"{label} at {n} shards", go, path)
            check(c.unique_state_count() == golden, f"{label} at {n} shards: {c.unique_state_count()} != {golden}")
            check_k11(kernels, f"{label} at {n} shards", c, launches,
                      kernels.EXPAND_2PC if label == "2pc-7" else kernels.EXPAND_PAXOS, "claim_dedup_lanes")
            check(lens == lens_1, f"{label} at {n} shards: discoveries {lens} != single-device {lens_1}")
            tel = c.telemetry()
            iters = launches["exchange"]
            out = dict(label=label, shards=n, options=opts, wall_secs=wall, steps=tel["steps"],
                       partial_steps=tel["partial_steps"], lockstep_steps=iters, eras=tel["eras"],
                       dispatches=tel["dispatches"], graph_captures=tel["graph_captures"],
                       capture_secs=tel["capture_secs"], wall_ms_per_step=wall * 1e3 / iters,
                       launches_per_step=sum(launches[k.name] for k in path) / iters,
                       kernel_launches_per_step=per_step(launches, iters),
                       max_memory_allocated=peak, peak_above_live=peak - live,
                       shard_imbalance_max=tel.get("shard_imbalance_max"),
                       quota=tel["quota"], chunk=tel["chunk"], discovery_lengths=lens,
                       discovery_fps_equal_single_device=dict(c._discovery_fps) == fps_1, card=card)
            print(f"mesh {label}: {json.dumps(out)}", flush=True)
            if label == "2pc-7" and n == MESH_N:
                launches_mesh = launches
            del c
    grabbed = grab_mesh_state(stage_mod)
    _make7, _g, by_n7 = MESH_RUNS["2pc-7"]
    profiled_pair(torch, kernels, card, "2pc-7 at 8 shards",
                  lambda prof: mesh_bfs(two_pc(7), "cuda", MESH_N, by_n7[MESH_N],
                                        (lambda b: b.stage_profile()) if prof else (lambda b: b)),
                  result_dict, path + kernels.MESH_STAGE_KERNELS, (kernels.EXPAND_2PC, "claim_dedup_lanes"))
    progs, state = grabbed.pop("mesh")
    mesh_stages_match_plain(torch, "2pc-7 at 8 shards", progs, state)
    # Where a paxos-3 lockstep step goes at 8 shards (its split only).
    _make, _g, by_npx = MESH_RUNS["paxos-3"]
    profiled_pair(torch, kernels, card, "paxos-3 at 8 shards",
                  lambda prof: mesh_bfs(PaxosTensorExhaustive(3), "cuda", MESH_N, by_npx[MESH_N],
                                        (lambda b: b.stage_profile()) if prof else (lambda b: b)),
                  result_dict, path + kernels.MESH_STAGE_KERNELS, (kernels.EXPAND_PAXOS, "claim_dedup_lanes"))
    grabbed.pop("mesh")
    if not skip_full:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        print(f"2pc-10 at 8 shards, capacities: {MESH10}", flush=True)

        def run10():
            c, t = mesh_bfs(two_pc(10), "cuda", MESH_N, MESH10)
            return c, t, check_paths(c)

        (c10, t10, lens), launches10 = counted(torch, kernels, "2pc-10 at 8 shards", run10, path)
        check(c10.unique_state_count() == GOLDEN[10], f"2pc-10 at 8 shards: {c10.unique_state_count()}")
        check_k11(kernels, "2pc-10 at 8 shards", c10, launches10, kernels.EXPAND_2PC, "claim_dedup_lanes")
        tel = c10.telemetry()
        print(f"mesh 2pc-10: shards={MESH_N} unique={c10.unique_state_count()} states={c10.state_count()} "
              f"wall_secs={t10:.3f} steps={tel['steps']} partial_steps={tel['partial_steps']} "
              f"table_growths={tel.get('table_growths', 0)} max_memory_allocated={torch.cuda.max_memory_allocated()} "
              f"peak_above_live={torch.cuda.max_memory_allocated() - live} "
              f"shard_imbalance_max={tel.get('shard_imbalance_max')} paths={lens} card={card}", flush=True)
        del c10
    torch.cuda.empty_cache()
    return res, launches_mesh


# -- phase 19: the speclint pre-flight (K16, K16a) ----------------------------

# The reachable rows of the full-width device and symmetry rules, and the
# BFS runs they come from (the first rows the ring took, of a run stopped
# at a target before the ring wraps): paxos-3 at its BFS chunk, 2pc-10 at
# its symmetry chunk; 2pc-7's rows at its bench chunk for K16a's second
# width.
LINT_ROWS = {
    "paxos-3": (16384, dict(PAXOS3, table_capacity=1 << 22), 400_000),
    "2pc-7": (6144, BENCH7, 60_000),
    "2pc-10": (8192, dict(SYM10, table_capacity=1 << 22), 200_000),
}
# The reference defaults of analyze() (samples 256, 128 device rows) on
# the bundled models: every model on the kernel route, each of whose
# analyze() launches its K11 WALK once (2PC's symmetry family its K11c
# too) to hold it against numpy.
LINT_MODELS = ("2pc-5", "2pc-7", "paxos-3", "abd-ordered-3", "abd-2", "increment-2", "increment-lock-3",
               "single-copy-4")


def lint_model(name):
    from stateright_tpu_torch.models import (
        AbdOrderedTensor,
        AbdTensor,
        IncrementLockTensor,
        IncrementTensor,
        PaxosTensorExhaustive,
        SingleCopyTensor,
    )

    return {"2pc-5": lambda: two_pc(5), "2pc-7": lambda: two_pc(7), "2pc-10": lambda: two_pc(10),
            "paxos-3": lambda: PaxosTensorExhaustive(3), "abd-ordered-3": lambda: AbdOrderedTensor(3),
            "abd-2": lambda: AbdTensor(2), "increment-2": lambda: IncrementTensor(2),
            "increment-lock-3": lambda: IncrementLockTensor(3),
            "single-copy-4": lambda: SingleCopyTensor(4)}[name]()


def bfs_ring(model, device, opts, target, configure=lambda b: b):
    """The port's BFS of `model` (the builder through `configure`) stopped
    at `target` (0: run to its end), and its ring [S + 2, queue_capacity +
    1] (lanes, ebits, depth), which holds every state the run took, in
    order, where it does not wrap: (checker, ring, wall)."""
    from stateright_tpu_torch.engines import era

    kept = []
    free = era.EraProgram.free_graph

    def keep(self):
        kept.append(self)
        free(self)

    era.EraProgram.free_graph = keep
    try:
        c, t = bfs(model, device, opts, lambda b: configure(b).target_state_count(target))
    finally:
        era.EraProgram.free_graph = free
    check(c.unique_state_count() <= opts["queue_capacity"],
          f"{c.unique_state_count()} states wrap a ring of {opts['queue_capacity']}")
    return c, kept[-1].ring, t


def reachable_rows(torch, np, label, device="cuda"):
    """LINT_ROWS[label]'s rows from the port's own BFS (`bfs_ring`): its
    first n columns are n distinct reachable states."""
    n, opts, target = LINT_ROWS[label]
    c, ring, t = bfs_ring(lint_model(label), device, opts, target)
    unique = c.unique_state_count()
    check(n <= unique, f"{label}: {unique} states for {n} rows")
    rows = ring[:c.tm.state_width, :n].T.cpu().numpy().astype(np.uint32)
    check(len(np.unique(rows, axis=0)) == n, f"{label}: the ring's rows are not distinct")
    print(f"{label}: {n} reachable rows from a BFS stopped at {unique} states ({t:.2f}s)", flush=True)
    return rows


def torch_launches(torch, fn):
    """(torch launches, elements they write) of one call of fn, counted
    under a dispatch mode: an op whose output is a new CUDA storage."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        launches = 0
        elements = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            seen = {a.untyped_storage().data_ptr() for a in args if isinstance(a, torch.Tensor)}
            for t in out if isinstance(out, (tuple, list)) else (out,):
                # Views share an input's storage and launch nothing.
                if (isinstance(t, torch.Tensor) and t.device.type == "cuda" and t.numel()
                        and t.untyped_storage().data_ptr() not in seen):
                    Count.launches += 1
                    Count.elements += t.numel()
            return out

    with Count():
        fn()
    return Count.launches, Count.elements


def agree_parity(torch, np, label, tm, rows):
    """K16a against its plain version on one table: the card's step_lanes
    (eager, through xp) and numpy's over `rows`, first as they are (they
    must agree: STR205 at full width), then with a mismatched lane, a
    flipped mask and high bits planted at known rows; bit for bit, the
    walk's first finding where it was planted, CUDA-event times."""
    from stateright_tpu_torch.ops.agree import agree, agree_plain, read_table, table_words
    from stateright_tpu_torch.xp import TorchXP

    dev = torch.device("cuda")
    S, A = tm.state_width, tm.max_actions
    B = rows.shape[0]
    lanes_np = tuple(np.ascontiguousarray(rows[:, s]) for s in range(S))
    succs, masks = tm.step_lanes(TorchXP(dev), tuple(torch.from_numpy(l.astype(np.int64)).to(dev)
                                                       for l in lanes_np))
    card = torch.stack([torch.stack(tuple(succs[a])) for a in range(A)]).contiguous()
    dmask = torch.stack(tuple(masks)).contiguous()
    h_succs, h_masks = tm.step_lanes(np, lanes_np)
    host_np = np.stack([np.stack([np.asarray(h_succs[a][s]).astype(np.uint32) for s in range(S)])
                        for a in range(A)])
    hmask_np = np.stack([np.asarray(m) for m in h_masks])
    host, hmask = torch.from_numpy(host_np).to(dev), torch.from_numpy(hmask_np).to(dev)
    errs = []

    def both(*args):
        t_k, t_p = agree(*args), agree_plain(*args)
        errs.append(max_abs_err(torch, [(t_k, t_p)]))
        return t_k.cpu().numpy()

    clean = both(card, dmask, host, hmask)
    check(read_table(clean, A, S, B) is None, f"{label}: step_lanes on the card disagrees with numpy on reachable rows")
    # Plant: high bits on every seventh row (must still agree), a lane
    # mismatch at the last (action, lane) valid on a late row, and a mask
    # flip on a later action.
    planted = card.clone()
    planted[:, :, ::7] += 3 << 32
    valid = np.nonzero(hmask_np.any(1))[0]
    a_l = int(valid[len(valid) // 2])
    r_l = int(np.nonzero(hmask_np[a_l])[0][-1])
    planted[a_l, S - 1, r_l] ^= 1 << 5
    dflip = dmask.clone()
    if a_l + 1 < A:
        dflip[a_l + 1, B // 3] = ~dflip[a_l + 1, B // 3]
    found = read_table(both(planted, dflip, host, hmask), A, S, B)
    check(found is not None and (found.action, found.lane, found.row) == (a_l, S - 1, r_l),
          f"{label}: K16a's first finding {found} is not the planted (action {a_l}, lane {S - 1}, row {r_l})")
    if a_l + 1 < A:
        nolane = read_table(both(card, dflip, host, hmask), A, S, B)
        check(nolane == (a_l + 1, None, B // 3, int(dflip[a_l + 1].sum()), int(hmask_np[a_l + 1].sum())),
              f"{label}: K16a's mask finding {nolane}")
    check(max(errs) == 0, f"{label}: K16a disagrees with its plain version")
    args = (planted, dflip, host, hmask)
    r = dict(
        max_abs_err=max(errs),
        ms=time_device_ms(torch, lambda _: agree(*args)),
        call_ms=time_ms(torch, lambda _: agree(*args)),
        plain_ms=time_ms(torch, lambda _: agree_plain(*args)),
        bytes=12 * A * S * B + 2 * A * B + 4 * table_words(A, S),
        ops=3 * A * S * B + 2 * A * B, library_ms=None,
        shape=f"{label}: A={A}, S={S}, B={B} reachable rows",
    )
    print(f"K16a at the {label} widths: {len(errs)} tables equal to the plain version; the planted "
          f"findings read back where they were planted", flush=True)
    return r


def same_report(a, b):
    """Equal reports: the dict form, the messages of STR201 and STR401
    aside (a refused capture says where the lane program was captured and
    what refused it: the card, or meta lanes on the cpu)."""
    da, db = a.to_dict(), b.to_dict()
    for d in (da, db):
        for diag in d["diagnostics"]:
            if diag["code"] in ("STR201", "STR401"):
                diag["message"] = ""
    return da == db


def lint_phase(torch, np, kernels, card):
    """Phase 19: K16a against its plain version at the paxos-3 and 2pc-7
    widths on reachable rows; analyze() on the card == on the cpu for the
    bundled models (the main path: K16a must launch); the device and
    symmetry rules at full width on reachable paxos-3 and 2pc-10 rows
    (K16: the captured step_lanes timed); every card-side fixture == its
    cpu report, capture state clean after each; the strict path. Returns
    K16a's timing dict (paxos-3 widths) and the launches of the main path."""
    from stateright_tpu_torch import SpecLintError, TensorModelAdapter, analyze
    from stateright_tpu_torch.analysis import device as lint_device
    from stateright_tpu_torch.analysis import symmetry as lint_symmetry
    from stateright_tpu_torch.analysis.diagnostics import AnalysisReport
    from stateright_tpu_torch.analysis.probe import LaneProbe
    from stateright_tpu_torch.xp import TorchXP

    import torch_lint_fixtures as fx

    rows = {label: reachable_rows(torch, np, label) for label in LINT_ROWS}
    res = finish({"lane_agree": agree_parity(torch, np, "paxos-3", lint_model("paxos-3"), rows["paxos-3"])})
    finish({"lane_agree at 2pc-7": agree_parity(torch, np, "2pc-7", two_pc(7), rows["2pc-7"])})
    torch.cuda.empty_cache()

    # The main path: analyze() at the reference defaults on the card. Each
    # model is on the kernel route, so its analyze() launches its K11 WALK
    # once (K16 against the kernel) and, for 2PC, K11c once.
    from stateright_tpu_torch.ops.expand import kernel_of

    def lint_all():
        out = {}
        for name in LINT_MODELS:
            tm = lint_model(name)
            walk = kernel_of(tm, tm.tensor_properties())[1]
            torch.cuda.synchronize()
            before = kernels.launch_counts()
            t0 = time.monotonic()
            r = analyze(tm)
            wall = time.monotonic() - t0
            torch.cuda.synchronize()
            after = kernels.launch_counts()
            probed = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            canon = 1 if name.startswith("2pc") else 0
            check(probed.get(walk.name) == 1 and probed.get(kernels.CANON_2PC.name, 0) == canon,
                  f"{name}: analyze() launched {probed}, not {walk.name} once"
                  f"{' and canon_2pc once' if canon else ''}")
            out[name] = (r, wall, probed)
        return out

    on_card, launches = counted(torch, kernels, "speclint", lint_all,
                                kernels.LINT_KERNELS + kernels.WALK_KERNELS + kernels.CANON_KERNELS)
    threads = torch.get_num_threads()
    for name in LINT_MODELS:
        r, wall, probed = on_card[name]
        torch.set_num_threads(1)
        t0 = time.monotonic()
        r_cpu = analyze(lint_model(name), device="cpu")
        t_cpu = time.monotonic() - t0
        torch.set_num_threads(threads)
        check(r.to_dict() == r_cpu.to_dict(), f"{name}: the card's report differs from the cpu's:\n"
              f"{r.format()}\n{r_cpu.format()}")
        check(r.ok, f"{name} does not lint clean:\n{r.format()}")
        print(f"lint {name}: card == cpu, wall_secs={wall:.3f} (cpu {t_cpu:.3f}) "
              f"families={r.families_run} counts={r.counts_by_code()} sample={r.sample.to_dict()} "
              f"captures={r.probes['captures']} capture_secs={r.probes['capture_secs']:.3f} "
              f"graph_launches={r.probes['graph_launches']} kernel probes {r.probes.get('kernels')} "
              f"launched {probed} card={card}", flush=True)

    # The device and symmetry rules at full width on reachable rows.
    bad = {"STR201", "STR202", "STR205", "STR401", "STR404"}
    k16 = {}
    for label in ("paxos-3", "2pc-10"):
        tm, rws = lint_model(label), rows[label]
        report = AnalysisReport(type(tm).__name__)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        lint_device.run(tm, rws, report, torch.device("cuda"))
        if tm.representative_lanes is not None:
            lint_symmetry._check_lanes(tm, rws, report, torch.device("cuda"))
        wall = time.monotonic() - t0
        found = {d.code for d in report.diagnostics} & bad
        check(not found, f"{label} at {len(rws)} rows: {report.format()}")
        print(f"full width {label}, {len(rws)} reachable rows: {report.families_run} "
              f"{'and symmetry lanes ' if tm.representative_lanes is not None else ''}clean of "
              f"{sorted(bad)}; findings {report.counts_by_code()}; captures={report.probes['captures']} "
              f"capture_secs={report.probes['capture_secs']:.3f} graph_launches={report.probes['graph_launches']} "
              f"wall_secs={wall:.3f} card={card}", flush=True)
        # K16: the captured step_lanes program at these widths, one replay.
        S, A, B = tm.state_width, tm.max_actions, len(rws)
        lanes = tuple(np.ascontiguousarray(rws[:, s]) for s in range(S))
        probe = LaneProbe(tm.step_lanes, lanes, "cuda")
        probe.structure(lint_device._pack_step(A, S, B))
        dev_lanes = tuple(torch.from_numpy(l.astype(np.int64)).cuda() for l in lanes)
        xp = TorchXP("cuda")
        n_launch, elements = torch_launches(torch, lambda: tm.step_lanes(xp, dev_lanes))
        k16[f"K16 step_lanes ({label})"] = dict(
            max_abs_err=None,
            ms=time_device_ms(torch, lambda _: probe.graph.replay()),
            call_ms=time_ms(torch, lambda _: probe.graph.replay()),
            plain_ms=time_ms(torch, lambda _: tm.step_lanes(xp, dev_lanes)),
            bytes=8 * S * B + 8 * A * S * B + A * B, ops=elements, library_ms=None,
            shape=f"the captured graph (+ the stack K16a reads) at B={B}; "
                  f"{n_launch} torch launches a call, capture {probe.capture_secs:.3f}s",
        )
        probe.release()
    finish(k16)

    # Every fixture whose error comes from the card: the cpu's finding.
    for cls, code in fx.CARD_FIXTURES:
        torch.cuda.synchronize()
        r, r_cpu = analyze(cls()), analyze(cls(), device="cpu")
        check(code in {d.code for d in r.errors}, f"{cls.__name__}: no {code} on the card:\n{r.format()}")
        check(same_report(r, r_cpu), f"{cls.__name__}: card != cpu:\n{r.format()}\n{r_cpu.format()}")
        # A refused capture leaves torch's capture state clean: not
        # capturing, the caller's stream, and a launch that runs.
        check(not torch.cuda.is_current_stream_capturing()
              and torch.cuda.current_stream() == torch.cuda.default_stream(), f"{cls.__name__}: capture state")
        probe = torch.arange(1024, device="cuda").sum()
        torch.cuda.synchronize()
        check(int(probe) == 523776, f"{cls.__name__}: the card is unusable after the fixture")
        print(f"fixture {cls.__name__}: {code} on the card == cpu "
              f"{[(d.code, d.severity.value, d.location) for d in r.diagnostics]}; "
              f"{r.errors[0].message[:160] if r.errors else ''}", flush=True)

    # The strict path: a clean 2pc-7 run at the bench options, and a broken
    # fixture refused before any engine kernel launches.
    def strict7():
        c, t = bfs(two_pc(7), "cuda", BENCH7, lambda b: b.strict())
        check_2pc(c, 7)  # its paths walk through K6
        return c, t

    (c7, t7), _ = counted(torch, kernels, "strict 2pc-7", strict7, kernels.BFS_KERNELS + kernels.LINT_KERNELS)
    tel = c7.telemetry()
    lint_tel = {k: v for k, v in tel.items() if k.startswith("lint_")}
    check(lint_tel.get("lint_errors") == 0 and "lint_warnings" in lint_tel, f"strict 2pc-7 telemetry {lint_tel}")
    print(f"strict 2pc-7: unique={c7.unique_state_count()} wall_secs={t7:.3f} lint telemetry {lint_tel} "
          f"card={card}", flush=True)
    kernels.reset_launches()
    try:
        TensorModelAdapter(fx.WrapShiftTensor()).checker().strict().spawn_gpu_bfs(**BENCH7)
        refused = None
    except SpecLintError as e:
        refused = e
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check(refused is not None and "STR205" in str(refused), "strict spawn of a broken fixture was not refused")
    check(not any(counts[k.name] for k in kernels.BFS_KERNELS),
          f"a refused strict spawn launched engine kernels: {counts}")
    print(f"strict spawn of WrapShiftTensor refused (STR205) with no engine kernel launched; "
          f"lane_agree launches {counts['lane_agree']}", flush=True)
    return res, launches


# -- phase 20: the host spill, checkpoints and the degraded regrow (K7s) -----

# 2pc-10 at phase 7's options through a ring of 2^22 rows, a sixteenth of
# its 2^26; paxos-3 killed at a target and resumed; 2pc-7 at 8 shards with
# chunk 1,024 asked and 55 taken (the clamp of a 2^12 ring a shard, whose
# high water of 3,584 rows 2pc-7's frontier passes), and at 1 shard.
SPILL10 = dict(FULL10, queue_capacity=1 << 22)
PAXOS3_KILL = 600_000
SPILL_MESH = {MESH_N: dict(chunk_size=1024, queue_capacity_per_shard=1 << 12, table_capacity_per_shard=1 << 18),
              1: dict(chunk_size=1024, queue_capacity_per_shard=1 << 12, table_capacity_per_shard=1 << 21)}
SPILL_LANES = 8


def spill_kernel_parity(torch, np):
    """K7s DRAIN and REFILL against their plain versions on the same card
    tensors, exactly: one ring at the 2pc-10 spilling run's widths (its
    largest drain, from a head that wraps) and 8 shards' rings with
    ragged row counts (a shard with none, one with its whole ring)."""
    from stateright_tpu_torch.ops import frontier as fr

    dev = torch.device("cuda")
    tm = two_pc(10)
    S, A, qcap = tm.state_width, tm.max_actions, SPILL10["queue_capacity"]
    C = min(SPILL10["chunk_size"], qcap // (2 * A))
    W = S + 2
    hw = qcap - C * A
    k = qcap - max(hw // 2, hw - 64 * C * A)
    gen = torch.Generator(device=dev).manual_seed(20)

    def ring_of(*shape):
        r = torch.randint(0, 1 << 32, shape, dtype=torch.int64, device=dev, generator=gen)
        r[..., -1] = 0
        return r

    ring = ring_of(W, qcap + 1)
    start = qcap - 12_345
    out = torch.empty((k, W), dtype=torch.int32, device=dev)
    drained = fr.ring_drain(ring, start, k, out).clone()
    errs_d = [max_abs_err(torch, [(drained, fr.ring_drain_plain(ring, start, k))])]
    tail = start + 777
    r1, r2 = ring.clone(), ring.clone()
    fr.ring_refill(r1, tail, drained)
    fr.ring_refill_plain(r2, tail, drained)
    errs_r = [max_abs_err(torch, [(r1, r2)])]
    # 8 shards, ragged.
    q8 = 1 << 15
    rings = ring_of(SPILL_LANES, W, q8 + 1)
    ks = [0, 17, q8, 4_096, 1, 30_000, 12_345, 999]
    starts = [q8 - 5, 3, 0, q8 - 2_000, 77, 10, q8 - 1, 31_000]
    lanes = fr.ring_drain_lanes(rings, starts, ks).clone()
    errs_d.append(max_abs_err(torch, [(lanes, fr.ring_drain_lanes_plain(rings, starts, ks))]))
    g1, g2 = rings.clone(), rings.clone()
    tails = [s + 100 for s in starts]
    fr.ring_refill_lanes(g1, tails, ks, lanes)
    fr.ring_refill_lanes_plain(g2, tails, ks, lanes)
    errs_r.append(max_abs_err(torch, [(g1, g2)]))
    torch.cuda.synchronize()
    idx = fr.ring_indices(start, k, qcap, dev)
    idx_t = fr.ring_indices(tail, k, qcap, dev)
    rows64 = fr.from_u32_bits(drained).T.contiguous()
    flat8 = fr._flat_rows(rings, starts, ks).reshape(-1)
    flat8_t = fr._flat_rows(rings, tails, ks).reshape(-1)
    vals8 = fr.from_u32_bits(lanes).reshape(-1)
    # A spill's trip through the run's pinned buffer, as SpillStaging
    # makes it: the drain and its copy out, the copy in and the refill.
    pinned = torch.empty((k, W), dtype=torch.int32, pin_memory=True)

    def drain_to_host(_):
        fr.ring_drain(ring, start, k, out)
        pinned.copy_(out, non_blocking=True)

    def refill_from_host(_):
        out.copy_(pinned, non_blocking=True)
        fr.ring_refill(r1, tail, out)

    K8 = sum(ks)
    shape = f"[{k}, {W}] of a 2^{qcap.bit_length() - 1} ring; 8 rings of 2^15, {K8} ragged rows"
    return {
        "ring_drain": dict(
            max_abs_err=max(errs_d),
            ms=time_device_ms(torch, lambda _: fr.ring_drain(ring, start, k, out)),
            call_ms=time_ms(torch, lambda _: fr.ring_drain(ring, start, k, out)),
            plain_ms=time_ms(torch, lambda _: fr.ring_drain_plain(ring, start, k)),
            lanes_ms=time_device_ms(torch, lambda _: fr.ring_drain_lanes(rings, starts, ks, out)),
            lanes_library_ms=time_device_ms(torch, lambda _: rings.view(-1).index_select(0, flat8)),
            host_ms=time_device_ms(torch, drain_to_host),
            # Each row read once (8 bytes a lane) and written once (4).
            bytes=k * W * 12, ops=k * W,
            library_ms=time_device_ms(torch, lambda _: ring.index_select(1, idx)),
            shape=shape,
        ),
        "ring_refill": dict(
            max_abs_err=max(errs_r),
            ms=time_device_ms(torch, lambda _: fr.ring_refill(r1, tail, drained)),
            call_ms=time_ms(torch, lambda _: fr.ring_refill(r1, tail, drained)),
            plain_ms=time_ms(torch, lambda _: fr.ring_refill_plain(r2, tail, drained)),
            lanes_ms=time_device_ms(torch, lambda _: fr.ring_refill_lanes(g1, tails, ks, lanes)),
            lanes_library_ms=time_device_ms(torch, lambda _: g2.view(-1).index_copy_(0, flat8_t, vals8)),
            host_ms=time_device_ms(torch, refill_from_host),
            bytes=k * W * 12, ops=k * W,
            library_ms=time_device_ms(torch, lambda _: r2.index_copy_(1, idx_t, rows64)),
            shape=shape,
        ),
    }


def timed_saves(common):
    """Wrap the checkpoint IO so that each save's seconds and bytes are
    kept; returns (log, undo)."""
    log = []
    orig = common.save_checkpoint_atomic, common.save_checkpoint_delta

    def wrap(fn, kind):
        def run(path, *a, **k):
            t0 = time.monotonic()
            out = fn(path, *a, **k)
            log.append(dict(kind=kind, secs=round(time.monotonic() - t0, 4), bytes=os.path.getsize(path)))
            return out
        return run

    common.save_checkpoint_atomic = wrap(orig[0], "base")
    common.save_checkpoint_delta = wrap(orig[1], "delta")

    def undo():
        common.save_checkpoint_atomic, common.save_checkpoint_delta = orig

    return log, undo


def exact_bottom_k(torch, table, k=64):
    """The k smallest fingerprints (as unsigned 64-bit keys) of every
    state in a visited table, on the card: what a bottom-k sample is
    when no capture was dropped."""
    keys = table.keys.reshape(-1)
    flip = torch.iinfo(torch.int64).min  # signed order of key ^ 2^63 = unsigned order of key
    keys = keys[keys != 0] ^ flip
    low = torch.topk(keys, min(k, keys.numel()), largest=False).values ^ flip
    return tuple(sorted(int(v) % (1 << 64) for v in low.tolist()))


def spill_phase(torch, np, kernels, card, skip_full, ref10, ref_px, single):
    """Phase 20: K7s against its plain versions; 2pc-10 spilling (and
    under a host budget, through the disk tier) against the unspilled
    run; paxos-3 killed and resumed; the degraded regrow on 2pc-7; 2pc-7
    spilling at 8 shards against 1 shard. `ref10`, `ref_px`: the
    unspilled 2pc-10 and unbroken paxos-3 results of phases 7 and 5
    (run here when None). Returns the K7s timing dicts and its launches
    in the spilling runs (2pc-10 and 8 shards)."""
    import shutil
    import tempfile

    from stateright_tpu_torch.engines import common
    from stateright_tpu_torch.engines.gpu_bfs import GpuBfsChecker
    from stateright_tpu_torch.models import PaxosTensorExhaustive

    res = finish(spill_kernel_parity(torch, np))
    for name, r in res.items():
        print(f"kernel {name} at 8 shards: lanes_ms={r['lanes_ms']:.4f} card={card}", flush=True)
    torch.cuda.empty_cache()
    launches_spill = {k.name: 0 for k in kernels.SPILL_KERNELS}
    solo_path = kernels.BFS_KERNELS + kernels.SPILL_KERNELS
    tmp = tempfile.mkdtemp(prefix="chip_smoke-spill-")

    def summary(c, wall):
        tel = c.telemetry()
        ph = tel.get("phase_ms", {})
        return dict(unique=c.unique_state_count(), states=c.state_count(), wall_secs=round(wall, 3),
                    eras=tel["eras"], steps=tel["steps"], dispatches=tel["dispatches"],
                    spill_rows=tel.get("spill_rows", 0), refill_rows=tel.get("refill_rows", 0),
                    spill_ms=ph.get("spill", 0.0), refill_ms=ph.get("refill", 0.0),
                    device_era_ms=ph.get("device_era", 0.0),
                    spill_host_peak_bytes=tel.get("spill_host_peak_bytes", 0),
                    spill_tier_rows=tel.get("spill_tier_rows", 0),
                    spill_tier_refill_rows=tel.get("spill_tier_refill_rows", 0),
                    spill_disk_bytes=tel.get("spill_disk_bytes", 0), card=card)

    try:
        if not skip_full:
            if ref10 is None:
                c, _t = bfs(two_pc(10), "cuda", FULL10)
                ref10 = dict(states=c.state_count(), sample=tuple(c._sampler.fingerprints()))
                del c
                torch.cuda.empty_cache()
            print(f"2pc-10 spilling, options: {SPILL10}", flush=True)
            def run10():
                c, wall = bfs(two_pc(10), "cuda", SPILL10)
                return c, wall, check_paths(c)  # its paths walk through K6

            (c, wall, lens10), launches = counted(torch, kernels, "2pc-10 spilling", run10, solo_path)
            for k in kernels.SPILL_KERNELS:
                launches_spill[k.name] += launches[k.name]
            out = dict(summary(c, wall), paths=lens10)
            check(out["spill_rows"] > 0, "2pc-10 through a 2^22 ring did not spill")
            check(out["unique"] == GOLDEN[10], f"2pc-10 spilling: {out['unique']}")
            check(out["states"] == ref10["states"], "2pc-10 spilling: states differ from the unspilled run")
            check(tuple(c._sampler.fingerprints()) == ref10["sample"],
                  "2pc-10 spilling: the sample differs from the unspilled run")
            print(f"spill 2pc-10: {json.dumps(out)}", flush=True)
            budget = max(1, out["spill_host_peak_bytes"] // 4)
            del c
            torch.cuda.empty_cache()
            os.environ["STPU_SPILL_HOST_BUDGET_BYTES"] = str(budget)
            try:
                c, wall = bfs(two_pc(10), "cuda", SPILL10)
            finally:
                del os.environ["STPU_SPILL_HOST_BUDGET_BYTES"]
            out = dict(summary(c, wall), host_budget_bytes=budget)
            check(out["unique"] == GOLDEN[10] and tuple(c._sampler.fingerprints()) == ref10["sample"],
                  "2pc-10 through the disk tier differs from the unspilled run")
            check(out["spill_tier_rows"] > 0 and out["spill_tier_refill_rows"] == out["spill_tier_rows"],
                  f"2pc-10 disk tier: {out['spill_tier_rows']} rows down, {out['spill_tier_refill_rows']} back")
            print(f"spill 2pc-10 disk tier: {json.dumps(out)}", flush=True)
            del c
            torch.cuda.empty_cache()

        # paxos-3 killed at a target with a checkpoint at every era, then
        # resumed; beside an unbroken run.
        if ref_px is None:
            c, _t = bfs(PaxosTensorExhaustive(3), "cuda", PAXOS3)
            ref_px = dict(states=c.state_count(), max_depth=c.max_depth(), fps=dict(c._discovery_fps),
                          sample=tuple(c._sampler.fingerprints()), lens=check_paths(c),
                          drops=c._sampler.device_drops)
            del c
        path = os.path.join(tmp, "paxos3.npz")
        saves, undo = timed_saves(common)
        try:
            part, wall_part = bfs(PaxosTensorExhaustive(3), "cuda",
                                  dict(PAXOS3, checkpoint_path=path, checkpoint_every=1e-3),
                                  lambda b: b.target_state_count(PAXOS3_KILL))
        finally:
            undo()
        ptel = part.telemetry()
        part_unique = part.unique_state_count()
        check(part_unique < PAXOS3_GOLDEN, "paxos-3 kill: the target did not stop the run")
        check(ptel.get("checkpoint_delta_saves", 0) >= 2, f"paxos-3 kill: {ptel.get('checkpoint_delta_saves')} deltas")
        files = common.checkpoint_generations(path)[:1] + common.delta_chain_paths(path)
        del part
        torch.cuda.empty_cache()
        resumed, wall_res = bfs(PaxosTensorExhaustive(3), "cuda", dict(PAXOS3, resume_from=path))
        rtel = resumed.telemetry()
        lens = check_paths(resumed)
        # What a resume carries (ROADMAP Queue 3): not `max_depth`, read at
        # era ends, which a resumed run places elsewhere (in the JAX
        # engine too); it is printed beside the unbroken run's.
        got = dict(states=resumed.state_count(), fps=dict(resumed._discovery_fps), lens=lens)
        check(resumed.unique_state_count() == PAXOS3_GOLDEN, f"paxos-3 resumed: {resumed.unique_state_count()}")
        check(got == {k: ref_px[k] for k in got},
              f"paxos-3 resumed differs from the unbroken run: {got['states']} states, paths {got['lens']}")
        # The resumed run's sample is its table's exact bottom-k: the
        # restored sample's threshold is tight from its first step, so no
        # step drops a capture past its cap (the reference's
        # DEVICE_STEP_CAP). The unbroken run's early steps do drop
        # captures, so its sample is printed beside it and not held.
        exact = exact_bottom_k(torch, resumed._table)
        sample = tuple(resumed._sampler.fingerprints())
        for label, smp, drops in (("resumed", sample, resumed._sampler.device_drops),
                                  ("unbroken", ref_px["sample"], ref_px["drops"])):
            off = len(set(smp) ^ set(exact)) // 2
            print(f"paxos-3 {label} sample: {off} of 64 off the table's bottom-k, {drops} captures dropped",
                  flush=True)
        check(tuple(sorted(sample)) == exact, "paxos-3 resumed: the sample is not the table's bottom-k")
        out = dict(kill_at=PAXOS3_KILL, partial_unique=part_unique, partial_wall_secs=round(wall_part, 3),
                   saves=saves, checkpoint_save_ms=ptel["phase_ms"].get("checkpoint_save"),
                   checkpoint_saves=ptel.get("checkpoint_saves"), checkpoint_delta_saves=ptel["checkpoint_delta_saves"],
                   load_files_bytes=[os.path.getsize(f) for f in files],
                   checkpoint_load_ms=rtel["phase_ms"].get("checkpoint_load"),
                   delta_folds=rtel.get("checkpoint_delta_folds", 0), resumed_wall_secs=round(wall_res, 3),
                   resumed_states=resumed.state_count(),
                   max_depth=dict(resumed=resumed.max_depth(), unbroken=ref_px["max_depth"]), card=card)
        print(f"checkpoint paxos-3: {json.dumps(out)}", flush=True)
        del resumed
        torch.cuda.empty_cache()

        # The degraded regrow: a probe error faked at era 1 of 2pc-7.
        orig_start = GpuBfsChecker._start

        def start(self):
            self._chaos_probe_error_era = 1
            orig_start(self)

        GpuBfsChecker._start = start
        try:
            c, wall = bfs(two_pc(7), "cuda", dict(BENCH7, checkpoint_path=os.path.join(tmp, "regrow.npz"),
                                                  checkpoint_every=1e-3))
        finally:
            GpuBfsChecker._start = orig_start
        tel = c.telemetry()
        check(tel.get("degraded_regrow") == 1, f"2pc-7 regrow: degraded_regrow={tel.get('degraded_regrow')}")
        check_2pc(c, 7)
        print(f"regrow 2pc-7: unique={c.unique_state_count()} wall_secs={wall:.3f} "
              f"degraded_regrow={tel['degraded_regrow']} table_growths={tel.get('table_growths')} "
              f"table_capacity={tel['table_capacity']} checkpoint_saves={tel.get('checkpoint_saves')} "
              f"checkpoint_load_ms={tel['phase_ms'].get('checkpoint_load')} card={card}", flush=True)
        del c
        torch.cuda.empty_cache()

        # 2pc-7 spilling at 8 shards and at 1 shard.
        mesh_path = kernels.MESH_KERNELS + kernels.SPILL_KERNELS
        results = {}
        for n, opts in SPILL_MESH.items():
            def go():
                c, wall = mesh_bfs(two_pc(7), "cuda", n, opts)
                return c, wall, check_paths(c)

            (c, wall, lens), launches = counted(torch, kernels, f"2pc-7 spilling at {n} shards", go, mesh_path)
            if n == MESH_N:
                for k in kernels.SPILL_KERNELS:
                    launches_spill[k.name] += launches[k.name]
            out = dict(summary(c, wall), shards=n, chunk=c.telemetry()["chunk"], quota=c.telemetry()["quota"],
                       max_depth=c.max_depth(), paths=lens)
            check(out["spill_rows"] > 0, f"2pc-7 at {n} shards did not spill")
            check(out["unique"] == GOLDEN[7], f"2pc-7 spilling at {n} shards: {out['unique']}")
            results[n] = (out["states"], tuple(c._sampler.fingerprints()), lens)
            check(results[n][1] == exact_bottom_k(torch, c._prog.table),
                  f"2pc-7 spilling at {n} shards: the sample is not the table's bottom-k")
            print(f"spill 2pc-7 at {n} shards: {json.dumps(out)}", flush=True)
            del c
        check(results[MESH_N] == results[1], "2pc-7 spilling: 8 shards differ from 1 shard")
        print(f"2pc-7 spilling: 8 shards == 1 shard (states, sample, path lengths); the sample equals the "
              f"solo run's (phase 4): {results[1][1] == single['2pc-7 sample']}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return res, launches_spill


def single_copy_lock_phase(torch, kernels, card, threads, HasDiscoveries, SingleCopyTensor,
                           IncrementLockTensor):
    """Phase 6b: the reference bench's single-copy-register check 4 to its
    400,233 states with no linearizability violation, the 3x2 model's
    violation found and replayed, increment-lock-2 and -3 exhausted with
    both properties holding, each on K11's kernel route; then cuda == cpu
    (the whole result dict, sample included) for single-copy (2, 1), (3,
    1) and the (2, 2) violation and increment-lock-2 and -3, and the 3x2
    violation found by the simulation through WALK. Returns the launches
    of the check-4 run and of increment-lock-3's, for the kernels line,
    and the walks' runs as {kernel name: launches}."""
    def exhaust():
        c, t = bfs(SingleCopyTensor(4), "cuda", SC4)
        return c, t, check_paths(c)

    exhaust()  # warm-up: the first run pays its torch kernels' module loads
    (c4, t4, lens), launches_sc = counted(torch, kernels, "single-copy-4", exhaust)
    check(c4.unique_state_count() == SC4_GOLDEN, f"single-copy-4: {c4.unique_state_count()}")
    check_k11(kernels, "single-copy-4", c4, launches_sc, kernels.EXPAND_SINGLE_COPY)
    c4.assert_no_discovery("linearizable")
    c4.assert_no_discovery("network within capacity")
    tel = c4.telemetry()
    steps = tel["steps"] + tel.get("partial_steps", 0)
    print(f"single-copy-4: unique={c4.unique_state_count()} states={c4.state_count()} time_to_exhaust_secs={t4:.3f} "
          f"wall_per_step_ms={t4 / max(1, steps) * 1e3:.4f} steps={steps} "
          f"generated_states_per_sec={c4.state_count() / t4:.1f} paths={lens} telemetry={tel} card={card}",
          flush=True)
    del c4

    def violation():
        c, t = bfs(SingleCopyTensor(3, 2), "cuda", SC32,
                   lambda b: b.finish_when(HasDiscoveries.any_of(["linearizable"])))
        return c, t, check_paths(c)

    violation()  # warm-up
    (c32, t32, lens), launches32 = counted(torch, kernels, "single-copy-3x2", violation)
    check_k11(kernels, "single-copy-3x2", c32, launches32, kernels.EXPAND_SINGLE_COPY)
    path = c32.discovery("linearizable")
    check(path is not None and "linearizable" in lens, "single-copy-3x2: no linearizability violation")
    c32.assert_discovery("linearizable", path.into_actions())
    check(not c32.model().property("linearizable").condition(c32.model(), path.last_state()),
          "single-copy-3x2: the violation's path ends where linearizable holds")
    print(f"single-copy-3x2: linearizable violated after {c32.unique_state_count()} states, "
          f"time_to_counterexample_secs={t32:.4f} path of {lens['linearizable']} "
          f"telemetry={c32.telemetry()} card={card}", flush=True)

    launches_lock = None
    for n in (2, 3):
        def lock(n=n):
            c, t = bfs(IncrementLockTensor(n), "cuda", LOCK_OPTS)
            return c, t, check_paths(c)

        # Both properties hold: no discovery, no path, so K6 does not run.
        (cl, tl, lens), launches_l = counted(
            torch, kernels, f"increment-lock-{n}", lock,
            tuple(k for k in kernels.BFS_KERNELS if k is not kernels.LOOKUP_PARENT))
        check(cl.unique_state_count() == LOCK_GOLDEN[n], f"increment-lock-{n}: {cl.unique_state_count()}")
        check_k11(kernels, f"increment-lock-{n}", cl, launches_l, kernels.EXPAND_INCREMENT_LOCK)
        cl.assert_properties()
        print(f"increment-lock-{n}: unique={cl.unique_state_count()} wall_secs={tl:.4f} fin and mutex hold "
              f"card={card}", flush=True)
        launches_lock = launches_l

    # cuda == cpu: the whole result dict, sample included.
    for label, make, want in (
        ("single-copy-2", lambda: SingleCopyTensor(2), 93),
        ("single-copy-3", lambda: SingleCopyTensor(3), 4_243),
        ("single-copy-2x2", lambda: SingleCopyTensor(2, 2), 62),
        ("increment-lock-2", lambda: IncrementLockTensor(2), LOCK_GOLDEN[2]),
        ("increment-lock-3", lambda: IncrementLockTensor(3), LOCK_GOLDEN[3]),
    ):
        c_gpu, t_gpu = bfs(make(), "cuda", TEST_OPTS)
        check(c_gpu.telemetry()["expand_route"] == "kernel", f"{label}: the plain route on the card")
        d_gpu = result_dict(c_gpu)
        torch.set_num_threads(1)
        c_cpu, t_cpu = bfs(make(), "cpu", TEST_OPTS)
        torch.set_num_threads(threads)
        d_cpu = result_dict(c_cpu)
        check(d_gpu == d_cpu, f"{label}: cuda {d_gpu} != cpu {d_cpu}")
        check(d_gpu["unique"] == want, f"{label}: {d_gpu['unique']} states")
        if label == "single-copy-2x2":
            check("linearizable" in d_gpu["paths"], "single-copy-2x2: no linearizability violation")
        check_paths(c_gpu)
        print(f"{label} equal on cuda ({t_gpu:.3f}s) and cpu ({t_cpu:.3f}s): unique={want} "
              f"discoveries={sorted(d_gpu['paths'])} sample of {len(d_gpu['sample'])}", flush=True)

    # The walks: the 3x2 violation through WALK, and increment-lock-3 to a
    # target; cuda == cpu.
    launches_walk = {}
    for label, make, seed, configure, opts, k11 in (
        ("single-copy-3x2", lambda: SingleCopyTensor(3, 2), 5,
         lambda b: b.coverage().finish_when(HasDiscoveries.any_of(["linearizable"])), SIM_SC32,
         kernels.WALK_SINGLE_COPY),
        ("increment-lock-3", lambda: IncrementLockTensor(3), 0, lambda b: b.target_state_count(20_000),
         SIM_LOCK3, kernels.WALK_INCREMENT_LOCK),
    ):
        (c_gpu, t_gpu), launches_w = counted(torch, kernels, f"{label} simulation",
                                             lambda: simulate(make(), "cuda", seed, configure, opts),
                                             kernels.SIM_KERNELS)
        check_k11(kernels, f"{label} simulation", c_gpu, launches_w, k11, "walk_step")
        launches_walk[k11.name] = launches_w[k11.name]
        torch.set_num_threads(1)
        c_cpu, t_cpu = simulate(make(), "cpu", seed, configure, opts)
        torch.set_num_threads(threads)
        d_gpu, d_cpu = sim_dict(c_gpu), sim_dict(c_cpu)
        check(d_gpu == d_cpu, f"{label} simulation: cuda {d_gpu} != cpu {d_cpu}")
        lens = check_paths(c_gpu)
        if label == "single-copy-3x2":
            check("linearizable" in lens, "single-copy-3x2 simulation: no linearizability violation")
            c_gpu.assert_discovery("linearizable", c_gpu.discovery("linearizable").into_actions())
        else:
            c_gpu.assert_no_discovery("fin")
            c_gpu.assert_no_discovery("mutex")
        print(f"{label} simulation equal on cuda ({t_gpu:.3f}s) and cpu ({t_cpu:.3f}s): "
              f"generated={d_gpu['states']} steps={d_gpu['steps']} eras={d_gpu['eras']} paths={lens} card={card}",
              flush=True)
    return launches_sc, launches_lock, launches_walk


def main(argv) -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "stateright_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    # The JAX-free test helpers (torch_era_ops, torch_lint_fixtures), last,
    # so that nothing there shadows a module the smoke imports.
    sys.path.append(os.path.join(HERE, "tests"))
    if argv[:1] == ["--profile-one"]:
        print(json.dumps(profiled_run(torch, argv[1], argv[2])), flush=True)
        return 0
    skip_full = "--skip-full" in argv
    lint_only = "--lint-only" in argv
    spill_only = "--spill-only" in argv
    from stateright_tpu_torch import kernels
    from stateright_tpu_torch.has_discoveries import HasDiscoveries
    from stateright_tpu_torch.models import (
        AbdOrderedTensor,
        AbdTensor,
        IncrementLockTensor,
        IncrementTensor,
        PaxosTensor,
        PaxosTensorExhaustive,
        SingleCopyTensor,
    )

    phase("0 environment")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    print("nvcc:", run([kernels._nvcc(), "--version"]).splitlines()[-1])
    card = card_line()
    print("card:", card, "| devices:", torch.cuda.device_count())

    phase("1 build")
    secs = kernels.build_all(verbose=True)
    print(f"build_secs={secs:.2f}", flush=True)
    if lint_only:
        phase("19 the speclint pre-flight (K16, K16a)")
        lint_phase(torch, np, kernels, card)
        print(f"chip_smoke --lint-only: phases 0, 1 and 19 passed in {time.monotonic() - T0:.1f} s", flush=True)
        return 0
    if spill_only:
        phase("20 the host spill, checkpoints and the degraded regrow (K7s)")
        c7, _t = bfs(two_pc(7), "cuda", BENCH7)
        single = {"2pc-7 sample": tuple(c7._sampler.fingerprints())}
        del c7
        spill_res, launches_spill = spill_phase(torch, np, kernels, card, skip_full, None, None, single)
        print(json.dumps({"kernels": [
            dict(name=k.name, route="cuda", source=os.path.relpath(k.source_path, HERE), replaces=k.replaces,
                 launches=launches_spill[k.name], **{key: spill_res[k.name][key] for key in (
                     "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
            for k in kernels.SPILL_KERNELS]}))
        print(f"chip_smoke --spill-only: phases 0, 1 and 20 passed in {time.monotonic() - T0:.1f} s", flush=True)
        return 0

    phase("2 kernel parity (2pc-7 and paxos-3 widths)")
    results, extra7 = kernel_parity(torch, np, "2pc-7", 6144, 37, 3, 1 << 22, 1 << 20)
    results_px, extra_px = kernel_parity(torch, np, "paxos-3", 16384, 21, 30, 1 << 26, 1 << 21)
    for label, extra in (("2pc-7", extra7), ("paxos-3", extra_px)):
        for name, r in finish(extra).items():
            print(f"beside the kernels ({label}): {name}", flush=True)
    torch.cuda.empty_cache()

    phase("2b K11: EXPAND and WALK against their plain versions (2pc-7, paxos-3, the lane widths, 2pc-10 walks)")
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import expand_times

    k11_res = finish(expand_times.measure(torch, sys.modules[__name__]))
    for name, r in k11_res.items():
        print(f"K11 {name}: graph_plain_ms={r['graph_plain_ms']:.4f} plain_launches={r['plain_launches']} "
              f"kernels_a_call={r['launches_a_call']} card={card}", flush=True)
    torch.cuda.empty_cache()

    phase("3 2pc-5 on cuda and on cpu, sampling on, plain and with symmetry")
    threads = torch.get_num_threads()
    for label, configure, closure in (
        ("2pc-5", lambda b: b, GOLDEN[5]),
        ("2pc-5 symmetry", lambda b: b.symmetry(), SYM_CLOSURE[5]),
    ):
        def on_card():
            c, t = bfs(two_pc(5), "cuda", TEST_OPTS, configure)
            return c, t, result_dict(c)  # its paths walk through K6

        (c_gpu, t_gpu, d_gpu), launches3 = counted(torch, kernels, label, on_card)
        check_k11(kernels, label, c_gpu, launches3, kernels.EXPAND_2PC)
        check_canon(kernels, label, c_gpu, launches3, label.endswith("symmetry"))
        if label.endswith("symmetry"):
            launches_canon = launches3  # the kernels line's, with --skip-full
        tel3 = c_gpu.telemetry()
        print(f"{label} kernel launches a step: "
              f"{json.dumps(per_step(launches3, tel3['steps'] + tel3.get('partial_steps', 0)))}", flush=True)
        torch.set_num_threads(1)  # small CPU ops: the thread pool only slows them
        c_cpu, t_cpu = bfs(two_pc(5), "cpu", TEST_OPTS, configure)
        torch.set_num_threads(threads)
        d_cpu = result_dict(c_cpu)
        check(d_gpu == d_cpu, f"{label} cuda {d_gpu} != cpu {d_cpu}")
        check(d_gpu["unique"] == closure and len(d_gpu["sample"]) == 64, f"{label} golden / sample")
        print(f"{label} equal on cuda ({t_gpu:.2f}s) and cpu ({t_cpu:.2f}s), unique={closure}, "
              f"sample of {len(d_gpu['sample'])}: {c_gpu.telemetry()}", flush=True)

    phase("4 2pc-7 headline")
    bfs(two_pc(7), "cuda", BENCH7)  # warm-up

    def two_pc7():
        c, t = bfs(two_pc(7), "cuda", BENCH7)
        check_2pc(c, 7)  # its paths walk through K6
        return c, t

    (c7, t7), launches = counted(torch, kernels, "2pc-7", two_pc7)
    check_k11(kernels, "2pc-7", c7, launches, kernels.EXPAND_2PC)
    d7 = result_dict(c7)
    tel7 = c7.telemetry()
    print(f"2pc-7: unique={c7.unique_state_count()} states={c7.state_count()} wall_secs={t7:.3f} "
          f"generated_states_per_sec={c7.state_count() / t7:.1f} unique_per_sec={c7.unique_state_count() / t7:.1f} "
          f"telemetry={c7.telemetry()} card={card}", flush=True)
    # Phase 18 holds the sharded runs' discoveries against these, phase 20
    # the sample.
    single = {"2pc-7": (dict(c7._discovery_fps), check_paths(c7)), "2pc-7 sample": d7["sample"]}
    c7g, t7g = bfs(two_pc(7), "cuda", dict(BENCH7, table_capacity=1 << 16))
    check(result_dict(c7g) == d7, "2pc-7 with growth differs from the run without")
    print(f"2pc-7 with growth from 2^16: equal, wall_secs={t7g:.3f} telemetry={c7g.telemetry()}", flush=True)
    walls = {"on": [t7], "off": []}
    for mode in ("off", "off", "on"):
        c, t = bfs(two_pc(7), "cuda", BENCH7, (lambda b: b) if mode == "on" else (lambda b: b.sample(False)))
        check(c.unique_state_count() == GOLDEN[7], "2pc-7 golden")
        walls[mode].append(t)
    print(f"2pc-7 sampling cost: wall_secs on={walls['on']} off={walls['off']} "
          f"(order on, off, off, on) card={card}", flush=True)
    for name, r in finish({"K10f (2pc-7)": k10f_case(torch, np, "2pc-7", two_pc(7), BENCH7)}).items():
        print(f"{name}: seed_ms={r['seed_ms']:.4f} (the device part alone) card={card}", flush=True)

    phase("5 paxos-3")
    torch.cuda.reset_peak_memory_stats()

    def paxos3():
        c, t = bfs(PaxosTensorExhaustive(3), "cuda", PAXOS3)
        peak = torch.cuda.max_memory_allocated()
        t0 = time.monotonic()
        lens = check_paths(c)
        t_paths = time.monotonic() - t0
        t0 = time.monotonic()
        prof = c.space_profile()
        t_prof = time.monotonic() - t0
        return c, t, peak, lens, t_paths, prof, t_prof

    (cpx, tpx, peak, lens, t_paths, prof, t_prof), launches_px = counted(torch, kernels, "paxos-3", paxos3)
    check(cpx.unique_state_count() == PAXOS3_GOLDEN, f"paxos-3: {cpx.unique_state_count()}")
    check_k11(kernels, "paxos-3", cpx, launches_px, kernels.EXPAND_PAXOS)
    for name in ("linearizable", "network within capacity", "ballot rounds within range"):
        cpx.assert_no_discovery(name)
    check("value chosen" in lens, "paxos-3: value chosen not found")
    check(prof["samples"] == 64 and prof["unresolved"] == 0, "paxos-3 sample rows unresolved")
    single["paxos-3"] = (dict(cpx._discovery_fps), lens)
    # Phase 20's resumed run is held against this one.
    ref_px = dict(states=cpx.state_count(), max_depth=cpx.max_depth(), fps=dict(cpx._discovery_fps),
                  sample=tuple(cpx._sampler.fingerprints()), lens=lens, drops=cpx._sampler.device_drops)
    tel = cpx.telemetry()
    print(f"paxos-3: unique={cpx.unique_state_count()} states={cpx.state_count()} wall_secs={tpx:.3f} "
          f"generated_states_per_sec={cpx.state_count() / tpx:.1f} steps={tel.get('steps')} "
          f"max_memory_allocated={peak} paths={lens} paths_secs={t_paths:.3f} "
          f"space_profile_secs={t_prof:.3f} telemetry={tel} card={card}", flush=True)
    for name, r in finish({"K10f (paxos-3)": k10f_case(torch, np, "paxos-3", PaxosTensorExhaustive(3),
                                                       PAXOS3)}).items():
        print(f"{name}: seed_ms={r['seed_ms']:.4f} (the device part alone) card={card}", flush=True)

    phase("6 abd-ordered-3 and abd-2")
    def with_paths(model, opts, configure=lambda b: b):
        c, t = bfs(model, "cuda", opts, configure)
        return c, t, check_paths(c)

    (cab, tab, lens), launches_ab = counted(torch, kernels, "abd-ordered-3",
                                            lambda: with_paths(AbdOrderedTensor(3), ABDO3))
    check(cab.unique_state_count() == ABDO3_GOLDEN, f"abd-ordered-3: {cab.unique_state_count()}")
    check_k11(kernels, "abd-ordered-3", cab, launches_ab, kernels.EXPAND_ABD)
    cab.assert_no_discovery("linearizable")
    print(f"abd-ordered-3: unique={cab.unique_state_count()} states={cab.state_count()} wall_secs={tab:.3f} "
          f"generated_states_per_sec={cab.state_count() / tab:.1f} paths={lens} "
          f"telemetry={cab.telemetry()} card={card}", flush=True)
    # The unordered network: linearizable-register check 2 (bench.py:1137-1145).
    (ca2, ta2, lens), launches_a2 = counted(torch, kernels, "abd-2", lambda: with_paths(AbdTensor(2), ABD2))
    check(ca2.unique_state_count() == ABD2_GOLDEN, f"abd-2: {ca2.unique_state_count()}")
    check_k11(kernels, "abd-2", ca2, launches_a2, kernels.EXPAND_ABD)
    ca2.assert_no_discovery("linearizable")
    print(f"abd-2: unique={ca2.unique_state_count()} states={ca2.state_count()} wall_secs={ta2:.3f} "
          f"paths={lens} telemetry={ca2.telemetry()} card={card}", flush=True)
    del ca2

    phase("6b single-copy-register check 4; the 3x2 violation; increment-lock-2 and -3; cuda == cpu")
    launches_sc, launches_lock, launches_walk_new = single_copy_lock_phase(torch, kernels, card, threads, HasDiscoveries,
                                                        SingleCopyTensor, IncrementLockTensor)

    if not skip_full:
        phase("7 2pc-10 full size, plain and with symmetry")
        del c7, c7g, cpx, prof, cab  # their tables would count in the peak
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        c10, t10 = bfs(two_pc(10), "cuda", FULL10)
        check(c10.unique_state_count() == GOLDEN[10], f"2pc-10: {c10.unique_state_count()}")
        print(f"2pc-10: unique={c10.unique_state_count()} states={c10.state_count()} wall_secs={t10:.3f} "
              f"generated_states_per_sec={c10.state_count() / t10:.1f} "
              f"max_memory_allocated={torch.cuda.max_memory_allocated()} telemetry={c10.telemetry()} card={card}",
              flush=True)
        # Phase 20's spilling runs are held against this one.
        ref10 = dict(states=c10.state_count(), sample=tuple(c10._sampler.fingerprints()))
        del c10
        torch.cuda.empty_cache()
        (c10s, t10s, lens), launches10s = counted(torch, kernels, "2pc-10 symmetry",
                                                  lambda: with_paths(two_pc(10), SYM10, lambda b: b.symmetry()))
        check(c10s.unique_state_count() == SYM_CLOSURE[10], f"2pc-10 symmetry: {c10s.unique_state_count()}")
        check_k11(kernels, "2pc-10 symmetry", c10s, launches10s, kernels.EXPAND_2PC)
        check_canon(kernels, "2pc-10 symmetry", c10s, launches10s, True)
        launches_canon = launches10s
        c10s.assert_no_discovery("consistent")
        print(f"2pc-10 symmetry: unique={c10s.unique_state_count()} states={c10s.state_count()} "
              f"wall_secs={t10s:.3f} paths={lens} telemetry={c10s.telemetry()} card={card}",
              flush=True)

    phase("8 simulation kernel parity (paxos-3 and 2pc-10 simulation widths)")
    sim_px = sim_kernel_parity(torch, np, "paxos-3", PaxosTensor(3), SIM_PAXOS3["walks"], SIM_L)
    sim_kernel_parity(torch, np, "2pc-10", two_pc(10), SIM_2PC10["walks"], SIM_L)

    phase("9 simulation on cuda and on cpu: increment-2, 2pc-5 and 2pc-10; 2pc-5 against the reference")

    def fin_any(b):
        return b.finish_when(HasDiscoveries.any_of(["fin"]))

    def target(n):
        return lambda b: b.target_state_count(n)

    dicts, launches_walk = {}, {}
    for label, model, seed, configure, opts, k11 in (
        ("increment-2", IncrementTensor(2), 7, fin_any, SIM_INC2, kernels.WALK_INCREMENT),
        ("2pc-5", two_pc(5), 11, target(200_000), SIM_2PC5, kernels.WALK_2PC),
        ("abd-ordered-3", AbdOrderedTensor(3), 0, target(200_000), SIM_ABDO3, kernels.WALK_ABD),
        ("2pc-10", two_pc(10), 0, target(300_000), SIM_2PC10_SMALL, kernels.WALK_2PC),
    ):
        (c_gpu, t_gpu), launches9 = counted(torch, kernels, f"{label} simulation",
                                            lambda: simulate(model, "cuda", seed, configure, opts), kernels.SIM_KERNELS)
        check_k11(kernels, f"{label} simulation", c_gpu, launches9, k11, "walk_step")
        launches_walk[k11.name] = launches9  # walk_2pc: the 2pc-10 run's, the loop's last
        torch.set_num_threads(1)
        c_cpu, t_cpu = simulate(model, "cpu", seed, configure, opts)
        torch.set_num_threads(threads)
        d_gpu, d_cpu = sim_dict(c_gpu), sim_dict(c_cpu)
        check(d_gpu == d_cpu, f"{label} simulation: cuda {d_gpu} != cpu {d_cpu}")
        lens = check_paths(c_gpu)
        check(len(d_gpu["sample"]) > 0 and (lens or label == "abd-ordered-3"),
              f"{label} simulation: no discovery or no sample")
        if label == "abd-ordered-3":
            c_gpu.assert_no_discovery("linearizable")
        dicts[label] = d_gpu
        print(f"{label} simulation equal on cuda ({t_gpu:.3f}s) and cpu ({t_cpu:.3f}s): "
              f"generated={d_gpu['states']} steps={d_gpu['steps']} eras={d_gpu['eras']} paths={lens} "
              f"sample of {len(d_gpu['sample'])}", flush=True)
    def reach(b):
        return b.finish_when(HasDiscoveries.any_of(["commit agreement"])).target_state_count(5_000_000)

    for walks, want in REACH_2PC5.items():
        c, t = simulate(two_pc(5), "cuda", 0, reach, dict(walks=walks, walk_cap=SIM_L, sync_steps=64))
        tel = c.telemetry()
        got = ("commit agreement" in c.discoveries(), c.state_count(), tel["steps"], tel["eras"])
        check(got == want, f"2pc-5 simulation, {walks} walks: (found, states, steps, eras) {got} != the reference's {want}")
        lens = check_paths(c)
        print(f"2pc-5 simulation, {walks} walks: commit agreement {'found' if got[0] else 'not found'} after "
              f"{got[1]} states, {got[2]} steps, {got[3]} eras, as the reference ({t:.3f}s) paths={lens}", flush=True)
    c_inc, t_inc = simulate(IncrementTensor(2), "cuda", 7, fin_any, SIM_INC2)
    check(sim_dict(c_inc) == dicts["increment-2"], "increment-2 simulation: second run differs")
    c_inc.assert_discovery("fin", c_inc.discovery("fin").into_actions())
    print(f"increment-2 simulation: time to the fin counterexample after a warm-up {t_inc:.4f}s "
          f"({c_inc.telemetry()['steps']} steps, {c_inc.state_count()} states) card={card}", flush=True)

    phase("10 paxos-3 simulation (seed 0, 16,384 walks, walk_cap 256, timeout 10 s)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def paxos3_sim():
        c, t = simulate(PaxosTensor(3), "cuda", 0, lambda b: b.timeout(10.0), SIM_PAXOS3)
        return c, t, torch.cuda.max_memory_allocated(), check_paths(c)

    (cps, tps, peak, lens), launches_sim = counted(torch, kernels, "paxos-3 simulation", paxos3_sim,
                                                   kernels.SIM_KERNELS)
    check("value chosen" in lens, "paxos-3 simulation: value chosen not found")
    check_k11(kernels, "paxos-3 simulation", cps, launches_sim, kernels.WALK_PAXOS, "walk_step")
    cps.assert_discovery("value chosen", cps.discovery("value chosen").into_actions())
    for name in ("linearizable", "network within capacity", "ballot rounds within range"):
        cps.assert_no_discovery(name)
    sim_line("paxos-3 simulation", cps, tps, card, peak)
    print(f"paxos-3 simulation: paths={lens} telemetry={cps.telemetry()}", flush=True)
    del cps

    if not skip_full:
        phase("11 2pc-10 simulation (seed 0, 65,536 walks, sync_steps 64, target 100,000,000)")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        def two_pc10_sim():
            c, t = simulate(two_pc(10), "cuda", 0, target(SIM_TARGET10), SIM_2PC10)
            return c, t, torch.cuda.max_memory_allocated(), check_paths(c)

        (c10s, t10s, peak, lens), launches11 = counted(torch, kernels, "2pc-10 simulation", two_pc10_sim,
                                                       kernels.SIM_KERNELS)
        check_k11(kernels, "2pc-10 simulation", c10s, launches11, kernels.WALK_2PC, "walk_step")
        launches_walk["walk_2pc"] = launches11
        # Uniform random walks reach "commit agreement" only when every
        # RM prepares before any abort: 8,192 2pc-5 walks need 4.5 M
        # states for it, 65,536 find none in 5 M (the reference's walks
        # too, phase 9), 2pc-6 none in 10 M (PERF.md), so at 2pc-10 and
        # 100 M states only "abort agreement" is certain.
        check("abort agreement" in lens, f"2pc-10 simulation: {lens}")
        c10s.assert_no_discovery("consistent")
        check(c10s.state_count() >= SIM_TARGET10, "2pc-10 simulation stopped short of its target")
        sim_line("2pc-10 simulation", c10s, t10s, card, peak)
        print(f"2pc-10 simulation: paths={lens} telemetry={c10s.telemetry()}", flush=True)

    phase("12 lane kernel parity (1,024 lanes of 2pc-5: C=151, A=27, S=3, table 2^16, ring 2^13)")
    tm5 = two_pc(5)
    C5 = min(LANE_SHAPE["chunk"], LANE_SHAPE["queue_capacity"] // (2 * tm5.max_actions))
    lane_res = lane_kernel_parity(torch, np, SWEEP_LANES, C5, tm5.max_actions, tm5.state_width,
                                  LANE_SHAPE["table_capacity"], LANE_SHAPE["queue_capacity"])

    phase("13 the service shape: 32 increment-2 lanes; 27 mixed 2pc-5 builders in 32 lanes")
    inc = [lambda b: b] * 32
    lanes(IncrementTensor(2), inc, "cuda", dict(lanes=32))  # warm-up: the lane program
    (inc_gpu, t_inc), launches13 = counted(torch, kernels, "increment-2 lanes",
                                           lambda: lanes(IncrementTensor(2), inc, "cuda", dict(lanes=32)),
                                           kernels.LANE_KERNELS)
    check_k11(kernels, "increment-2 lanes", inc_gpu[0], launches13, kernels.EXPAND_INCREMENT, "claim_dedup_lanes")
    launches_inc = launches13  # the kernels line's expand_increment
    inc_cpu, t_inc_cpu = cpu_lanes(torch, IncrementTensor(2), inc, dict(lanes=32))
    inc_solo = solo_like(IncrementTensor(2), lambda b: b, LANE_SHAPE)
    for i, (g, c) in enumerate(zip(inc_gpu, inc_cpu)):
        check(lane_dict(g) == lane_dict(c), f"increment-2 lane {i}: cuda {lane_dict(g)} != cpu {lane_dict(c)}")
        check(g.unique_state_count() == 13, f"increment-2 lane {i}: {g.unique_state_count()}")
        check((g.unique_state_count(), g.state_count(), g.max_depth())
              == (inc_solo.unique_state_count(), inc_solo.state_count(), inc_solo.max_depth()),
              f"increment-2 lane {i} differs from its solo run")
        check_paths(g)
    inc_serial = serial_solo_rate(torch, lambda: IncrementTensor(2), [(lambda b: b, 13, 1)] * 8,
                                  dict(chunk_size=64, queue_capacity=1 << 10, table_capacity=1 << 12))
    print(f"increment-2, 32 lanes: equal on cuda ({t_inc:.4f}s) and cpu ({t_inc_cpu:.4f}s), 13 unique each; "
          f"lanes_checks_per_sec={32 / t_inc:.1f} serial_solo_checks_per_sec={inc_serial:.2f} "
          f"(8 solo runs, bench.py:1575-1591) speedup={32 / t_inc / inc_serial:.1f} "
          f"batch_steps={inc_gpu[0].telemetry()['batch_steps']} card={card}", flush=True)

    mixed = [mixed_config(i, HasDiscoveries) for i in range(27)]
    (mix_gpu, t_mix), launches13 = counted(torch, kernels, "2pc-5 mixed lanes",
                                           lambda: lanes(two_pc(5), mixed, "cuda", dict(lanes=32)),
                                           kernels.LANE_KERNELS)
    check_k11(kernels, "2pc-5 mixed lanes", mix_gpu[0], launches13, kernels.EXPAND_2PC, "claim_dedup_lanes")
    mix_cpu, t_mix_cpu = cpu_lanes(torch, two_pc(5), mixed, dict(lanes=32))
    solos = {}
    for i, (g, c) in enumerate(zip(mix_gpu, mix_cpu)):
        check(lane_dict(g) == lane_dict(c), f"2pc-5 mixed lane {i}: cuda != cpu")
        check_paths(g)
        key = i % 12  # mixed_config repeats every 12 builders
        if key not in solos:
            solos[key] = solo_like(two_pc(5), lambda b, i=i: mixed_config(i, HasDiscoveries)(b), LANE_SHAPE)
        s = solos[key]
        check((g.unique_state_count(), g.state_count(), g.max_depth())
              == (s.unique_state_count(), s.state_count(), s.max_depth()),
              f"2pc-5 mixed lane {i} differs from its solo run")
    print(f"2pc-5, 27 mixed builders in 32 lanes: equal on cuda ({t_mix:.4f}s) and cpu ({t_mix_cpu:.3f}s) "
          f"and to {len(solos)} solo runs; unique={[c.unique_state_count() for c in mix_gpu]} "
          f"batch_steps={mix_gpu[0].telemetry()['batch_steps']} card={card}", flush=True)
    mix_dicts = [lane_dict(c) for c in mix_cpu]  # phase 16 holds the graph lanes against them
    del inc_gpu, inc_cpu, mix_gpu, mix_cpu, solos

    phase("14 sweeps: 1,024 lanes of 2pc-5 (target_max_depth 1 + i % 18), 256 lanes of paxos-2")
    depth_cfgs = [(lambda b, d=1 + i % 18: b.target_max_depth(d)) for i in range(SWEEP_LANES)]
    sw, launches_lanes, sw_stats = sweep(torch, kernels, "2pc-5 sweep", lambda: two_pc(5), depth_cfgs,
                                         dict(LANE_SHAPE, lanes=SWEEP_LANES), card, kernels.EXPAND_2PC)
    mix = []  # the sweep's checks: (configure, unique count, lanes at that depth)
    for d in range(1, 19):
        s = solo_like(two_pc(5), lambda b, d=d: b.target_max_depth(d), LANE_SHAPE)
        mix.append((lambda b, d=d: b.sample(False).target_max_depth(d), s.unique_state_count(),
                    len(range(d - 1, SWEEP_LANES, 18))))
        for i in range(d - 1, SWEEP_LANES, 18):
            g = sw[i]
            check((g.unique_state_count(), g.state_count(), g.max_depth())
                  == (s.unique_state_count(), s.state_count(), s.max_depth()),
                  f"2pc-5 sweep lane {i} (depth {d}) differs from its solo run")
    check(all(sw[i].unique_state_count() == GOLDEN[5] for i in range(17, SWEEP_LANES, 18)),
          "2pc-5 sweep: an unbounded lane missed 8,832")
    held, _t = cpu_lanes(torch, two_pc(5), depth_cfgs[:64], dict(LANE_SHAPE, lanes=64))
    for i, c in enumerate(held):
        check(lane_dict(sw[i]) == lane_dict(c), f"2pc-5 sweep lane {i}: cuda != cpu")
    # The serial baseline runs the sweep's own checks: one solo run at each
    # of its 18 depths, weighted by the lanes at that depth; at the lane's
    # chunk, queue and table (the same steps a check as its lane), and at
    # the solo engine's defaults (chunk 8192: what a user running the
    # check alone would take).
    sw5_serial = serial_solo_rate(torch, lambda: two_pc(5), mix,
                                  dict(chunk_size=LANE_SHAPE["chunk"], queue_capacity=LANE_SHAPE["queue_capacity"],
                                       table_capacity=LANE_SHAPE["table_capacity"], sync_steps=1 << 20))
    sw5_serial_default = serial_solo_rate(torch, lambda: two_pc(5), mix, {})
    print(f"2pc-5 sweep: 18 depths equal to their solo runs, {len(range(17, SWEEP_LANES, 18))} unbounded lanes "
          f"at 8,832, 64 lanes equal on cpu; lanes_checks_per_sec={sw_stats['checks_per_sec']:.1f} "
          f"serial_solo_checks_per_sec={sw5_serial:.2f} (the sweep's depth mix, solo at the lane's chunk {C5}) "
          f"speedup={sw_stats['checks_per_sec'] / sw5_serial:.1f} "
          f"serial_solo_default_checks_per_sec={sw5_serial_default:.2f} (the same mix at the solo defaults) "
          f"speedup_default={sw_stats['checks_per_sec'] / sw5_serial_default:.1f} card={card}", flush=True)
    del sw, held
    torch.cuda.empty_cache()
    px, _launches_px, px_stats = sweep(torch, kernels, "paxos-2 sweep", lambda: PaxosTensor(2), [lambda b: b] * 256,
                                       dict(PAXOS2_LANES, lanes=256), card, kernels.EXPAND_PAXOS)
    check(all(c.unique_state_count() == PAXOS2_GOLDEN for c in px), "paxos-2 sweep: a lane missed 16,668")
    held, _t = cpu_lanes(torch, PaxosTensor(2), [lambda b: b] * 8, dict(PAXOS2_LANES, lanes=8))
    for i, c in enumerate(held):
        check(lane_dict(px[i]) == lane_dict(c), f"paxos-2 sweep lane {i}: cuda != cpu")
    check_paths(px[0])
    px_serial = serial_solo_rate(torch, lambda: PaxosTensor(2), [(lambda b: b.sample(False), PAXOS2_GOLDEN, 1)] * 8,
                                 dict(chunk_size=256, queue_capacity=PAXOS2_LANES["queue_capacity"],
                                      table_capacity=PAXOS2_LANES["table_capacity"], sync_steps=1 << 20))
    print(f"paxos-2 sweep: 256 lanes at 16,668 in {px[0].telemetry()['steps']} steps, 8 equal on cpu; "
          f"lanes_checks_per_sec={px_stats['checks_per_sec']:.2f} serial_solo_checks_per_sec={px_serial:.3f} "
          f"(8 solo runs) card={card}", flush=True)
    del px, held

    phase("15 device-resident eras: K8f's kernels; graph eras cuda == cpu; 2pc-7, paxos-3, abd-ordered-3 pipelined")
    torch.cuda.empty_cache()
    era_res = era_kernel_parity(torch, np, "2pc-7", two_pc(7), 6144, 1 << 20)
    era_px = era_kernel_parity(torch, np, "paxos-3", PaxosTensorExhaustive(3), 16384, 1 << 21)
    results.update(era_res)
    check(all(r["max_abs_err"] == 0 for r in era_px.values()), "era kernels at the paxos-3 widths")
    for pipe in PIPE_SWEEP:
        configure = PIPES["serial"] if pipe is None else (lambda b, p=pipe: b.pipeline(depth=p[0], fuse=p[1]))
        c_gpu, t_gpu = bfs(two_pc(5), "cuda", TEST_OPTS, configure)
        torch.set_num_threads(1)
        c_cpu, t_cpu = bfs(two_pc(5), "cpu", TEST_OPTS, configure)
        torch.set_num_threads(threads)
        d_gpu = dict(result_dict(c_gpu), eras=c_gpu.telemetry()["eras"], steps=c_gpu.telemetry()["steps"])
        d_cpu = dict(result_dict(c_cpu), eras=c_cpu.telemetry()["eras"], steps=c_cpu.telemetry()["steps"])
        check(d_gpu == d_cpu and d_gpu["unique"] == GOLDEN[5], f"2pc-5 pipeline {pipe}: cuda != cpu")
        print(f"2pc-5 pipeline {pipe or 'serial'}: equal on cuda ({t_gpu:.3f}s) and cpu ({t_cpu:.3f}s), "
              f"eras={d_gpu['eras']} steps={d_gpu['steps']} telemetry={c_gpu.telemetry()}", flush=True)
    era_runs(torch, kernels, card, "2pc-7", GOLDEN[7], kernels.EXPAND_2PC, lambda c: check_2pc(c, 7))
    era_runs(torch, kernels, card, "paxos-3", PAXOS3_GOLDEN, kernels.EXPAND_PAXOS)
    era_runs(torch, kernels, card, "abd-ordered-3", ABDO3_GOLDEN, kernels.EXPAND_ABD)

    phase("16 simulation eras and lane batches as graphs: K13f, K14f; graph == cpu; the speed cells")
    torch.cuda.empty_cache()
    walk_res = walk_era_parity(torch, np, "paxos-3", PaxosTensor(3), SIM_PAXOS3["walks"], SIM_L)
    sim_px.update(walk_res)
    lane_res.update(lane_era_parity(torch, np, SWEEP_LANES, tm5, C5, LANE_SHAPE["queue_capacity"]))
    # Graph eras against the cpu eras of phase 9 (the sample included):
    # one capture a run, one readback an era (the path harvests apart).
    for label, mdl, seed, configure, opts in (
        ("increment-2", IncrementTensor(2), 7, fin_any, SIM_INC2),
        ("2pc-5", two_pc(5), 11, target(200_000), SIM_2PC5),
    ):
        (c, t), launches16 = counted(torch, kernels, f"{label} graph simulation",
                                     lambda: simulate(mdl, "cuda", seed, configure, opts), kernels.SIM_KERNELS)
        check_k11(kernels, f"{label} graph simulation", c, launches16,
                  kernels.WALK_INCREMENT if label == "increment-2" else kernels.WALK_2PC, "walk_step")
        tel = c.telemetry()
        check(sim_dict(c) == dicts[label], f"{label} graph simulation differs from the cpu run")
        check(tel["graph_captures"] == 1 and tel["readbacks"] == tel["eras"],
              f"{label} graph simulation: {tel['graph_captures']} captures, {tel['readbacks']} readbacks "
              f"for {tel['eras']} eras")
        print(f"{label} graph simulation == cpu: {tel['eras']} eras, {tel['readbacks']} era readbacks, "
              f"{tel.get('path_readbacks', 0)} path readbacks, 1 capture ({tel['capture_secs']:.3f}s), "
              f"{t:.3f}s", flush=True)
    # The 27 mixed 2pc-5 builders in 4 batches of 8 lanes on one warm
    # program: one capture, one readback a batch, each lane == its cpu lane.
    from stateright_tpu_torch import ExecutableCache

    cache = ExecutableCache()
    (mix8, _t), _ = counted(torch, kernels, "2pc-5 mixed lanes, batches of 8",
                            lambda: lanes(two_pc(5), mixed, "cuda", dict(lanes=8, cache=cache)), kernels.LANE_KERNELS)
    warm = cache.get(two_pc(5), "multiplex", lanes=8, device="cuda")[0].program
    lane_res["era_step_lanes"]["step_nodes"] = step_nodes(torch, "2pc-5 lane step (8 lanes)", warm, "lanes")
    for i, c in enumerate(mix8):
        check(lane_dict(c) == mix_dicts[i], f"2pc-5 mixed lane {i} in batches of 8 differs from its cpu lane")
    check(warm.graph_captures == 1 and warm.readbacks == 4,
          f"warm lane program: {warm.graph_captures} captures, {warm.readbacks} readbacks for 4 batches")
    print(f"2pc-5 mixed lanes in 4 batches of 8: == cpu lane by lane; 1 capture ({warm.capture_secs:.3f}s), "
          f"4 batch readbacks", flush=True)
    del mix8, warm, cache
    # The speed cells of scripts/solo_walls.py: simulation at fixed targets
    # and the time to a counterexample; the lane batches.
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import solo_walls

    _torch, cell_run = solo_walls._setup(HERE)
    cells = {}
    for label in solo_walls.SIMS:
        cells[label], _ = graph_cell(torch, kernels, card, cell_run, label, kernels.SIM_KERNELS)
    for label in solo_walls.LANES:
        cells[label], _ = graph_cell(torch, kernels, card, cell_run, label, kernels.LANE_KERNELS)
    torch.cuda.empty_cache()

    phase("17 the stage profiler (K12): K12a and K12b; stage graphs == plain; profiled runs")
    stage_res, launches_stage, launches_stage_sim = stage_phase(torch, np, kernels, card, skip_full)

    phase("18 the sharded mesh (K15): K15a, K15f; 8 shards cuda == cpu; 2pc-7, paxos-3 (and 2pc-10) at 8 shards")
    mesh_res, launches_mesh = mesh_phase(torch, np, kernels, card, skip_full, single)

    # The lane forms at one sharded step of phase 18's 2pc-7 run (8 shards,
    # chunk 1,024, table 2^18 and ring 2^17 a shard), for K15's bound.
    from stateright_tpu_torch.parallel.mesh import dedup_cap_for

    lane_mesh = lane_kernel_parity(torch, np, MESH_N, 1024, 37, 3, 1 << 18, 1 << 17, dedup_cap_for)
    torch.cuda.empty_cache()

    phase("19 the speclint pre-flight (K16, K16a): K16a; analyze() cuda == cpu; full width; fixtures; strict")
    torch.cuda.empty_cache()
    lint_res, launches_lint = lint_phase(torch, np, kernels, card)

    phase("20 the host spill, checkpoints and the degraded regrow (K7s): K7s; 2pc-10 spilling; "
          "paxos-3 killed and resumed; 2pc-7 regrow; 2pc-7 spilling at 8 shards")
    spill_res, launches_spill = spill_phase(torch, np, kernels, card, skip_full,
                                            None if skip_full else ref10, ref_px, single)

    # The loop rows' bounds: the sum of their kernels' bounds (one call at
    # the run's widths) times their launches in the run; a step is one
    # K3 launch (BFS), one K13b launch (simulation), one lane K3 launch.
    bfs_steps = launches["claim_dedup"]
    loops = {
        "K8 (2pc-7 run, with K11's EXPAND)": sum(results[k.name]["bound_ms"] * launches[k.name] for k in kernels.BFS_KERNELS)
        + k11_res["expand_2pc"]["bound_ms"] * bfs_steps,
        "K13 (paxos-3 simulation run, with K11's WALK)": sum(
            sim_px[k.name]["bound_ms"] * launches_sim[k.name] for k in kernels.SIM_KERNELS if k.name in sim_px)
        + k11_res["walk_paxos"]["bound_ms"] * launches_sim["walk_step"],
        "K14 (2pc-5 sweep, lane kernels)": sum(
            lane_res[k.name]["bound_ms"] * launches_lanes[k.name] for k in kernels.LANE_KERNELS[1:]),
        # The stage programs' launches: the profiled 2pc-7 run's less the
        # same run's unprofiled launches (phase 4); K12a at phase 17's
        # widths, the BFS kernels at the 2pc-7 widths.
        "K12 (2pc-7 profiled run, the stage programs' kernels)": sum(
            {**results, **stage_res}[k.name]["bound_ms"] * (launches_stage[k.name] - launches.get(k.name, 0))
            for k in kernels.BFS_STAGE_KERNELS),
        # K15a, K15f and K9a's and K9b's lane forms at the mesh's 2pc-7
        # widths, the other lane forms at one step of 8 shards (above), K1
        # at the solo 2pc-7 widths (6,144 rows a step against the mesh's
        # 8 x 1,024: a lower bound).
        "K15 (2pc-7 at 8 shards, its kernels)": sum(
            {**results, **lane_mesh, **mesh_res}[k.name]["bound_ms"] * launches_mesh[k.name]
            for k in kernels.MESH_KERNELS),
    }
    print(f"loop bounds (ms over the run): {json.dumps(loops)} steps: 2pc-7 {bfs_steps} "
          f"(telemetry {tel7['steps']} + {tel7.get('partial_steps', 0)} partial), "
          f"paxos-3 simulation {launches_sim['walk_step']}, 2pc-5 sweep {launches_lanes['claim_dedup_lanes']} "
          f"card={card}", flush=True)

    line = {"kernels": []}
    for k in kernels.KERNELS + (kernels.RING_APPEND, kernels.SLAB_BOTTOMK_LANES, kernels.STAGE_LANES,
                                kernels.RING_REFILL, kernels.SAMPLE_CAPTURE_LANES, kernels.MESH_COMMIT):
        # BFS kernels at the 2pc-7 widths and launches; the walk kernels
        # at the paxos-3 simulation widths and launches; the stage
        # profiler's at the 2pc-7 widths (K12a) and the paxos-3 simulation
        # widths (K12b), with the launches of its profiled runs of phase 17.
        if k.name in stage_res:
            r = stage_res[k.name]
            n = (launches_stage_sim if k is kernels.STAGE_WALK else launches_stage)[k.name]
        elif k.name in mesh_res:
            # K15a and K15f (its COMMIT grid and its other phases) at the
            # 2pc-7 widths at 8 shards, with the launches of phase 18's
            # 2pc-7 run at 8 shards.
            r, n = mesh_res[k.name], launches_mesh[k.name]
        elif k.name in lint_res:
            # K16a at the paxos-3 widths, with the launches of phase 19's
            # analyze() runs of the bundled models.
            r, n = lint_res[k.name], launches_lint[k.name]
        elif k.name in spill_res:
            # K7s at the 2pc-10 spilling run's widths, with the launches of
            # phase 20's spilling runs (2pc-10 and 2pc-7 at 8 shards).
            r, n = spill_res[k.name], launches_spill[k.name]
        elif k in kernels.EXPAND_KERNELS + kernels.CANON_KERNELS:
            # K11's EXPAND at the 2pc-7 / paxos-3 / abd-ordered-3 /
            # single-copy-4 BFS widths, the 32 increment-2 lanes' and 8,192
            # increment-lock-3 rows (phase 2b), with the launches of phase
            # 4's / 5's / 6's / 6b's / 13's / 6b's increment-lock-3 run;
            # K11c at the 2pc-10 symmetry
            # width with phase 7's 2pc-10 symmetry run's (phase 3's 2pc-5
            # symmetry run's with --skip-full).
            r = k11_res[k.name]
            n = {kernels.EXPAND_2PC: launches, kernels.EXPAND_PAXOS: launches_px, kernels.EXPAND_ABD: launches_ab,
                 kernels.EXPAND_INCREMENT: launches_inc, kernels.EXPAND_INCREMENT_LOCK: launches_lock,
                 kernels.EXPAND_SINGLE_COPY: launches_sc, kernels.CANON_2PC: launches_canon}[k][k.name]
        elif k.name in results:
            r, n = results[k.name], launches[k.name]
        else:
            r, n = sim_px[k.name], launches_sim[k.name]
        entry = dict(
            name=k.name, route="cuda", source=os.path.relpath(k.source_path, HERE),
            replaces=k.replaces, launches=n, max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
        )
        if k is kernels.WALK_STEP:
            # The same source's second entry point, the era prologue.
            entry["prologue_launches"] = launches_sim[kernels.WALK_PROLOGUE.name]
        for extra in ("call_ms", "launches_a_call", "host_ms", "lanes_library_ms",
                      "pop_append_ms", "pop_append_library_ms", "per_shard_ms", "begin_ms",
                      "epilogue_ms", "epilogue_plain_ms", "ring_ms", "mix_ms", "record_ms",
                      "record_plain_ms", "record_bound_ms", "choose_ms", "choose_plain_ms", "choose_bound_ms",
                      "lanes_ms", "graph_plain_ms", "plain_launches", "rows_compared", "empty_ms",
                      "step_nodes", "long_ms", "long_plain_ms", "long_bound_ms", "tight_ms", "tight_plain_ms",
                      "tight_bound_ms", "fresh_ms", "fresh_plain_ms", "fresh_bound_ms"):
            if extra in r:
                entry[extra] = r[extra]
        line["kernels"].append(entry)
    # K11's WALK: the paxos-3 / 2pc-10 simulation widths and B = 16,384 for
    # ABD, increment, increment-lock and single-copy (phase 2b), with the
    # launches of phase 10's run, of phase 11's (phase 9's 2pc-10 run with
    # --skip-full), of phase 9's abd-ordered-3 and increment-2 runs and of
    # phase 6b's increment-lock-3 and single-copy-3x2 simulations.
    for k, n in ((kernels.WALK_PAXOS, launches_sim[kernels.WALK_PAXOS.name]),
                 (kernels.WALK_2PC, launches_walk["walk_2pc"]["walk_2pc"]),
                 (kernels.WALK_ABD, launches_walk["walk_abd"]["walk_abd"]),
                 (kernels.WALK_INCREMENT, launches_walk["walk_increment"]["walk_increment"]),
                 (kernels.WALK_INCREMENT_LOCK, launches_walk_new["walk_increment_lock"]),
                 (kernels.WALK_SINGLE_COPY, launches_walk_new["walk_single_copy"])):
        r = k11_res[k.name]
        line["kernels"].append(dict(
            name=k.name, route="cuda", source=os.path.relpath(k.source_path, HERE), replaces=k.replaces,
            launches=n, **{key: r[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "call_ms",
                "graph_plain_ms", "plain_launches", "launches_a_call")}))
    for k in kernels.LANE_KERNELS[1:]:
        # The lane entry points of the same sources: phase 12's widths,
        # the 2pc-5 sweep's launches.
        r = lane_res[k.name]
        line["kernels"].append(dict(
            name=k.name, route="cuda", source=os.path.relpath(k.source_path, HERE),
            replaces=k.replaces, launches=launches_lanes[k.name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], call_ms=r.get("call_ms"),
            **({"launches_a_call": r["launches_a_call"]} if "launches_a_call" in r else {}),
        ))
    check(all(results_px[k]["max_abs_err"] == 0 for k in results_px), "paxos-3 widths parity")
    print(json.dumps(line))
    print(f"chip_smoke: every phase passed in {time.monotonic() - T0:.1f} s", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
