#!/usr/bin/env python3
"""K11 on the card: the hand-written EXPAND and WALK kernels
(`kernels/csrc/expand_2pc.cu`, `expand_paxos.cu`, `expand_abd.cu`,
`expand_increment.cu`, `expand_increment_lock.cu`,
`expand_single_copy.cu`) and K11c, the 2PC symmetry canon
(`kernels/csrc/canon_2pc.cu`), against their plain versions, bit for
bit, and their device times beside the plain versions' and the bound.

    python3 scripts/expand_times.py [--reps N] [--verbose-build]

Rows come from the port's own BFS rings (a run whose ring does not wrap
holds every state it took, in order, with its ebits and depth lanes):

  expand 2pc-7     every reachable 2pc-7 row (296,448) in chunks of 6,144
                   (the bench chunk), a 0-d depth limit read on the card
                   (unbounded, then 12 on every other chunk), the last
                   chunk part inactive;
  expand paxos-3   16,384 ring rows spread over a BFS stopped at 400,000
                   states, at C = 16,384 (the paxos-3 chunk), unbounded
                   and at the rows' median depth;
  expand lanes     the lane engine's widths with a limit a row: 1,024
                   lanes of 151 2pc-5 rows (W = 154,624, lane i at depth
                   1 + i % 18; the 8,832 reachable rows tiled) and 256
                   lanes of 256 paxos-2 rows (W = 65,536; 16,668 tiled);
  walk paxos-3     B = 16,384 (the paxos-3 simulation's walks), the
                   paxos-3 rows above;
  walk 2pc-10      B = 65,536 (the 2pc-10 simulation's walks), rows spread
                   over a 2pc-10 BFS stopped at 200,000 states;
  expand abd       every abd-ordered-3 row (46,516) in chunks of 2,048
                   (bench.py:1159-1161) and every abd-2 row (544) at chunk
                   512 (bench.py:1137-1139), a 0-d limit read on the card
                   (unbounded, then the rows' median depth) and a limit a
                   row by turns, a chunk's last columns inactive;
                   abd-ordered-3's first full chunk timed (`expand_abd`),
                   abd-2's too;
  walk abd         B = 16,384 abd-ordered-3 rows;
  increment        EXPAND over increment-2's 13 rows under each limit,
                   then at the 32-lane width (32 x 256 rows, the 13
                   tiled, a limit a row; timed: `expand_increment`);
                   WALK at B = 16,384 (the 13 tiled);
  increment-lock   EXPAND over increment-lock-3's 61 rows under each
                   limit, then at 8,192 rows (the 61 tiled, a limit a
                   row; timed: `expand_increment_lock`); WALK at B =
                   16,384 (the 61 tiled; `walk_increment_lock`);
  single-copy      every single-copy-register check 4 row (SingleCopy-
                   Tensor(4): 400,233) in chunks of 2,048 (bench.py:
                   1492-1494) and every row of the 3x2 violation's model
                   (SingleCopyTensor(3, 2), 2,519 rows of its full
                   space) in chunks of 256 (bench.py:1211), the limits by
                   turns as for ABD, a chunk's last columns inactive; the
                   first full chunk timed (`expand_single_copy`, and
                   `expand single-copy-3x2`); WALK at B = 16,384 of the
                   check-4 rows (`walk_single_copy`) and over the 2,519
                   3x2 rows (`walk single-copy-3x2`);
  canon            K11c over the canon's inputs of the whole 2pc-5
                   symmetry run (every valid successor of its 1,092
                   representatives, a popped chunk of 64 at a time,
                   compacted to the step's 1,728 columns, timed there:
                   `canon 2pc-5`) and at the 2pc-10 symmetry width
                   (141,994 columns: the candidates of 8,192 rows of a
                   2pc-10 symmetry BFS, compacted as its step does; timed:
                   `canon_2pc`).

Each kernel is timed on the device alone (`chip_smoke.time_device_ms`:
CUDA events around back-to-back calls behind a spin kernel), beside its
plain version captured in one CUDA graph and replayed (`graph_plain_ms`,
what the era graph ran before this kernel) and called eagerly
(`plain_ms`, one call with the host's share); its kernels a call are
counted on the card (one kernel node, no memset). The bound is the
larger of the bytes moved (rows, ebits, depth, active and the limit in;
ebits, the successor lanes as int64, valid, the hits and `generated`
out) over the HBM rate and the plain version's written elements over the
32-bit rate; the canon's, 2 x 3 x 8 bytes a row against its 32-bit
operations (19n + 3n(n-1)/2 + 6 a row: the descriptors, the network's
compare-and-selects, the rebuilt lanes). Prints one JSON line with the card's name and power limit;
`chip_smoke.py` runs the same measurement as a phase (`measure`).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M32 = 0xFFFFFFFF
CHUNK7, CHUNK_PX = 6144, 16384
WALK_10 = 65536
LANES_5 = (1024, 151)  # the 2pc-5 sweep: lanes, chunk (chip_smoke phase 12)
LANES_PX2 = (256, 256)  # the paxos-2 sweep: lanes, chunk
LANES_INC2 = (32, 256)  # the 32 increment-2 lanes (chip_smoke phase 13)
ABD2 = dict(chunk_size=512, queue_capacity=1 << 14, table_capacity=1 << 13)  # bench.py:1137-1139
WALK_B = 16384  # the ABD, increment and single-copy walks
LANES_LOCK = 8192  # the increment-lock EXPAND width (the increment-2 lanes')


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ring_rows(torch, smoke, model, opts, target, n, configure=lambda b: b):
    """[S + 2, n] int64 rows (lanes, ebits, depth) on the card from the
    port's BFS of `model` stopped at `target` (0: run to the end;
    `chip_smoke.bfs_ring`): n columns spread evenly over the states it
    took. Returns (rows, the run's unique count)."""
    c, ring, _t = smoke.bfs_ring(model, "cuda", opts, target, configure)
    unique = c.unique_state_count()
    cols = torch.linspace(0, unique - 1, min(n, unique), device="cuda").round().to(torch.int64)
    return ring[:model.state_width + 2].index_select(1, cols).contiguous(), unique


def _plain_in_graph(torch, fn):
    """fn captured once in a CUDA graph (as the era graph holds the plain
    expand); returns the replay."""
    from stateright_tpu_torch.engines import graph as gr

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with gr.capture_guard() as stream:
        with torch.cuda.graph(g, stream=stream):
            fn()
    torch.cuda.synchronize()
    return g


def _expand_pair(smoke, tm, W):
    from stateright_tpu_torch.ops.expand import build_expand_lean, build_expand_lean_plain
    from stateright_tpu_torch.xp import TorchXP

    xp = TorchXP("cuda")
    props = tm.tensor_properties()
    k = build_expand_lean(tm, props, W, xp)
    smoke.check(k.route == "kernel", f"{type(tm).__name__}: expand route {k.route}")
    return k, build_expand_lean_plain(tm, props, W, xp)


def _expand_outputs(torch, ex):
    return [ex.ebits, ex.flat, ex.valid, ex.generated, torch.stack(ex.prop_hits)]


def expand_case(torch, smoke, label, tm, rows, limits, active=None, reps=50):
    """EXPAND against its plain version on rows [S + 2, W] (lanes, ebits,
    depth) under each depth limit of `limits`, then timed under the
    first; returns the timing dict chip_smoke's `finish` bounds."""
    S, A, P = tm.state_width, tm.max_actions, len(tm.tensor_properties())
    W = rows.shape[1]
    k, plain = _expand_pair(smoke, tm, W)
    lanes, ebits, depth = rows[:S], rows[S].contiguous(), rows[S + 1].contiguous()
    if active is None:
        active = torch.ones(W, dtype=torch.bool, device="cuda")
    err = 0
    for dl in limits:
        err = max(err, smoke.max_abs_err(torch, zip(
            _expand_outputs(torch, k(lanes, ebits, depth, active, dl)),
            _expand_outputs(torch, plain(lanes, ebits, depth, active, dl)))))
    dl = limits[0]
    g = _plain_in_graph(torch, lambda: plain(lanes, ebits, depth, active, dl))
    n_launch, elements = smoke.torch_launches(torch, lambda: plain(lanes, ebits, depth, active, dl))
    dl_bytes = dl.numel() * 8 if isinstance(dl, torch.Tensor) else 0
    return dict(
        max_abs_err=err,
        ms=smoke.time_device_ms(torch, lambda _: k(lanes, ebits, depth, active, dl), reps=reps),
        call_ms=smoke.time_ms(torch, lambda _: k(lanes, ebits, depth, active, dl)),
        graph_plain_ms=smoke.time_device_ms(torch, lambda _: g.replay(), reps=reps),
        plain_ms=smoke.time_ms(torch, lambda _: plain(lanes, ebits, depth, active, dl), reps=5),
        launches_a_call=smoke.kernels_a_call(torch, f"K11 EXPAND ({label})",
                                             lambda: k(lanes, ebits, depth, active, dl), 1),
        plain_launches=n_launch,
        library_ms=None,
        bytes=W * (S * 8 + 8 + 8 + 1) + dl_bytes + W * 8 + S * A * W * 8 + A * W + P * W + 8,
        ops=elements,
        shape=f"{label}: W={W}, S={S}, A={A}, P={P}; the plain version {n_launch} torch launches",
    )


def walk_case(torch, smoke, label, tm, rows, reps=50):
    """WALK against its plain version on rows [S, B]; timed as above."""
    from stateright_tpu_torch.ops.expand import build_walk_step, build_walk_step_plain
    from stateright_tpu_torch.xp import TorchXP

    xp = TorchXP("cuda")
    props = tm.tensor_properties()
    S, A, P = tm.state_width, tm.max_actions, len(props)
    B = rows.shape[1]
    k, plain = build_walk_step(tm, props, xp), build_walk_step_plain(tm, props, xp)
    smoke.check(k.route == "kernel", f"{label}: walk route {k.route}")
    err = smoke.max_abs_err(torch, zip(k(rows), plain(rows)))
    g = _plain_in_graph(torch, lambda: plain(rows))
    n_launch, elements = smoke.torch_launches(torch, lambda: plain(rows))
    return dict(
        max_abs_err=err,
        ms=smoke.time_device_ms(torch, lambda _: k(rows), reps=reps),
        call_ms=smoke.time_ms(torch, lambda _: k(rows)),
        graph_plain_ms=smoke.time_device_ms(torch, lambda _: g.replay(), reps=reps),
        plain_ms=smoke.time_ms(torch, lambda _: plain(rows), reps=5),
        launches_a_call=smoke.kernels_a_call(torch, f"K11 WALK ({label})", lambda: k(rows), 1),
        plain_launches=n_launch,
        library_ms=None,
        bytes=B * S * 8 + P * B + A * B + A * S * B * 8,
        ops=elements,
        shape=f"{label}: B={B}, S={S}, A={A}, P={P}; the plain version {n_launch} torch launches",
    )


def chunked_expand(torch, smoke, label, tm, rows, C, limit_of):
    """EXPAND against its plain version over every column of rows [S + 2,
    N] in chunks of C (the last one's tail inactive), chunk i under
    limit_of(i, depth); returns the largest difference."""
    dev = rows.device
    S, N = tm.state_width, rows.shape[1]
    k, plain = _expand_pair(smoke, tm, C)
    err = 0
    for i, at in enumerate(range(0, N, C)):
        chunk = torch.zeros((S + 2, C), dtype=torch.int64, device=dev)
        n = min(C, N - at)
        chunk[:, :n] = rows[:, at:at + n]
        active = torch.arange(C, device=dev) < n
        depth = chunk[S + 1].contiguous()
        args = (chunk[:S], chunk[S].contiguous(), depth, active, limit_of(i, depth))
        err = max(err, smoke.max_abs_err(torch, zip(_expand_outputs(torch, k(*args)),
                                                     _expand_outputs(torch, plain(*args)))))
    print(f"K11 EXPAND {label}: {N} rows in {-(-N // C)} chunks of {C}: max_abs_err={err}", flush=True)
    smoke.check(err == 0, f"K11 EXPAND ({label}) disagrees with its plain version")
    return err


def canon_inputs(torch, tm, rows, C):
    """The canon's inputs of BFS steps over rows [S + 2, N], C popped rows
    at a time: each chunk's successors (K11's EXPAND) compacted to the
    step's width (vcap, K2) as engines/era.py `_step` gathers them. Yields
    [S, vcap] int64 tensors."""
    from stateright_tpu_torch.engines.era import widths
    from stateright_tpu_torch.ops import visited_set as vs
    from stateright_tpu_torch.ops.expand import build_expand_lean
    from stateright_tpu_torch.xp import TorchXP

    S, N, dev = tm.state_width, rows.shape[1], rows.device
    vcap = widths(tm.max_actions, C)[0]
    expand = build_expand_lean(tm, tm.tensor_properties(), C, TorchXP(dev))
    for at in range(0, N, C):
        chunk = torch.zeros((S + 2, C), dtype=torch.int64, device=dev)
        n = min(C, N - at)
        chunk[:, :n] = rows[:, at:at + n]
        ex = expand(chunk[:S], chunk[S].contiguous(), chunk[S + 1].contiguous(),
                    torch.arange(C, device=dev) < n, M32)
        vids, _vvalid, _n = vs.compact_ids(ex.valid, vcap)
        yield ex.flat.index_select(1, vids)


def canon_case(torch, smoke, label, tm, batches, reps=50):
    """K11c against its plain version on every [S, W] batch of `batches`,
    then timed on the last; returns the timing dict."""
    from stateright_tpu_torch.ops.canon import build_canon, build_canon_plain
    from stateright_tpu_torch.xp import TorchXP

    xp = TorchXP("cuda")
    k, plain = build_canon(tm, xp), build_canon_plain(tm, xp)
    smoke.check(k.route == "kernel", f"{label}: canon route {k.route}")
    err, cols = 0, 0
    for rows in batches:
        err = max(err, smoke.max_abs_err(torch, [(k(rows), plain(rows))]))
        cols += rows.shape[1]
    print(f"K11c canon {label}: {cols} candidate columns: max_abs_err={err}", flush=True)
    smoke.check(err == 0, f"K11c canon ({label}) disagrees with its plain version")
    S, W, n = tm.state_width, rows.shape[1], tm.n
    g = _plain_in_graph(torch, lambda: plain(rows))
    n_launch, _elements = smoke.torch_launches(torch, lambda: plain(rows))
    return dict(
        max_abs_err=err,
        ms=smoke.time_device_ms(torch, lambda _: k(rows), reps=reps),
        call_ms=smoke.time_ms(torch, lambda _: k(rows)),
        graph_plain_ms=smoke.time_device_ms(torch, lambda _: g.replay(), reps=reps),
        plain_ms=smoke.time_ms(torch, lambda _: plain(rows), reps=5),
        launches_a_call=smoke.kernels_a_call(torch, f"K11c canon ({label})", lambda: k(rows), 1),
        plain_launches=n_launch,
        library_ms=None,
        rows_compared=cols,
        bytes=2 * S * 8 * W,
        ops=W * (19 * n + 3 * n * (n - 1) // 2 + 6),
        shape=f"{label}: W={W}, S={S}, n={n}; the plain version {n_launch} torch launches",
    )


def measure(torch, smoke, reps=50) -> dict:
    """Every case above; returns {name: timing dict} (the kernel rows under
    their kernels' names: expand_2pc at 2pc-7, expand_paxos at paxos-3,
    walk_2pc at 2pc-10, walk_paxos at paxos-3, expand_abd and walk_abd
    at abd-ordered-3, expand_increment at the 32 increment-2 lanes,
    walk_increment at B = 16,384, expand_increment_lock at 8,192
    increment-lock-3 rows, walk_increment_lock at B = 16,384,
    expand_single_copy at single-copy-4's chunk, walk_single_copy at B =
    16,384 of its rows, canon_2pc at the 2pc-10 symmetry width;
    the other widths beside them). Raises if a kernel disagrees with its
    plain version."""
    from stateright_tpu_torch.models import (
        AbdOrderedTensor,
        AbdTensor,
        IncrementLockTensor,
        IncrementTensor,
        PaxosTensor,
        PaxosTensorExhaustive,
        SingleCopyTensor,
        TwoPhaseTensor,
    )

    dev = torch.device("cuda")
    out = {}

    # 2pc-7: every reachable row, chunk by chunk; the first full chunk timed.
    tm7 = TwoPhaseTensor(7)
    rows7, unique7 = ring_rows(torch, smoke, tm7, smoke.BENCH7, 0, 1 << 20)
    smoke.check(unique7 == smoke.GOLDEN[7], f"2pc-7 ring: {unique7} states")
    limits = (torch.full((), M32, dtype=torch.int64, device=dev), torch.full((), 12, dtype=torch.int64, device=dev))
    chunked_expand(torch, smoke, "2pc-7", tm7, rows7, CHUNK7, lambda i, depth: limits[i % 2])
    out["expand_2pc"] = expand_case(torch, smoke, "2pc-7", tm7, rows7[:, :CHUNK7].contiguous(),
                                    limits, reps=reps)
    out["expand_2pc"]["rows_compared"] = unique7
    del rows7

    # paxos-3 at its chunk; the same rows through WALK at the simulation's B.
    px = PaxosTensorExhaustive(3)
    rows_px, unique_px = ring_rows(torch, smoke, px, dict(smoke.PAXOS3, table_capacity=1 << 22), 400_000,
                                   CHUNK_PX)
    med = int(rows_px[px.state_width + 1].median())
    out["expand_paxos"] = expand_case(
        torch, smoke, "paxos-3", px, rows_px,
        (torch.full((), M32, dtype=torch.int64, device=dev), torch.full((), med, dtype=torch.int64, device=dev)),
        active=torch.arange(CHUNK_PX, device=dev) % 11 != 5, reps=reps)
    out["walk_paxos"] = walk_case(torch, smoke, "paxos-3", PaxosTensor(3),
                                  rows_px[:px.state_width].contiguous(), reps=reps)

    # The lane widths, a depth limit a row.
    for name, tm, (N, C), opts in (
        ("2pc-5 sweep", TwoPhaseTensor(5), LANES_5,
         dict(chunk_size=256, queue_capacity=1 << 14, table_capacity=1 << 16)),
        ("paxos-2 sweep", PaxosTensor(2), LANES_PX2,
         dict(chunk_size=256, queue_capacity=1 << 15, table_capacity=1 << 17)),
    ):
        rows, unique = ring_rows(torch, smoke, tm, opts, 0, 1 << 20)
        W = N * C
        tiled = rows[:, torch.arange(W, device=dev) % unique].contiguous()
        dl_rows = (1 + (torch.arange(W, device=dev) // C) % 18).to(torch.int64)
        out[f"expand {name}"] = expand_case(
            torch, smoke, name, tm, tiled, (dl_rows, torch.full((W,), M32, dtype=torch.int64, device=dev)),
            reps=reps)
        del rows, tiled

    # 2pc-10 walks.
    tm10 = TwoPhaseTensor(10)
    rows10, _u = ring_rows(torch, smoke, tm10,
                           dict(chunk_size=8192, queue_capacity=1 << 21, table_capacity=1 << 22),
                           200_000, WALK_10)
    smoke.check(rows10.shape[1] == WALK_10, f"2pc-10 walk rows: {rows10.shape[1]}")
    out["walk_2pc"] = walk_case(torch, smoke, "2pc-10", tm10, rows10[:3].contiguous(), reps=reps)
    del rows10

    # ABD: every abd-ordered-3 and every abd-2 row, the limit by turns a
    # 0-d one read on the card (unbounded, the median depth) and one a row.
    for name, tm, opts, C, golden in (
        ("abd-ordered-3", AbdOrderedTensor(3), smoke.ABDO3, 2048, smoke.ABDO3_GOLDEN),
        ("abd-2", AbdTensor(2), ABD2, 512, 544),
    ):
        rows, unique = ring_rows(torch, smoke, tm, dict(opts, queue_capacity=1 << 16), 0, 1 << 20)
        smoke.check(unique == golden, f"{name} ring: {unique} states")
        med = int(rows[tm.state_width + 1].median())
        limits = (torch.full((), M32, dtype=torch.int64, device=dev),
                  torch.full((), med, dtype=torch.int64, device=dev))

        def limit_of(i, depth, limits=limits):
            return limits[i % 2] if i % 3 != 2 else depth + (torch.arange(depth.numel(), device=dev) % 3) - 1

        chunked_expand(torch, smoke, name, tm, rows, C, limit_of)
        key = "expand_abd" if name == "abd-ordered-3" else f"expand {name}"
        first = rows[:, :C].contiguous()
        out[key] = expand_case(torch, smoke, name, tm, first, limits,
                               active=torch.arange(C, device=dev) % 11 != 5, reps=reps)
        out[key]["rows_compared"] = unique
        if name == "abd-ordered-3":
            out["walk_abd"] = walk_case(torch, smoke, name, tm,
                                        rows[:tm.state_width, :WALK_B].contiguous(), reps=reps)
        del rows, first

    # increment-2: its 13 rows under each limit, then the 32-lane width
    # (timed) with a limit a row; WALK at B = 16,384.
    tm = IncrementTensor(2)
    rows, unique = ring_rows(torch, smoke, tm, dict(chunk_size=64, queue_capacity=1 << 10,
                                                     table_capacity=1 << 12), 0, 1 << 10)
    smoke.check(unique == 13, f"increment-2 ring: {unique} states")
    chunked_expand(torch, smoke, "increment-2", tm, rows, 13,
                   lambda i, depth: depth + (torch.arange(depth.numel(), device=dev) % 3) - 1)
    N, C = LANES_INC2
    W = N * C
    tiled = rows[:, torch.arange(W, device=dev) % unique].contiguous()
    dl_rows = (1 + (torch.arange(W, device=dev) // C) % 6).to(torch.int64)
    out["expand_increment"] = expand_case(
        torch, smoke, "increment-2 lanes", tm, tiled,
        (dl_rows, torch.full((), M32, dtype=torch.int64, device=dev), 3), reps=reps)
    out["expand_increment"]["rows_compared"] = unique
    walk_rows = rows[:tm.state_width, torch.arange(WALK_B, device=dev) % unique].contiguous()
    out["walk_increment"] = walk_case(torch, smoke, "increment-2", tm, walk_rows, reps=reps)
    del rows, tiled, walk_rows

    # increment-lock-3: its 61 rows under each limit, then 8,192 rows (the
    # 61 tiled, timed) with a limit a row; WALK at B = 16,384.
    tm = IncrementLockTensor(3)
    rows, unique = ring_rows(torch, smoke, tm, smoke.LOCK_OPTS, 0, 1 << 10)
    smoke.check(unique == smoke.LOCK_GOLDEN[3], f"increment-lock-3 ring: {unique} states")
    chunked_expand(torch, smoke, "increment-lock-3", tm, rows, unique,
                   lambda i, depth: depth + (torch.arange(depth.numel(), device=dev) % 3) - 1)
    chunked_expand(torch, smoke, "increment-lock-3 (chunk 16)", tm, rows, 16,
                   lambda i, depth: torch.full((), M32 if i % 2 else 5, dtype=torch.int64, device=dev))
    tiled = rows[:, torch.arange(LANES_LOCK, device=dev) % unique].contiguous()
    dl_rows = (1 + torch.arange(LANES_LOCK, device=dev) % 12).to(torch.int64)
    out["expand_increment_lock"] = expand_case(
        torch, smoke, "increment-lock-3", tm, tiled,
        (dl_rows, torch.full((), M32, dtype=torch.int64, device=dev), 4), reps=reps)
    out["expand_increment_lock"]["rows_compared"] = unique
    walk_rows = rows[:tm.state_width, torch.arange(WALK_B, device=dev) % unique].contiguous()
    out["walk_increment_lock"] = walk_case(torch, smoke, "increment-lock-3", tm, walk_rows, reps=reps)
    del rows, tiled, walk_rows

    # single-copy: every check-4 row at its bench chunk and every 3x2 row
    # at its chunk, the limits by turns as for ABD; WALK over both.
    for name, tm, opts, golden in (
        ("single-copy-4", SingleCopyTensor(4), dict(smoke.SC4, queue_capacity=1 << 19), smoke.SC4_GOLDEN),
        ("single-copy-3x2", SingleCopyTensor(3, 2), dict(smoke.SC32, queue_capacity=1 << 13), smoke.SC32_SPACE),
    ):
        C = opts["chunk_size"]
        rows, unique = ring_rows(torch, smoke, tm, dict(opts, table_capacity=max(opts["table_capacity"], 1 << 14)),
                                 0, 1 << 20)
        smoke.check(unique == golden, f"{name} ring: {unique} states")
        med = int(rows[tm.state_width + 1].median())
        limits = (torch.full((), M32, dtype=torch.int64, device=dev),
                  torch.full((), med, dtype=torch.int64, device=dev))

        def limit_of(i, depth, limits=limits):
            return limits[i % 2] if i % 3 != 2 else depth + (torch.arange(depth.numel(), device=dev) % 3) - 1

        chunked_expand(torch, smoke, name, tm, rows, C, limit_of)
        key = "expand_single_copy" if name == "single-copy-4" else f"expand {name}"
        first = rows[:, :C].contiguous()
        out[key] = expand_case(torch, smoke, name, tm, first, limits,
                               active=torch.arange(C, device=dev) % 11 != 5, reps=reps)
        out[key]["rows_compared"] = unique
        if name == "single-copy-4":
            walk_rows = rows[:tm.state_width, torch.linspace(0, unique - 1, WALK_B, device=dev).round().long()]
            out["walk_single_copy"] = walk_case(torch, smoke, name, tm, walk_rows.contiguous(), reps=reps)
        else:
            out[f"walk {name}"] = walk_case(torch, smoke, name, tm, rows[:tm.state_width].contiguous(), reps=reps)
            out[f"walk {name}"]["rows_compared"] = unique
        del rows, first

    # K11c: the 2pc-5 symmetry run's canon inputs, chunk 64 at a time
    # (timed at its 1,728 columns); then 8,192 rows of a 2pc-10 symmetry
    # BFS, compacted to its step's 141,994 columns (timed: the kernel row).
    def sym(b):
        return b.symmetry()

    tm5 = TwoPhaseTensor(5)
    rows5, unique5 = ring_rows(torch, smoke, tm5, smoke.TEST_OPTS, 0, 1 << 12, sym)
    smoke.check(unique5 == smoke.SYM_CLOSURE[5], f"2pc-5 symmetry ring: {unique5} states")
    out["canon 2pc-5"] = canon_case(torch, smoke, "2pc-5 symmetry",
                                    tm5, list(canon_inputs(torch, tm5, rows5, smoke.TEST_OPTS["chunk_size"])),
                                    reps=reps)
    C10 = smoke.SYM10["chunk_size"]
    rows10s, _u = ring_rows(torch, smoke, tm10, smoke.SYM10, 3 * C10, C10, sym)
    out["canon_2pc"] = canon_case(torch, smoke, "2pc-10 symmetry", tm10,
                                  list(canon_inputs(torch, tm10, rows10s, C10)), reps=reps)
    del rows5, rows10s
    torch.cuda.empty_cache()
    for name, r in out.items():
        smoke.check(r["max_abs_err"] == 0, f"K11 {name} disagrees with its plain version")
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--verbose-build", action="store_true", help="print ptxas's registers and spills")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("expand_times: needs a CUDA device", file=sys.stderr)
        return 2
    from stateright_tpu_torch import kernels

    smoke = _smoke()
    secs = kernels.build_all(kernels.EXPAND_KERNELS + kernels.CANON_KERNELS + kernels.BFS_KERNELS
                             + kernels.SIM_KERNELS, verbose=args.verbose_build)
    print(f"build_secs={secs:.2f}", flush=True)
    res = smoke.finish(measure(torch, smoke, args.reps))
    print(json.dumps(dict(card=smoke.card_line(), k11={
        name: {key: r.get(key) for key in ("ms", "call_ms", "graph_plain_ms", "plain_ms", "bound_ms", "bound_by",
                                           "launches_a_call", "plain_launches", "max_abs_err", "shape")}
        for name, r in res.items()})))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
