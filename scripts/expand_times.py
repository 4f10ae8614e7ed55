#!/usr/bin/env python3
"""K11 on the card: the hand-written EXPAND and WALK kernels
(`kernels/csrc/expand_2pc.cu`, `expand_paxos.cu`) against their plain
versions, bit for bit, and their device times beside the plain versions'
and the bound.

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
                   over a 2pc-10 BFS stopped at 200,000 states.

Each kernel is timed on the device alone (`chip_smoke.time_device_ms`:
CUDA events around back-to-back calls behind a spin kernel), beside its
plain version captured in one CUDA graph and replayed (`graph_plain_ms`,
what the era graph ran before this kernel) and called eagerly
(`plain_ms`, one call with the host's share); its kernels a call are
counted on the card (one kernel node, no memset). The bound is the
larger of the bytes moved (rows, ebits, depth, active and the limit in;
ebits, the successor lanes as int64, valid, the hits and `generated`
out) over the HBM rate and the plain version's written elements over the
32-bit rate. Prints one JSON line with the card's name and power limit;
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


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ring_rows(torch, smoke, model, opts, target, n):
    """[S + 2, n] int64 rows (lanes, ebits, depth) on the card from the
    port's BFS of `model` stopped at `target` (0: run to the end;
    `chip_smoke.bfs_ring`): n columns spread evenly over the states it
    took. Returns (rows, the run's unique count)."""
    c, ring, _t = smoke.bfs_ring(model, "cuda", opts, target)
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


def measure(torch, smoke, reps=50) -> dict:
    """Every case above; returns {name: timing dict} (the kernel rows under
    their kernels' names: expand_2pc at 2pc-7, expand_paxos at paxos-3,
    walk_2pc at 2pc-10, walk_paxos at paxos-3; the lane widths beside
    them). Raises if a kernel disagrees with its plain version."""
    from stateright_tpu_torch.models import PaxosTensor, PaxosTensorExhaustive, TwoPhaseTensor

    dev = torch.device("cuda")
    out = {}

    # 2pc-7: every reachable row, chunk by chunk; the first full chunk timed.
    tm7 = TwoPhaseTensor(7)
    rows7, unique7 = ring_rows(torch, smoke, tm7, smoke.BENCH7, 0, 1 << 20)
    smoke.check(unique7 == smoke.GOLDEN[7], f"2pc-7 ring: {unique7} states")
    k, plain = _expand_pair(smoke, tm7, CHUNK7)
    err = 0
    limits = (torch.full((), M32, dtype=torch.int64, device=dev), torch.full((), 12, dtype=torch.int64, device=dev))
    for i, at in enumerate(range(0, unique7, CHUNK7)):
        chunk = torch.zeros((5, CHUNK7), dtype=torch.int64, device=dev)
        n = min(CHUNK7, unique7 - at)
        chunk[:, :n] = rows7[:, at:at + n]
        active = torch.arange(CHUNK7, device=dev) < n
        dl = limits[i % 2]
        args = (chunk[:3], chunk[3].contiguous(), chunk[4].contiguous(), active, dl)
        err = max(err, smoke.max_abs_err(torch, zip(_expand_outputs(torch, k(*args)),
                                                     _expand_outputs(torch, plain(*args)))))
    print(f"K11 EXPAND 2pc-7: {unique7} reachable rows in {-(-unique7 // CHUNK7)} chunks of {CHUNK7}: "
          f"max_abs_err={err}", flush=True)
    smoke.check(err == 0, "K11 EXPAND (2pc-7) disagrees with its plain version")
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
    secs = kernels.build_all(kernels.EXPAND_KERNELS + kernels.BFS_KERNELS + kernels.SIM_KERNELS,
                             verbose=args.verbose_build)
    print(f"build_secs={secs:.2f}", flush=True)
    res = smoke.finish(measure(torch, smoke, args.reps))
    print(json.dumps(dict(card=smoke.card_line(), k11={
        name: {key: r.get(key) for key in ("ms", "call_ms", "graph_plain_ms", "plain_ms", "bound_ms", "bound_by",
                                           "launches_a_call", "plain_launches", "max_abs_err", "shape")}
        for name, r in res.items()})))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
