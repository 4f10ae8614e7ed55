"""K13a (the walk record) and K13c (the walk capture) as their kernels
compute them, block by block, against their plain versions, and the plain
versions against the JAX walk step.

`_k13a_transcribed` follows kernels/csrc/walk_record.cu: blocks of
kWalks walks in an order drawn from a seed; in a block each walk's run
of units (16-byte slot pairs where L is even, else single slots) is
placed by a scan of the walks' unit counts, the block's units are read
and compared in an order drawn from the seed, each finding its walk by
the kernel's binary search of the scan, a hit marking its walk; then
each walk is settled by its own thread, in an order drawn from the seed;
the depth bins are the block's own, merged one add a non-empty bin, and
gen and maxd are reduced in the block. `_k13c_transcribed` runs
csrc/capture_scan.cuh's one launch (`capture_one_transcribed`, shared
with K9a's test) with K13c's operands (one lane, step_cap = B, no
dropped counter): the blocks take their tiles from a counter, publish
their counts, look back over the earlier tiles' counts, write their own
rows and take a ticket, their steps interleaved in an order drawn from
the seed; the last block advances occupied and clears the status words
and the counter. Its scratch persists from call to call, as the
program's does.

The JAX side runs one step of `stateright_tpu/engines/tpu_simulation.py`'s
era loop from a crafted walk state (paths of many lengths, cycles at
slot 0 and at ptr - 1) beside one era of one step of the port's program
on the CPU (the plain versions): the walk lanes, the path rows below ptr
and the whole params vector (gen, maxd, the depth histogram, the sample
the capture fed) are equal. Tolerance: exact equality throughout.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernel_plans import capture_one_transcribed
from test_torch_walk import _pair
from torch_parity import one_torch_thread, reference_uncached  # noqa: F401

from stateright_tpu.engines import tpu_simulation as ts
from stateright_tpu_torch.engines.gpu_simulation import SimProgram
from stateright_tpu_torch.obs.coverage import DEPTH_CAP
from stateright_tpu_torch.obs.sample import slab_entries
from stateright_tpu_torch.ops import slab as sl
from stateright_tpu_torch.ops import walk as wk
from stateright_tpu_torch.ops.visited_set import pack64

M32 = 0xFFFFFFFF
WALKS = 128  # walk_record.cu kWalks
TILE = sl.CAPTURE_TILE  # capture_scan.cuh kTile
K = 64


# ---------------------------------------------------------------------------
# K13a
# ---------------------------------------------------------------------------

def _k13a_transcribed(h1, h2, walk, path, stats, dhist, seed):
    """walk_record.cu on numpy int64 arrays (updated in place: walk, path,
    stats, dhist); returns (counted, cycle, each walk's settle count)."""
    rng = random.Random(seed)
    S, B = walk.shape[0] - 4, walk.shape[1]
    L = path.shape[1]
    flat = path.reshape(-1)  # the kernel's row arithmetic: w * L + slot
    per = 2 if L % 2 == 0 else 1  # slots a unit
    cap = 0 if dhist is None else len(dhist)
    counted_out = np.zeros(B, dtype=bool)
    cycle_out = np.zeros(B, dtype=bool)
    settled = np.zeros(B, dtype=np.int64)
    blocks = list(range(-(-B // WALKS)))
    rng.shuffle(blocks)
    for blk in blocks:
        w0 = blk * WALKS
        mine = [t for t in range(WALKS) if w0 + t < B]
        ptr = np.array([int(walk[S + 1, w0 + t]) if t in mine else 0 for t in range(WALKS)])
        frozen = np.array([walk[S + 3, w0 + t] != 0 if t in mine else True for t in range(WALKS)])
        key = np.zeros(WALKS, dtype=np.int64)
        for t in mine:
            key[t] = np.uint64((int(h1[w0 + t]) & M32) << 32 | (int(h2[w0 + t]) & M32)).view(np.int64)
        n = np.where(frozen, 0, np.minimum(ptr, L))
        units = -(-n // per)
        off = np.concatenate([[0], np.cumsum(units)])  # off[WALKS]: the block's total
        total = int(off[WALKS])
        hit = np.zeros(WALKS, dtype=bool)
        p = np.arange(total)
        rng.shuffle(p)  # the units' loads and compares, in any order
        lo, hi = np.zeros(total, dtype=np.int64), np.full(total, WALKS - 1)
        while (lo < hi).any():  # the kernel's search: the last walk whose run starts at or before p
            mid = (lo + hi + 1) >> 1
            up = off[mid] <= p
            lo, hi = np.where(up & (lo < hi), mid, lo), np.where(~up & (lo < hi), mid - 1, hi)
        s = (p - off[lo]) * per
        v0 = flat[(w0 + lo) * L + s]
        h = v0 == key[lo]
        if per == 2:
            v1 = flat[(w0 + lo) * L + s + 1]
            h |= (s + 1 < n[lo]) & (v1 == key[lo])
        hit[lo[h]] = True
        bins = None if dhist is None else np.zeros(cap, dtype=np.int64)
        gen = maxd = 0
        order = list(mine)
        rng.shuffle(order)
        for t in order:  # each walk settled by its own thread
            w = w0 + t
            c = not frozen[t] and not hit[t]
            counted_out[w], cycle_out[w] = c, not frozen[t] and hit[t]
            settled[w] += 1
            q = int(ptr[t])
            if c:
                if q < L:
                    flat[w * L + q] = key[t]
                q += 1
                walk[S + 1, w] = q
                gen += 1
                if bins is not None:
                    bins[q if q < cap - 1 else cap - 1] += 1
            maxd = max(maxd, q)
        if gen:
            stats[wk.GEN] += gen
        stats[wk.MAXD] = max(stats[wk.MAXD], maxd)
        if bins is not None:
            for i in np.nonzero(bins)[0]:
                dhist[i] += bins[i]
    return counted_out, cycle_out, settled


def _k13a_inputs(B, L, S, seed, frozen_every=7):
    """Walks with ptr over 0..L (every length, L itself, and the run's
    ptr = L + 1 once a walk counted at L), random path words, an eighth of
    the active walks on a cycle at slot 0, at ptr - 1 or between, and some
    frozen walks (at every length too)."""
    rng = np.random.default_rng(seed)
    walk = rng.integers(0, 1 << 32, (S + 4, B)).astype(np.int64)
    ptr = rng.integers(0, L + 1, B)
    ptr[:L + 2] = np.arange(L + 2)[:B] if B >= L + 2 else ptr[:L + 2]
    walk[S + 1] = ptr
    walk[S + 3] = (np.arange(B) % frozen_every == 5).astype(np.int64)
    h = rng.integers(0, 1 << 32, (2, B)).astype(np.int64)
    path = rng.integers(-(1 << 62), 1 << 62, (B, L)).astype(np.int64)
    key = (h[0].astype(np.uint64) << np.uint64(32) | h[1].astype(np.uint64)).view(np.int64)
    w = np.arange(B)
    cyc = (w % 8 == 3) & (ptr > 0)
    at = np.where(w % 24 == 3, 0, np.where(w % 24 == 11, np.minimum(ptr, L) - 1,
                                          rng.integers(0, 1 << 30, B) % np.maximum(np.minimum(ptr, L), 1)))
    path[w[cyc], at[cyc]] = key[cyc]
    # A key above ptr is not on the path: the compare must stop at ptr.
    above = (w % 8 == 5) & (ptr < L)
    path[w[above], ptr[above]] = key[above]
    return h[0], h[1], walk, path


@pytest.mark.parametrize("B,L,depth_cap", [
    (300, 256, DEPTH_CAP),      # pairs; depths past the bins' end
    (1000, 40, DEPTH_CAP),      # short and long rows in one block
    (129, 17, 8),               # odd L: single-slot loads; few bins
    (512, 16, DEPTH_CAP),       # short rows: a block's units in one round
    (260, 256, 0),              # coverage off: no histogram
])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k13a_blocks_in_random_orders_equal_the_plain_record(B, L, depth_cap, seed):
    S = 3
    h1, h2, walk, path = _k13a_inputs(B, L, S, seed + B)
    stats = np.array([5, 7, 9, 3, 11], dtype=np.int64)
    dhist = np.arange(depth_cap, dtype=np.int64) if depth_cap else None
    t = [torch.from_numpy(x.copy()) for x in (walk, path, stats)]
    td = torch.from_numpy(dhist.copy()) if depth_cap else None
    want_counted, want_cycle = wk.record_plain(torch.from_numpy(h1), torch.from_numpy(h2), *t, td)
    counted, cycle, settled = _k13a_transcribed(h1, h2, walk, path, stats, dhist, seed)
    assert (settled == 1).all()
    assert np.array_equal(counted, want_counted.numpy()) and np.array_equal(cycle, want_cycle.numpy())
    assert np.array_equal(walk, t[0].numpy()) and np.array_equal(path, t[1].numpy())
    assert np.array_equal(stats, t[2].numpy())
    if depth_cap:
        assert np.array_equal(dhist, td.numpy())
    # The inputs hold what the cases name: cycles, frozen walks, counted
    # walks at ptr = L (no slot written), depths past the bins.
    assert cycle.any() and (walk[S + 3] != 0).any() and (counted & (t[0].numpy()[S + 1] == L + 1)).any()


def test_k13a_settles_each_walk_once_at_every_length():
    """Every path length 0..L + 1, one walk each, one of them frozen."""
    L, S = 256, 2
    h1, h2, walk, path = _k13a_inputs(L + 2, L, S, 5, frozen_every=10 ** 9)
    stats = np.zeros(5, dtype=np.int64)
    dhist = np.zeros(DEPTH_CAP, dtype=np.int64)
    t = [torch.from_numpy(x.copy()) for x in (walk, path, stats, dhist)]
    want = wk.record_plain(torch.from_numpy(h1), torch.from_numpy(h2), *t)
    counted, cycle, settled = _k13a_transcribed(h1, h2, walk, path, stats, dhist, 0)
    assert (settled == 1).all() and np.array_equal(counted, want[0].numpy())
    for a, b in zip((walk, path, stats, dhist), t):
        assert np.array_equal(a, b.numpy())


# ---------------------------------------------------------------------------
# K13c
# ---------------------------------------------------------------------------

class _Scratch:
    """capture_scan.cuh's scratch for one lane: the ticket, the tile
    counter and the tiles' status words, zero between launches."""

    def __init__(self, B):
        self.ticket = [(0, 0, 0)]
        self.status = np.zeros((1, -(-B // TILE)), dtype=np.int64)

    def clean(self):
        return self.ticket == [(0, 0, 0)] and not self.status.any()


def _k13c_transcribed(slab, stats, counted, h1, h2, walk, thresh, scr, seed):
    """capture_scan.cuh's one launch with walk_capture.cu's operands, on
    numpy arrays (slab and stats updated in place, `scr` a _Scratch)."""
    S, B = walk.shape[0] - 4, walk.shape[1]
    srcs = [x[None, :] for x in [h1, h2, walk[S + 1]] + [walk[s] for s in range(S)]]
    occ = stats[wk.OCC:wk.OCC + 1]  # a view: the launch advances it in place
    capture_one_transcribed(counted[None, :], h1[None, :], h2[None, :], np.array([thresh], dtype=np.int64),
                            srcs, slab[:, None, :], occ, None, B, scr.status, scr.ticket, seed)


def _k13c_inputs(B, S, density, seed):
    rng = np.random.default_rng(seed)
    walk = rng.integers(0, 1 << 32, (S + 4, B)).astype(np.int64)
    walk[S + 1] = rng.integers(0, 300, B)
    counted = rng.random(B) < density
    h = rng.integers(0, 1 << 32, (2, B)).astype(np.int64)
    h[0, :B // 8] = 0x00800000  # ties on the threshold's high word
    return counted, h[0], h[1], walk


def _capture_both(slab, stats, counted, h1, h2, walk, thresh, scr, seed):
    want_slab, want_stats = torch.from_numpy(slab.copy()), torch.from_numpy(stats.copy())
    wk.capture_plain(want_slab, want_stats, torch.from_numpy(counted), torch.from_numpy(h1),
                     torch.from_numpy(h2), torch.from_numpy(walk), torch.from_numpy(np.array(thresh)))
    _k13c_transcribed(slab, stats, counted, h1, h2, walk, thresh, scr, seed)
    scap = slab.shape[1] - 1
    assert np.array_equal(slab[:, :scap], want_slab.numpy()[:, :scap])
    assert np.array_equal(stats, want_stats.numpy())
    assert scr.clean()


@pytest.mark.parametrize("B,S,density,thresh,occ,scap", [
    (16_384, 30, 0.85, (M32, M32), 0, 17_000),                  # paxos-3's loose step: every counted walk
    (16_384, 30, 0.85, (0x00800000, 0x40000000), 5, 17_000),    # ties on the threshold's high word
    (65_536, 3, 0.85, (0x00400000, 0), 600, 66_560),            # 2pc-10's tight step
    (3_000, 5, 0.9, (M32, M32), 1_900, 2_000),                  # the slab reaches its trash row
    (300 * TILE + 7, 1, 0.0005, (M32, M32), 0, 1_000),          # over 256 tiles: a look-back past kThreads
    (777, 37, 0.5, (0x80000000, 1), 3, 900),                    # 40 lanes, one ragged tile
])
@pytest.mark.parametrize("seed", [0, 1])
def test_k13c_blocks_in_random_orders_equal_the_plain_capture(B, S, density, thresh, occ, scap, seed):
    counted, h1, h2, walk = _k13c_inputs(B, S, density, seed + B)
    rng = np.random.default_rng(seed)
    slab = rng.integers(0, 1 << 32, (3 + S, scap + 1)).astype(np.int64)
    stats = np.array([1, occ, 2, 3, 4], dtype=np.int64)
    scr = _Scratch(B)
    _capture_both(slab, stats, counted, h1, h2, walk, thresh, scr, seed)


def test_k13c_on_one_scratch_over_a_run_of_steps():
    """A loose step, tight steps, an empty step (slab, stats and scratch
    untouched), and a step into the trash row, on one scratch."""
    B, S = 5_000, 4
    scap = 9_000
    slab = np.zeros((3 + S, scap + 1), dtype=np.int64)
    stats = np.zeros(5, dtype=np.int64)
    scr = _Scratch(B)
    for step, (thresh, density) in enumerate([((M32, M32), 0.9), ((0x08000000, 0), 0.9), ((0x00800000, 7), 0.5),
                                              ((0, 0), 0.9), ((0x01000000, 0), 0.9), ((M32, M32), 0.9)]):
        counted, h1, h2, walk = _k13c_inputs(B, S, density, step)
        before = (slab.copy(), stats.copy())
        _capture_both(slab, stats, counted, h1, h2, walk, thresh, scr, step)
        if thresh == (0, 0):
            assert np.array_equal(slab, before[0]) and np.array_equal(stats, before[1])
    assert stats[wk.OCC] > scap  # the last step wrote past the slab's end: into its trash row


# ---------------------------------------------------------------------------
# The plain versions against the JAX walk step
# ---------------------------------------------------------------------------

def _crafted(prog, S, B, L, rng):
    """The program's walks after a few eras, with ptr redrawn over 0..L-1
    (an active walk reaches L only to restart in the same step), random
    words above the real paths, and an eighth of the walks on a cycle at
    slot 0 or at ptr - 1; none frozen (the JAX era restarts those)."""
    walk, path = prog.walk, prog.path
    walk[S + 3] = 0
    old = walk[S + 1].clone()
    ptr = torch.from_numpy(rng.integers(0, L, B))
    ptr[:4] = torch.tensor([0, 1, L - 2, L - 1])
    above = torch.arange(L)[None, :] >= old[:, None]
    path.copy_(torch.where(above, torch.from_numpy(rng.integers(0, 1 << 62, (B, L))), path))
    walk[S + 1] = ptr
    from stateright_tpu_torch.fingerprint import hash_lanes

    h1, h2 = hash_lanes(walk[:S])
    key = pack64(h1, h2)
    w = torch.arange(B)
    cyc = ((w % 8 == 3) & (ptr > 0)).nonzero().view(-1)
    at = torch.where(w % 16 == 3, 0, ptr - 1)
    path[cyc, at[cyc]] = key[cyc]


@pytest.mark.parametrize("model,B,L,thresh", [
    (("TwoPhaseTensor", 3), 64, 12, (M32, M32)),
    (("TwoPhaseTensor", 3), 64, 12, "a walk's own"),
    (("IncrementTensor", 2), 48, 9, (0x80000000, 0)),
])
def test_record_and_capture_plain_equal_the_jax_step(model, B, L, thresh):
    jtm, ttm = _pair(*model)
    S = ttm.state_width
    loop, _seed_run, _n = ts._build_sim_loop(jtm, jtm.tensor_properties(), B, L, True, sample_k=K)
    prog = SimProgram(ttm, ttm.tensor_properties(), B, L, True, K, "cpu")
    walk, path = prog.seed(9)
    for _ in range(3):
        prog.era(walk, path, rec_bits=0, max_steps=4, fin_any=0, fin_all=0, fin_all_en=0, target_gen=0, gen0=0)
    rng = np.random.default_rng(B + L)
    _crafted(prog, S, B, L, rng)
    if thresh == "a walk's own":
        from stateright_tpu_torch.fingerprint import hash_lanes

        h1, h2 = hash_lanes(walk[:S])
        thresh = (int(h1[5]), int(h2[5]))  # the walks on this state tie on both halves
    w_np, p_np = walk.numpy().copy(), path.numpy().copy()
    sk2 = slab_entries(K)
    P, A = len(ttm.tensor_properties()), ttm.max_actions
    s_base = ts.P_LEN + 2 * P + A + P + DEPTH_CAP
    params = np.zeros(s_base + 4 + (4 + S) * sk2, dtype=np.uint32)
    params[ts.P_MAX_STEPS] = 1
    params[ts.P_SEED] = 9
    params[s_base:s_base + 2] = thresh
    u = np.uint32
    walk_j = tuple(jnp.asarray(w_np[i].astype(u)) for i in range(S + 4))
    f1 = jnp.asarray(((p_np >> 32) & M32).astype(u).reshape(-1))
    f2 = jnp.asarray((p_np & M32).astype(u).reshape(-1))
    walk_j, f1, f2, out = loop(walk_j, f1, f2, jnp.asarray(params))
    r = prog.era(walk, path, rec_bits=0, max_steps=1, fin_any=0, fin_all=0, fin_all_en=0, target_gen=0,
                 gen0=0, threshold=thresh)
    assert np.array_equal(np.stack([np.asarray(x) for x in walk_j]).astype(np.int64), walk.numpy())
    ptr = walk[S + 1].numpy()
    below = np.arange(L)[None, :] < ptr[:, None]
    pw = path.numpy()
    for lane, half in ((f1, (pw >> 32) & M32), (f2, pw & M32)):
        assert np.array_equal(np.asarray(lane).reshape(B, L)[below], half[below])
    assert np.array_equal(np.asarray(out).astype(np.int64), r.params)
    # The step found cycles, counted walks and, below the threshold, captures.
    assert 0 < r.gen < B and r.occupied > 0
