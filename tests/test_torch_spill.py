"""The host spill (slice 7): K7s's plain versions against the JAX engines'
eager spill programs, and spilling runs of the port against fresh JAX
runs under `JAX_PLATFORMS=cpu`.

- K7s DRAIN / REFILL (`ops/frontier.py`) against the JAX expressions of
  S1 (`tpu_bfs.py:1924-1948`: the newest k rows of each ring lane,
  stacked to [k, W]), S2 (`:2071-2087`: `queue[i].at[tail_idx].set`),
  and their per-shard twins S3/S4 (`parallel/mesh.py:1776-1800`,
  `:1952-1985`) with ragged shard counts and wraps past qcap.
- 2pc-5 at the reference's `SPILL_OPTS` (tests/test_outofcore.py:29),
  with and without the disk tier: the ring after every era, the spill
  stack's pushes and pops, and the parity dict, sample included.
- The sharded engine spilling at N = 2 (2pc-5); at N = 8 the quota floor
  (64 rows) keeps a shard's ring at 2^11 or more, which no model small
  enough for these tests outgrows: the card runs it (chip_smoke.py phase
  20), the lane forms of K7s are held here at N = 8.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import stateright_tpu.models as jax_models
import stateright_tpu_torch.models as torch_models
from stateright_tpu.tensor import TensorModelAdapter as JaxAdapter
from stateright_tpu_torch import TensorModelAdapter
from stateright_tpu_torch.ops import frontier as fr
from torch_parity import _JAX_MODELS, one_torch_thread, parity_dict, reference_uncached  # noqa: F401

SPILL_OPTS = dict(chunk_size=32, queue_capacity=1 << 10, table_capacity=1 << 11)


def _ring(rng, W, qcap, lanes=None):
    shape = (W, qcap) if lanes is None else (lanes, W, qcap)
    u = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
    trash = np.zeros(shape[:-1] + (1,), dtype=np.int64)
    return u, torch.from_numpy(np.concatenate([u.astype(np.int64), trash], -1))


# (qcap, W, head, count, k): a plain drain, one that wraps past qcap, the
# whole ring, and one row.
SOLO_CASES = [(64, 5, 3, 40, 17), (64, 5, 50, 30, 29), (32, 32, 7, 32, 32), (16, 3, 15, 1, 1)]


@pytest.mark.parametrize("qcap,W,head,count,k", SOLO_CASES)
def test_drain_and_refill_match_the_jax_solo_programs(qcap, W, head, count, k):
    rng = np.random.default_rng(qcap + W + k)
    u, ring = _ring(rng, W, qcap)
    queue = tuple(jnp.asarray(u[i]) for i in range(W))
    take_idx = jnp.asarray((head + count - k + np.arange(k)) & (qcap - 1))
    big = np.asarray(jnp.stack([queue[i][take_idx] for i in range(W)], axis=1))
    got = fr.ring_drain_plain(ring, head + count - k, k).numpy().view(np.uint32)
    assert got.dtype == big.dtype and np.array_equal(got, big)
    assert np.array_equal(fr.ring_drain(ring, head + count - k, k).numpy().view(np.uint32), big)
    # S2: the same rows back at the tail of another ring state.
    rows = rng.integers(0, 1 << 32, size=(k, W), dtype=np.uint64).astype(np.uint32)
    tail_idx = jnp.asarray((head + count + np.arange(k)) & (qcap - 1))
    rows_dev = jnp.asarray(rows)
    want = np.stack([np.asarray(queue[i].at[tail_idx].set(rows_dev[:, i])) for i in range(W)])
    for refill in (fr.ring_refill_plain, fr.ring_refill):
        r = ring.clone()
        refill(r, head + count, torch.from_numpy(rows.view(np.int32)))
        assert np.array_equal(r[:, :qcap].numpy().astype(np.uint32), want)
        assert int(r[:, qcap].abs().sum()) == 0  # the trash column is never written


# (qcap, W, heads, counts, ks) a shard: ragged counts, a shard with
# nothing to move and drains and refills that wrap past qcap.
MESH_CASES = [
    (64, 5, [0, 60], [50, 20], [9, 17]),
    (128, 4, [5, 120, 64, 0, 127, 33, 90, 1], [100, 40, 0, 128, 3, 60, 77, 12],
     [30, 40, 0, 128, 1, 0, 60, 12]),
]


@pytest.mark.parametrize("qcap,W,heads,counts,ks", MESH_CASES, ids=["n2", "n8"])
def test_lane_forms_match_the_jax_mesh_programs(qcap, W, heads, counts, ks):
    N = len(heads)
    rng = np.random.default_rng(N)
    u, rings = _ring(rng, W, qcap, lanes=N)
    queue = tuple(jnp.asarray(u[:, t]) for t in range(W))
    starts = [h + c - k for h, c, k in zip(heads, counts, ks)]
    blocks = []
    for s in range(N):
        idx = jnp.asarray((starts[s] + np.arange(ks[s])) & (qcap - 1))
        blocks.append(np.asarray(jnp.stack([queue[t][s, idx] for t in range(W)], axis=1)).reshape(-1, W))
    want = np.concatenate(blocks)
    got = fr.ring_drain_lanes_plain(rings, starts, ks).numpy().view(np.uint32)
    assert np.array_equal(got, want)
    staged = fr.SpillStaging(W, "cpu").drain(rings, starts, ks)
    assert staged.dtype == np.uint32 and np.array_equal(staged, want)
    # S4: each shard's rows at its own tail.
    rows = rng.integers(0, 1 << 32, size=(sum(ks), W), dtype=np.uint64).astype(np.uint32)
    tails = [h + c for h, c in zip(heads, counts)]
    q = queue
    off = 0
    for s in range(N):
        idx = jnp.asarray((tails[s] + np.arange(ks[s])) & (qcap - 1))
        rows_dev = jnp.asarray(rows[off:off + ks[s]])
        q = tuple(q[t].at[s, idx].set(rows_dev[:, t]) for t in range(W))
        off += ks[s]
    want_q = np.stack([np.asarray(lane) for lane in q], 1)
    r = rings.clone()
    fr.ring_refill_lanes_plain(r, tails, ks, torch.from_numpy(rows.view(np.int32)))
    assert np.array_equal(r[:, :, :qcap].numpy().astype(np.uint32), want_q)
    # The staging refill, whole and in pieces smaller than a shard's block.
    for piece in (0, 7, max(ks)):
        r = rings.clone()
        fr.SpillStaging(W, "cpu", piece).refill(r, tails, ks, rows)
        assert np.array_equal(r[:, :, :qcap].numpy().astype(np.uint32), want_q), piece


def test_refill_takes_uint32_rows_of_the_ring_width():
    ring = fr.empty_ring(4, 16, "cpu")
    with pytest.raises(ValueError, match="int32"):
        fr.ring_refill(ring, 0, torch.zeros((3, 4), dtype=torch.int64))
    with pytest.raises(ValueError, match="int32"):
        fr.ring_refill(ring, 0, torch.zeros((3, 5), dtype=torch.int32))


# -- engine runs --------------------------------------------------------------

def _jax_2pc5():
    """The reference model instance the engine tests share: its compiled
    programs are cached per instance."""
    return _JAX_MODELS.setdefault(("TwoPhaseTensor", (5,)), jax_models.TwoPhaseTensor(5))


def _record_jax(monkeypatch, log):
    """Record every JAX era dispatch's input and output ring and every
    spill push and pop."""
    from stateright_tpu.engines import tpu_bfs
    from stateright_tpu.ops import tiering

    orig_loop, orig_seed = tpu_bfs._build_loop, tpu_bfs._build_seed_loop

    def ring_np(queue):
        return np.stack([np.asarray(q) for q in queue]).astype(np.int64)

    def wrap(fn):
        def run(table, queue, f1, f2, params):
            log["in"].append(ring_np(queue))
            out = fn(table, queue, f1, f2, params)
            log["out"].append(ring_np(out[1]))
            return out
        return run

    def build_loop(*a, **k):
        prog = orig_loop(*a, **k)
        if k.get("raw"):
            return prog
        return tpu_bfs.EraProgram(serial=wrap(prog.serial), chain=wrap(prog.chain))

    def build_seed(*a, **k):
        seed = orig_seed(*a, **k)

        def run(*args):
            out = seed(*args)
            log["out"].append(ring_np(out[1]))
            return out
        return run

    monkeypatch.setattr(tpu_bfs, "_build_loop", build_loop)
    monkeypatch.setattr(tpu_bfs, "_build_seed_loop", build_seed)
    _record_stack(monkeypatch, tiering.TieredSpillStore, log)


def _record_stack(monkeypatch, cls, log):
    orig_append, orig_pop = cls.append, cls.pop

    def append(self, block):
        log["stack"].append(("push", np.asarray(block).tobytes()))
        return orig_append(self, block)

    def pop(self):
        block = orig_pop(self)
        log["stack"].append(("pop", np.asarray(block).tobytes()))
        return block

    monkeypatch.setattr(cls, "append", append)
    monkeypatch.setattr(cls, "pop", pop)


def _record_port(monkeypatch, log):
    from stateright_tpu_torch.engines import era
    from stateright_tpu_torch.ops import tiering

    orig_launch = era.EraProgram.launch

    def launch(self):
        log["in"].append(self.ring[:, :self.qcap].numpy().copy())
        out = orig_launch(self)
        log["out"].append(self.ring[:, :self.qcap].numpy().copy())
        return out

    monkeypatch.setattr(era.EraProgram, "launch", launch)
    _record_stack(monkeypatch, tiering.TieredSpillStore, log)


@pytest.mark.parametrize("budget", [None, 2 * 18 * 27 * 5 * 4], ids=["ram", "disk"])
def test_spilling_run_matches_jax_era_by_era(monkeypatch, budget):
    """2pc-5 through a 2^10 ring, serial eras: after every era the port's
    ring equals the JAX ring word for word, the spill stack takes the
    same blocks in the same order, and the results are equal. With the
    budget (two blocks of 18 x 27 rows) the disk tier takes the older
    blocks and gives every row back."""
    if budget is not None:
        monkeypatch.setenv("STPU_SPILL_HOST_BUDGET_BYTES", str(budget))
    jlog = {"in": [], "out": [], "stack": []}
    plog = {"in": [], "out": [], "stack": []}
    with monkeypatch.context() as m:
        _record_jax(m, jlog)
        ref = JaxAdapter(_jax_2pc5()).checker().coverage().pipeline(False).spawn_tpu_bfs(
            **SPILL_OPTS).join()
    with monkeypatch.context() as m:
        _record_port(m, plog)
        ours = TensorModelAdapter(torch_models.TwoPhaseTensor(5)).checker().coverage().pipeline(
            False).spawn_gpu_bfs(device="cpu", **SPILL_OPTS).join()
    assert parity_dict(ours) == parity_dict(ref)
    assert ours.unique_state_count() == 8_832
    rt, jt = ours.telemetry(), ref.telemetry()
    for key in ("spill_rows", "refill_rows", "eras", "steps", "spill_tier_rows", "spill_tier_refill_rows"):
        assert rt.get(key) == jt.get(key), key
    assert rt["spill_rows"] > 0 and rt["refill_rows"] == rt["spill_rows"]
    if budget is not None:
        assert rt["spill_tier_rows"] > 0 and rt["spill_tier_refill_rows"] == rt["spill_tier_rows"]
    # The first launch's input is the seeded ring, which JAX builds inside
    # its fused seed program.
    assert len(plog["out"]) == len(jlog["out"]) == rt["eras"]
    assert len(plog["in"][1:]) == len(jlog["in"])
    for i, (a, b) in enumerate(zip(plog["out"], jlog["out"])):
        assert np.array_equal(a, b), f"ring after era {i}"
    for i, (a, b) in enumerate(zip(plog["in"][1:], jlog["in"])):
        assert np.array_equal(a, b), f"ring into era {i + 1}"
    assert plog["stack"] == jlog["stack"]


def test_spilling_run_pipelined_matches_jax():
    from torch_parity import run_pair

    ref, ours = run_pair("TwoPhaseTensor", (5,), SPILL_OPTS)
    assert parity_dict(ours) == parity_dict(ref)
    rt, jt = ours.telemetry(), ref.telemetry()
    for key in ("spill_rows", "refill_rows", "eras", "steps", "dispatches", "spec_wasted"):
        assert rt.get(key) == jt.get(key), key


def test_sharded_spilling_run_matches_jax():
    """2pc-5 at 2 shards past each shard's high water (chunk 9 after the
    clamp, a 2^9 ring a shard)."""
    opts = dict(chunk_size=32, queue_capacity_per_shard=1 << 9)
    ref = JaxAdapter(_jax_2pc5()).checker().coverage().spawn_sharded_bfs(
        devices=jax.devices()[:2], **opts).join()
    ours = TensorModelAdapter(torch_models.TwoPhaseTensor(5)).checker().coverage().spawn_sharded_bfs(
        devices=2, device="cpu", **opts).join()
    assert parity_dict(ours) == parity_dict(ref)
    rt, jt = ours.telemetry(), ref.telemetry()
    for key in ("spill_rows", "refill_rows", "eras", "steps", "dispatches"):
        assert rt.get(key) == jt.get(key), key
    assert rt["spill_rows"] > 0
