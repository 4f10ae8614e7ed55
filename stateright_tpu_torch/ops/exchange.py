"""The owner exchange of the sharded step (K15a): bucket each shard's
candidates by owner shard and lay them out as every owner receives them,
with a hand-written kernel (kernels/csrc/exchange.cu: COUNT, then WRITE
as its programmatic dependent, two launches over every source's tiles)
and its plain torch version.

The port's counterpart of `stateright_tpu/parallel/mesh.py:337-384`:
after the in-batch dedup, candidate i of shard l goes to its owner
`h1 % N` (N: every shard of the mesh) at its STABLE rank among shard l's
candidates for that owner — the rank a cumsum in candidate order gives,
so the owner's receive buffer, its insert's winner (the highest index)
and its ring order are the JAX program's. A candidate ranked past
`quota` stays home and counts into its shard's overflow.

The X exchanged lanes (the state's S lanes, then ebits, depth, and the
parent fingerprint p1, p2; JAX exchanges the same lanes in another order,
and no result depends on it) land in the receive layout of a tiled
all_to_all: owner o sees [src][quota], in source-shard order, and an
empty slot is all zero (an all-zero parent pair marks it, mesh.py:392).

A rank holds NL = N / W local shards. The send buffer is
[W, X, NL, NL, quota]: destination rank, lane, local owner, local source,
rank in the bucket. On one rank (W = 1) it IS every local owner's
receive buffer [X, NL, NL * quota], so the kernel is the whole exchange;
across ranks one `all_to_all_single` moves it and `receive` puts the
source rank next to the local source.
"""

from __future__ import annotations

import torch

from .. import kernels

MAX_SHARDS = 256  # owners a kernel block counts in shared memory
# K15a's blocks (kernels/csrc/exchange.cu): a sub-tile is EXCHANGE_SUB
# candidates (a block's threads), and every WRITE block reads its
# source's counts of every tile and owner, at most EXCHANGE_MAX_CELLS.
EXCHANGE_SUB = 256
EXCHANGE_MAX_CELLS = 16384


def exchange_plan(V: int, n_total: int):
    """K15a's launch plan for sources of V candidates and n_total owners:
    (per, tiles). A tile is `per` sub-tiles of EXCHANGE_SUB candidates, as
    few as keep tiles x n_total within EXCHANGE_MAX_CELLS (0 tiles when V
    is 0, none of them empty); COUNT and WRITE run a block a (tile,
    source), WRITE at least one a source. The scratch holds one int32 a
    (source, tile, owner)."""
    sub = -(-V // EXCHANGE_SUB)
    most = max(1, EXCHANGE_MAX_CELLS // n_total)
    per = max(1, -(-sub // most))
    return per, -(-sub // per)


def send_shape(world: int, X: int, nl: int, quota: int):
    return (world, X, nl, nl, quota)


def exchange_plain(h1, reps, vals, n_total: int, quota: int, world: int = 1):
    nl, V = reps.shape
    X = vals.shape[0]
    dev = reps.device
    owner = h1.reshape(nl, V) % n_total
    onehot = (owner[..., None] == torch.arange(n_total, device=dev)) & reps[..., None]
    csum = torch.cumsum(onehot.to(torch.int64), 1)
    pos = (csum * onehot).sum(2) - 1
    per_owner = csum[:, -1]
    n_ovf = (per_owner - per_owner.clamp(max=quota)).sum(1)
    keep = reps & (pos < quota)
    d, ol = owner // nl, owner % nl
    src = torch.arange(nl, device=dev)[:, None]
    lane = torch.arange(X, device=dev)[:, None, None]
    flat = (((d[None] * X + lane) * nl + ol[None]) * nl + src[None]) * quota + pos[None]
    send = torch.zeros(world * X * nl * nl * quota, dtype=torch.int64, device=dev)
    k = keep.reshape(-1)
    send.index_copy_(0, flat.reshape(X, -1)[:, k].reshape(-1), vals.reshape(X, -1)[:, k].reshape(-1))
    return send.view(send_shape(world, X, nl, quota)), n_ovf


def exchange(h1: torch.Tensor, reps: torch.Tensor, vals: torch.Tensor, n_total: int,
             quota: int, world: int = 1, out=None):
    """Bucket every local shard's candidates by owner (K15a).

    h1 int64 [NL * V] (the candidates' fingerprint halves, shard l's at
    l * V ..), reps bool [NL, V] (the dedup's survivors), vals int64
    [X, NL * V] (the exchanged lanes); `n_total` shards in the mesh,
    `world` ranks of NL = n_total / world shards. Returns (send [W, X,
    NL, NL, quota], n_ovf [NL]): the send buffer (on one rank, the
    receive buffer; slots nobody fills are zero) and each local shard's
    candidates past its owners' quotas. `out`, if given, is the send
    buffer to write (every word is written). On CPU tensors the plain
    version runs."""
    nl, V = reps.shape
    X = vals.shape[0]
    if nl * world != n_total:
        raise ValueError("the ranks' local shards must add up to the mesh")
    if not kernels.on_card(h1, reps, vals):
        send, n_ovf = exchange_plain(h1, reps, vals, n_total, quota, world)
        if out is not None:
            out.copy_(send)
            return out, n_ovf
        return send, n_ovf
    if n_total > MAX_SHARDS:
        raise ValueError(f"the exchange kernel takes at most {MAX_SHARDS} shards")
    if reps.dtype != torch.bool or vals.stride(1) != 1:
        raise ValueError("exchange takes a bool reps mask and row-contiguous lanes")
    dev = reps.device
    send = out if out is not None else torch.empty(
        send_shape(world, X, nl, quota), dtype=torch.int64, device=dev
    )
    n_ovf = torch.empty(nl, dtype=torch.int64, device=dev)
    per, tiles = exchange_plan(V, n_total)
    # COUNT writes every entry before WRITE reads it: no reset, so under a
    # graph capture this allocation is made once and replayed as it is.
    scratch = torch.empty(nl * max(1, tiles) * n_total, dtype=torch.int32, device=dev)
    kernels.EXCHANGE.launch(
        kernels.ptr(h1.contiguous()), kernels.ptr(reps.contiguous()), vals.data_ptr(),
        vals.stride(0), nl, V, X, n_total, quota, world, per, tiles, kernels.ptr(scratch),
        kernels.ptr(send), kernels.ptr(n_ovf),
    )
    return send, n_ovf


def receive(out: torch.Tensor) -> torch.Tensor:
    """The receive buffer [X, NL, N * quota] from what an all_to_all_single
    of the send buffers delivered ([W_src, X, NL, NL, quota]): owner o's
    slots in global source-shard order."""
    W, X, nl, _nl, quota = out.shape
    return out.permute(1, 2, 0, 3, 4).reshape(X, nl, W * nl * quota)
