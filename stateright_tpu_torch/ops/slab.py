"""The bottom-k sample slab on the card (K9): per-step capture (K9a) and
the era epilogue (K9b), the port's counterpart of the sampling parts of
`stateright_tpu/engines/tpu_bfs.py` (capture :506-549, epilogue
:983-995).

A slab is four int64 lanes of scap + 1 rows (fp1, fp2, depth, action;
row scap is the trash row of out-of-range writes) and an int64[2]
counts vector (occupied, dropped), all on the engine's device. The era
loop captures into it after every insert, ends the era once `occupied`
passes the sampler's high-water mark, and drains the sk2 rows with the
smallest fp1 into `obs.sample.SpaceSampler.drain_slab`.

`capture` and `bottom_k`, and their forms over every shard's slab
(`capture_lanes`, `bottom_k_lanes`), run their kernels (kernels/csrc) on
CUDA tensors and their plain torch versions on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from .visited_set import compact_ids

M32 = 0xFFFFFFFF
SLAB_MAX_ROWS = 16384  # K9b holds one slab's words in one block's shared memory


class Slab(NamedTuple):
    fp1: torch.Tensor
    fp2: torch.Tensor
    depth: torch.Tensor
    action: torch.Tensor
    counts: torch.Tensor  # [occupied, dropped]

    @property
    def capacity(self) -> int:
        return self.fp1.shape[0] - 1


def empty_slab(scap: int, device) -> Slab:
    def z(n):
        return torch.zeros(n, dtype=torch.int64, device=device)

    return Slab(z(scap + 1), z(scap + 1), z(scap + 1), z(scap + 1), z(2))


def below_threshold(is_new, h1, h2, thresh):
    """New inserts whose fingerprint is below thresh = (t1, t2) (an int64
    [2] tensor on the candidates' device), lexicographically. The halves
    are uint32 held in int64, so int64 compares are the unsigned compares
    of the JAX uint32 lanes."""
    t1, t2 = thresh[0], thresh[1]
    return is_new & ((h1 < t1) | ((h1 == t1) & (h2 < t2)))


def capture_plain(slab: Slab, is_new, h1, h2, depth, action, thresh, step_cap: int) -> None:
    below = below_threshold(is_new, h1, h2, thresh)
    scap = slab.capacity
    cids, cvalid, n_c = compact_ids(below, step_cap)
    occ = slab.counts[0]
    pos = occ + torch.arange(step_cap, dtype=torch.int64, device=h1.device)
    widx = torch.where(cvalid & (pos < scap), pos, scap)
    for lane, src in zip(slab[:4], (h1, h2, depth, action)):
        # Every valid write has its own row; only the trash row repeats.
        lane.index_copy_(0, widx[cvalid], src.index_select(0, cids[cvalid]))
    fit = torch.clamp(n_c, max=step_cap)
    slab.counts[0] += fit
    slab.counts[1] += n_c - fit


CAPTURE_TILE = 1024  # candidates a block of K9a (csrc/capture_scan.cuh kTile)
CAPTURE_WORDS = CAPTURE_TILE // 32  # a tile's capture bits, 32 candidates a word


def _capture_ints(lanes: int, n: int) -> int:
    return lanes * (2 + -(-n // CAPTURE_TILE) * (1 + 2 * CAPTURE_WORDS))


def capture_scratch(lanes: int, n: int, device) -> torch.Tensor:
    """K9a's scratch for `lanes` slabs of n candidates (int32, zero): each
    lane's ticket, each tile's count, capture bits and words' first ranks.
    Every launch leaves it as it found it, so a program keeps one for all
    its steps."""
    return torch.zeros(_capture_ints(lanes, n), dtype=torch.int32, device=device)


def _capture_launch(kernel, lanes: int, dst, slab_stride: int, counts, is_new, h1, h2, depth,
                    action, act_stride: int, thresh, thresh_stride: int, step_cap: int,
                    scratch) -> None:
    n = is_new.shape[-1]
    if is_new.dtype != torch.bool or not thresh.is_contiguous() or thresh.shape[-1] != 2:
        raise ValueError("capture takes a bool is_new mask and contiguous [2] thresholds")
    if scratch is None:
        scratch = capture_scratch(lanes, n, is_new.device)
    if scratch.dtype != torch.int32 or scratch.numel() < _capture_ints(lanes, n):
        raise ValueError("the capture scratch is too small")
    p = kernels.ptr
    kernel.launch(
        lanes, p(is_new), p(h1), p(h2), p(depth), p(action), n, n, act_stride, p(thresh),
        thresh_stride, *(t.data_ptr() for t in dst), slab_stride, dst[0].shape[-1] - 1, p(counts),
        step_cap, p(scratch), scratch.numel(),
    )


def capture(slab: Slab, is_new, h1, h2, depth, action, thresh, step_cap: int,
            scratch=None) -> None:
    """Append the new inserts below the threshold thresh = (t1, t2) to the
    slab, in candidate order, at most `step_cap` of them (the rest count
    as dropped); updates the slab and its counts in place. is_new bool
    [n]; h1, h2, depth, action int64 [n]; thresh int64 [2] on the same
    device, read there (the era's state vector holds it, so a captured
    step reads the threshold of each era it runs in). `scratch`
    (`capture_scratch(1, n)`): a program passes its own, a call without
    one gets a fresh one."""
    if not kernels.on_card(slab.fp1, is_new, h1, h2, depth, action, thresh):
        return capture_plain(slab, is_new, h1, h2, depth, action, thresh, step_cap)
    if thresh.numel() != 2:
        raise ValueError("capture takes one [2] threshold")
    args = [t.contiguous() for t in (is_new, h1, h2, depth, action)]
    _capture_launch(kernels.SAMPLE_CAPTURE, 1, slab[:4], 0, slab.counts, *args, 0, thresh, 0,
                    step_cap, scratch)


def capture_lanes_plain(slabs: torch.Tensor, counts: torch.Tensor, is_new, h1, h2, depth,
                        action, thresh, step_cap: int) -> None:
    N = slabs.shape[1]
    for l in range(N):
        capture_plain(Slab(*(slabs[k, l] for k in range(4)), counts[l]), is_new[l], h1[l], h2[l],
                      depth[l], action if action.dim() == 1 else action[l],
                      thresh if thresh.dim() == 1 else thresh[l], step_cap)


def capture_lanes(slabs: torch.Tensor, counts: torch.Tensor, is_new, h1, h2, depth, action,
                  thresh, step_cap: int, scratch=None) -> None:
    """`capture` into every shard's slab in one launch (the sharded step's
    capture, mesh.py:398-431 on each shard): slabs int64 [4, N, scap + 1]
    (fp1, fp2, depth, action), counts int64 [N, 2]; is_new bool, h1, h2
    and depth int64 [N, n]; action [N, n] or one [n] for every shard;
    thresh [2] (one threshold) or [N, 2]. `scratch`:
    `capture_scratch(N, n)`."""
    if not kernels.on_card(slabs, counts, is_new, h1, h2, depth, action, thresh):
        return capture_lanes_plain(slabs, counts, is_new, h1, h2, depth, action, thresh, step_cap)
    N = slabs.shape[1]
    if not slabs.is_contiguous() or counts.shape != (N, 2) or is_new.shape[0] != N:
        raise ValueError("capture_lanes takes contiguous slabs [4, N, scap + 1] and counts [N, 2]")
    args = [t.contiguous() for t in (is_new, h1, h2, depth, action)]
    _capture_launch(kernels.SAMPLE_CAPTURE_LANES, N, tuple(slabs[:, 0]), slabs.shape[2], counts,
                    *args, 0 if action.dim() == 1 else is_new.shape[1], thresh,
                    0 if thresh.dim() == 1 else 2, step_cap, scratch)


def bottom_k_lanes_plain(slabs: torch.Tensor, counts: torch.Tensor, k: int):
    N, scap = slabs.shape[1], slabs.shape[2] - 1
    used = torch.arange(scap, device=slabs.device)[None, :] < counts[:, :1]
    key = torch.where(used, (~slabs[0, :, :scap]) & M32, 0)
    # Stable descending sort: equal keys keep the lower row first, the
    # order lax.top_k gives.
    top = torch.sort(key, dim=1, descending=True, stable=True).indices[:, :k]
    return tuple(slabs[j, :, :scap].gather(1, top) for j in range(4)) + (used.gather(1, top),)


def _bottom_k(lanes, counts: torch.Tensor, k: int, kernel):
    """K9b over the slabs whose lanes (fp1, fp2, depth, action) are [N,
    scap + 1] views with one row stride, counts [N, 2]."""
    N, scap = lanes[0].shape[0], lanes[0].shape[1] - 1
    if not 0 < k <= scap:
        raise ValueError("bottom_k takes 0 < k <= the slab's capacity")
    if scap > SLAB_MAX_ROWS:
        raise ValueError(f"the slab kernel takes at most {SLAB_MAX_ROWS:,} rows a slab")
    stride = lanes[0].stride(0)
    if any(t.stride() != (stride, 1) for t in lanes) or counts.stride() != (2, 1):
        raise ValueError("the slab lanes and counts must be rows of one stride")
    dev = lanes[0].device
    out = torch.empty((4, N, k), dtype=torch.int64, device=dev)
    valid = torch.empty((N, k), dtype=torch.bool, device=dev)
    kernel.launch(
        *(t.data_ptr() for t in lanes), stride, scap, counts.data_ptr(), 2, k,
        *(kernels.ptr(t) for t in out), kernels.ptr(valid), N,
    )
    return (*out, valid)


def bottom_k_lanes(slabs: torch.Tensor, counts: torch.Tensor, k: int):
    """`bottom_k` of every shard's slab in one launch: slabs int64 [4, N,
    scap + 1] (fp1, fp2, depth, action), counts int64 [N, 2]; returns
    (fp1, fp2, depth, action, valid), each [N, k] (the sharded tail,
    mesh.py:797 on each shard)."""
    if not kernels.on_card(slabs, counts):
        return bottom_k_lanes_plain(slabs, counts, k)
    return _bottom_k(tuple(slabs[j] for j in range(4)), counts, k, kernels.SLAB_BOTTOMK_LANES)


def bottom_k_plain(slab: Slab, k: int):
    return tuple(x[0] for x in bottom_k_lanes_plain(torch.stack(slab[:4])[:, None], slab.counts[None], k))


def bottom_k(slab: Slab, k: int):
    """The k used slab rows with the smallest fp1 (ties: lower row first),
    padded with unused rows: (fp1, fp2, depth, action, valid), each [k].
    The one-slab case of `bottom_k_lanes`."""
    if k > slab.capacity:
        raise ValueError("bottom_k takes at most the slab's capacity")
    if not kernels.on_card(slab.fp1):
        return bottom_k_plain(slab, k)
    got = _bottom_k(tuple(t[None] for t in slab[:4]), slab.counts[None], k, kernels.SLAB_BOTTOMK)
    return tuple(x[0] for x in got)
