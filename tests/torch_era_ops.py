"""K8f COMMIT's operands built from per-lane counts, for the tests of
the era kernels' plain versions and of the kernels on the card. No JAX
here: the card tests import it too."""

import numpy as np
import torch

from stateright_tpu_torch.ops import era as eo


def step_operands(C, A, P, m, n_val, n_d, unres, new, hs, pa, gen=None, depth=3, solo=False,
                  device="cpu"):
    """A step of N = len(n_val) lanes at chunk C: lane l's unresolved and
    new masks (width m) hold unres[l] / new[l] leading set bits, its hits of
    property i the hs[l][i] leading chunk positions, its valid mask of
    action a the pa[l][a] leading positions; every new insert sits at
    `depth`; the popped rows' hashes and depths are distinct per position.
    gen: per-lane generated counts, or None (counted from the valid mask,
    as the lanes' COMMIT does). solo: one lane in the solo shapes (0-d
    counts, [C] hits). The era's first-hit lanes start empty."""
    N = len(n_val)
    unresolved = torch.zeros((N, m), dtype=torch.bool)
    c_new = torch.zeros((N, m), dtype=torch.bool)
    hits = torch.zeros((P, N, C), dtype=torch.bool)
    valid = torch.zeros((A, N, C), dtype=torch.bool)
    for l in range(N):
        unresolved[l, :unres[l]] = True
        c_new[l, :new[l]] = True
        for i in range(P):
            hits[i, l, :hs[l][i]] = True
        for a in range(A):
            valid[a, l, :pa[l][a]] = True
    pos = torch.arange(N * C, dtype=torch.int64)
    counts = [torch.tensor(v, dtype=torch.int64) for v in (n_val, n_d)]
    generated = None if gen is None else torch.tensor(gen, dtype=torch.int64)
    if solo:
        counts = [t[0] for t in counts]
        unresolved, c_new = unresolved[0], c_new[0]
        generated = None if generated is None else generated[0]
    ops = eo.StepOperands(
        *counts, unresolved, c_new, generated, list(hits.view(P, N * C)), valid.view(-1),
        torch.full((N * m,), depth, dtype=torch.int64), (pos + 100, pos + 200, pos % 5 + 1),
        eo.FirstHits.zeros(P, N * C, "cpu"),
    )
    return to(ops, device)


def to(ops, device):
    """The operands (first-hit lanes included) on `device`."""
    return eo.StepOperands(
        *(None if t is None else t.to(device) for t in ops[:5]), [h.to(device) for h in ops.hits],
        ops.valid.to(device), ops.ddepth.to(device), tuple(r.to(device) for r in ops.rows),
        eo.FirstHits(*(t.to(device) for t in ops.first)),
    )


def lane(ops, l, C, solo=False):
    """Lane l of a lane step at chunk C as a one-lane step (solo: in the
    solo shapes), with first-hit lanes of its own."""
    N = ops.n_val.shape[0]
    A = ops.valid.shape[0] // (N * C)
    m = ops.c_new.shape[1]
    pick = (lambda t: t[l]) if solo else (lambda t: t[l:l + 1])
    cols = slice(l * C, (l + 1) * C)
    return eo.StepOperands(
        pick(ops.n_val), pick(ops.n_d), pick(ops.unresolved), pick(ops.c_new),
        None if ops.generated is None else pick(ops.generated),
        [h[cols] for h in ops.hits], ops.valid.view(A, N, C)[:, l].reshape(-1),
        ops.ddepth.view(N, m)[l], tuple(r[cols] for r in ops.rows),
        eo.FirstHits(*(t[:, cols].clone() for t in ops.first)),
    )


def random_operands(rng, N, C, A, P, m, n_val_max, n_d_max, unres=0.01, new=0.3, hit=0.02,
                    valid=0.3, seen=0.05, gen=True, solo=False, device="cpu"):
    """A random step of N lanes at chunk C (numpy `rng`): masks of the
    given densities, each lane's candidates at two adjacent depths (a BFS
    step's), drawn past the histogram's last bin too, rows' hashes of 32
    bits, and first-hit lanes already holding a share `seen` of hits.
    gen: per-lane generated counts (else None: counted from the valid
    mask). solo: one lane in the solo shapes."""
    def u32(*shape):
        return torch.from_numpy(rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.int64))

    def mask(shape, p):
        return torch.from_numpy(rng.random(shape) < p)

    counts = [torch.from_numpy(rng.integers(0, hi + 1, N)) for hi in (n_val_max, n_d_max)]
    unresolved, c_new = mask((N, m), unres), mask((N, m), new)
    generated = torch.from_numpy(rng.integers(0, C * A, N)) if gen else None
    if solo:
        counts = [t[0] for t in counts]
        unresolved, c_new = unresolved[0], c_new[0]
        generated = None if generated is None else generated[0]
    first = eo.FirstHits(mask((P, N * C), seen), u32(P, N * C), u32(P, N * C),
                         torch.from_numpy(rng.integers(1, 40, (P, N * C))))
    ops = eo.StepOperands(
        *counts, unresolved, c_new, generated, list(mask((P, N * C), hit)), mask(A * N * C, valid),
        torch.from_numpy((rng.integers(1, 200, N)[:, None] + rng.integers(0, 2, (N, m))).reshape(-1)),
        (u32(N * C), u32(N * C), torch.from_numpy(rng.integers(1, 40, N * C))), first,
    )
    return to(ops, device)
