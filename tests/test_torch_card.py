"""The port's kernels on the card, each against its plain version, and a
small engine run on cuda against cpu. Marked `cuda`: they skip where no
CUDA device is present. On a machine with a card (no JAX needed):

    python -m pytest --noconftest -q tests/test_torch_card.py
"""

import numpy as np
import pytest
import torch

from stateright_tpu_torch import TensorModelAdapter
from stateright_tpu_torch.fingerprint import hash_lanes, hash_lanes_plain
from stateright_tpu_torch.models import TwoPhaseTensor
from stateright_tpu_torch.ops import frontier as fr
from stateright_tpu_torch.ops import visited_set as vs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _u32(rng, *shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.int64)


def test_hash_lanes_kernel(dev):
    lanes = torch.from_numpy(_u32(np.random.default_rng(0), 9, 5000)).to(dev)
    for a, b in zip(hash_lanes(lanes), hash_lanes_plain(lanes)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,density,cap", [(100_000, 0.3, 40_000), (100_000, 0.6, 40_000), (7, 1.0, 3)])
def test_compact_ids_kernel(dev, n, density, cap):
    mask = torch.from_numpy(np.random.default_rng(n).random(n) < density).to(dev)
    for a, b in zip(vs.compact_ids(mask, cap), vs.compact_ids_plain(mask, cap)):
        assert torch.equal(a, b)


def test_claim_dedup_kernel(dev):
    rng = np.random.default_rng(1)
    pool = _u32(rng, 2, 500)
    pick = rng.integers(0, 500, size=20_000)
    h1, h2 = (torch.from_numpy(pool[i, pick]).to(dev) for i in range(2))
    valid = torch.from_numpy(rng.random(20_000) < 0.8).to(dev)
    assert torch.equal(fr.claim_dedup(h1, h2, valid, 1 << 12), fr.claim_dedup_plain(h1, h2, valid, 1 << 12))


def test_insert_kernel_and_winner_rule(dev):
    rng = np.random.default_rng(2)
    n = 20_000
    h = _u32(rng, 2, n)
    h[:, n - 64:] = h[:, :1]  # 65 copies of one key, distinct parents
    p = _u32(rng, 2, n)
    args = [torch.from_numpy(a).to(dev) for a in (h[0], h[1], p[0], p[1])]
    act = torch.ones(n, dtype=torch.bool, device=dev)
    ta, tb = vs.empty_table(1 << 17, dev), vs.empty_table(1 << 17, dev)
    for _ in range(2):  # the second call finds every key
        a = vs.insert(ta, *args, act)
        b = vs.insert_plain(tb, *args, act)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        # Same key -> parent map; the slot layout may differ.
        assert set(zip(*vs.table_to_lanes(ta))) == set(zip(*vs.table_to_lanes(tb)))
    assert not bool(a[0].any())


def test_engine_cuda_matches_cpu(dev):
    opts = dict(chunk_size=64, queue_capacity=1 << 12, table_capacity=1 << 11, sync_steps=4)

    def run(device):
        c = TensorModelAdapter(TwoPhaseTensor(4)).checker().spawn_gpu_bfs(device=device, **opts).join()
        return c.unique_state_count(), c.state_count(), c.max_depth(), dict(c._discovery_fps), c.coverage()

    assert run("cuda") == run("cpu")
