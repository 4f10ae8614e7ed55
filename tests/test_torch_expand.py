"""K11 evaluate-and-expand of the port against the JAX package's
`build_expand_lean` on 2pc-3 and 2pc-5 rows: flat, valid, ebits,
generated and prop_hits, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.models import TwoPhaseTensor as JaxTwoPhase
from stateright_tpu.ops.expand import build_expand_lean as jax_expand
from stateright_tpu_torch.models import TwoPhaseTensor
from stateright_tpu_torch.ops.expand import build_expand_lean
from stateright_tpu_torch.xp import TorchXP

from test_torch_model_2pc import reachable_rows


@pytest.mark.parametrize("n,chunk,depth_limit", [(3, 128, 0xFFFFFFFF), (5, 512, 0xFFFFFFFF), (5, 512, 9)])
def test_expand_matches_jax(n, chunk, depth_limit):
    rows = reachable_rows(JaxTwoPhase(n))
    rng = np.random.default_rng(n + chunk + depth_limit)
    rows = rows[rng.integers(0, len(rows), size=chunk)].T.copy()  # [S, C]
    ebits = rng.integers(0, 4, size=chunk).astype(np.uint32)
    depth = rng.integers(1, 14, size=chunk).astype(np.uint32)
    active = np.arange(chunk) < chunk - 17

    tm, jm = TwoPhaseTensor(n), JaxTwoPhase(n)
    ours = build_expand_lean(tm, tm.tensor_properties(), chunk, TorchXP("cpu"))(
        torch.from_numpy(rows.astype(np.int64)), torch.from_numpy(ebits.astype(np.int64)),
        torch.from_numpy(depth.astype(np.int64)), torch.from_numpy(active), depth_limit,
    )
    ref = jax_expand(jm, jm.tensor_properties(), chunk)(
        tuple(jnp.asarray(r) for r in rows), jnp.asarray(ebits), jnp.asarray(depth),
        jnp.asarray(active), jnp.uint32(depth_limit),
    )
    assert np.array_equal(ours.flat.numpy(), np.stack([np.asarray(f) for f in ref.flat]).astype(np.int64))
    assert np.array_equal(ours.valid.numpy(), np.asarray(ref.valid))
    assert np.array_equal(ours.ebits.numpy(), np.asarray(ref.ebits).astype(np.int64))
    assert int(ours.generated) == int(ref.generated)
    assert len(ours.prop_hits) == len(ref.prop_hits) == 3
    for a, b in zip(ours.prop_hits, ref.prop_hits):
        assert np.array_equal(a.numpy(), np.asarray(b))
