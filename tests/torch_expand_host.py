"""The host harness of K11's model headers and the JAX references the CPU
tests hold it against (tests/test_torch_expand_kernel.py,
test_torch_expand_kernel_abd.py, test_torch_canon_kernel.py).

`kernels/csrc/models/harness.cpp` is built with g++ into a temporary
directory and bound with ctypes: the same `SRT_HD` functions the CUDA
kernels run (EXPAND, WALK and the 2PC canon), looped over the rows on
the CPU. Here are the calls into it at the kernels' layouts, and the JAX
package's `build_expand_lean`, walk step and `representative_lanes` on
the same inputs.
"""

import ctypes
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest

from stateright_tpu.models import AbdTensor as JaxAbd
from stateright_tpu.models import IncrementLockTensor as JaxIncrementLock
from stateright_tpu.models import IncrementTensor as JaxIncrement
from stateright_tpu.models import PaxosTensor as JaxPaxos
from stateright_tpu.models import SingleCopyTensor as JaxSingleCopy
from stateright_tpu.models import TwoPhaseTensor as JaxTwoPhase
from stateright_tpu.ops.expand import build_expand_lean as jax_expand

HARNESS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "stateright_tpu_torch", "kernels", "csrc", "models", "harness.cpp")
M32 = 0xFFFFFFFF
_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
# Each model's entry suffix and its leading int arguments' count.
_LEADING = {"2pc": 1, "paxos": 1, "abd": 2, "increment": 1, "increment_lock": 1, "single_copy": 2}


def build_harness(tmp_dir):
    """The harness built with g++ into `tmp_dir`, every entry's argument
    types set (skips where there is no g++)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host harness of the model headers")
    out = os.path.join(str(tmp_dir), "libexpand_host.so")
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-o", out, HARNESS], check=True)
    lib = ctypes.CDLL(out)
    for kind, n in _LEADING.items():
        getattr(lib, f"srt_host_expand_{kind}").argtypes = [_I32] * n + [_P] * 5 + [_I64] * 3 + [_P] * 5
        getattr(lib, f"srt_host_walk_{kind}").argtypes = [_I32] * n + [_P, _I64, _P, _P, _P]
    lib.srt_host_canon_2pc.argtypes = [_I32, _P, _P, _I64]
    return lib


def _ptr(a):
    assert a.flags.c_contiguous
    return a.ctypes.data


def which(jm):
    """(entry suffix, leading size arguments) of a JAX model."""
    if isinstance(jm, JaxTwoPhase):
        return "2pc", (jm.n,)
    if isinstance(jm, JaxPaxos):
        return "paxos", (jm.c,)
    if isinstance(jm, JaxAbd):
        return "abd", (jm.c, int(jm.ordered))
    if isinstance(jm, JaxIncrement):
        return "increment", (jm.n,)
    if isinstance(jm, JaxIncrementLock):
        return "increment_lock", (jm.n,)
    if isinstance(jm, JaxSingleCopy):
        return "single_copy", (jm.s, jm.c)
    raise TypeError(type(jm).__name__)


def host_expand(lib, jm, rows, ebits, depth, active, depth_limit):
    """The harness's EXPAND over rows [S, W] (uint32); depth_limit an int
    or one limit a row."""
    kind, size = which(jm)
    S, A, P = jm.state_width, jm.max_actions, len(jm.tensor_properties())
    W = rows.shape[1]
    rows64 = np.ascontiguousarray(rows.astype(np.int64))
    eb, dp = ebits.astype(np.int64), depth.astype(np.int64)
    act = np.ascontiguousarray(active.astype(np.bool_))
    dl, dl_value, dl_stride = None, 0, 0
    if isinstance(depth_limit, np.ndarray):
        dl_arr = np.ascontiguousarray(depth_limit.astype(np.int64))
        dl, dl_stride = _ptr(dl_arr), 1
    else:
        dl_value = int(depth_limit)
    out = dict(ebits=np.zeros(W, np.int64), flat=np.zeros((S, A * W), np.int64),
               valid=np.zeros(A * W, np.bool_), hits=np.zeros((P, W), np.bool_),
               generated=np.zeros(1, np.int64))
    rc = getattr(lib, f"srt_host_expand_{kind}")(
        *size, _ptr(rows64), _ptr(eb), _ptr(dp), _ptr(act), dl, dl_value, dl_stride, W,
        _ptr(out["ebits"]), _ptr(out["flat"]), _ptr(out["valid"]), _ptr(out["hits"]),
        _ptr(out["generated"]))
    assert rc == 0
    return out


def jax_reference(jm, rows, ebits, depth, active, depth_limit):
    """JAX's build_expand_lean on the same inputs (uint32 arrays)."""
    W = rows.shape[1]
    ref = jax_expand(jm, jm.tensor_properties(), W)(
        tuple(jnp.asarray(r, dtype=jnp.uint32) for r in rows), jnp.asarray(ebits, dtype=jnp.uint32),
        jnp.asarray(depth, dtype=jnp.uint32), jnp.asarray(active),
        jnp.asarray(depth_limit, dtype=jnp.uint32),
    )
    return dict(
        ebits=np.asarray(ref.ebits).astype(np.int64),
        flat=np.stack([np.asarray(f) for f in ref.flat]).astype(np.int64),
        valid=np.asarray(ref.valid),
        hits=np.stack([np.asarray(h) for h in ref.prop_hits]),
        generated=np.asarray([int(ref.generated)], np.int64),
    )


def host_walk(lib, jm, rows):
    kind, size = which(jm)
    S, A, P = jm.state_width, jm.max_actions, len(jm.tensor_properties())
    B = rows.shape[1]
    rows64 = np.ascontiguousarray(rows.astype(np.int64))
    checks, valid = np.zeros((P, B), np.bool_), np.zeros((A, B), np.bool_)
    succ = np.zeros((A, S, B), np.int64)
    assert getattr(lib, f"srt_host_walk_{kind}")(*size, _ptr(rows64), B, _ptr(checks), _ptr(valid),
                                                  _ptr(succ)) == 0
    return checks, valid, succ


def jax_walk(jm, rows):
    """The model step of the JAX walk (tpu_simulation.py:268-300): the
    raw predicates, the enabled-and-in-boundary mask, the successors."""
    S, A = jm.state_width, jm.max_actions
    lanes = tuple(jnp.asarray(r, dtype=jnp.uint32) for r in rows)
    checks = np.stack([np.asarray(p.check(jnp, lanes)) for p in jm.tensor_properties()])
    succs, amask = jm.step_lanes(jnp, lanes)
    valid = np.stack([np.asarray(amask[a] & jm.within_boundary_lanes(jnp, succs[a])) for a in range(A)])
    succ = np.stack([np.stack([np.broadcast_to(np.asarray(succs[a][s]), (rows.shape[1],))
                               for s in range(S)]) for a in range(A)]).astype(np.int64)
    return checks, valid, succ


def host_canon(lib, n, rows):
    """The harness's 2PC canon over rows [3, W] (uint32) -> int64 [3, W]."""
    rows64 = np.ascontiguousarray(rows.astype(np.int64))
    out = np.zeros_like(rows64)
    assert lib.srt_host_canon_2pc(n, _ptr(rows64), _ptr(out), rows.shape[1]) == 0
    return out


def jax_canon(n, rows):
    """The JAX package's `representative_lanes` under jax.numpy."""
    reps = JaxTwoPhase(n).representative_lanes(jnp, tuple(jnp.asarray(r, dtype=jnp.uint32) for r in rows))
    return np.stack([np.asarray(r) for r in reps]).astype(np.int64)


def bfs_levels(jm, levels, cap):
    """Distinct rows within `levels` BFS steps of the init states ([N, S]
    uint32, at most `cap`), through the JAX model's step_lanes on numpy."""
    S, A = jm.state_width, jm.max_actions
    seen = {tuple(r) for r in jm.init_states_array().tolist()}
    frontier = np.asarray(sorted(seen), dtype=np.uint32)
    for _ in range(levels):
        succs, valid = jm.step_lanes(np, tuple(frontier[:, s] for s in range(S)))
        nxt = np.concatenate([
            np.stack([np.broadcast_to(succs[a][s], (len(frontier),)) for s in range(S)], axis=1)[
                np.asarray(valid[a], dtype=bool)]
            for a in range(A)
        ])
        new = {tuple(r) for r in nxt.tolist()} - seen
        if not new or len(seen) >= cap:
            break
        seen |= new
        frontier = np.asarray(sorted(new), dtype=np.uint32).reshape(-1, S)
    return np.asarray(sorted(seen), dtype=np.uint32)[:cap]


def inputs(rng, W):
    """Seeded ebits, depths and an `active` mask for W rows."""
    ebits = rng.integers(0, 4, size=W).astype(np.uint32)
    depth = rng.integers(1, 14, size=W).astype(np.uint32)
    active = rng.random(W) < 0.9
    return ebits, depth, active


def assert_same(ours, ref):
    for key in ("ebits", "flat", "valid", "hits", "generated"):
        assert np.array_equal(ours[key], ref[key]), key
