"""The torch array namespace that model code receives as ``xp``.

A `TensorModel` writes its transition function once, against an array
namespace ``xp`` (numpy on the host, jax.numpy in the JAX package). This
module is that namespace for torch.

Lanes are int64 tensors holding uint32 values, not ``torch.uint32``
tensors: torch has no ``add``, ``<<``, ``>>``, ``minimum``, ``index_put``
or ``scatter_`` for ``uint32`` on the CPU. ``xp.uint32(c)`` is a plain
Python int in [0, 2^32), so ``~xp.uint32(3)`` is -4, and ``&``, ``|``,
``<<`` and ``>>`` against int64 lanes give the same low 32 bits as numpy's
uint32 arithmetic. Results may carry high bits (``~lane``); the engine
masks successor lanes to 32 bits before it hashes or stores them.

The namespace holds what the ported models call (2PC, Paxos, ABD and
the `lanes` toolkit); a model ported later adds what it needs (ROADMAP P2
lists the calls of the bundled models). numpy's ``arr.astype(xp.uint32)``
on a bool mask has no torch method; the port's model copies write it as
``xp.where(mask, u(1), u(0))``, which is the same uint32 array under
numpy and an int64 lane here, and keeps every op a plain tensor op (a
tensor subclass with ``astype`` would put a Python hook on every op of
the launch-bound expand).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


class TorchXP:
    """`xp` bound to one device (array constructors need to know where)."""

    def __init__(self, device):
        self.device = torch.device(device)

    @staticmethod
    def uint32(c):
        """A uint32 constant (Python int), or a tensor masked to 32 bits."""
        if isinstance(c, torch.Tensor):
            return c.to(torch.int64) & M32
        return int(c) & M32

    def _dtype(self, dtype):
        if dtype is None or dtype is TorchXP.uint32:
            return torch.int64
        if dtype is bool:
            return torch.bool
        raise TypeError(f"unsupported lane dtype {dtype!r}")

    def zeros(self, shape, dtype=None):
        return torch.zeros(shape, dtype=self._dtype(dtype), device=self.device)

    def ones(self, shape, dtype=None):
        return torch.ones(shape, dtype=self._dtype(dtype), device=self.device)

    # Scalar operands stay Python numbers: torch passes them to the
    # kernel by value, where `torch.as_tensor(x, device=cuda)` would be a
    # pageable host-to-device copy, which CUDA-graph capture refuses.
    # The results are the same int64 lanes either way.

    def minimum(self, a, b):
        return self._binary(torch.minimum, "max", a, b)

    def maximum(self, a, b):
        return self._binary(torch.maximum, "min", a, b)

    def _binary(self, op, clamp_kw, a, b):
        ta, tb = isinstance(a, torch.Tensor), isinstance(b, torch.Tensor)
        if ta and tb:
            return op(a, b)
        if ta or tb:
            t, c = (a, b) if ta else (b, a)
            return torch.clamp(t, **{clamp_kw: int(c)})
        pick = min if op is torch.minimum else max
        return torch.full((), pick(int(a), int(b)), dtype=torch.int64, device=self.device)

    def where(self, cond, a, b):
        """numpy's where; scalar operands become int64 lanes."""
        return torch.where(cond, a, b)

    @staticmethod
    def concatenate(arrays):
        return torch.cat(list(arrays))

    def full(self, shape, fill_value, dtype=None):
        if isinstance(shape, int):
            shape = (shape,)
        return torch.full(shape, int(fill_value), dtype=self._dtype(dtype), device=self.device)

    @staticmethod
    def full_like(x, fill_value):
        return torch.full_like(x, int(fill_value))

    @staticmethod
    def zeros_like(x):
        return torch.zeros_like(x)

    @staticmethod
    def ones_like(x):
        return torch.ones_like(x)
