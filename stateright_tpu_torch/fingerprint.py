"""Stable 64-bit state fingerprints (the port's copy of
`stateright_tpu/fingerprint.py`).

Two hash domains, both with fixed seeds, bit-identical to the JAX
package so that discovery paths and tables carry across:

1. `fingerprint(value)`: arbitrary host-side Python states, canonically
   serialized and hashed with BLAKE2b-64.
2. `hash_words_np` / `hash_lanes_np` / `hash_lanes`: fixed-width uint32
   state rows. h1 is an xxhash32-style mix over the words in order, h2 a
   structurally independent mix over the words reversed (see the note in
   the JAX module on why a seed-only difference is not enough); a pair of
   zeros becomes (0, 1), because 0 is the visited table's empty key.

`hash_lanes` is the device entry point: on a CUDA tensor it launches the
hand-written kernel (kernels/csrc/hash_lanes.cu), on a CPU tensor it runs
`hash_lanes_plain`, which repeats the kernel's arithmetic in int64 torch
ops without ever overflowing int64.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import struct
from typing import Any

import numpy as np
import torch

from . import kernels

SEED1 = np.uint32(0x9E3779B1)
SEED2 = np.uint32(0x85EBCA77)

_PRIME2 = 2246822519
_PRIME3 = 3266489917
_PRIME4 = 668265263
_PRIME5 = 374761393

_PERSON = b"srtpu-v1"

M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Canonical serialization for arbitrary host states.
# ---------------------------------------------------------------------------

def _encode(value: Any, out: bytearray) -> None:
    """Append a canonical, type-tagged encoding of `value` to `out`."""
    if value is None:
        out += b"N"
    elif value is True:
        out += b"T"
    elif value is False:
        out += b"F"
    elif isinstance(value, enum.Enum):
        out += b"E"
        _encode(type(value).__name__, out)
        _encode(value.name, out)
    elif isinstance(value, (int, np.integer)):
        v = int(value)
        if -(2**63) <= v < 2**63:
            out += b"i"
            out += struct.pack("<q", v)
        else:
            out += b"I"
            b = v.to_bytes((v.bit_length() + 15) // 8, "little", signed=True)
            out += struct.pack("<I", len(b))
            out += b
    elif isinstance(value, (float, np.floating)):
        out += b"f"
        out += struct.pack("<d", float(value))
    elif isinstance(value, str):
        b = value.encode("utf-8")
        out += b"s"
        out += struct.pack("<I", len(b))
        out += b
    elif isinstance(value, (bytes, bytearray)):
        out += b"b"
        out += struct.pack("<I", len(value))
        out += bytes(value)
    elif isinstance(value, (tuple, list)):
        out += b"l"
        out += struct.pack("<I", len(value))
        for item in value:
            _encode(item, out)
    elif isinstance(value, (set, frozenset)):
        out += b"S"
        out += struct.pack("<I", len(value))
        encs = []
        for item in value:
            buf = bytearray()
            _encode(item, buf)
            encs.append(bytes(buf))
        for e in sorted(encs):
            out += e
    elif isinstance(value, dict):
        out += b"D"
        out += struct.pack("<I", len(value))
        encs = []
        for k, v in value.items():
            buf = bytearray()
            _encode(k, buf)
            _encode(v, buf)
            encs.append(bytes(buf))
        for e in sorted(encs):
            out += e
    elif isinstance(value, np.ndarray):
        out += b"A"
        _encode(value.shape, out)
        _encode(value.dtype.str, out)
        out += np.ascontiguousarray(value).tobytes()
    elif dataclasses.is_dataclass(value):
        out += b"O"
        _encode(type(value).__name__, out)
        for field in dataclasses.fields(value):
            if field.metadata.get("skip_fingerprint"):
                continue
            _encode(getattr(value, field.name), out)
    elif hasattr(value, "fingerprint_key"):
        out += b"K"
        _encode(type(value).__name__, out)
        _encode(value.fingerprint_key(), out)
    else:
        raise TypeError(
            f"Cannot canonically fingerprint value of type {type(value).__name__}. "
            "Use dataclasses, builtin containers, or define fingerprint_key()."
        )


def canonical_bytes(value: Any) -> bytes:
    out = bytearray()
    _encode(value, out)
    return bytes(out)


def fingerprint(value: Any) -> int:
    """Stable nonzero 64-bit fingerprint of an arbitrary host-side state."""
    digest = hashlib.blake2b(
        canonical_bytes(value), digest_size=8, person=_PERSON
    ).digest()
    fp = int.from_bytes(digest, "little")
    return fp if fp != 0 else 1


# ---------------------------------------------------------------------------
# Word-stream hashing of uint32 rows (numpy host versions).
# ---------------------------------------------------------------------------

# (rotation, multiplier, post-multiplier, final mul 1, final mul 2)
_H1 = (17, _PRIME3, _PRIME4, _PRIME2, _PRIME3)
_H2 = (13, _PRIME2, _PRIME5, _PRIME4, _PRIME5)


def _absorb_np(words, base_shape, S, seed, params):
    rot, mul, post, fin1, fin2 = params
    u = np.uint32
    acc = np.zeros(base_shape, dtype=np.uint32)
    acc = acc + u(seed) + u(_PRIME5) + u(S * 4)
    for w in words:
        acc = acc + w * u(mul)
        acc = (acc << u(rot)) | (acc >> u(32 - rot))
        acc = acc * u(post)
    acc = acc ^ (acc >> u(15))
    acc = acc * u(fin1)
    acc = acc ^ (acc >> u(13))
    acc = acc * u(fin2)
    acc = acc ^ (acc >> u(16))
    return acc


def hash_lanes_np(lanes) -> tuple[np.ndarray, np.ndarray]:
    """Hash a sequence of S uint32 lane arrays -> (h1, h2) uint32 arrays."""
    lanes = [np.asarray(l, dtype=np.uint32) for l in lanes]
    S = len(lanes)
    with np.errstate(over="ignore"):
        h1 = _absorb_np(lanes, lanes[0].shape, S, SEED1, _H1)
        h2 = _absorb_np(list(reversed(lanes)), lanes[0].shape, S, SEED2, _H2)
    h2 = np.where((h1 == 0) & (h2 == 0), np.uint32(1), h2)
    return h1, h2


def hash_words_np(words: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Row form of `hash_lanes_np`: words [..., S] uint32 -> (h1, h2)."""
    words = np.asarray(words, dtype=np.uint32)
    return hash_lanes_np([words[..., i] for i in range(words.shape[-1])])


def combine64(h1, h2) -> int:
    """Combine a (h1, h2) uint32 pair into the canonical 64-bit fingerprint."""
    return (int(h1) << 32) | int(h2)


def split64(fp: int) -> tuple[int, int]:
    return (fp >> 32) & M32, fp & M32


# ---------------------------------------------------------------------------
# The device hash (K1): kernel on CUDA, plain torch on the CPU.
# ---------------------------------------------------------------------------

def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 tensors holding uint32 values and a
    constant c < 2^32, split so that no product reaches 2^63."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * c + (((hi * (c & 0xFFFF)) & 0xFFFF) << 16)) & M32


def _absorb_plain(words, S, seed, params):
    rot, mul, post, fin1, fin2 = params
    acc = torch.full_like(words[0], (int(seed) + _PRIME5 + S * 4) & M32)
    for w in words:
        acc = (acc + mul32(w, mul)) & M32
        acc = ((acc << rot) & M32) | (acc >> (32 - rot))
        acc = mul32(acc, post)
    acc = acc ^ (acc >> 15)
    acc = mul32(acc, fin1)
    acc = acc ^ (acc >> 13)
    acc = mul32(acc, fin2)
    acc = acc ^ (acc >> 16)
    return acc


def hash_lanes_plain(lanes: torch.Tensor):
    """Plain torch version of the K1 kernel: lanes [S, n] int64 holding
    uint32 values -> (h1, h2), each [n] int64 holding uint32 values."""
    S = lanes.shape[0]
    words = [lanes[s] & M32 for s in range(S)]
    h1 = _absorb_plain(words, S, SEED1, _H1)
    h2 = _absorb_plain(words[::-1], S, SEED2, _H2)
    h2 = torch.where((h1 == 0) & (h2 == 0), torch.ones_like(h2), h2)
    return h1, h2


def hash_lanes(lanes: torch.Tensor):
    """Fingerprint halves of n states given as lanes [S, n] int64 holding
    uint32 values: the hand-written kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if lanes.dim() != 2 or lanes.dtype != torch.int64:
        raise ValueError("hash_lanes takes an int64 [S, n] lane tensor")
    if not kernels.on_card(lanes):
        return hash_lanes_plain(lanes)
    lanes = lanes.contiguous()
    S, n = lanes.shape
    h1 = torch.empty(n, dtype=torch.int64, device=lanes.device)
    h2 = torch.empty(n, dtype=torch.int64, device=lanes.device)
    kernels.HASH_LANES.launch(kernels.ptr(lanes), n, S, kernels.ptr(h1), kernels.ptr(h2))
    return h1, h2
