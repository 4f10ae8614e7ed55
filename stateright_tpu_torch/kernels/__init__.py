"""Hand-written Hopper kernels: build, load, launch and count.

Each kernel source in ``csrc/`` is compiled on first use with
``nvcc -arch=sm_90a`` into its own shared library with a plain C
interface, and bound with ``ctypes`` (no PyTorch headers, so a build
takes seconds, not minutes). The libraries land in ``_build/`` beside
this file, named by a digest of their source, so an unchanged source is
never rebuilt and an edited one never loads a stale binary.

Every C entry point takes device pointers, sizes and the CUDA stream as
plain integers, launches on that stream without synchronising, and
returns ``cudaGetLastError()`` (0 = launched). `Kernel.launch` raises on
anything else and then adds one to the kernel's ``launches`` count — the
count a run reads to show its main path went through the kernel.

A launch made while a CUDA graph captures is not a launch: the device
programs' graphs (engines/graph.py) take the counts their captures added
back off (`restore_launches`) and add each captured segment's launches
once per run of the segment on the card (`add_launches`), from the run
counts the program's state vector reports.

Nothing here builds or loads at import: the CPU tests import every
module on machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
ARCH = "sm_90a"

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_U64 = ctypes.c_ulonglong


class Kernel:
    """One kernel library: its source, C symbol, argument types and the
    count of launches made through `launch`."""

    def __init__(self, name: str, source: str, symbol: str, argtypes, replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [_P]  # + stream
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    @property
    def source_path(self) -> str:
        return os.path.join(_CSRC, self.source)

    def function(self, symbol: str, argtypes, restype=ctypes.c_int):
        """Another C function of this kernel's library (built and loaded
        on first use), with its argument types."""
        if self._fn is None:
            self._fn = _load(self)
        fn = getattr(_libs[_lib_path(self)], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        return fn

    def launch(self, *args) -> None:
        fn = self._fn
        if fn is None:
            fn = self._fn = _load(self)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"kernel {self.name} failed to launch: cudaError {err}"
            )
        self.launches += 1


HASH_LANES = Kernel(
    "hash_lanes", "hash_lanes.cu", "srt_hash_lanes",
    [_P, _I64, _I32, _P, _P],
    "stateright_tpu/fingerprint.py:262",
)

# K2, K3, K4, K6 and K7 take a lane axis (the multiplexed engine's
# lanes, engines/multiplex.py); the solo engine calls them with one lane.
# Each source has two counted entries: the solo calls count on the first,
# the lane calls on its `_lanes` twin (same source, same C symbol).
_COMPACT_ARGS = [_P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _P, _P, _P, _P]
_DEDUP_ARGS = [_P, _P, _P, _P, _I64, _I64, _P, _I64, _P]
_INSERT_ARGS = [_P, _P, _P, _I64, _U64, _P, _P, _P, _P, _P, _P, _I64, _I64, _P, _P, _P, _P]
_RING_ARGS = [_P, _I64, _I64, _I64, _I64, _I64, _I64, _P, _P, _I64, _I64]
_APPEND_ARGS = [_I32, _P, _I64, _I64, _I64, _I64, _I64, _I64, _P, _P, _I64, _P, _I64, _I64, _P]
_BOTTOMK_ARGS = [_P, _P, _P, _P, _I64, _I64, _P, _I64, _I64, _P, _P, _P, _P, _P, _I64]
_LOOKUP_ARGS = [_P, _P, _I64, _P, _P, _P, _I64, _P, _P, _P]


def _with_lanes(name, source, symbol, argtypes, replaces):
    return (
        Kernel(name, source, symbol, argtypes, replaces),
        Kernel(f"{name}_lanes", source, symbol, argtypes,
               f"{replaces} under jax.vmap (stateright_tpu/engines/multiplex.py:86)"),
    )


COMPACT_IDS, COMPACT_IDS_LANES = _with_lanes(
    "compact_ids", "compact_ids.cu", "srt_compact_ids", _COMPACT_ARGS,
    "stateright_tpu/ops/visited_set.py:250",
)
CLAIM_DEDUP, CLAIM_DEDUP_LANES = _with_lanes(
    "claim_dedup", "claim_dedup.cu", "srt_claim_dedup", _DEDUP_ARGS,
    "stateright_tpu/ops/frontier.py:20",
)
VISITED_INSERT, VISITED_INSERT_LANES = _with_lanes(
    "visited_insert", "visited_insert.cu", "srt_visited_insert", _INSERT_ARGS,
    "stateright_tpu/ops/visited_set.py:335",
)
RING, RING_LANES = _with_lanes(
    "ring", "ring.cu", "srt_ring", _RING_ARGS,
    "stateright_tpu/ops/frontier.py:55",
)
# K7's append, the same source's second entry point: COUNT and WRITE,
# one launch each (two a call).
RING_APPEND, RING_APPEND_LANES = _with_lanes(
    "ring_append", "ring.cu", "srt_ring_append", _APPEND_ARGS,
    "stateright_tpu/ops/frontier.py:62",
)
LOOKUP_PARENT, LOOKUP_PARENT_LANES = _with_lanes(
    "lookup_parent", "lookup_parent.cu", "srt_lookup_parent", _LOOKUP_ARGS,
    "stateright_tpu/ops/visited_set.py:411",
)
# K9a, solo and (the twin, same source and symbol) over every shard's
# slab in one launch.
_CAPTURE_ARGS = [_I64, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P, _I64, _P, _P, _P, _P, _I64, _I64,
                 _P, _I64, _P, _I64]
SAMPLE_CAPTURE = Kernel(
    "sample_capture", "sample_capture.cu", "srt_sample_capture", _CAPTURE_ARGS,
    "stateright_tpu/engines/tpu_bfs.py:519",
)
SAMPLE_CAPTURE_LANES = Kernel(
    "sample_capture_lanes", "sample_capture.cu", "srt_sample_capture", _CAPTURE_ARGS,
    "stateright_tpu/parallel/mesh.py:412",
)
SLAB_BOTTOMK = Kernel(
    "slab_bottomk", "slab_bottomk.cu", "srt_slab_bottomk", _BOTTOMK_ARGS,
    "stateright_tpu/engines/tpu_bfs.py:995",
)
# K9b over every shard's slab in one launch (the sharded tail).
SLAB_BOTTOMK_LANES = Kernel(
    "slab_bottomk_lanes", "slab_bottomk.cu", "srt_slab_bottomk", _BOTTOMK_ARGS,
    "stateright_tpu/parallel/mesh.py:797",
)

# K8f: the era's gate and step commit, and its epilogue (engines/era.py);
# with a lane axis, K14f's (engines/multiplex.py), counted on the twins.
ERA_STEP, ERA_STEP_LANES = _with_lanes(
    "era_step", "era_step.cu", "srt_era_step",
    [_I32, _P, _P, _I64, _I64, _P, _P, _P, _P, _I64, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
     _P, _P, _P, _P, _P, _P, _P, _U64],
    "stateright_tpu/engines/tpu_bfs.py:403",
)
ERA_EPILOGUE, ERA_EPILOGUE_LANES = _with_lanes(
    "era_epilogue", "era_epilogue.cu", "srt_era_epilogue",
    [_P, _P, _I64, _I64, _P, _P, _P, _P, _P, _I64, _P, _P, _U64],
    "stateright_tpu/engines/tpu_bfs.py:781",
)

WALK_RECORD = Kernel(
    "walk_record", "walk_record.cu", "srt_walk_record",
    [_P, _P, _P, _I32, _I64, _P, _I32, _P, _P, _P, _P, _I32],
    "stateright_tpu/engines/tpu_simulation.py:199",
)
WALK_STEP = Kernel(
    "walk_step", "walk_step.cu", "srt_walk_step",
    [_P, _I32, _I64, _I32, _P, _I32, _I64, _I64, _P, _I32, _P, _P, _I64, _I64,
     _P, _P, _P, _P, _P, _P],
    "stateright_tpu/engines/tpu_simulation.py:268",
)
# K13b's second entry point, the era prologue: same source and row, its
# own launch count.
WALK_PROLOGUE = Kernel(
    "walk_prologue", "walk_step.cu", "srt_walk_prologue",
    [_P, _I32, _I64, _P, _I64, _I64],
    "stateright_tpu/engines/tpu_simulation.py:394",
)
WALK_CAPTURE = Kernel(
    "walk_capture", "walk_capture.cu", "srt_walk_capture",
    [_P, _P, _P, _P, _I32, _I64, _P, _P, _I64, _P, _P, _I64],
    "stateright_tpu/engines/tpu_simulation.py:219",
)
# K13f: the simulation era's gate, commit and epilogue (engines/gpu_simulation.py).
WALK_ERA = Kernel(
    "walk_era", "walk_era.cu", "srt_walk_era",
    [_I32, _P, _P, _P, _P, _P, _U64],
    "stateright_tpu/engines/tpu_simulation.py:168",
)
WALK_SLAB = Kernel(
    "walk_slab", "walk_slab.cu", "srt_walk_slab",
    [_P, _I32, _I64, _P, _I32, _P, _I64, _P, _P, _I64, _P, _P],
    "stateright_tpu/engines/tpu_simulation.py:502",
)

# K12: the stage profiler (engines/stages.py). K12a's loop kernel (START,
# FOLD, ADD) and, a second entry point of the same source, its synthetic
# lanes; K12b, the simulation's walk stages (CYCLE, RECORD, CHOOSE).
STAGE_LOOP = Kernel(
    "stage_loop", "stage_loop.cu", "srt_stage_loop",
    [_I32, _P, _I64, _U64, _P, _I32, _P, _U64],
    "stateright_tpu/obs/stageprof.py:60",
)
STAGE_LANES = Kernel(
    "stage_lanes", "stage_loop.cu", "srt_stage_lanes",
    [_I32, _P, _P, _P, _P, _P],
    "stateright_tpu/engines/tpu_bfs.py:1180",
)
STAGE_WALK = Kernel(
    "stage_walk", "stage_walk.cu", "srt_stage_walk",
    [_I32, _P, _I64, _I32, _I32, _I32, _P, _P, _P, _P, _P, _P, _P],
    "stateright_tpu/engines/tpu_simulation.py:622",
)

# K15a and K15f: the sharded era's owner exchange (COUNT and WRITE, two
# launches a call) and its shard-coupled gate, commit, epilogue and tail
# (parallel/mesh.py).
EXCHANGE = Kernel(
    "exchange", "exchange.cu", "srt_exchange",
    [_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _P, _P, _P],
    "stateright_tpu/parallel/mesh.py:337",
)
MESH_ERA = Kernel(
    "mesh_era", "mesh_era.cu", "srt_mesh_era",
    [_I32, _I32, _I32, _P, _P, _I64, _I64, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _P, _P, _P, _U64],
    "stateright_tpu/parallel/mesh.py:257",
)
# K15f's COMMIT, the same source's second entry: the step's fold and
# commit as one grid over (tile, shard).
MESH_COMMIT = Kernel(
    "mesh_commit", "mesh_era.cu", "srt_mesh_commit",
    [_I32, _P, _P, _I64, _I64, _P, _P, _P, _I64, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
     _P, _U64],
    "stateright_tpu/parallel/mesh.py:437",
)

# K16a: the speclint probes' agreement table (analysis/device.py STR205,
# analysis/symmetry.py STR404; ops/agree.py).
LANE_AGREE = Kernel(
    "lane_agree", "lane_agree.cu", "srt_lane_agree",
    [_P, _P, _P, _P, _I64, _I64, _I64, _P],
    "stateright_tpu/analysis/device.py:336",
)

# K11: the expand (EXPAND, one launch a BFS step) and the simulation's
# model step (WALK, one launch a walk step), one source a model with a
# kernel (ops/expand.py picks the route); the model headers are in
# csrc/models/.
_EXPAND_ARGS = [_I32, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P, _P, _P, _P, _P, _P, _P]
_WALK_ARGS = [_I32, _P, _I64, _P, _P, _P]
EXPAND_2PC = Kernel(
    "expand_2pc", "expand_2pc.cu", "srt_expand_2pc", _EXPAND_ARGS,
    "stateright_tpu/ops/expand.py:54",
)
WALK_2PC = Kernel(
    "walk_2pc", "expand_2pc.cu", "srt_walk_2pc", _WALK_ARGS,
    "stateright_tpu/engines/tpu_simulation.py:281",
)
EXPAND_PAXOS = Kernel(
    "expand_paxos", "expand_paxos.cu", "srt_expand_paxos", _EXPAND_ARGS,
    "stateright_tpu/ops/expand.py:54",
)
WALK_PAXOS = Kernel(
    "walk_paxos", "expand_paxos.cu", "srt_walk_paxos", _WALK_ARGS,
    "stateright_tpu/engines/tpu_simulation.py:281",
)
# ABD's two entries take the network too: (c, ordered, ...).
EXPAND_ABD = Kernel(
    "expand_abd", "expand_abd.cu", "srt_expand_abd", [_I32] + _EXPAND_ARGS,
    "stateright_tpu/ops/expand.py:54",
)
WALK_ABD = Kernel(
    "walk_abd", "expand_abd.cu", "srt_walk_abd", [_I32] + _WALK_ARGS,
    "stateright_tpu/engines/tpu_simulation.py:281",
)
EXPAND_INCREMENT = Kernel(
    "expand_increment", "expand_increment.cu", "srt_expand_increment", _EXPAND_ARGS,
    "stateright_tpu/ops/expand.py:54",
)
WALK_INCREMENT = Kernel(
    "walk_increment", "expand_increment.cu", "srt_walk_increment", _WALK_ARGS,
    "stateright_tpu/engines/tpu_simulation.py:281",
)
EXPAND_INCREMENT_LOCK = Kernel(
    "expand_increment_lock", "expand_increment_lock.cu", "srt_expand_increment_lock",
    _EXPAND_ARGS, "stateright_tpu/ops/expand.py:54",
)
WALK_INCREMENT_LOCK = Kernel(
    "walk_increment_lock", "expand_increment_lock.cu", "srt_walk_increment_lock", _WALK_ARGS,
    "stateright_tpu/engines/tpu_simulation.py:281",
)
# The single-copy register's two entries take the servers too: (s, c, ...).
EXPAND_SINGLE_COPY = Kernel(
    "expand_single_copy", "expand_single_copy.cu", "srt_expand_single_copy",
    [_I32] + _EXPAND_ARGS, "stateright_tpu/ops/expand.py:54",
)
WALK_SINGLE_COPY = Kernel(
    "walk_single_copy", "expand_single_copy.cu", "srt_walk_single_copy", [_I32] + _WALK_ARGS,
    "stateright_tpu/engines/tpu_simulation.py:281",
)
# K11c: the 2PC symmetry canon of the BFS step's compacted candidates
# (ops/canon.py picks the route), one launch a step under .symmetry().
CANON_2PC = Kernel(
    "canon_2pc", "canon_2pc.cu", "srt_canon_2pc", [_I32, _P, _P, _I64],
    "stateright_tpu/models/two_phase_commit.py:270",
)

# K7s: the host spill's ring drain and refill (ops/frontier.py), one
# source with two entry points, each counted.
_SPILL_ARGS = [_P, _I64, _I64, _I64, _I64, _P, _I64, _I64, _I64, _P]
RING_DRAIN = Kernel(
    "ring_drain", "ring_spill.cu", "srt_ring_drain", _SPILL_ARGS,
    "stateright_tpu/engines/tpu_bfs.py:1924",
)
RING_REFILL = Kernel(
    "ring_refill", "ring_spill.cu", "srt_ring_refill", _SPILL_ARGS,
    "stateright_tpu/engines/tpu_bfs.py:2071",
)

# The kernels of each engine's path: the BFS step and its epilogue, the
# simulation step, its era kernel and its epilogue, and the multiplexed
# lane step, its seed, its era kernels and its path walks (K1 runs on
# all three). KERNELS has one entry a
# source; ENTRIES adds the second entry points.
BFS_KERNELS = (
    HASH_LANES, COMPACT_IDS, CLAIM_DEDUP, VISITED_INSERT,
    RING, RING_APPEND, SAMPLE_CAPTURE, SLAB_BOTTOMK, LOOKUP_PARENT, ERA_STEP, ERA_EPILOGUE,
)
SIM_KERNELS = (HASH_LANES, WALK_RECORD, WALK_STEP, WALK_PROLOGUE, WALK_CAPTURE, WALK_SLAB, WALK_ERA)
LANE_KERNELS = (
    HASH_LANES, COMPACT_IDS_LANES, CLAIM_DEDUP_LANES, VISITED_INSERT_LANES,
    RING_LANES, RING_APPEND_LANES, LOOKUP_PARENT_LANES, ERA_STEP_LANES, ERA_EPILOGUE_LANES,
)
# The sharded engine's path: the lane forms of the BFS kernels with the
# shard axis, K9a and K9b over every shard, K15a and K15f.
MESH_KERNELS = (
    HASH_LANES, COMPACT_IDS_LANES, CLAIM_DEDUP_LANES, VISITED_INSERT_LANES, RING_LANES, RING_APPEND_LANES,
    SAMPLE_CAPTURE_LANES, SLAB_BOTTOMK_LANES, LOOKUP_PARENT_LANES, EXCHANGE, MESH_ERA, MESH_COMMIT,
)
# The stage profiler's paths: each stage program's kernels and the loop's.
BFS_STAGE_KERNELS = (
    STAGE_LOOP, STAGE_LANES, HASH_LANES, COMPACT_IDS, CLAIM_DEDUP, VISITED_INSERT, RING, RING_APPEND,
)
SIM_STAGE_KERNELS = (STAGE_LOOP, STAGE_LANES, STAGE_WALK, HASH_LANES)
MESH_STAGE_KERNELS = (
    STAGE_LOOP, STAGE_LANES, HASH_LANES, COMPACT_IDS_LANES, CLAIM_DEDUP_LANES, VISITED_INSERT_LANES,
    RING_LANES, RING_APPEND_LANES, EXCHANGE,
)
# The speclint pre-flight's path (analysis/): the agreement table.
LINT_KERNELS = (LANE_AGREE,)
# The spill tier's path (a BFS run past its ring's high water, solo or
# sharded): K7s's two entry points.
SPILL_KERNELS = (RING_DRAIN, RING_REFILL)
# K11's entries: a model's expand on every BFS path (solo, lanes, mesh,
# stages), its walk on the simulation's, when the route is the kernel.
EXPAND_KERNELS = (EXPAND_2PC, EXPAND_PAXOS, EXPAND_ABD, EXPAND_INCREMENT, EXPAND_INCREMENT_LOCK,
                  EXPAND_SINGLE_COPY)
WALK_KERNELS = (WALK_2PC, WALK_PAXOS, WALK_ABD, WALK_INCREMENT, WALK_INCREMENT_LOCK,
                WALK_SINGLE_COPY)
# K11c's entry: the BFS step's canon under .symmetry() (solo engine and
# its canon stage), when the route is the kernel.
CANON_KERNELS = (CANON_2PC,)
KERNELS = tuple(k for k in BFS_KERNELS if k is not RING_APPEND) + (
    WALK_RECORD, WALK_STEP, WALK_CAPTURE, WALK_SLAB, WALK_ERA, STAGE_LOOP, STAGE_WALK, EXCHANGE, MESH_ERA,
    LANE_AGREE, RING_DRAIN,
) + EXPAND_KERNELS + CANON_KERNELS
ENTRIES = (KERNELS + (RING_APPEND, WALK_PROLOGUE, STAGE_LANES, RING_REFILL, SLAB_BOTTOMK_LANES,
                      SAMPLE_CAPTURE_LANES, MESH_COMMIT)
           + LANE_KERNELS[1:] + WALK_KERNELS)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device (launch the kernel),
    False when every one lies on the CPU (run the plain version); raises
    on a mix or on any other device — never a silent fallback."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on unsupported or mixed devices: {sorted(kinds)}")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _lib_path(k: Kernel) -> str:
    h = hashlib.sha256(ARCH.encode())
    # The shared headers (csrc/*.cuh, csrc/models/*.cuh) are part of every source.
    headers = glob.glob(os.path.join(_CSRC, "*.cuh")) + glob.glob(os.path.join(_CSRC, "models", "*.cuh"))
    for path in [k.source_path] + sorted(headers):
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{os.path.splitext(k.source)[0]}_{digest}.so")


def _nvcc_cmd(k: Kernel, out: str) -> list:
    return [
        _nvcc(), f"-arch={ARCH}", "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-o", out, k.source_path,
    ]


def build_all(kernels=KERNELS, verbose: bool = False) -> float:
    """Compile every stale kernel library, one `nvcc` per source, all
    started together; returns the wall seconds the build took."""
    t0 = time.monotonic()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for k in kernels:
        out = _lib_path(k)
        if os.path.exists(out) or any(p[1] == out for p in procs):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = _nvcc_cmd(k, tmp)
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs.append((k, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for k, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{k.source}:\n{log}")
            continue
        if verbose and log.strip():
            print(f"[nvcc {k.source}] {log.strip()}")
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.monotonic() - t0


def _load(k: Kernel):
    with _lock:
        path = _lib_path(k)
        lib = _libs.get(path)
        if lib is None:
            if not os.path.exists(path):
                build_all([k])
            lib = _libs[path] = ctypes.CDLL(path)
        fn = getattr(lib, k.symbol)
        fn.argtypes = k.argtypes
        fn.restype = ctypes.c_int
        return fn


def reset_launches() -> None:
    for k in ENTRIES:
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in ENTRIES}


def restore_launches(counts: Dict[str, int]) -> None:
    """Set every count back to `counts` (a `launch_counts()` snapshot)."""
    for k in ENTRIES:
        k.launches = counts[k.name]


def add_launches(per_run: Dict[str, int], runs: int) -> None:
    """Add `runs` times the launches of one run of a captured segment."""
    if runs:
        for k in ENTRIES:
            k.launches += per_run.get(k.name, 0) * runs


CAPTURE_TILE = 1024  # candidates a block in csrc/capture_scan.cuh (kTile)
APPEND_TILE = 4096  # mask columns a block of K7's append (csrc/ring.cu kTile)


def capture_scratch(n: int, device) -> torch.Tensor:
    """The per-tile counts that K13c passes between its two launches over
    n candidates, and the occupancy it starts from."""
    return torch.empty(-(-n // CAPTURE_TILE) + 1, dtype=torch.int64, device=device)


def ptr(t: torch.Tensor) -> int:
    """Device pointer of a contiguous tensor."""
    if not t.is_contiguous():
        raise ValueError("kernel arguments must be contiguous")
    return t.data_ptr()
