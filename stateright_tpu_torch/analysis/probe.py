"""A model's lane program run as the engines run it, for the speclint
probes (analysis/device.py, analysis/symmetry.py): the port's counterpart
of the JAX probes' `jax.eval_shape` (does it trace?) and `jax.jit` (what
does it compute?), K16.

On the card the program runs once eagerly on the sampled rows (every
lazy initialisation, as the era runs its step before capturing it,
engines/era.py), then once inside `torch.cuda.graph` capture through
`TorchXP(device)`, as `engines/graph.py Graph.capture` captures the
expand into the era graph: data-dependent Python control flow (`bool()`,
`if` or `.item()` on a lane) fails that capture exactly where the era's
capture would. One replay of the graph gives the values. On the CPU the
structure comes from a run on `meta` lanes, where the same control flow
raises (`Tensor.item() cannot be called on meta tensors`), and the
values from an eager CPU call.

A refused capture leaves nothing behind: the capture ends on the
engines' capture stream, and torch's current stream is the caller's
again.

A model on the kernel route (`ops/expand.py expand_route`,
`ops/canon.py canon_route`) never runs its `xp` code in a check on the
card: the engines launch K11 (its WALK entry gives the successors and
masks in the layout the agreement table reads) and, under symmetry,
K11c. `kernel_probe` and `canon_probe` name that kernel without
launching anything, and `run_kernel` launches it once on the sampled
rows in the same capture setting, so STR205 and STR404 also hold numpy
against the program the engines run.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from .. import kernels
from ..engines.graph import capture_guard
from ..xp import TorchXP


class ProbeFailed(Exception):
    """The lane program failed: `stage` is "run" (it raised when run on
    the card or the CPU) or "capture" (it raised under capture or on meta
    lanes); `cause` is what it raised."""

    def __init__(self, stage: str, cause: BaseException):
        self.stage = stage
        self.cause = cause
        super().__init__(f"{stage}: {type(cause).__name__}: {cause}")


def failure_message(member: str, failure: ProbeFailed, device) -> str:
    """What a finding says of a lane program that failed in a probe."""
    cause = failure.cause
    text = str(cause).splitlines()[0] if str(cause) else ""
    if failure.stage == "capture":
        where = "on the card" if torch.device(device).type == "cuda" else "on meta lanes"
        return f"{member} fails to capture {where}: {type(cause).__name__}: {text}"
    return f"{member} fails to run on the device: {type(cause).__name__}: {text}"


def _capture(device: torch.device, body: Callable[[], Any]):
    """Capture `body` as a CUDA graph in the engines' capture setting
    (`graph.capture_guard`: their capture stream, the collector paused);
    returns (graph, what body returned). A failure ends the capture and
    raises body's error."""
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize(device)
    with capture_guard(device) as side:
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = body()
            except BaseException:
                try:
                    graph.capture_end()
                except Exception:
                    pass  # an invalidated capture ends with an error of its own
                raise
            graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(side)
    return graph, out


class LaneProbe:
    """`fn(xp, lanes)` over the sampled `lanes` (S uint32 [B] arrays) on
    `device`. `structure(pack)` runs it for its outputs' structure and
    `values()` for the packed values; `pack(out)` turns the outputs into
    the tensors the comparison reads (it runs inside the capture, so the
    replay fills them), or returns None when their structure is wrong."""

    def __init__(self, fn, lanes: Sequence[np.ndarray], device):
        self.fn = fn
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.lanes = [np.asarray(l).astype(np.int64) for l in lanes]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._pack = None
        self._packed = None
        self.capture_secs = 0.0
        self.launches = 0  # replays of the captured graph

    def _real_lanes(self):
        return tuple(torch.from_numpy(l).to(self.device) for l in self.lanes)

    def structure(self, pack: Callable[[Any], Any]):
        """The outputs of one run whose structure (types, shapes, dtypes)
        is the engines'. Raises ProbeFailed."""
        self._pack = pack
        if not self.on_card:
            meta = tuple(torch.empty(l.shape, dtype=torch.int64, device="meta") for l in self.lanes)
            try:
                return self.fn(TorchXP("meta"), meta)
            except Exception as e:  # reported as a finding
                raise ProbeFailed("capture", e) from e
        xp = TorchXP(self.device)
        lanes = self._real_lanes()
        try:
            self.fn(xp, lanes)
        except Exception as e:  # reported as a finding
            raise ProbeFailed("run", e) from e
        t0 = time.monotonic()
        box = {}

        def body():
            out = box["out"] = self.fn(xp, lanes)
            box["packed"] = pack(out)

        try:
            self.graph, _ = _capture(self.device, body)
        except Exception as e:  # reported as a finding
            raise ProbeFailed("capture", e) from e
        finally:
            self.capture_secs += time.monotonic() - t0
        self._packed = box["packed"]
        return box["out"]

    def values(self):
        """The packed outputs on the sampled rows: one replay of the graph
        on the card, an eager call on the CPU. Raises ProbeFailed."""
        if self.on_card:
            self.graph.replay()
            self.launches += 1
            return self._packed
        try:
            return self._pack(self.fn(TorchXP("cpu"), self._real_lanes()))
        except Exception as e:  # reported as a finding
            raise ProbeFailed("run", e) from e

    def release(self) -> None:
        if self.graph is not None:
            torch.cuda.current_stream(self.device).synchronize()
            self.graph.reset()
            self.graph = None
        self._packed = None


def kernel_probe(tm, device) -> Optional[kernels.Kernel]:
    """The K11 WALK kernel the engines run for `tm` (with its own
    properties) on `device`, or None where they run its `xp` code (the
    CPU, a model with no kernel). Builds and launches nothing."""
    from ..ops.expand import expand_route, kernel_of

    try:
        props = list(tm.tensor_properties())
    except Exception:  # the properties family reports it
        return None
    if expand_route(tm, props, device) != "kernel":
        return None
    return kernel_of(tm, props)[1]


def canon_probe(tm, device) -> Optional[kernels.Kernel]:
    """The K11c canon kernel the BFS engine runs for `tm` under
    `.symmetry()` on `device`, or None. Builds and launches nothing."""
    from ..ops.canon import canon_route, kernel_of

    return kernel_of(tm)[0] if canon_route(tm, device) == "kernel" else None


def run_kernel(device, fn: Callable[[torch.Tensor], Any], rows: np.ndarray):
    """`fn` (a kernel route's function of rows [S, B] int64) once on the
    sampled `rows` ([B, S] uint32) on the card, on the engines' capture
    stream with the collector paused (`graph.capture_guard`, the setting
    of every probe); returns what it returned, finished."""
    device = torch.device(device)
    lanes = torch.from_numpy(np.ascontiguousarray(rows.T.astype(np.int64))).to(device)
    with capture_guard(device) as side:
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            out = fn(lanes)
        side.synchronize()
    return out
