"""Device programs as CUDA graphs: the plumbing the era programs share
(the BFS era, engines/era.py; the simulation era, engines/gpu_simulation.py;
the lane batch, engines/multiplex.py).

A program's segments are captured once each with `torch.cuda.graph` and
placed, as child graphs, into a graph built in C (kernels/csrc/
era_step.cu `srt_graph_*`) whose conditional WHILE nodes run the loops on
the card: a kernel of the segment before a loop and of the loop's body
sets the loop's condition, so no loop needs a host round trip. A program
is launched with one `cudaGraphLaunch`, and its result comes back with
one asynchronous copy to pinned memory on a side stream (`Readback`).

Launches made while a segment is captured are not launches: `build`
takes them back off the kernels' counts and keeps each segment's
launches a run, which `count` adds once per run of the segment on the
card. A capture, a node or an instantiation that fails raises; nothing
falls back to running the segments from the host.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import gc
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import kernels

_V = ctypes.c_void_p
_PV = ctypes.POINTER(ctypes.c_void_p)
_U = ctypes.c_ulonglong

_SIGNATURES = (
    ("srt_graph_create", [_PV]),
    ("srt_graph_handle", [_V, ctypes.POINTER(_U)]),
    ("srt_graph_while", [_V, _V, _U, _PV, _PV]),
    ("srt_graph_child", [_V, _V, _V, _PV]),
    ("srt_graph_instantiate", [_V, _PV]),
    ("srt_graph_launch", [_V, _V]),
    ("srt_graph_destroy", [_V, _V]),
    ("srt_graph_nodes", [_V, ctypes.POINTER(ctypes.c_longlong)]),
)


def _call(name: str):
    return kernels.ERA_STEP.function(name, dict(_SIGNATURES)[name])


def _ok(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"device program graph: {what} failed: cudaError {err}")


@functools.lru_cache(maxsize=None)
def _capture_stream(device: int) -> torch.cuda.Stream:
    """The stream every segment is captured on: one of the high-priority
    pool. torch's default capture stream and the readbacks' side streams
    come from the default-priority pool, handed out in turn, so a
    readback's pinned slots could otherwise carry events of the stream a
    later program captures on."""
    return torch.cuda.Stream(device=device, priority=-1)


@contextlib.contextmanager
def capture_guard(device=None):
    """The setting every capture runs in (the program segments here, the
    speclint probe's lane program, analysis/probe.py): yields the stream
    to capture on, `_capture_stream`, with the Python collector paused
    until the capture is over. A collection inside a capture can free a
    pinned buffer (a readback slot), which records an event on each stream
    the buffer was used on; on the capturing stream that record is
    captured, not made, so the host allocator's next query of the event
    fails ("invalid argument" at the next capture's _host_emptyCache)."""
    dev = None if device is None else torch.device(device).index
    if dev is None:
        dev = torch.cuda.current_device()
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield _capture_stream(dev)
    finally:
        if collecting:
            gc.enable()


def captured_nodes(fn: Callable[[], None]) -> Dict[str, int]:
    """Capture one call of `fn` on the current device and count its graph
    nodes (kernels, memsets and all): what a call launches, counted on
    the card (the kernels' `launches` count calls of their C entry
    points)."""
    counts = kernels.launch_counts()
    tg = torch.cuda.CUDAGraph(keep_graph=True)
    try:
        with capture_guard() as stream:
            with torch.cuda.graph(tg, stream=stream, capture_error_mode="thread_local"):
                fn()
        out = (ctypes.c_longlong * 3)()
        _ok(_call("srt_graph_nodes")(_V(tg.raw_cuda_graph()), out), "graph nodes")
        return dict(kernels=out[0], memsets=out[1], nodes=out[2])
    finally:
        kernels.restore_launches(counts)
        tg.reset()


class Graph:
    """One device program: the C-built graph and its instantiation, the
    torch graphs (and their memory pools) its child nodes copy, and each
    segment's kernel launches a run. Build it with `build`."""

    def __init__(self):
        self.root = _V()
        self.exec = _V()
        self.torch_graphs: List[torch.cuda.CUDAGraph] = []
        self.per_run: Dict[str, Dict[str, int]] = {}
        self.secs = 0.0

    # -- nodes (used inside `build`'s describe) ------------------------------

    def capture(self, name: str, fn: Callable[[], None]) -> _V:
        """Capture `fn` as the segment `name`: the raw graph to place."""
        before = kernels.launch_counts()
        tg = torch.cuda.CUDAGraph(keep_graph=True)
        with capture_guard() as stream:
            with torch.cuda.graph(tg, stream=stream, capture_error_mode="thread_local"):
                fn()
        after = kernels.launch_counts()
        self.per_run[name] = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        self.torch_graphs.append(tg)
        return _V(tg.raw_cuda_graph())

    def handle(self, graph: _V) -> _U:
        """A conditional handle of `graph`, 0 at every launch until a
        kernel sets it."""
        h = _U()
        _ok(_call("srt_graph_handle")(graph, ctypes.byref(h)), "conditional handle")
        return h

    def child(self, graph: _V, after: Optional[_V], raw: _V) -> _V:
        """A node running a copy of the captured `raw` in `graph`, after
        node `after` (None: a root)."""
        node = _V()
        _ok(_call("srt_graph_child")(graph, after, raw, ctypes.byref(node)), "child graph")
        return node

    def loop(self, graph: _V, after: Optional[_V], h: _U) -> Tuple[_V, _V]:
        """A WHILE node on handle `h` in `graph`, after `after`: (node, its
        body graph)."""
        node, body = _V(), _V()
        _ok(_call("srt_graph_while")(graph, after, h, ctypes.byref(node), ctypes.byref(body)),
            "while node")
        return node, body

    # -- running -------------------------------------------------------------

    def launch(self, stream) -> None:
        err = _call("srt_graph_launch")(self.exec, stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"device program graph launch failed: cudaError {err}")

    def count(self, runs: Dict[str, int]) -> None:
        """Add each segment's launches `runs[name]` times."""
        for name, n in runs.items():
            kernels.add_launches(self.per_run.get(name, {}), n)

    def free(self) -> None:
        """Destroy the graph and release its segments' memory. The caller
        makes sure no launch of it is still running (a program's result
        was read back, or `Readback.drain`)."""
        if self.exec.value or self.root.value:
            _call("srt_graph_destroy")(self.exec, self.root)
            self.exec, self.root = _V(), _V()
        for g in self.torch_graphs:
            g.reset()
        self.torch_graphs = []

    def __del__(self):
        # A program dropped with its graph (an evicted warm lane program,
        # a finished simulation) frees it here.
        try:
            self.free()
        except Exception:
            pass


def build(device, describe: Callable[[Graph], None]) -> Graph:
    """Build and instantiate one device program on `device`: `describe(g)`
    adds its nodes to `g.root` (capturing each segment with `g.capture`).
    Every lazy initialisation must have run before (run each segment once
    eagerly with nothing to do); the caller synchronises its stream first.
    A failure frees what was built and raises."""
    t0 = time.monotonic()
    torch.cuda.synchronize(device)
    counts = kernels.launch_counts()
    g = Graph()
    try:
        _ok(_call("srt_graph_create")(ctypes.byref(g.root)), "graph create")
        describe(g)
        _ok(_call("srt_graph_instantiate")(g.root, ctypes.byref(g.exec)), "instantiate")
    except BaseException:
        g.free()
        raise
    finally:
        # Captured launches are not launches: each run adds them back.
        kernels.restore_launches(counts)
    g.secs = time.monotonic() - t0
    return g


def build_era(device, start, begin, step, epilogue, tail=None) -> Graph:
    """The era graph of both BFS programs (engines/era.py, parallel/
    mesh.py): START, then a WHILE node over the inner eras — BEGIN, a
    WHILE node over the step, the epilogue — then the tail. Each segment
    is called with the conditional handle it sets (START and the
    epilogue the outer loop's, BEGIN and the step the inner loop's); the
    segments' launches are counted as `count_era` runs them."""

    def describe(g: Graph) -> None:
        outer = g.handle(g.root)
        first = g.child(g.root, None, g.capture("start", lambda: start(outer.value)))
        outer_loop, outer_body = g.loop(g.root, first, outer)
        inner = g.handle(outer_body)
        opened = g.child(outer_body, None, g.capture("begin", lambda: begin(inner.value)))
        inner_loop, inner_body = g.loop(outer_body, opened, inner)
        g.child(inner_body, None, g.capture("step", lambda: step(inner.value)))
        g.child(outer_body, inner_loop, g.capture("epilogue", lambda: epilogue(outer.value)))
        if tail is not None:
            g.child(g.root, outer_loop, g.capture("tail", tail))

    return build(device, describe)


def count_era(g: Graph, steps: int, eras: int) -> None:
    """Add the launches of one run of an era graph that ran `steps` step
    bodies over `eras` inner eras."""
    g.count(dict(start=1, begin=eras, step=steps, epilogue=eras, tail=1))


class Readback:
    """Pinned host copies of one device tensor, filled asynchronously on a
    side stream after a launch: `slots` of them, one for each result that
    may be in flight at once."""

    def __init__(self, src: torch.Tensor, slots: int = 1):
        self.src = src
        self.side = torch.cuda.Stream(device=src.device)
        self.slots = [torch.empty(src.shape, dtype=src.dtype).pin_memory() for _ in range(slots)]
        self.next = 0
        self.done: Optional[torch.cuda.Event] = None

    def before_launch(self, main) -> None:
        """The program rewrites `src` in place: the last copy must have
        read it first."""
        if self.done is not None:
            main.wait_event(self.done)

    def after_launch(self, main):
        """Queue the copy of `src` behind the work on `main`; returns a
        handle for `wait`."""
        launched = torch.cuda.Event()
        launched.record(main)
        slot = self.slots[self.next]
        self.next = (self.next + 1) % len(self.slots)
        with torch.cuda.stream(self.side):
            self.side.wait_event(launched)
            slot.copy_(self.src, non_blocking=True)
            read = torch.cuda.Event()
            read.record(self.side)
        self.done = read
        return slot, read

    def wait(self, handle) -> np.ndarray:
        slot, read = handle
        read.synchronize()
        return slot.numpy().copy()

    def drain(self) -> None:
        if self.done is not None:
            self.done.synchronize()
