"""Device-side control flow for the burst, and its capture into a CUDA graph.

The JAX burst is one jitted program: its liveness gate is a ``lax.cond``
and its prefill bucket a ``lax.switch``, so the host dispatches a burst and
reads nothing inside it. Here the burst is plain PyTorch code that runs in
one of three ways:

  * eagerly on the CPU: ``device_if`` / ``device_switch`` read their
    predicate (a CPU read is not a sync) and call the branch or not;
  * eagerly on CUDA (a check path): the same, and the read is a host sync,
    which they report;
  * captured on CUDA (``capture``): every branch is recorded into an IF
    node of the graph (csrc/graph_cond.cu), taken or skipped at replay by
    the predicate in device memory. A replay of the graph is the burst,
    one host call and no read.

``warming()`` runs every branch eagerly, whatever its predicate: the warm-up
before a capture, so that everything the capture records (kernel libraries,
their shared-memory attributes, cuBLAS handles) has run once.

Under capture a body is recorded on a stream of its own (one per nesting
depth), and allocations on it go to a private memory pool kept as long as
the graph, so that its temporaries keep their addresses for every replay.
Results that must outlive a body are written into buffers that exist
before it. torch.profiler sessions come after every capture: a graph with
IF nodes captured after a session that traced the card faults with an
illegal address when replayed under a later one (torch 2.11 on CUDA 12.8,
driver 580; tools/graph_profile_repro.py shows when).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import gc
import time
import weakref

import torch

from ..ops import _build
from ..utils import profiling

_SOURCE = "graph_cond.cu"

_warming = False
# the capture under way: [its device, the IF depth being recorded]
_capture = None


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    vp = ctypes.c_void_p
    lib.mli_if_begin.argtypes = [vp, vp, vp]
    lib.mli_if_begin.restype = ctypes.c_int
    lib.mli_if_end.argtypes = [vp]
    lib.mli_if_end.restype = ctypes.c_int
    lib.mli_phase_stamp.argtypes = [vp, vp, ctypes.c_int]
    lib.mli_phase_stamp.restype = ctypes.c_int
    lib.mli_graph_dot.argtypes = [vp, ctypes.c_char_p]
    lib.mli_graph_dot.restype = ctypes.c_int
    lib.mli_stream_create.argtypes = []
    lib.mli_stream_create.restype = vp
    lib.mli_error_string.argtypes = [ctypes.c_int]
    lib.mli_error_string.restype = ctypes.c_char_p
    return lib


@contextlib.contextmanager
def warming():
    """Inside, device_if and device_switch run every branch."""
    global _warming
    prev, _warming = _warming, True
    try:
        yield
    finally:
        _warming = prev


def device_if(pred: torch.Tensor, fn) -> int:
    """``fn()`` where the device bool ``pred`` holds (JAX: ``lax.cond``
    with a no-op false branch). Returns the host syncs made: 1 when a CUDA
    ``pred`` was read eagerly, else 0."""
    if _capture is not None:
        _captured_if(pred, fn)
        return 0
    if _warming:
        fn()
        return 0
    if bool(pred):
        fn()
    return int(pred.is_cuda)


def device_switch(index: torch.Tensor, branches) -> int:
    """``branches[index]()`` for the device int ``index`` (JAX:
    ``lax.switch``); a None branch does nothing. Under capture, one IF node
    per branch with the predicate ``index == k``. Returns the host syncs
    made, as device_if."""
    if _capture is not None:
        for k, fn in enumerate(branches):
            if fn is not None:
                _captured_if(index == k, fn)
        return 0
    if _warming:
        for fn in branches:
            if fn is not None:
                fn()
        return 0
    fn = branches[int(index)]
    if fn is not None:
        fn()
    return int(index.is_cuda)


def _captured_if(pred: torch.Tensor, fn) -> None:
    if pred.dtype != torch.bool or pred.numel() != 1:
        raise ValueError("an IF node's predicate is one device bool")
    dev, depth = _capture
    child = capture_stream(dev, depth + 1)
    lib = _library()
    parent = torch.cuda.current_stream(dev)
    _build.check(lib, lib.mli_if_begin(parent.cuda_stream, pred.data_ptr(),
                                       child.cuda_stream), "IF node")
    _capture[1] = depth + 1
    try:
        with torch.cuda.stream(child):
            fn()
    finally:
        _capture[1] = depth
        _build.check(lib, lib.mli_if_end(child.cuda_stream), "IF node end")


def _stamp(row: torch.Tensor, end: bool) -> None:
    """Record a device span's start or end stamp on ``row`` of a phase
    table into the graph under capture (utils/profiling.phase)."""
    lib = _library()
    stream = torch.cuda.current_stream(row.device)
    _build.check(lib, lib.mli_phase_stamp(stream.cuda_stream, row.data_ptr(),
                                          int(end)), "phase stamp")


class Captured:
    """A captured graph and what its capture cost: ``capture_s`` (recording
    the work), ``instantiate_s`` and
    ``pool_bytes`` (device memory the capture reserved)."""

    def __init__(self, graph, capture_s, instantiate_s, pool_bytes):
        self.graph = graph
        self.capture_s = capture_s
        self.instantiate_s = instantiate_s
        self.pool_bytes = pool_bytes

    def replay(self) -> None:
        self.graph.replay()


def new_pools() -> tuple:
    """Memory pools for captures that share them: (the graphs' own, their
    IF bodies'). Graphs that share pools must not replay concurrently."""
    return torch.cuda.graph_pool_handle(), torch.cuda.graph_pool_handle()


def capture(fn, dev: torch.device, pools: tuple | None = None,
            launch_counts: torch.Tensor | None = None,
            debug_dot: str | None = None,
            phase_table: torch.Tensor | None = None) -> Captured:
    """Record ``fn()`` into a new CUDA graph on ``capture_stream(dev)``
    (which first waits for the current stream), allocating from ``pools``
    (``new_pools()``; None = pools of its own). With ``launch_counts``,
    kernel wrappers count their launches into it on the device
    (ops/_build.count_launch). With ``phase_table`` and the program's
    tracing on, ``utils.profiling.phase`` regions record device spans into
    it (two stamp launches each); otherwise they add nothing to the graph.
    With ``debug_dot``, the graph is also
    written there in Graphviz form (conditional bodies included). Makes
    no host sync. The cyclic garbage collector is off meanwhile: a graph it
    frees during a capture fails to reset and takes the process down."""
    global _capture
    if _capture is not None:
        raise RuntimeError("a capture is already under way")
    dev = _indexed(dev)
    stream = capture_stream(dev)
    pool, body_pool = new_pools() if pools is None else pools
    # kept, so that it can be written out before it is instantiated
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    cur = torch.cuda.current_stream(dev)
    stream.wait_stream(cur)
    reserved = torch.cuda.memory_reserved(dev)
    t0 = time.perf_counter()
    gc_was_on = gc.isenabled()
    gc.disable()
    with torch.cuda.stream(stream), \
            _build.counting_on_device(launch_counts), \
            profiling.capturing(phase_table, _stamp):
        graph.capture_begin(pool=pool)
        # the capture's own routing covers the captured stream only: the IF
        # bodies' streams allocate from a pool of their own, which stays
        # reserved until the graph is freed
        torch._C._cuda_beginAllocateToPool(dev.index, body_pool)
        _capture = [dev, 0]
        try:
            fn()
        finally:
            _capture = None
            torch._C._cuda_endAllocateToPool(dev.index, body_pool)
            graph.capture_end()
            if gc_was_on:
                gc.enable()
    t1 = time.perf_counter()
    cur.wait_stream(stream)
    if debug_dot:
        lib = _library()
        _build.check(lib, lib.mli_graph_dot(graph.raw_cuda_graph(),
                                            debug_dot.encode()), "graph dump")
    t2 = time.perf_counter()
    graph.instantiate()
    done = Captured(graph, t1 - t0, time.perf_counter() - t2,
                    torch.cuda.memory_reserved(dev) - reserved)
    weakref.finalize(done, torch._C._cuda_releasePool, dev.index, body_pool)
    return done


def capture_stream(dev: torch.device, depth: int = 0):
    """The stream that records a burst on ``dev`` (depth 0; its eager
    warm-up runs there too) or an IF body at ``depth``: streams of their
    own, made once and kept (a stream's cuBLAS workspace is made at its
    first use). torch's pooled streams would not do: they are handed out
    round-robin, so two of them can be one stream."""
    dev = _indexed(dev)
    streams = _streams(dev)
    while len(streams) <= depth:
        with torch.cuda.device(dev):
            ptr = _library().mli_stream_create()
        if not ptr:
            raise RuntimeError("cannot create a CUDA stream")
        streams.append(torch.cuda.ExternalStream(ptr, device=dev))
    return streams[depth]


@functools.cache
def _streams(dev) -> list:
    return []


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current device>``."""
    return (dev if dev.index is not None
            else torch.device(dev.type, torch.cuda.current_device()))


def count_dot_nodes(path: str) -> int:
    """The nodes of a graph written by ``capture(debug_dot=...)``, its
    conditional bodies' included."""
    import re

    with open(path) as f:
        text = f.read()
    return len(set(re.findall(r'"(graph_\d+_node_\d+)"\s*\[', text)))
