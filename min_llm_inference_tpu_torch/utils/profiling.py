"""Engine phase ranges, device spans and trace capture (counterpart of
min_llm_inference_tpu/utils/profiling.py).

``phase(name)`` marks one engine phase. Outside a CUDA graph capture it is
a ``torch.profiler.record_function`` range, visible on the host timeline of
a ``torch.profiler`` trace, plus host wall-time accumulation in the
process-global ``PhaseStats``. While a graph is captured
(runtime/graph.capture) it records no host time, since a capture-time wall
means nothing: with tracing on, it records two stamp launches into the
graph instead, at its start and its end, which at every replay add the
region's device nanoseconds and one call to the phase's row of a device
table (csrc/graph_cond.cu). The owner of the table folds it into
``PhaseStats`` as ``device_seconds`` and ``device_calls`` (``fold_device``).

Tracing (``set_tracing``) is one process-wide switch, off by default. It is
read when a graph is captured: a graph captured with it off holds no
stamp.

``trace(logdir)`` captures a ``torch.profiler`` trace of the host and,
where there is one, the CUDA device into ``logdir``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

# rows of a device phase table: one per phase name recorded under capture
MAX_DEVICE_PHASES = 16
# columns of a row: the open region's start (ns), summed ns, calls
DEVICE_COLUMNS = 3

_tracing = False
# while a graph is captured: (the device phase table or None, the stamp
# launcher); None outside captures
_capture = None
# phase name -> row of every device phase table
_device_rows: Dict[str, int] = {}


def set_tracing(on: bool) -> bool:
    """Turn the program's tracing on or off; returns the previous
    setting."""
    global _tracing
    prev, _tracing = _tracing, bool(on)
    return prev


def tracing() -> bool:
    return _tracing


class PhaseStats:
    """Per-phase host wall time and, from graphs captured with tracing on,
    device time."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.device_seconds: Dict[str, float] = defaultdict(float)
        self.device_calls: Dict[str, int] = defaultdict(int)

    def add(self, name: str, dt: float) -> None:
        self.seconds[name] += dt
        self.calls[name] += 1

    def add_device(self, name: str, seconds: float, calls: int) -> None:
        self.device_seconds[name] += seconds
        self.device_calls[name] += calls

    def reset(self) -> None:
        self.seconds.clear()
        self.calls.clear()
        self.device_seconds.clear()
        self.device_calls.clear()

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per phase, host ``seconds``, ``calls`` and ``share`` of the host
        total, and where the device timed it ``device_seconds`` and
        ``device_calls``; ordered by host seconds."""
        total = sum(self.seconds.values()) or 1.0
        out = {}
        names = sorted(set(self.seconds) | set(self.device_seconds),
                       key=lambda n: (-self.seconds.get(n, 0.0), n))
        for name in names:
            s = self.seconds.get(name, 0.0)
            row = {"seconds": round(s, 4), "calls": self.calls.get(name, 0),
                   "share": round(s / total, 4)}
            if name in self.device_seconds:
                row["device_seconds"] = round(self.device_seconds[name], 6)
                row["device_calls"] = self.device_calls[name]
            out[name] = row
        return out


_global_stats = PhaseStats()


def get_global_phase_stats() -> PhaseStats:
    return _global_stats


def _device_row(name: str) -> int:
    row = _device_rows.get(name)
    if row is None:
        if len(_device_rows) == MAX_DEVICE_PHASES:
            raise RuntimeError("too many device-timed phases")
        row = _device_rows[name] = len(_device_rows)
    return row


def new_device_table(device) -> torch.Tensor:
    """A zeroed device phase table ([MAX_DEVICE_PHASES, DEVICE_COLUMNS]
    int64)."""
    return torch.zeros((MAX_DEVICE_PHASES, DEVICE_COLUMNS),
                       dtype=torch.int64, device=device)


def fold_device(table, stats: PhaseStats | None = None) -> None:
    """Add a device phase table read to the host (``table``: array-like
    [MAX_DEVICE_PHASES, DEVICE_COLUMNS]) to ``stats`` (default the global
    PhaseStats) as each phase's device seconds and calls."""
    stats = _global_stats if stats is None else stats
    for name, row in _device_rows.items():
        calls = int(table[row][2])
        if calls:
            stats.add_device(name, int(table[row][1]) * 1e-9, calls)


@contextlib.contextmanager
def capturing(table, stamp) -> Iterator[None]:
    """Inside, a CUDA graph is being captured: ``phase`` records no host
    time, and with tracing on and a ``table`` it records
    ``stamp(row, end)`` launches around its region into the graph (``row``:
    the phase's row of ``table``; ``end``: False at the start, True at the
    end)."""
    global _capture
    prev = _capture
    _capture = (table if _tracing else None, stamp)
    try:
        yield
    finally:
        _capture = prev


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Annotate one engine phase: a profiler range and host wall time, or
    under a graph capture the stamps of a device span (see the module's
    docstring)."""
    if _capture is not None:
        table, stamp = _capture
        if table is None:
            yield
            return
        row = table[_device_row(name)]
        stamp(row, False)
        yield
        stamp(row, True)
        return
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    _global_stats.add(name, time.perf_counter() - t0)


@contextlib.contextmanager
def trace(logdir: str | None) -> Iterator[None]:
    """Capture a torch.profiler trace into ``logdir`` as a Chrome trace
    (``trace.json``; open it in Perfetto or chrome://tracing), with the
    CUDA device's rows when CUDA is available; None is a no-op. Host rows
    show the ``phase(...)`` ranges."""
    if not logdir:
        yield
        return
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
