"""Engine phase ranges and trace capture (counterpart of
min_llm_inference_tpu/utils/profiling.py).

``phase(name)`` marks one host-side engine phase: a
``torch.profiler.record_function`` range, visible on the host timeline of a
``torch.profiler`` trace, plus host wall-time accumulation in a
process-global ``PhaseStats``. ``trace(logdir)`` captures a
``torch.profiler`` trace of the host and, where there is one, the CUDA
device into ``logdir``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


class PhaseStats:
    """Per-phase host wall-time accumulator."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)

    def add(self, name: str, dt: float) -> None:
        self.seconds[name] += dt
        self.calls[name] += 1

    def reset(self) -> None:
        self.seconds.clear()
        self.calls.clear()

    def summary(self) -> Dict[str, Dict[str, float]]:
        total = sum(self.seconds.values()) or 1.0
        return {
            name: {
                "seconds": round(s, 4),
                "calls": self.calls[name],
                "share": round(s / total, 4),
            }
            for name, s in sorted(
                self.seconds.items(), key=lambda kv: -kv[1]
            )
        }


_global_stats = PhaseStats()


def get_global_phase_stats() -> PhaseStats:
    return _global_stats


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Annotate one engine phase (profiler range + wall-time
    accumulation)."""
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
