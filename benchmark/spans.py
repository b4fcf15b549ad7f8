"""The harness's spans: a name, a start and an end on the host clock, kept
in memory. Each span is also a ``torch.profiler.record_function`` range
named ``bench:<name>``, so that a traced stretch shows which harness span
was open on the host while the device sat idle."""

from __future__ import annotations

import contextlib
import time

import torch


class Spans:
    def __init__(self) -> None:
        self.records: list = []   # (name, start, end), perf_counter seconds

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench:" + name):
            yield
        self.records.append((name, t0, time.perf_counter()))

    def of(self, name: str, since: float = 0.0) -> list:
        """(start, end) of every span called ``name`` that began at or after
        ``since``."""
        return [(a, b) for n, a, b in self.records if n == name and a >= since]
