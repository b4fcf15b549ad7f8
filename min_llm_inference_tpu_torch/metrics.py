"""Throughput accounting.

The port's copy of min_llm_inference_tpu/metrics.py: the reference's global
ThroughputCounter singleton
(include/throughput_counter.h:5-18, src/throughput_counter.cpp:8-35):
``start_record`` begins a run, ``add_record_if_recording`` accumulates
generated tokens, ``print_throughput`` reports tokens / seconds / tok/s.
Extended with per-request first-token latency tracking (TTFT percentiles)
which the reference does not have.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class ThroughputCounter:
    total_tokens: int = 0
    _recording: bool = False
    _start_time: float = 0.0
    _elapsed: float = 0.0
    # request id -> submit time; first-token latencies in seconds
    _submit_times: dict = field(default_factory=dict)
    ttfts: list = field(default_factory=list)

    def start_record(self) -> None:
        if not self._recording:
            self._recording = True
            self._start_time = time.perf_counter()

    def stop_record(self) -> None:
        if self._recording:
            self._elapsed += time.perf_counter() - self._start_time
            self._recording = False

    def add_record_if_recording(self, n_tokens: int) -> None:
        if self._recording:
            self.total_tokens += n_tokens

    def note_submit(self, request_id: int) -> None:
        self._submit_times.setdefault(request_id, time.perf_counter())

    def note_first_token(self, request_id: int) -> None:
        t0 = self._submit_times.pop(request_id, None)
        if t0 is not None:
            self.ttfts.append(time.perf_counter() - t0)

    @property
    def elapsed_seconds(self) -> float:
        if self._recording:
            return self._elapsed + (time.perf_counter() - self._start_time)
        return self._elapsed

    @property
    def tokens_per_second(self) -> float:
        secs = self.elapsed_seconds
        return self.total_tokens / secs if secs > 0 else 0.0

    def ttft_percentile(self, q: float) -> float:
        if not self.ttfts:
            return 0.0
        xs = sorted(self.ttfts)
        idx = min(len(xs) - 1, int(q * len(xs)))
        return xs[idx]

    def print_throughput(self) -> None:
        print(
            f"total tokens: {self.total_tokens}, "
            f"seconds: {self.elapsed_seconds:.3f}, "
            f"throughput: {self.tokens_per_second:.1f} tokens/s"
        )

    def reset(self) -> None:
        self.total_tokens = 0
        self._recording = False
        self._elapsed = 0.0
        self._submit_times.clear()
        self.ttfts.clear()


_GLOBAL_COUNTER = ThroughputCounter()


def get_global_throughput_counter() -> ThroughputCounter:
    return _GLOBAL_COUNTER
