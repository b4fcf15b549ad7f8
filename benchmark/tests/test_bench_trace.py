"""The trace reduction on hand-made kineto events: the busy union,
per-kernel sums, the idle gaps and their host labels, with and without
the events' ``activity_type`` (torch 2.11 has none)."""

from __future__ import annotations

import types

import pytest
import torch

from benchmark import trace

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, a, b, kind=None):
        self._n, self._d, self._a, self._b = name, dev, a, b
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a


def _prof(events):
    res = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=res))


def _events(with_kind: bool):
    k = (lambda kind: kind) if with_kind else (lambda kind: None)
    return [
        Ev("bench:profiled", CPU, 0, 1000, k("user_annotation")),
        Ev("bench:batch", CPU, 100, 900, k("user_annotation")),
        Ev("aten::mm", CPU, 120, 130, k("cpu_op")),
        Ev("bench:batch", CUDA, 100, 900, k("gpu_user_annotation")),
        Ev("attention_kernel<1>", CUDA, 200, 300, k("kernel")),
        Ev("attention_kernel<1>", CUDA, 250, 400, k("kernel")),
        Ev("Memcpy DtoH", CUDA, 600, 650, k("gpu_memcpy")),
        Ev("gemm", CUDA, 950, 1100, k("kernel")),   # runs past the stretch
    ]


@pytest.mark.parametrize("with_kind", [True, False])
def test_reduce(with_kind):
    red = trace.reduce(_prof(_events(with_kind)))
    # union: [200, 400] + [600, 650] + [950, 1000] = 300 ns
    assert red["busy_s"] == pytest.approx(300e-9)
    assert red["window_s"] == pytest.approx(1000e-9)
    assert red["kernels"]["attention_kernel<1>"] == [2, pytest.approx(
        250e-9)]
    assert red["kernels"]["gemm"] == [1, pytest.approx(50e-9)]
    assert "bench:batch" not in red["kernels"]
    gaps = red["gaps"]
    # [0,200], [400,600], [650,950]: longest first, labelled by the host
    # ranges open at its start
    assert [round(s * 1e9) for _, s in gaps] == [300, 200, 200]
    assert gaps[0][0] == "bench:batch"
    assert "(no host range)" in [n for n, _ in gaps]
    b = trace.breakdown(red)
    assert b["device_ops"][0][0] == "attention_kernel<1>"
    assert len(b["idle_gaps"]) == 3
