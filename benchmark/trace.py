"""Reduction of a ``torch.profiler`` trace of the card to what the per-layer
metrics and the result's ``breakdown`` read.

The traced stretch is the ``bench:profiled`` range. Inside it:

- ``busy_s``: the union of the device's kernel, copy and set intervals
  (overlapping operations count once);
- ``window_s``: the length of the range;
- ``kernels``: per kernel name, its launches and summed device seconds;
- ``gaps``: every interval in which no device operation ran, labelled by
  the host ranges (the harness's ``bench:`` spans and the program's
  phases) open at its start.
"""

from __future__ import annotations

import sys

import torch

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
STRETCH = "bench:profiled"


def _kind(e, on_device: bool, phases: set):
    """The kineto activity of an event: ``kernel`` and the like on the
    device, ``user_annotation`` for a host range. A torch without
    ``activity_type`` (2.11) is read by name: a host range is a harness
    span (``bench:``) or one of the program's phases, and every device
    event but their mirrors on the device timeline is an operation."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    annotation = name.startswith("bench:") or name in phases
    if on_device:
        return "gpu_user_annotation" if annotation else "kernel"
    return "user_annotation" if annotation else "cpu_op"


def _events(prof):
    """(device intervals, host ranges), each a list of (start_ns, end_ns,
    name)."""
    from min_llm_inference_tpu_torch.utils.profiling import \
        get_global_phase_stats
    phases = set(get_global_phase_stats().seconds)
    cuda = torch.autograd.DeviceType.CUDA
    dev, host, other = [], [], set()
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == cuda
        kind = _kind(e, on_device, phases)
        a = e.start_ns()
        b = a + e.duration_ns()
        if on_device:
            if kind in DEVICE_KINDS:
                dev.append((a, b, e.name()))
            else:
                other.add(kind)
        elif kind == "user_annotation":
            host.append((a, b, e.name()))
    if other:
        print(f"trace: device activities left out: {sorted(other)}",
              file=sys.stderr)
    return dev, host


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def reduce(prof) -> dict:
    dev, host = _events(prof)
    stretch = [(a, b) for a, b, n in host if n == STRETCH]
    if not stretch:
        raise RuntimeError(f"no {STRETCH} range in the trace")
    w0, w1 = stretch[0]
    inside = [(max(a, w0), min(b, w1), n) for a, b, n in dev
              if b > w0 and a < w1]
    busy = _union([(a, b) for a, b, _ in inside])
    kernels: dict = {}
    for a, b, n in inside:
        k = kernels.setdefault(n, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) * 1e-9
    gaps, t = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    ranges = sorted((a, b, n) for a, b, n in host if n != STRETCH)

    def label(t0):
        open_ = [n for a, b, n in ranges if a <= t0 < b]
        return "/".join(open_) or "(no host range)"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "busy_s": sum(b - a for a, b in busy) * 1e-9,
        "window_s": (w1 - w0) * 1e-9,
        "kernels": kernels,
        "gaps": [(label(a), (b - a) * 1e-9) for a, b in gaps[:10]],
        "device_events": len(inside),
    }


def breakdown(red: dict) -> dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time, and the ten longest idle gaps by the host ranges open."""
    ops = sorted(red["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
    return {"device_ops": [[n, s] for n, (_, s) in ops],
            "idle_gaps": [[n, s] for n, s in red["gaps"]]}
