"""One run of one cell: set-up, the measured window, the traced stretch, the
check against the plain reference, and the result line.

``setup_s`` runs from the start of the process to the start of the window:
the kernels' build (a no-op once built in this checkout), the weights made
on the device from the seed, the engine, and the loop's warm-up, which
captures every CUDA graph the window replays. The window captures nothing;
the traced run starts its profiler only after the window, on a stretch of
the same traffic, so that every capture precedes the profiler (a graph with
conditional nodes captured after a profiler session faults when replayed
under a later one).

A traced run also turns the program's own tracing on before set-up, so
that the graphs it captures time their phases on the device, and hands
what the program counted over the window to the metric readers as
``run.program`` (``ProgramWindow``). An untraced run leaves the program's
tracing off: its graphs are those of a run with no benchmark around it.
"""

from __future__ import annotations

import gc
import os
import sys
import time
import types

import torch

from . import spec, trace
from .reference import check
from .reference.model import no_tf32
from .spans import Spans

# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "min_llm_inference_tpu")


def process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock (Linux: from
    /proc; elsewhere the first call)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        age = up - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in sys.modules}
                  & set(FORBIDDEN))


class Harness:
    """What a loop works with: the cell's configuration and traffic, the
    seed, the device, the weights, the spans and the engine it builds."""

    def __init__(self, cell: dict, cfg: dict, traffic: dict, seed: int,
                 device):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.seed, self.device = seed, device
        self.spans = Spans()
        self.params = None
        self.engine = None
        self.state: dict = {}

    @property
    def eof(self) -> int:
        return self.cfg["model"]["eof_token_id"]

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def prepare(cell: dict, cfg: dict, traffic: dict, seed: int, device):
    """The set-up of a run: the kernels built, the weights made, the
    engine built and warmed by the loop. Returns (harness, loop)."""
    h = Harness(cell, cfg, traffic, seed, device)
    loop = spec.loop(traffic["loop"])
    if device.type == "cuda":
        from min_llm_inference_tpu_torch.ops import _build
        with h.spans.span("setup.build"):
            _build.build()
    with h.spans.span("setup.weights"):
        h.params = spec.arch(cfg["arch"]).make_weights(cfg, seed, device)
    loop.setup(h)
    h.sync()
    return h, loop


class ProgramWindow:
    """What the program counted over a window, for the per-layer readers:
    made as the window starts (it zeroes the global ``PhaseStats`` and the
    ``ThroughputCounter``'s admission waits, and notes the engine's
    slot-rounds and each counted kernel wrapper's launches), read by
    ``close`` as it ends, before the traced stretch."""

    def __init__(self, h) -> None:
        from min_llm_inference_tpu_torch.metrics import \
            get_global_throughput_counter
        from min_llm_inference_tpu_torch.ops import _build
        from min_llm_inference_tpu_torch.utils.profiling import \
            get_global_phase_stats
        self.h = h
        self.phases = get_global_phase_stats()
        self.counter = get_global_throughput_counter()
        self.wrappers = list(_build.COUNTED)
        self.phases.reset()
        self.counter.ttfts.clear()
        self.slot_rounds = h.engine.stats.slot_rounds
        self.launches = [w.launches for w in self.wrappers]

    def close(self, win: dict) -> dict:
        """``device_s``: device seconds by phase (from graphs captured with
        tracing on, folded at each run's final pull); ``slot_rounds``: the
        engine's executed slot-rounds; ``served_tokens``: the tokens of the
        window's requests; ``ttfts``: the counter's admission waits (s);
        ``launches``: each counted kernel wrapper's launches."""
        return {
            "device_s": dict(self.phases.device_seconds),
            "slot_rounds": self.h.engine.stats.slot_rounds
            - self.slot_rounds,
            "served_tokens": sum(len(s) for _, s in win["requests"]),
            "ttfts": list(self.counter.ttfts),
            "launches": {w.__name__: w.launches - n
                         for w, n in zip(self.wrappers, self.launches)},
        }


def span_share(program: dict | None, name: str) -> float | None:
    """100 x the device seconds of the program's span ``name`` over those
    of ``burst`` in a window; None where either span is absent."""
    spans = (program or {}).get("device_s", {})
    if not spans.get("burst") or name not in spans:
        return None
    return 100.0 * spans[name] / spans["burst"]


def run(cell_name: str, seed: int, seconds: float, traced: bool, device,
        bench: dict | None = None, t_start: float | None = None,
        cfg: dict | None = None, traffic: dict | None = None,
        control: bool = False) -> tuple:
    """One run. Returns (result dict, the compared numbers with their
    limits). ``cfg``/``traffic`` replace the cell's files (tests);
    ``control`` also judges the control (the reference at the precision
    below the configuration's, read on the same requests) by the same
    checks and limits, as ``result["control"]``; it never enters the
    run's own ``correct``."""
    t_start = process_start() if t_start is None else t_start
    bench = bench or spec.benchmark()
    cell = spec.cell(bench, cell_name)
    cfg = cfg or spec.config(cell["config"])
    traffic = traffic or spec.traffic(cell["traffic"])
    device = torch.device(device)
    if traced:
        from min_llm_inference_tpu_torch.utils.profiling import set_tracing
        tracing_was = set_tracing(True)
    try:
        return _run(cell, cfg, traffic, seed, seconds, traced, device,
                    bench, t_start, control)
    finally:
        if traced:
            set_tracing(tracing_was)


def _run(cell, cfg, traffic, seed, seconds, traced, device, bench, t_start,
         control):
    cell_name = cell["name"]
    h, loop = prepare(cell, cfg, traffic, seed, device)
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    captures0 = h.engine.stats.captures
    print(f"set-up: {setup_s:.4f} s, graph captures {captures0}",
          file=sys.stderr)

    # what set-up made lives on: a full collection in the window need not
    # walk it
    gc.collect()
    gc.freeze()
    program = ProgramWindow(h) if traced else None
    win = loop.window(h, seconds)
    if program is not None:
        program = program.close(win)
    window_captures = h.engine.stats.captures - captures0
    print(f"window: graph captures {window_captures}", file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, \
            record_function
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        t0 = time.perf_counter()
        with profile(activities=acts) as p:
            with record_function(trace.STRETCH):
                stretch = loop.profiled(h)
            h.sync()
            t1 = time.perf_counter()
        t2 = time.perf_counter()
        prof = trace.reduce(p) if device.type == "cuda" else {}
        prof["requests"] = stretch["requests"]
        del p
        print(f"trace: stretch {t1 - t0:.2f} s, profiler stop "
              f"{t2 - t1:.2f} s, reduction {time.perf_counter() - t2:.2f} "
              f"s, {prof.get('device_events', 0)} device events",
              file=sys.stderr)

    sample = check.sample(win["requests"], seed,
                          traffic["check_requests"])
    gc.unfreeze()
    loop.close(h)
    h.engine = None
    h.state.clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    no_tf32()
    t0 = time.perf_counter()
    nums = check.read(cfg, h.params, sample, control=control)
    print(f"check: {nums['served_tokens']} served tokens of {len(sample)} "
          f"requests against the reference in "
          f"{time.perf_counter() - t0:.2f} s", file=sys.stderr)
    # the served stream's own numbers; the gap is the program's, or in
    # the control's verdict the control's, against the same limit
    stream = {
        "length_faults": [nums["length_faults"], 0],
        "unfinished": [win["failed"], 0],
        "window_captures": [window_captures, 0],
    }
    limit = cfg["check"]["max_gap_sd"]
    checks = {"gap_sd": [nums["max_gap_sd"], limit], **stream}
    correct = passes(checks)

    run_info = types.SimpleNamespace(cfg=cfg, traffic=traffic,
                                     setup_s=setup_s, window=win,
                                     profile=prof, program=program)
    group = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(bench, cell_name, group):
        value = spec.metric(m["name"]).read(run_info)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else str(device)),
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics, "device": dev}
    if traced and device.type == "cuda":
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
        result["breakdown"] = trace.breakdown(prof)
    if control:
        ctl = {"gap_sd": [nums["control_max_gap_sd"], limit], **stream}
        result["control"] = {"correct": passes(ctl), "check": shown(ctl),
                             "served_tokens": nums["served_tokens"]}
    result["check"] = shown(checks)
    return result, checks


def passes(checks: dict) -> bool:
    """``correct``: every compared number within its limit."""
    return all(v <= lim for v, lim in checks.values())


def shown(checks: dict) -> dict:
    return {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
