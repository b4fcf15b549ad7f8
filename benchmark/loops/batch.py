"""Offline batches: ``AutonomousEngine.run`` on whole batches of the mix,
back to back.

The mix gives ``requests_per_batch``, ``prompt_len``, ``bursts_per_chunk``
(bursts between the engine's status reads), ``warm_requests`` (the
warm-up batch, whose longest prompt is the mix's, so that it has the
window's queue shape and captures the graphs the window replays) and
``profile_seconds`` (the traced stretch: whole batches until it lasts that
long).

The window runs batches until the first batch end at or after
``seconds``; each batch is a fresh draw from the seed.
"""

from __future__ import annotations

import sys
import time

from min_llm_inference_tpu_torch.metrics import get_global_throughput_counter
from min_llm_inference_tpu_torch.runtime.item_storage import (
    ItemStorage,
    Request,
)

from benchmark import generate
from benchmark.engine import make_engine
from benchmark.records import Served

WINDOW, WARM, PROFILED = 1, 3, 4   # generator streams


def serve(h, prompts: list, id0: int) -> dict:
    """One batch through ``engine.run``: its wall (host clock; the run ends
    in a blocking pull of the outputs), tokens served, decode rounds, and
    the requests as (prompt, served) pairs."""
    eng = h.engine
    get_global_throughput_counter().reset()
    store = ItemStorage()
    for i, p in enumerate(prompts):
        store.add_new_item(Request(id0 + i, list(p)))
    rounds0 = eng.stats.rounds
    with h.spans.span("batch"):
        t0 = time.perf_counter()
        eng.run(store)
        wall = time.perf_counter() - t0
    reqs = Served()
    for i, p in enumerate(prompts):
        reqs.add(p, store.finished[id0 + i].tokens[len(p):])
    return {"wall": wall, "tokens": sum(len(s) for s in reqs.served),
            "rounds": eng.stats.rounds - rounds0, "requests": reqs}


def _batch(h, stream: int, index: int, n: int) -> list:
    return generate.batch(h.seed, index, n, h.traffic["prompt_len"], h.eof,
                          stream)


def setup(h) -> None:
    n = h.traffic["requests_per_batch"]
    with h.spans.span("setup.engine"):
        h.engine = make_engine(h, n)
    with h.spans.span("setup.warm"):
        serve(h, _batch(h, WARM, 0, h.traffic["warm_requests"]), 0)


def _run(h, stream: int, seconds: float) -> dict:
    n = h.traffic["requests_per_batch"]
    t_end = time.perf_counter() + seconds
    out = {"walls": [], "tokens": [], "rounds": 0, "requests": Served()}
    b = 0
    while True:
        rec = serve(h, _batch(h, stream, b, n), b * n)
        out["walls"].append(rec["wall"])
        out["tokens"].append(rec["tokens"])
        out["rounds"] += rec["rounds"]
        out["requests"].extend(rec["requests"])
        b += 1
        if time.perf_counter() >= t_end:
            break
    w = out["walls"]
    print(f"batches: {len(w)}, walls {min(w):.4f}-{max(w):.4f} s, "
          f"tokens {sum(out['tokens'])}", file=sys.stderr)
    out["attempted"] = len(out["requests"])
    out["failed"] = 0   # engine.run raises on a request left unfinished
    return out


def window(h, seconds: float) -> dict:
    return _run(h, WINDOW, seconds)


def profiled(h) -> dict:
    return _run(h, PROFILED, h.traffic["profile_seconds"])


def close(h) -> None:
    h.engine = None
