"""An open loop: independent users whose requests arrive on a schedule,
served by ``StreamingSession``'s chunked loop (``submit``, ``step`` with
the status and completions in one read, ``poll``).

The mix gives ``arrival`` (the process and its rate), ``prompt_len``,
``bursts_per_chunk`` (bursts between the client's status reads),
``session_capacity`` (rows of the session's request ring),
``warm_requests``, ``drain_seconds`` (how long after the window the run
waits for the requests still in flight) and ``profile_seconds`` (the
traced stretch of arrivals after the window).

Each request's latency runs from its scheduled arrival to the status read
that saw it finish, so a request held back by a full ring or a slow step
is charged its wait. Requests due after the window are never sent; those
in flight when it closes are drained, and any still unfinished after
``drain_seconds`` count as failed.
"""

from __future__ import annotations

import time

import numpy as np

from min_llm_inference_tpu_torch.runtime.autonomous import StreamingSession
from min_llm_inference_tpu_torch.runtime.item_storage import Request

from benchmark import generate
from benchmark.engine import make_engine
from benchmark.records import Served

WINDOW, WARM, PROFILED = 2, 3, 5   # generator streams


def _session(h) -> StreamingSession:
    return StreamingSession(h.engine, h.traffic["session_capacity"],
                            h.traffic["prompt_len"]["max"])


def setup(h) -> None:
    with h.spans.span("setup.engine"):
        h.engine = make_engine(h, None)
    with h.spans.span("setup.warm"):
        # the first submit, step, poll and close of a session
        warm = _session(h)
        prompts = generate.batch(h.seed, 0, h.traffic["warm_requests"],
                                 h.traffic["prompt_len"], h.eof, WARM)
        warm.submit([Request(i, list(p)) for i, p in enumerate(prompts)])
        s = warm.step(observe=True)
        warm.poll(s["fin_lens"], s["n_submitted_at"])
        warm.close()
        del warm
        # the session the window serves; its graph is captured here
        h.state["session"] = _session(h)
        h.state["next_id"] = 0


def serve(h, stream: int, seconds: float) -> dict:
    """Serve arrivals due in the next ``seconds``, then drain them."""
    sess = h.state["session"]
    arrivals = generate.Arrivals(h.seed, h.traffic, h.eof, stream)
    drain = h.traffic["drain_seconds"]
    sched, done, prompts, served = {}, {}, {}, {}
    backlog = []
    reads, queued = [], []
    syncs0, bursts0 = sess.stats.host_syncs, sess.stats.bursts
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while True:
        now = time.perf_counter()
        if now < t_end:
            due, when = arrivals.take(now - t0)
            for p, t in zip(due, when):
                rid = h.state["next_id"]
                h.state["next_id"] += 1
                sched[rid] = t0 + float(t)
                prompts[rid] = np.asarray(p, dtype=np.int32)
                backlog.append(Request(rid, list(p)))
        k = min(len(backlog), sess.free_capacity)
        if k:
            with h.spans.span("submit"):
                sess.submit(backlog[:k])
            backlog = backlog[k:]
        with h.spans.span("step"):
            s = sess.step(observe=True)
        t_read = time.perf_counter()
        reads.append(t_read)
        queued.append(s["queued"] + len(backlog))
        with h.spans.span("poll"):
            for r in sess.poll(s["fin_lens"], s["n_submitted_at"]):
                done[r.id] = t_read
                served[r.id] = np.asarray(r.tokens[r.prompt_len:],
                                          dtype=np.int32)
        if t_read >= t_end and not backlog and len(done) == len(sched):
            break
        if t_read >= t_end + drain:
            break
    in_window = [t for t in reads if t <= t_end]
    reqs = Served()
    for i in sorted(done):
        reqs.add(prompts[i], served[i])
    return {
        "queued": queued[:len(in_window)],
        "latencies": [done[i] - sched[i] for i in done],
        "reads": in_window,
        "host_syncs": sess.stats.host_syncs - syncs0,
        "bursts": sess.stats.bursts - bursts0,
        "requests": reqs,
        "attempted": len(sched),
        "failed": len(sched) - len(done),
    }


def window(h, seconds: float) -> dict:
    return serve(h, WINDOW, seconds)


def profiled(h) -> dict:
    return serve(h, PROFILED, h.traffic["profile_seconds"])


def close(h) -> None:
    h.state.pop("session", None)
    h.engine = None
