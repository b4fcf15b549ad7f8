"""Online-serving benchmark: StreamingSession under staggered or open-loop
arrivals, with the command line of the JAX package's tools/serving_bench.py.

    python -m min_llm_inference_tpu_torch.tools.serving_bench \\
        [--requests 2048] [--waves 4] [--arrival-rate REQ_S] [--pipelined] \\
        [--out FILE] [--device cpu]

The headline bench (``min_llm_inference_tpu_torch.bench``) queues every
request up front. Here requests arrive while the engine runs: in
``--waves`` equal waves (closed loop), or at ``--arrival-rate`` requests a
second on a virtual clock (open loop, latency counted from each request's
scheduled arrival), at the bench's shapes and weights. It reports the
served tokens per second and completion-latency percentiles, observed at
poll granularity: a chunk of bursts (the default loop), or a burst read
``--observe-lag`` bursts late (``--pipelined``). Prints ONE JSON line
(also written to ``--out``).

Runs on ``cuda`` unless ``--device`` names another; without a GPU it
raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..bench import (
    BASELINE_TOK_S,
    bench_params,
    device_name,
    draw_prompts,
    ref_model,
)
from ..config import EngineConfig, resolve_device
from ..runtime.autonomous import AutonomousEngine, StreamingSession
from ..runtime.item_storage import Request


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m min_llm_inference_tpu_torch.tools.serving_bench",
        description=__doc__.split("\n")[0])
    ap.add_argument("--slots", type=int, default=1024)
    ap.add_argument("--pages", type=int, default=4096)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--emb", type=int, default=2048)
    ap.add_argument("--vocab", type=int, default=1024)
    ap.add_argument("--requests", type=int, default=2048)
    ap.add_argument("--waves", type=int, default=4,
                    help="requests arrive in this many equal waves, one "
                         "submitted before each early engine step")
    ap.add_argument("--rounds", type=int, default=16)
    ap.add_argument("--kv-dtype", default="int8")
    ap.add_argument("--max-prompt", type=int, default=64)
    # smaller than the batch bench's 24: the chunk is the serving quantum
    # (arrivals are admitted and completions observed at its boundaries)
    ap.add_argument("--bursts-per-chunk", type=int, default=6)
    ap.add_argument("--chunked", dest="pipelined", action="store_false",
                    help="(default) chunk-quantum loop: step + poll")
    ap.add_argument("--pipelined", dest="pipelined", action="store_true",
                    help="per-burst dispatch/observe/poll loop")
    ap.set_defaults(pipelined=False)
    ap.add_argument("--observe-lag", type=int, default=2)
    ap.add_argument("--subbursts", type=int, default=2,
                    help="in-burst admission granularity (see bench)")
    ap.add_argument("--overcommit", action="store_true",
                    help="half-group grants + growth + youngest-first "
                         "preemption (pair with a reduced --pages)")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    metavar="REQ_S",
                    help="open-loop arrival rate (requests/second); "
                         "overrides --waves")
    ap.add_argument("--trace", action="store_true",
                    help="print per-iteration wall/made/finished lines")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def resolve(args) -> tuple:
    """(ModelConfig, EngineConfig) of parsed ``args``: the reference
    model in bfloat16, the session's engine."""
    model_cfg = ref_model(args.vocab, args.emb, args.seq, "bfloat16")
    engine_cfg = EngineConfig(
        n_slots=args.slots, n_pages=args.pages, page_size=32,
        n_forward_rounds=args.rounds, kv_dtype=args.kv_dtype,
        subbursts=args.subbursts, overcommit=args.overcommit,
    )
    return model_cfg, engine_cfg


def serve(args, model_cfg, engine_cfg) -> tuple:
    """One serving run: (the result dict, {request id: finished
    Request})."""
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    params = bench_params(rng, model_cfg, device)

    def make_requests(n, id0=0):
        prompts = draw_prompts(rng, n, args.max_prompt, args.vocab)
        return [Request(id0 + i, p) for i, p in enumerate(prompts)]

    eng = AutonomousEngine(params, model_cfg, engine_cfg,
                           bursts_per_chunk=args.bursts_per_chunk,
                           max_new_per_burst=512, device=device)
    del params

    # warm: the first launches of every path the timed run takes (the
    # burst, the wave-sized and power-of-two submits, the fused and the
    # pipelined status reads), the pinned staging and the allocator. The
    # JAX bench also compiles its power-of-two poll gathers here; the
    # port's gather is one index_select and compiles nothing.
    wave = args.requests // args.waves
    warm = StreamingSession(eng, capacity=args.requests,
                            max_prompt_len=args.max_prompt)
    warm.submit(make_requests(wave))
    if args.arrival_rate:
        made, k = wave, 1
        while k <= 512 and made + k <= args.requests:
            warm.submit(make_requests(k, id0=made))
            made += k
            k *= 2
    warm.step()
    warm.poll()
    warm.dispatch()
    warm.observe(block=True)
    warm.close()
    del warm

    # the timed session captures its graph when it is made, before t0
    sess = StreamingSession(eng, capacity=args.requests,
                            max_prompt_len=args.max_prompt,
                            observe_lag=args.observe_lag)
    submit_t = {}
    done_t = {}
    done = {}
    n_gen = 0
    t0 = time.perf_counter()
    made = 0

    def collect(reqs, now):
        nonlocal n_gen
        for r in reqs:
            done_t[r.id] = now
            done[r.id] = r
            n_gen += len(r.tokens) - r.prompt_len

    def feed_open_loop():
        """Submit every request whose scheduled arrival time has passed,
        in power-of-two batches; latency counts from the scheduled
        arrival, so backpressure delay is charged to the engine."""
        nonlocal made
        due = min(int((time.perf_counter() - t0) * args.arrival_rate),
                  args.requests)
        while made < due:
            k = min(due - made, sess.free_capacity, 512)
            if k <= 0:
                break
            k = 1 << (k.bit_length() - 1)
            reqs = make_requests(k, id0=made)
            for j, r in enumerate(reqs):
                submit_t[r.id] = t0 + (made + j) / args.arrival_rate
            sess.submit(reqs)
            made += k

    def feed_wave():
        nonlocal made
        reqs = make_requests(min(wave, args.requests - made), id0=made)
        now = time.perf_counter()
        for r in reqs:
            submit_t[r.id] = now
        sess.submit(reqs)
        made += len(reqs)

    if not args.pipelined:
        # chunk-quantum loop: admission and observation at chunk
        # boundaries
        while made < args.requests or len(done_t) < args.requests:
            if args.arrival_rate:
                feed_open_loop()
            elif made < args.requests:
                feed_wave()
            # open-loop arrivals finish requests nearly every chunk, so
            # the final_lens snapshot rides in the status read (step's
            # observe mode); closed-loop waves finish in bunches and poll
            # with a read of their own only when something finished
            s = sess.step(observe=bool(args.arrival_rate))
            if s["finished_total"] > len(done_t):
                collect(sess.poll(s.get("fin_lens"),
                                  s.get("n_submitted_at")),
                        time.perf_counter())
            if args.trace:
                print(f"it wall={time.perf_counter()-t0:.3f} made={made} "
                      f"fin={s['finished_total']} coll={len(done_t)} "
                      f"live={s['live']}", flush=True)
    else:
        # pipelined loop: one burst an iteration, its status read
        # observe_lag bursts later, the device queue never drained by a
        # read
        collected = 0
        submit_every = max(1, args.bursts_per_chunk)
        i = 0
        while made < args.requests or len(done_t) < args.requests:
            if args.arrival_rate:
                feed_open_loop()
            elif made < args.requests and i % submit_every == 0:
                feed_wave()
            sess.dispatch()
            i += 1
            block = made >= args.requests and len(done_t) < made
            s = sess.observe(block=block)
            if s is not None and s["finished_total"] > collected:
                collected = s["finished_total"]
                collect(sess.poll(s["fin_lens"], s["n_submitted_at"]),
                        time.perf_counter())
        for r in sess.close():
            collect([r], time.perf_counter())
    wall = time.perf_counter() - t0

    lat = np.array(sorted(done_t[i] - submit_t[i] for i in done_t))
    result = {
        "metric": "serving_tokens_per_s",
        "value": round(n_gen / wall, 1),
        "unit": "tok/s",
        "vs_batch_baseline": round(n_gen / wall / BASELINE_TOK_S, 4),
        "total_tokens": n_gen,
        "seconds": round(wall, 3),
        "requests": args.requests,
        "arrival_waves": args.waves,
        "mode": "pipelined" if args.pipelined else "chunked",
        "arrival_rate_req_s": args.arrival_rate,
        "offered_tok_s": (round(args.arrival_rate * n_gen / args.requests, 1)
                          if args.arrival_rate else None),
        "completion_latency_s": {
            "p50": round(float(np.quantile(lat, 0.5)), 3),
            "p90": round(float(np.quantile(lat, 0.9)), 3),
            "p99": round(float(np.quantile(lat, 0.99)), 3),
        },
        "config": {
            "slots": args.slots, "pages": args.pages, "seq": args.seq,
            "emb": args.emb, "kv_dtype": args.kv_dtype,
            "rounds": args.rounds, "subbursts": args.subbursts,
            "bursts_per_chunk": args.bursts_per_chunk,
            "overcommit": args.overcommit,
            "device": device_name(device),
        },
    }
    return result, done


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    result, _ = serve(args, *resolve(args))
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
