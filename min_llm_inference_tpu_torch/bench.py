"""Headline benchmark of the port: paged continuous-batching decode
throughput, with bench.py's command line.

    python -m min_llm_inference_tpu_torch.bench [bench.py's flags] \\
        [--device cpu]

The workload of the reference's profile test: 1024 slots, 4096 pages,
n_seq 128, emb 2048, vocab 1024; 2048 requests with prompt lengths uniform
in [1, 64]; uniform(0, 1) weights with the EOF embedding row scaled by
1.0001, so that sequences run to the n_seq cap. The flags, the per-model
defaults (``resolve``), the weights (drawn from ``np.random.default_rng(0)``
in bench.py's order), the request draws and the one JSON line are
bench.py's; ``--attention`` keeps its names (``jnp``, ``pallas``,
``grouped``: the port's ``torch``, ``paged``, ``grouped``) so that one
command line runs on both packages.

One engine serves the warm run and every timed run. The port's CUDA graphs
belong to the engine (one captured program per queue shape), so a new
engine per run would capture again inside the timed window; the timed
runs replay what the warm run captured. ``--phase-stats`` turns the
program's tracing on (utils/profiling: the graphs the warm run captures
time their phases on the device) and writes the phase times, host seconds
and beside them the device seconds of the phases inside a burst graph, and
the timed runs' capture count to stderr.

Runs on ``cuda`` unless ``--device`` names another; without a GPU it
raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from .config import EngineConfig, ModelConfig, resolve_device
from .metrics import get_global_throughput_counter
from .models.params import init_params, params_from_numpy
from .runtime.autonomous import AutonomousEngine
from .runtime.engine import PagedEngine
from .runtime.item_storage import ItemStorage, Request
from .utils.profiling import (
    get_global_phase_stats,
    set_tracing,
    trace,
    tracing,
)

# The reference C++/CUDA engine's published throughput (its README, best
# lineage), measured on an unspecified NVIDIA GPU; kept so that
# ``vs_baseline`` keeps its meaning in the JSON line.
BASELINE_TOK_S = 123284.0
# bench.py's --attention names -> the port's attention_impl
ATTENTION = {"jnp": "torch", "pallas": "paged", "grouped": "grouped"}


def device_name(device: torch.device) -> str:
    """The ``device`` of an output line: the card's name, or ``cpu``."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def ref_model(n_vocab: int = 1024, emb_dim: int = 2048, n_seq: int = 128,
              dtype: str = "bfloat16") -> ModelConfig:
    """The reference-parity single attention block (``--model ref``)."""
    return ModelConfig(n_vocab=n_vocab, emb_dim=emb_dim, n_seq=n_seq,
                       eof_token_id=n_vocab - 1, dtype=dtype)


def gpt2s_model(n_vocab: int = 1024, n_seq: int = 128,
                dtype: str = "bfloat16") -> ModelConfig:
    """The 12-layer GPT-2-small-class stack (``--model gpt2s``)."""
    return ModelConfig(n_vocab=n_vocab, emb_dim=768, n_seq=n_seq,
                       n_layers=12, n_heads=12, ffn_dim=3072,
                       use_output_proj=True, use_layernorm=True,
                       eof_token_id=n_vocab - 1, dtype=dtype)


def bench_tree(rng, model_cfg: ModelConfig) -> dict:
    """bench.py's weights as a float32 numpy tree: uniform(0, 1) like the
    reference's curand init, the EOF row scaled by 1.0001 in float32, drawn
    in bench.py's order (wte, wpe, wq, wk, wv)."""
    V, D, S = model_cfg.n_vocab, model_cfg.emb_dim, model_cfg.n_seq

    def u(shape):
        return rng.random(shape, dtype=np.float32)

    wte = u((V, D))
    wte[model_cfg.eof_token_id] *= 1.0001
    wpe = u((S, D))
    wq, wk, wv = u((D, D)), u((D, D)), u((D, D))
    return {"wte": wte, "wpe": wpe,
            "layers": [{"wq": wq, "wk": wk, "wv": wv}]}


def bench_params(rng, model_cfg: ModelConfig, device=None) -> dict:
    """bench_tree on ``device`` in ``model_cfg.dtype`` (rounded to nearest
    even, as ``jnp.asarray(x, bfloat16)`` rounds)."""
    return params_from_numpy(bench_tree(rng, model_cfg), model_cfg, device)


def ref_params(device=None) -> dict:
    """bench.py's weights of the reference model at its default widths."""
    return bench_params(np.random.default_rng(0), ref_model(), device)


def draw_prompts(rng, n: int, max_prompt: int, n_vocab: int) -> list:
    """bench.py's request draws: per request a length uniform in
    [1, max_prompt], then that many tokens below the EOF id."""
    out = []
    for _ in range(n):
        ln = int(rng.integers(1, max_prompt + 1))
        out.append(rng.integers(0, n_vocab - 1, ln).tolist())
    return out


def make_store(prompts) -> ItemStorage:
    """A request store of ``prompts``, request i holding prompts[i]."""
    store = ItemStorage()
    for i, p in enumerate(prompts):
        store.add_new_item(Request(i, list(p)))
    return store


def build_store(rng, n: int, max_prompt: int, n_vocab: int) -> ItemStorage:
    return make_store(draw_prompts(rng, n, max_prompt, n_vocab))


@dataclasses.dataclass(frozen=True)
class RunOptions:
    """What a bench run does besides the two configs: the engine
    (``auto`` or ``host``), the port's attention_impl, the autonomous
    engine's chunk, admissions per burst and drain floor (None: off), the
    warm run's request count (None: no warm run), the prompt-length cap,
    the timed runs' request count (also the autonomous engine's request
    capacity, so that warm and timed queues share one shape) and
    number."""

    engine: str
    attention: str
    bursts_per_chunk: int
    max_new: int
    min_drain_slots: int | None
    n_warm: int | None
    max_prompt: int
    requests: int
    repeats: int


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m min_llm_inference_tpu_torch.bench",
        description=__doc__.split("\n")[0])
    ap.add_argument("--slots", type=int, default=1024)
    ap.add_argument("--pages", type=int, default=4096)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--emb", type=int, default=2048)
    ap.add_argument("--vocab", type=int, default=1024)
    ap.add_argument("--requests", type=int, default=2048)
    ap.add_argument("--rounds", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=32)
    ap.add_argument("--init-pages", type=int, default=2)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--kv-dtype", default=None,
                    help="KV cache dtype (default: int4 for ref, int8 under "
                         "--overcommit or --attention pallas; int8 for "
                         "gpt2s, whose dgrid partial takes no packed int4)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed runs; the median by tok/s is reported")
    ap.add_argument("--attention", default="grouped",
                    choices=["jnp", "pallas", "grouped"],
                    help="jnp: gather oracle (torch); pallas: one-slot "
                         "kernel (paged); grouped: fused-write kernel")
    ap.add_argument("--max-prefill-batch", type=int, default=128)
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--warm-requests", type=int, default=None,
                    help="warm-run request count (default min(slots, 64)); "
                         "overcommit admits other slot counts than full "
                         "grant, so its warm run takes the timed count")
    ap.add_argument("--engine", default="auto", choices=["host", "auto"],
                    help="auto: AutonomousEngine (scheduler on the device, "
                         "a burst per CUDA graph); host: PagedEngine")
    ap.add_argument("--model", default="ref", choices=["ref", "gpt2s"],
                    help="ref = reference-parity single attention block; "
                         "gpt2s = 12-layer GPT-2-small-class stack")
    ap.add_argument("--bursts-per-chunk", type=int, default=None,
                    help="bursts dispatched per status read (default 24 "
                         "for ref, 6 for gpt2s)")
    ap.add_argument("--max-new-per-burst", type=int, default=512)
    ap.add_argument("--min-drain-slots", type=int, default=None,
                    help="drain-downshift floor (default: off for ref, 512 "
                         "for gpt2s)")
    ap.add_argument("--pages-per-dma", type=int, default=None,
                    help="TPU kernel DMA run length; accepted and validated, "
                         "not read by the port")
    ap.add_argument("--attn-group", type=int, default=None,
                    help="TPU grouped-kernel slots per grid step; accepted, "
                         "not read by the port")
    ap.add_argument("--subbursts", type=int, default=None,
                    help="admit+decode+flush bodies per burst (default 2 "
                         "for ref, 1 for gpt2s)")
    ap.add_argument("--attn-dense", action="store_true",
                    help="dense-view page partial over full-grant group "
                         "rows (ring decode)")
    ap.add_argument("--attn-dgrid", action="store_true",
                    help="dgrid page partial over full-grant group rows "
                         "(default on for gpt2s, off for ref)")
    ap.add_argument("--no-attn-dgrid", action="store_true",
                    help="force the grouped kernel on gpt2s")
    ap.add_argument("--sort-admits", action="store_true",
                    help="sort each admission wave by prompt length "
                         "(default on for gpt2s)")
    ap.add_argument("--no-sort-admits", action="store_true")
    ap.add_argument("--dgrid-block", type=int, default=None,
                    help="TPU dgrid group-block rows; accepted, not read "
                         "by the port")
    ap.add_argument("--no-burst-flush", action="store_true",
                    help="flush the decode ring per sub-burst instead of "
                         "once per burst")
    ap.add_argument("--overcommit", action="store_true",
                    help="half-group grants + growth + youngest-first "
                         "preemption (pair with a reduced --pages)")
    ap.add_argument("--no-ring", action="store_true",
                    help="no decode ring: per-round fused page writes "
                         "(default for ref; gpt2s defaults to the ring)")
    ap.add_argument("--ring", action="store_true",
                    help="force the decode ring on")
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="trace ONE timed run with torch.profiler into "
                         "LOGDIR (trace.json)")
    ap.add_argument("--phase-stats", action="store_true",
                    help="trace the engine's phases (host wall times; "
                         "device times inside burst graphs) and print them "
                         "and the timed runs' graph captures to stderr")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def resolve(args) -> tuple:
    """bench.py's per-model defaults: (ModelConfig, EngineConfig,
    RunOptions) of parsed ``args``, resolved as bench.py resolves them."""
    gpt2s = args.model == "gpt2s"
    if gpt2s:
        model_cfg = gpt2s_model(args.vocab, args.seq, args.dtype)
    else:
        model_cfg = ref_model(args.vocab, args.emb, args.seq, args.dtype)
    kv_dtype = args.kv_dtype or ("int8" if gpt2s else "int4")
    # bench.py keeps overcommit and the one-slot kernel on int8 when int4
    # was only defaulted
    if kv_dtype == "int4" and args.kv_dtype is None and (
            args.overcommit or args.attention == "pallas"):
        kv_dtype = "int8"
    engine_cfg = EngineConfig(
        n_slots=args.slots, n_pages=args.pages,
        n_forward_rounds=args.rounds,
        page_size=args.page_size, init_num_pages=args.init_pages,
        kv_dtype=kv_dtype,
        max_prefill_batch=args.max_prefill_batch,
        pages_per_dma=args.pages_per_dma,
        attn_group_size=args.attn_group,
        decode_ring=args.ring or (gpt2s and not args.no_ring),
        attn_dense=args.attn_dense,
        # the dgrid default drops out whenever its preconditions do: it
        # implements the ring-partial contract and takes no packed int4
        attn_dgrid=(args.attn_dgrid or
                    (gpt2s and not args.no_attn_dgrid
                     and not args.no_ring and kv_dtype != "int4"
                     and not args.overcommit and not args.attn_dense)),
        dgrid_block=args.dgrid_block,
        sort_admits=((args.sort_admits or gpt2s)
                     and not args.no_sort_admits),
        subbursts=(args.subbursts if args.subbursts is not None
                   else (1 if gpt2s else 2)),
        burst_flush=not args.no_burst_flush,
        overcommit=args.overcommit,
    )
    min_drain = args.min_drain_slots
    if min_drain is None and gpt2s:
        min_drain = 512
    opts = RunOptions(
        engine=args.engine,
        attention=ATTENTION[args.attention],
        bursts_per_chunk=(args.bursts_per_chunk
                          if args.bursts_per_chunk is not None
                          else (6 if gpt2s else 24)),
        max_new=args.max_new_per_burst,
        min_drain_slots=min_drain,
        n_warm=(None if args.no_warmup
                else args.warm_requests or min(args.slots, 64)),
        max_prompt=min(64, args.seq // 2),
        requests=args.requests,
        # a profile traces exactly the one timed run
        repeats=1 if args.profile else max(1, args.repeats),
    )
    return model_cfg, engine_cfg, opts


def make_engine(params, model_cfg, engine_cfg, opts: RunOptions, device):
    """The one engine of a bench run."""
    if opts.engine == "auto":
        return AutonomousEngine(
            params, model_cfg, engine_cfg, attention_impl=opts.attention,
            bursts_per_chunk=opts.bursts_per_chunk,
            request_capacity=opts.requests, max_new_per_burst=opts.max_new,
            min_drain_slots=opts.min_drain_slots or engine_cfg.n_slots,
            device=device)
    return PagedEngine(params, model_cfg, engine_cfg,
                       attention_impl=opts.attention, device=device)


def _captures(engine) -> int:
    return getattr(engine.stats, "captures", 0)


def run(args) -> tuple:
    """One bench run of parsed ``args``: (bench.py's result dict, extra)
    where extra holds every timed run in run order (``runs``), the warm
    and timed runs' graph captures and the phase stats summary. With
    ``--phase-stats`` the program's tracing is on for the run."""
    prev = set_tracing(args.phase_stats or tracing())
    try:
        return _run(args)
    finally:
        set_tracing(prev)


def _run(args) -> tuple:
    device = resolve_device(args.device)
    model_cfg, engine_cfg, opts = resolve(args)
    rng = np.random.default_rng(0)
    if args.model == "gpt2s":
        params = init_params(0, model_cfg, device=device)
    else:
        params = bench_params(rng, model_cfg, device)
    engine = make_engine(params, model_cfg, engine_cfg, opts, device)
    del params

    if opts.n_warm is not None:
        # the warm run captures the engine's graphs (one per executed
        # width) for the queue shape the timed runs share: capacity
        # --requests, prompts padded to the bucket of the longest
        engine.run(build_store(rng, opts.n_warm, opts.max_prompt,
                               args.vocab))
    warm_captures = _captures(engine)

    # The timed runs replay the warm run's graphs. This order also keeps
    # --profile clear of a CUDA/CUPTI fault: a graph with conditional
    # nodes captured after a torch.profiler session has traced the card
    # can fault when replayed under a later session, while graphs captured
    # before any session trace cleanly; so every capture precedes the one
    # profiled run.
    counter = get_global_throughput_counter()
    runs = []
    for _ in range(opts.repeats):
        counter.reset()  # before submits, for TTFT
        get_global_phase_stats().reset()
        store = build_store(rng, opts.requests, opts.max_prompt, args.vocab)
        t0 = time.perf_counter()
        with trace(args.profile):
            engine.run(store)  # ends in a blocking pull of the outputs
        wall = time.perf_counter() - t0
        runs.append({
            "wall": wall,
            "tok_s": counter.total_tokens / wall,
            "total_tokens": counter.total_tokens,
            "counter_seconds": counter.elapsed_seconds,
            "p50_ttft_ms": counter.ttft_percentile(0.5) * 1e3,
        })
    timed_captures = _captures(engine) - warm_captures
    ranked = sorted(runs, key=lambda r: r["tok_s"])
    # lower-middle median for even counts (the upper one is a best-of bias)
    med = ranked[(len(ranked) - 1) // 2]
    tok_s = med["tok_s"]
    result = {
        "metric": "decode_tokens_per_s",
        "value": round(tok_s, 1),
        "unit": "tok/s",
        "vs_baseline": round(tok_s / BASELINE_TOK_S, 4),
        "total_tokens": med["total_tokens"],
        "seconds": round(med["wall"], 3),
        "counter_seconds": round(med["counter_seconds"], 3),
        "runs_tok_s": [round(r["tok_s"], 1) for r in ranked],
        "p50_ttft_ms": round(med["p50_ttft_ms"], 1),
        "config": {
            "slots": args.slots, "pages": args.pages, "seq": args.seq,
            "emb": args.emb, "vocab": args.vocab, "requests": args.requests,
            "dtype": args.dtype, "kv_dtype": engine_cfg.kv_dtype,
            "attention": args.attention, "rounds": args.rounds,
            "engine": args.engine, "model": args.model,
            "subbursts": engine_cfg.subbursts,
            "decode_ring": engine_cfg.decode_ring,
            "sort_admits": engine_cfg.sort_admits,
            "page_size": args.page_size,
            "bursts_per_chunk": opts.bursts_per_chunk,
            "min_drain_slots": opts.min_drain_slots,
            "overcommit": args.overcommit,
            "attn_variant": ("dgrid" if engine_cfg.attn_dgrid else
                             "dense" if engine_cfg.attn_dense else
                             "default"),
            "device": device_name(device),
        },
    }
    extra = {"runs": runs, "warm_captures": warm_captures,
             "timed_captures": timed_captures,
             "phase_stats": get_global_phase_stats().summary()}
    return result, extra


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    result, extra = run(args)
    if args.phase_stats or args.profile:
        print(json.dumps({"phase_stats": extra["phase_stats"],
                          "timed_captures": extra["timed_captures"]}),
              file=sys.stderr)
    if args.profile:
        print(f"profiler trace written to {args.profile}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
