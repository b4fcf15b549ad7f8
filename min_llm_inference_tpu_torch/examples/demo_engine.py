"""End-to-end demo: continuous-batching greedy decode through the port's
public API.

Runs the chosen backends over one synthetic request stream and prints the
finished sequences, throughput and token parity between the backends (the
JAX package's examples/demo_engine.py, line for line but for the device
line and the times).

    python -m min_llm_inference_tpu_torch.examples.demo_engine \\
        [--backend dense|paged|native|auto|streaming|both|all] [--n-items N] \\
        [--attention jnp|pallas|grouped] [--device cpu]

``--attention`` keeps the JAX names: jnp is the gather oracle (``torch``),
pallas the one-slot kernel (``paged``), grouped the fused-write kernel.
Runs on ``cuda`` unless ``--device`` names another; without a GPU it
raises.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..bench import ATTENTION, device_name
from ..config import EngineConfig, ModelConfig, resolve_device
from ..metrics import get_global_throughput_counter
from ..models.params import init_params
from ..runtime.autonomous import AutonomousEngine, StreamingSession
from ..runtime.engine import DenseEngine, NativePagedEngine, PagedEngine
from ..runtime.item_storage import ItemStorage, Request


def build_store(rng, n_items, model_cfg):
    store = ItemStorage()
    for i in range(n_items):
        ln = int(rng.integers(1, 24))
        store.add_new_item(
            Request(i, rng.integers(0, model_cfg.eof_token_id, ln).tolist())
        )
    return store


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m min_llm_inference_tpu_torch.examples.demo_engine",
        description=__doc__.split("\n")[0])
    ap.add_argument("--backend", default="both",
                    choices=["dense", "paged", "native", "auto", "streaming",
                             "both", "all"])
    ap.add_argument("--n-items", type=int, default=32)
    ap.add_argument("--attention", default="jnp",
                    choices=["jnp", "pallas", "grouped"])
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature for the auto backend "
                         "(0 = greedy; sampling is AutonomousEngine-only)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    attention = ATTENTION[args.attention]

    print(f"device: {device_name(device)}")
    model_cfg = ModelConfig(n_vocab=256, emb_dim=128, n_seq=64,
                            eof_token_id=255)
    engine_cfg = EngineConfig(n_slots=16, n_pages=16 * 6,
                              max_prefill_batch=8)
    params = init_params(0, model_cfg, eof_bias=0.05, device=device)

    outputs = {}
    if args.backend == "both":
        backends = ["dense", "paged"]
    elif args.backend == "all":
        backends = ["dense", "paged", "native", "auto", "streaming"]
    else:
        backends = [args.backend]
    for name in backends:
        rng = np.random.default_rng(42)
        counter = get_global_throughput_counter()
        counter.reset()
        store = build_store(rng, args.n_items, model_cfg)
        if name == "streaming":
            # online serving: submit in waves while the engine runs; greedy
            # determinism means outputs must match the one-shot backends
            eng = AutonomousEngine(params, model_cfg, engine_cfg,
                                   attention_impl=attention, device=device)
            reqs = store.pop_new_items(1 << 30)
            sess = StreamingSession(
                eng, capacity=len(reqs),
                max_prompt_len=max(len(r.tokens) for r in reqs),
            )
            t0 = time.perf_counter()
            third = max(1, len(reqs) // 3)
            sess.submit(reqs[:third])
            sess.step()
            for r in sess.poll():
                store.add_finished(r)
            sess.submit(reqs[third: 2 * third])
            sess.step()
            sess.submit(reqs[2 * third:])
            for r in sess.close():
                store.add_finished(r)
            wall = time.perf_counter() - t0
            n_gen = sum(
                len(r.tokens) - r.prompt_len for r in store.finished.values()
            )
            outputs[name] = {rid: r.tokens
                             for rid, r in store.finished.items()}
            print(f"[{name}] finished {len(store.finished)}/{args.n_items} "
                  f"requests (3 submission waves)")
            print(f"total tokens: {n_gen}, seconds: {wall:.3f}, "
                  f"throughput: {n_gen / wall:.1f} tokens/s")
            sample = store.finished[0]
            print(f"[{name}] request 0: "
                  f"prompt={sample.tokens[:sample.prompt_len]} "
                  f"-> generated={sample.tokens[sample.prompt_len:]}")
            continue
        if name == "dense":
            eng = DenseEngine(params, model_cfg, engine_cfg, device=device)
        elif name == "native":
            eng = NativePagedEngine(params, model_cfg, engine_cfg,
                                    attention_impl=attention, device=device)
        elif name == "auto":
            eng = AutonomousEngine(
                params, model_cfg, engine_cfg, attention_impl=attention,
                temperature=args.temperature, top_k=args.top_k,
                sample_seed=args.seed, device=device,
            )
        else:
            eng = PagedEngine(params, model_cfg, engine_cfg,
                              attention_impl=attention, device=device)
        eng.run(store)
        outputs[name] = {rid: r.tokens for rid, r in store.finished.items()}
        print(f"[{name}] finished {len(store.finished)}/{args.n_items} "
              "requests")
        counter.print_throughput()
        print(f"[{name}] p50 TTFT: {counter.ttft_percentile(0.5)*1e3:.1f} ms")
        sample = store.finished[0]
        print(f"[{name}] request 0: "
              f"prompt={sample.tokens[:sample.prompt_len]} "
              f"-> generated={sample.tokens[sample.prompt_len:]}")

    # exact parity with "dense" holds for --attention jnp; the kernels'
    # online softmax accumulates in another order and may flip a greedy
    # near-tie (the kernel-backed engines still agree with each other)
    if len(backends) > 1 and args.temperature == 0:
        ref_name = backends[0]
        for other in backends[1:]:
            n_match = sum(
                outputs[ref_name][i] == outputs[other][i]
                for i in outputs[ref_name]
            )
            tag = "OK" if n_match == len(outputs[ref_name]) else (
                f"{n_match}/{len(outputs[ref_name])} sequences identical"
            )
            print(f"{ref_name} vs {other} token parity: {tag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
