"""The multi-device dryrun: both mesh engines on an N-rank dp x tp mesh.

    python -m min_llm_inference_tpu_torch.dryrun N [--device cpu]

Counterpart of the JAX package's ``dryrun_multichip``: the tiny flagship
model (2 layers, 4 heads, emb 64, float32) with int8 paged KV and two
sub-bursts per burst, tp the largest of 4, 2, 1 that divides both N and
the head count, dp = N / tp. It serves 3 * n_slots requests (admission
turnover) through ShardedPagedEngine on the one-slot kernel
(``attention_impl="paged"``) and through ShardedAutonomousEngine on the
grouped kernel, checks that every request finished and that the two
agree token for token, and prints one OK line. On the card each rank has
a card of its own (NCCL) when N cards are present; otherwise the ranks
share cuda:0 under gloo. Exits nonzero on any failure.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from .config import EngineConfig, ModelConfig
from .parallel import workers
from .parallel.launch import run_ranks

MODEL = ModelConfig(
    n_vocab=128, emb_dim=64, n_seq=32, n_layers=2, n_heads=4, ffn_dim=128,
    use_output_proj=True, use_layernorm=True, eof_token_id=127,
    dtype="float32")
ENGINE = EngineConfig(
    n_slots=8, n_forward_rounds=2, page_size=8, n_pages=32,
    init_num_pages=2, max_prefill_batch=8, kv_dtype="int8", subbursts=2)


def pick_tp(n_devices: int, n_heads: int) -> int:
    """The largest of 4, 2, 1 that divides both counts."""
    return next(t for t in (4, 2, 1)
                if n_devices % t == 0 and n_heads % t == 0)


def dryrun_cases(n_devices: int):
    """(tp, the prompts, the run_cases list) of a dryrun on N ranks."""
    tp = pick_tp(n_devices, MODEL.n_heads)
    dp = n_devices // tp
    if ENGINE.n_slots % dp or ENGINE.n_pages % dp:
        raise ValueError(f"the tiny config does not shard over dp={dp}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, MODEL.eof_token_id,
                            int(rng.integers(1, MODEL.n_seq // 2))).tolist()
               for _ in range(3 * ENGINE.n_slots)]
    common = dict(model=dataclasses.asdict(MODEL),
                  engine=dataclasses.asdict(ENGINE),
                  recipe=("init", 0, 0.05), prompts=prompts, tp=tp)
    cases = [("engine_run", dict(common, kind="paged", attention="paged")),
             ("engine_run", dict(common, kind="auto", attention="grouped"))]
    return tp, prompts, cases


def check(results, prompts) -> dict:
    """Raise unless every rank finished every request, EOF- or
    cap-terminated, and both engines agree; returns the tokens."""
    paged, auto = results[0]
    n = len(prompts)
    for rank, (p, a) in enumerate(results):
        if len(p["tokens"]) != n or len(a["tokens"]) != n:
            raise AssertionError(f"rank {rank}: {len(p['tokens'])} and "
                                 f"{len(a['tokens'])} of {n} finished")
        if p["tokens"] != paged["tokens"] or a["tokens"] != auto["tokens"]:
            raise AssertionError(f"rank {rank} disagrees with rank 0")
    for i, toks in paged["tokens"].items():
        if toks[-1] != MODEL.eof_token_id and len(toks) != MODEL.n_seq:
            raise AssertionError(f"request {i} ended without EOF or cap")
        if auto["tokens"][i] != toks:
            raise AssertionError(f"request {i}: autonomous tokens differ "
                                 "from the paged engine's")
    return paged["tokens"]


def dryrun(n_devices: int, device: str = "cuda",
           timeout: float = 600.0) -> tuple:
    """Run the dryrun on N ranks; returns the OK line and each rank's
    (paged, autonomous) engine_run results (raises on any failure)."""
    tp, prompts, cases = dryrun_cases(n_devices)
    share = device == "cuda" and n_devices > torch.cuda.device_count()
    results = run_ranks(workers.run_cases, n_devices, (cases,),
                        device=device, share_device=share, timeout=timeout)
    tokens = check(results, prompts)
    gen = sum(len(t) - len(p) for t, p in zip(
        (tokens[i] for i in range(len(prompts))), prompts))
    backend = "gloo" if device == "cpu" or share else "nccl"
    line = (f"dryrun OK: {n_devices} ranks, dp={n_devices // tp} tp={tp} "
            f"({backend} on {device}), {len(prompts)} requests, {gen} "
            "tokens, ShardedPagedEngine(paged) == "
            "ShardedAutonomousEngine(grouped)")
    return line, results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    print(dryrun(args.n_devices, args.device, args.timeout)[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
