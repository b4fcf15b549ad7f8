"""Scaling-efficiency harness: tokens/s of the mesh engines across mesh
sizes (the JAX package's examples/scaling_bench.py).

    python -m min_llm_inference_tpu_torch.examples.scaling_bench \\
        [--tp 2] [--requests 128] [--slots-per-dp 16] [--engine auto|paged] \\
        [--device cpu --n-devices N]

Mesh sizes tp, 2 tp, 4 tp, ... up to the devices present: on ``cuda`` the
card count (one rank per card, NCCL), on ``cpu`` ``--n-devices`` gloo
ranks. Each size runs dp = size / tp groups of ``--slots-per-dp`` slots
over one request stream and prints tok/s, tok/s per device and the
scaling efficiency against the smallest mesh. Each rank is a process of
its own (parallel.launch.run_ranks); a size's wall is its slowest rank's
``engine.run``, which includes the first run's graph captures on the
card, as the JAX harness's includes its compiles. CPU numbers show the
method, not hardware scaling.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from ..config import EngineConfig, ModelConfig
from ..parallel import workers
from ..parallel.launch import run_ranks

MODEL = ModelConfig(
    n_vocab=256, emb_dim=128, n_seq=64, n_layers=2, n_heads=4,
    ffn_dim=256, use_output_proj=True, use_layernorm=True,
    eof_token_id=255)
# init_params(0, MODEL, eof_bias=0.02) on every rank
RECIPE = ("init", 0, 0.02)
# the JAX harness's engines' default attention
ATTENTION = {"auto": "grouped", "paged": "torch"}


def draw_requests(n: int) -> list:
    rng = np.random.default_rng(0)
    return [rng.integers(0, 255, int(rng.integers(1, 24))).tolist()
            for _ in range(n)]


def engine_config(slots_per_dp: int, dp: int) -> EngineConfig:
    return EngineConfig(n_slots=slots_per_dp * dp, page_size=16,
                        n_pages=slots_per_dp * dp * 4, max_prefill_batch=8)


def run(n_devices: int, tp: int, requests: list, engine: str,
        slots_per_dp: int = 16, device: str = "cuda") -> tuple:
    """One mesh size: (tok/s, generated tokens, {request id: tokens})."""
    cfg = engine_config(slots_per_dp, n_devices // tp)
    case = ("engine_run", dict(
        kind=engine, model=dataclasses.asdict(MODEL),
        engine=dataclasses.asdict(cfg), recipe=RECIPE, prompts=requests,
        tp=tp, attention=ATTENTION[engine]))
    ranks = run_ranks(workers.run_cases, n_devices, ([case],), device=device)
    results = [r[0] for r in ranks]
    tokens = results[0]["tokens"]
    if len(tokens) != len(requests) or any(
            r["tokens"] != tokens for r in results):
        raise AssertionError(f"{n_devices} ranks: requests unfinished or "
                             "ranks disagree")
    total = sum(len(tokens[i]) - len(p) for i, p in enumerate(requests))
    wall = max(r["walls"][0] for r in results)
    return total / wall, total, tokens


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m min_llm_inference_tpu_torch.examples.scaling_bench",
        description=__doc__.split("\n")[0])
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--slots-per-dp", type=int, default=16)
    ap.add_argument("--engine", default="auto", choices=["auto", "paged"],
                    help="auto = device-resident scheduler "
                         "(ShardedAutonomousEngine); paged = host-scheduled")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--n-devices", type=int, default=None,
                    help="ranks available under --device cpu")
    args = ap.parse_args(argv)

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass --device cpu "
                               "--n-devices N to run on the CPU")
        n_avail = torch.cuda.device_count()
    elif args.n_devices is None:
        raise SystemExit("--device cpu needs --n-devices")
    else:
        n_avail = args.n_devices
    reqs = draw_requests(args.requests)

    base = None
    n = args.tp
    while n <= n_avail:
        dp = n // args.tp
        tok_s, _, _ = run(n, args.tp, reqs, args.engine, args.slots_per_dp,
                          args.device)
        if base is None:
            base = tok_s / n
        eff = tok_s / (n * base)
        print(f"devices={n:2d} (dp={dp} x tp={args.tp}): "
              f"{tok_s:10.1f} tok/s  per-device {tok_s/n:9.1f}  "
              f"efficiency {eff*100:5.1f}%", flush=True)
        n *= 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
