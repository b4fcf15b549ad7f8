"""Small copies of the benchmark's configurations and mixes for the CPU
tests: the same groups and kinds at widths the CPU runs in seconds."""

from __future__ import annotations

import copy

from benchmark import spec


def config(name: str) -> dict:
    cfg = copy.deepcopy(spec.config(name))
    m, e, r = cfg["model"], cfg["engine"], cfg["runner"]
    if name == "gpt2-small":
        m.update(n_vocab=512, emb_dim=192, n_seq=128, n_layers=4,
                 n_heads=3, ffn_dim=768, eof_token_id=511)
        e.update(n_slots=16, n_pages=64)
        r.update(max_new_per_burst=8, min_drain_slots=8)
    else:
        m.update(n_vocab=256, emb_dim=256, n_seq=64, eof_token_id=255)
        e.update(n_slots=16, n_pages=64)
        r.update(max_new_per_burst=16)
    return cfg


def traffic(name: str, seq: int) -> dict:
    t = copy.deepcopy(spec.traffic(name))
    lo = max(1, min(t["prompt_len"]["min"], seq // 4))
    t["prompt_len"].update(min=lo, max=min(t["prompt_len"]["max"],
                                           seq // 2))
    t.update(warm_requests=4, check_requests=24, profile_seconds=0.0,
             bursts_per_chunk=2)
    if t["loop"] == "batch":
        t["requests_per_batch"] = 24
    else:
        t.update(session_capacity=64, drain_seconds=30)
        t["arrival"]["rate_per_s"] = 200.0
    return t


def cell(name: str) -> tuple:
    """(cfg, traffic) of a cell at test size."""
    c = spec.cell(spec.benchmark(), name)
    cfg = config(c["config"])
    return cfg, traffic(c["traffic"], cfg["model"]["n_seq"])
