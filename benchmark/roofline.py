"""The yardstick's arithmetic: one H100's published peaks, the least time of
the decode-attention work, and the model FLOPs behind ``mfu_pct``.

The bounds copy ``chip_smoke.py``'s ``bound_of``, ``grouped_bound`` and
``partial_bound``: each input byte read once, each output byte written
once, over the HBM bandwidth, or the float32 multiply-adds over the
float32 peak, whichever is larger. They count what the live slots need:
a dead slot's row in a call is work no request asked for, so it is left
out (the least time is never overstated).
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least seconds for ``nbytes`` of HBM traffic and ``flops``
    float32 operations."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


def decode_contexts(prompt_len: int, n_served: int) -> np.ndarray:
    """The context length of each decode step of one request: the step that
    serves token j attends over positions 0 .. L-1+j, so L+j rows."""
    return prompt_len + np.arange(n_served, dtype=np.int64)


def ring_partial_rows(prompt_len: int, n_served: int, span: int):
    """The pool rows the page partial reads at each decode step of one
    request under ring decode with one admission a span: a request is
    admitted at a span's start and its ring holds the span's new rows, so
    at its step i the pages hold positions < L - 1 + span * (i // span)."""
    i = np.arange(n_served, dtype=np.int64)
    return prompt_len - 1 + span * (i // span)


def _pages(rows: np.ndarray, page: int) -> int:
    return int(np.ceil(rows / page).sum())


def grouped_bound_s(ctx: np.ndarray, D: int, Dk: int, W: int, P: int,
                    in_bytes: int, pool_bytes: int, scaled: bool,
                    n_layers: int = 1) -> float:
    """Least time of the fused-write attention over live slot-steps with
    contexts ``ctx`` (each slot-step: q, the new k and v read, the
    context's K and V rows read, the new row written, the pages' scales,
    o written in float32, the length and the page-table row), per layer."""
    rows = int(ctx.sum())
    n = ctx.size
    nbytes = (3 * n * D * in_bytes + 2 * rows * Dk * pool_bytes
              + (2 * _pages(ctx, P) * 4 if scaled else 0)
              + n * (D * 4 + 4 + W * 4))
    return n_layers * bound_s(nbytes, 4 * rows * D)


def partial_bound_s(rs: np.ndarray, D: int, Dk: int, H: int, P: int,
                    in_bytes: int, pool_bytes: int, scaled: bool,
                    n_layers: int = 1) -> float:
    """Least time of the ring's page partial over live slot-steps that read
    ``rs`` pool rows each (q read; K and V rows and their pages' scales
    read; o, m, l written in float32; length, ring start and one table
    entry read), per layer."""
    rows = int(rs.sum())
    n = rs.size
    nbytes = (n * D * in_bytes + 2 * rows * Dk * pool_bytes
              + (2 * _pages(rs, P) * 4 if scaled else 0)
              + n * ((D + 2 * H) * 4 + 2 * 4 + 4))
    return n_layers * bound_s(nbytes, 4 * rows * D)


def attention_bound_s(cfg: dict, requests: list) -> float:
    """Least time of the decode attention of ``requests`` (``(prompt,
    served)`` pairs) under the configuration's kernel (``cfg["attention"]
    ["bound"]``: ``grouped`` or ``partial``)."""
    m, e = cfg["model"], cfg["engine"]
    D, H, P = m["emb_dim"], m["n_heads"], e["page_size"]
    packed = e["kv_dtype"] == "int4"
    Dk = D // 2 if packed else D
    in_bytes = 2 if m["dtype"] == "bfloat16" else 4
    pool_bytes = {"int8": 1, "int4": 1, "bfloat16": 2}.get(e["kv_dtype"], 4)
    scaled = e["kv_dtype"] in ("int8", "int4")
    L = m["n_layers"]
    if cfg["attention"]["bound"] == "grouped":
        ctx = np.concatenate([decode_contexts(len(p), len(s))
                              for p, s in requests])
        W = -(-m["n_seq"] // P)
        return grouped_bound_s(ctx, D, Dk, W, P, in_bytes, pool_bytes,
                               scaled, L)
    span = e["n_forward_rounds"] // e["subbursts"]
    rs = np.concatenate([ring_partial_rows(len(p), len(s), span)
                         for p, s in requests])
    return partial_bound_s(rs, D, Dk, H, P, in_bytes, pool_bytes, scaled, L)


def model_flops(model: dict, prompt_len: int, n_served: int) -> float:
    """The FLOPs one request needs, padding left out: every prompt position
    but the last is prefilled (all layers; the last layer needs only its
    keys and values), every decode step runs every layer and the tied
    logits. A matrix product of m x k by k x n is 2mkn; attention over c
    positions is 4 * D * c."""
    D, V, F = model["emb_dim"], model["n_vocab"], model["ffn_dim"]
    nl = model["n_layers"]
    proj = 2 * D * D * (3 + (1 if model["use_output_proj"] else 0))
    ffn = 4 * D * F
    n_pre = prompt_len - 1
    pre_ctx = n_pre * (n_pre + 1) / 2          # positions 0 .. L-2 attend
    flops = (nl - 1) * (n_pre * (proj + ffn) + 4 * D * pre_ctx)
    flops += n_pre * 4 * D * D                 # the last layer's k and v
    ctx = decode_contexts(prompt_len, n_served)
    flops += n_served * (nl * (proj + ffn) + 2 * D * V)
    flops += nl * 4 * D * float(ctx.sum())
    return float(flops)
