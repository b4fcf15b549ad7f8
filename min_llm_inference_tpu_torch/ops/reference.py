"""Plain PyTorch reference ops: the oracle layer of the port.

Counterpart of min_llm_inference_tpu/ops/reference.py, with the same
conventions:
  * ``lengths[i] == 0`` means batch slot ``i`` is empty (liveness flag);
  * attention is length-masked: positions >= lengths[i] contribute nothing;
  * scores scale by 1/sqrt(head_dim);
  * greedy argmax resolves ties toward the lowest index.

The JAX package's one-hot embedding matmul is a TPU gather trick that is
bit-exact with a row gather, so the port gathers. Weight tables and
matrices may be weight-quantized ``{"q", "scale"}`` leaves
(ops/quant.quantize_params).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import EMPTY_ROW_TOKEN_ID
from .quant import gather_rows, is_quantized_leaf, maybe_dequant
from .random import gumbel

NEG_INF = float("-inf")
_F32 = torch.finfo(torch.float32)


def inv_sqrt(dh: int) -> float:
    """1/sqrt(dh) rounded as float32 arithmetic rounds it (the JAX oracle
    divides in float32), so both frameworks scale scores by the same f32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def _table(w):
    return w["q"] if is_quantized_leaf(w) else w


def token_pos_embed(tokens, positions, wte, wpe):
    """Token + positional embedding gather. Sentinel/padding ids (< 0) are
    clipped for the gather; callers mask the result by length. With a
    quantized wte the rows come out in bfloat16, as in the JAX package."""
    safe_tokens = tokens.clamp(0, _table(wte).shape[0] - 1).long()
    safe_pos = positions.clamp(0, _table(wpe).shape[0] - 1).long()
    dtype = (torch.bfloat16 if is_quantized_leaf(wte)
             else _table(wte).dtype)
    return (gather_rows(wte, safe_tokens, dtype)
            + gather_rows(wpe, safe_pos, dtype))


def project_qkv(emb, wq, wk, wv):
    """The q, k and v projections of emb [..., D] by [D, D] weights, each
    accumulated in float32 and cast back to emb's dtype (the JAX dot's
    preferred_element_type, then astype)."""
    x = emb.float()
    return tuple(torch.matmul(x, w.float()).to(emb.dtype)
                 for w in (wq, wk, wv))


def masked_softmax(scores, mask):
    """Softmax along the last axis; masked columns get probability 0 and a
    fully masked row is all zeros (not NaN)."""
    scores = scores.float()
    masked = torch.where(mask, scores, NEG_INF)
    row_max = masked.amax(dim=-1, keepdim=True).clamp_min(_F32.min)
    unnorm = torch.where(mask, torch.exp(scores - row_max), 0.0)
    denom = unnorm.sum(dim=-1, keepdim=True)
    return unnorm / denom.clamp_min(_F32.tiny)


def masked_attention(q, k_ctx, v_ctx, lengths, n_heads: int = 1):
    """Single-token attention of q [B, D] against per-slot contexts
    k_ctx/v_ctx [B, L, D], positions < lengths[b] valid. Returns [B, D] in
    q's dtype, exact zeros for empty slots."""
    B, L, D = k_ctx.shape
    dh = D // n_heads
    qh = q.reshape(B, n_heads, dh).float()
    kh = k_ctx.reshape(B, L, n_heads, dh).float()
    vh = v_ctx.reshape(B, L, n_heads, dh).float()
    scores = torch.einsum("bhd,blhd->bhl", qh, kh) * inv_sqrt(dh)
    pos = torch.arange(L, device=q.device)
    mask = pos[None, None, :] < lengths[:, None, None]
    probs = masked_softmax(scores, mask)
    out = torch.einsum("bhl,blhd->bhd", probs, vh)
    return out.reshape(B, D).to(q.dtype)


def tied_logits(x, wte):
    """Weight-tied LM head: logits = x @ wte^T, accumulated and returned in
    float32 (the JAX dot's preferred_element_type): bf16 logits would turn
    near-ties into ties. wte may be a weight-quantized leaf, read
    dequantized in x's dtype."""
    wte = maybe_dequant(wte, x.dtype)
    return torch.matmul(x.float(), wte.to(x.dtype).float().t())


def greedy_next_token(logits, lengths, n_seq: int, eof_token_id: int):
    """Greedy argmax (lowest index wins ties) + the reference decoder's
    length rules: an empty slot emits EMPTY_ROW_TOKEN_ID and stays empty; a
    live slot emits its token, then its length grows by one or resets to 0
    (finished) on EOF or when it reaches n_seq.

    Returns (next_tokens [B] int32, new_lengths [B] int32)."""
    live = lengths > 0
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    tok = torch.where(live, tok, EMPTY_ROW_TOKEN_ID)
    finished = live & ((tok == eof_token_id) | (lengths + 1 >= n_seq))
    new_lengths = torch.where(live & ~finished, lengths + 1, 0)
    return tok, new_lengths.to(torch.int32)


def perturbed_scores(logits, key, temperature: float = 1.0, top_k: int = 0):
    """The scores whose argmax is the sampled token: the JAX function's
    arithmetic, step by step. Logits in float32 divided (not multiplied by
    a reciprocal) by max(temperature, 1e-6); for 0 < top_k < V the k-th
    largest value is the threshold and values below it become -inf (ties
    at the threshold stay); plus ``gumbel(key, [B, V])``, the Gumbel-max
    draw of ``jax.random.categorical``. The divisor is a float32 tensor, so
    that CUDA divides too (a Python scalar divisor is turned into a
    reciprocal multiply there)."""
    t = torch.full((), max(temperature, 1e-6), dtype=torch.float32,
                   device=logits.device)
    scaled = logits.float() / t
    if top_k and top_k < logits.shape[-1]:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled >= kth, scaled, NEG_INF)
    return gumbel(key, tuple(scaled.shape)) + scaled


def sample_next_token(logits, lengths, n_seq: int, eof_token_id: int,
                      key, temperature: float = 1.0, top_k: int = 0):
    """Temperature + optional top-k sampling with the length rules of
    greedy_next_token; ``key`` (ops/random) is the round's draw key. The
    token is the argmax of perturbed_scores, the lowest index winning
    ties."""
    live = lengths > 0
    tok = torch.argmax(perturbed_scores(logits, key, temperature, top_k),
                       dim=-1).to(torch.int32)
    tok = torch.where(live, tok, EMPTY_ROW_TOKEN_ID)
    finished = live & ((tok == eof_token_id) | (lengths + 1 >= n_seq))
    new_lengths = torch.where(live & ~finished, lengths + 1, 0)
    return tok, new_lengths.to(torch.int32)


def feed_forward(x, w, b=None, activation=None):
    """Dense layer x @ W (+ b) (+ act) in x's dtype (float32 accumulation
    inside the matmul, as the JAX dot's preferred_element_type). W may be
    a weight-quantized leaf, read dequantized in x's dtype."""
    w = maybe_dequant(w, x.dtype)
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(x.dtype)
    if activation is not None:
        y = activation(y)
    return y


def online_softmax(x):
    """Standalone row softmax in float32 (the reference's softmax kernel,
    used only by tests there)."""
    return torch.softmax(x.float(), dim=-1)
