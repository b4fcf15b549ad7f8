"""Plain PyTorch reference ops: the oracle layer of the port.

Counterpart of min_llm_inference_tpu/ops/reference.py, with the same
conventions:
  * ``lengths[i] == 0`` means batch slot ``i`` is empty (liveness flag);
  * attention is length-masked: positions >= lengths[i] contribute nothing;
  * scores scale by 1/sqrt(head_dim);
  * greedy argmax resolves ties toward the lowest index.

The JAX package's one-hot embedding matmul is a TPU gather trick that is
bit-exact with a row gather, so the port gathers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import EMPTY_ROW_TOKEN_ID

NEG_INF = float("-inf")
_F32 = torch.finfo(torch.float32)


def inv_sqrt(dh: int) -> float:
    """1/sqrt(dh) rounded as float32 arithmetic rounds it (the JAX oracle
    divides in float32), so both frameworks scale scores by the same f32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def token_pos_embed(tokens, positions, wte, wpe):
    """Token + positional embedding gather. Sentinel/padding ids (< 0) are
    clipped for the gather; callers mask the result by length."""
    safe_tokens = tokens.clamp(0, wte.shape[0] - 1).long()
    safe_pos = positions.clamp(0, wpe.shape[0] - 1).long()
    return wte[safe_tokens] + wpe[safe_pos]


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
    near-ties into ties."""
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


def feed_forward(x, w, b=None, activation=None):
    """Dense layer x @ W (+ b) (+ act) in x's dtype (float32 accumulation
    inside the matmul, as the JAX dot's preferred_element_type)."""
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(x.dtype)
    if activation is not None:
        y = activation(y)
    return y
