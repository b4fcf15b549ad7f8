"""Backend-independent model math (counterpart of
min_llm_inference_tpu/models/model.py).

The math is written once against ``write_kv``/``attend`` callbacks that a
backend supplies (paged pool, fused kernel), which is what makes
token-exact cross-backend parity tests possible.
  * reference-parity mode (n_layers=1, ffn_dim=0, no residual/proj/LN):
    embedding -> single-head attention -> weight-tied argmax decoder;
  * general mode: pre-LN blocks with residuals, multi-head attention,
    optional output projection and FFN.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops import prefill_attention
from ..ops.reference import (
    feed_forward,
    greedy_next_token,
    inv_sqrt,
    masked_softmax,
    tied_logits,
    token_pos_embed,
)
from ..utils.profiling import phase


class SingleChipCtx:
    """Parallel context: the seams where tensor-parallel execution differs
    from one device (parallel/sharded.TpShardCtx overrides them). On one
    device the reductions are identities."""

    tp = 1

    def psum(self, x):
        """Reduce a row-parallel partial product (wo / w_down / logits)."""
        return x

    def pmax(self, x):
        """Max-reduce the feature-sharded absmax of the int8/int4 page
        scales (models/paged.scale_reduce_of hands it to
        ops/quant.update_page_scales when tp > 1; one device reduces
        nothing)."""
        return x

    def embed(self, params, tokens, positions):
        return token_pos_embed(tokens, positions, params["wte"], params["wpe"])

    def logits(self, h, wte):
        return tied_logits(h, wte)

    def local_heads(self, cfg: ModelConfig) -> int:
        return cfg.n_heads


DEFAULT_CTX = SingleChipCtx()


def _maybe_layernorm(x, gain):
    if gain is None:
        return x
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-5) * gain.float()).to(x.dtype)


def _use_residual(cfg: ModelConfig) -> bool:
    # the reference-parity single bare attention block has no residual
    return (cfg.n_layers > 1 or cfg.ffn_dim > 0 or cfg.use_output_proj
            or cfg.use_layernorm)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def layer_post(layer, cfg: ModelConfig, h_in, attn_out, ctx=DEFAULT_CTX):
    """Combine the attention output with the residual stream + optional
    FFN."""
    if cfg.use_output_proj:
        attn_out = ctx.psum(feed_forward(attn_out, layer["wo"]))
    if not _use_residual(cfg):
        return attn_out
    h = h_in + attn_out
    if cfg.ffn_dim > 0:
        h_norm = _maybe_layernorm(h, layer.get("ln2_g"))
        ffn = ctx.psum(
            feed_forward(
                feed_forward(h_norm, layer["w_up"], activation=_gelu),
                layer["w_down"],
            )
        )
        h = h + ffn
    return h


def layer_attn_input(layer, cfg: ModelConfig, h):
    return _maybe_layernorm(h, layer.get("ln1_g")) if cfg.use_layernorm else h


def decode_round_tokens(
    params,
    cfg: ModelConfig,
    lengths,
    last_tokens,
    write_kv: Callable,
    attend: Callable,
    ctx=DEFAULT_CTX,
    next_token_fn: Callable | None = None,
):
    """One greedy decode round for every live batch slot.

    lengths: [B] int32 (0 = empty slot); the latest existing token sits at
    position lengths-1 and is the one fed through the model this round.
    last_tokens: [B] int32, the token id at position lengths-1.
    write_kv(layer_idx, pos, k, v, live) appends the backend's K/V;
    attend(layer_idx, q, lengths) -> [B, D].

    Returns (next_tokens [B], new_lengths [B])."""
    pos = torch.clamp_min(lengths - 1, 0)
    h = ctx.embed(params, last_tokens, pos)
    live = lengths > 0
    for li, layer in enumerate(params["layers"]):
        x = layer_attn_input(layer, cfg, h)
        if "wqkv" in layer:
            qkv = feed_forward(x, layer["wqkv"])
            dl = qkv.shape[-1] // 3
            q, k, v = qkv[:, :dl], qkv[:, dl:2 * dl], qkv[:, 2 * dl:]
        else:
            q = feed_forward(x, layer["wq"])
            k = feed_forward(x, layer["wk"])
            v = feed_forward(x, layer["wv"])
        write_kv(li, pos, k, v, live)
        attn_out = attend(li, q, lengths)
        h = layer_post(layer, cfg, h, attn_out, ctx)
    with phase("logits"):
        logits = ctx.logits(h, params["wte"])
        if next_token_fn is not None:
            return next_token_fn(logits, lengths)
        return greedy_next_token(logits, lengths, cfg.n_seq,
                                 cfg.eof_token_id)


def causal_masked_attention(q, k, v, lengths, n_heads: int):
    """Causal attention over a prompt block, length-masked. q,k,v:
    [B, S, D]; position i attends to j <= i, j < len. Rows at positions
    >= lengths are garbage; callers mask their use."""
    B, S, D = q.shape
    dh = D // n_heads
    qh = q.reshape(B, S, n_heads, dh).float()
    kh = k.reshape(B, S, n_heads, dh).float()
    vh = v.reshape(B, S, n_heads, dh).float()
    scores = torch.einsum("bihd,bjhd->bhij", qh, kh) * inv_sqrt(dh)
    ar = torch.arange(S, device=q.device)
    row = ar[None, None, :, None]
    col = ar[None, None, None, :]
    mask = (col <= row) & (col < lengths[:, None, None, None])
    probs = masked_softmax(scores, mask)
    out = torch.einsum("bhij,bjhd->bihd", probs, vh)
    return out.reshape(B, S, D).to(q.dtype)


def prefill_write_kv(
    params,
    cfg: ModelConfig,
    prompts,
    prompt_lengths,
    write_kv_block: Callable,
    ctx=DEFAULT_CTX,
):
    """Prefill: run the prompt block through all layers, writing each
    layer's K/V through ``write_kv_block(layer_idx, k [M,S,D], v [M,S,D])``
    (the backend masks positions >= prompt_lengths itself). The last
    layer's attention is skipped: the first generated token comes from the
    decode step. The others go to the hand-written kernel
    (ops/prefill_attention) where ``kernel_takes`` holds for q (CUDA,
    bfloat16, a head dim of 16, 32, ..., 128), else to
    ``causal_masked_attention``."""
    M, S = prompts.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=prompts.device)[None, :].expand(M, S)
    h = ctx.embed(params, prompts, positions)
    n_layers = len(params["layers"])
    for li, layer in enumerate(params["layers"]):
        x = layer_attn_input(layer, cfg, h)
        if "wkv" in layer:
            kv = feed_forward(x, layer["wkv"])
            dl = kv.shape[-1] // 2
            k, v = kv[..., :dl], kv[..., dl:]
        else:
            k = feed_forward(x, layer["wk"])
            v = feed_forward(x, layer["wv"])
        write_kv_block(li, k, v)
        if li + 1 < n_layers:
            q = feed_forward(x, layer["wq"])
            heads = ctx.local_heads(cfg)
            attend = (prefill_attention.prefill_causal_attention
                      if prefill_attention.kernel_takes(
                          q.device, q.dtype, q.shape[-1] // heads)
                      else causal_masked_attention)
            attn_out = attend(q, k, v, prompt_lengths, heads)
            h = layer_post(layer, cfg, h, attn_out, ctx)
