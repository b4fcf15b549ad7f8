"""Quantization quality harness: teacher-forced perplexity deltas
(counterpart of min_llm_inference_tpu/utils/quality.py).

Token sequences are teacher-forced through the paged decode machinery
itself: every K/V write goes through the same (optionally quantized) page
pipeline the engines use, so ΔPPL between KV configurations on the same
sequences measures what quantization does in serving.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import EngineConfig, ModelConfig
from ..models.model import layer_attn_input, layer_post
from ..models.paged import (
    _flat_scatter_indices,
    _write_kv_tokens,
    decode_fresh_pid,
    init_paged_state,
    torch_paged_attend,
)
from ..models.params import params_device
from ..ops.reference import feed_forward, tied_logits, token_pos_embed


def teacher_forced_nll(params, model_cfg: ModelConfig,
                       engine_cfg: EngineConfig, tokens: np.ndarray,
                       lengths: np.ndarray):
    """Per-sequence summed negative log-likelihood of tokens[1:] given the
    prefix, step by step through the paged KV pipeline (int8/int4 page
    quantization acts exactly as in serving). tokens: [B, T] int32
    (padded); lengths: [B] int32 (>= 2). Runs on the params' device.

    Returns (nll_sum [B] float32, n_predicted [B])."""
    B, T = tokens.shape
    P = engine_cfg.page_size
    NP = engine_cfg.n_pages
    W = engine_cfg.pages_per_slot(model_cfg.n_seq)
    if NP < B * W:
        raise ValueError("the quality harness grants full pages per "
                         "sequence: n_pages must be >= B * pages_per_slot")
    if T > model_cfg.n_seq:
        raise ValueError(f"sequences of {T} tokens exceed n_seq")
    dev = params_device(params)
    page_table = torch.arange(B * W, dtype=torch.int32,
                              device=dev).reshape(B, W)
    kv = init_paged_state(model_cfg, engine_cfg, dev)
    kv_pages, k_scales, v_scales = (list(kv.kv_pages), list(kv.k_scales),
                                    list(kv.v_scales))
    tokens_d = torch.from_numpy(np.asarray(tokens, np.int32)).to(dev)
    lengths_d = torch.from_numpy(np.asarray(lengths, np.int32)).to(dev)
    nll = torch.zeros(B, dtype=torch.float32, device=dev)
    for t in range(T - 1):
        tok_t = tokens_d[:, t]
        valid = t < lengths_d
        pos = torch.full((B,), t, dtype=torch.int32, device=dev)
        h = token_pos_embed(tok_t, pos, params["wte"], params["wpe"])
        ctx_len = torch.where(valid, t + 1, 0).to(torch.int32)
        flat_idx = _flat_scatter_indices(page_table, pos, valid, P, NP)
        fresh_pid = decode_fresh_pid(page_table, pos, valid, P, NP)
        for li, layer in enumerate(params["layers"]):
            x = layer_attn_input(layer, model_cfg, h)
            q = feed_forward(x, layer["wq"])
            k = feed_forward(x, layer["wk"])
            v = feed_forward(x, layer["wv"])
            kv_pages[li], k_scales[li], v_scales[li] = _write_kv_tokens(
                kv_pages[li], k_scales[li], v_scales[li], flat_idx, k, v,
                fresh_pid, n_heads=model_cfg.n_heads)
            attn = torch_paged_attend(kv_pages[li], k_scales[li],
                                      v_scales[li], q, ctx_len, page_table,
                                      P, model_cfg.n_heads)
            h = layer_post(layer, model_cfg, h, attn)
        logp = torch.log_softmax(tied_logits(h, params["wte"]), dim=-1)
        next_tok = tokens_d[:, min(t + 1, T - 1)].long()
        step_nll = -torch.gather(logp, 1, next_tok[:, None])[:, 0]
        nll = nll + torch.where((t + 1) < lengths_d, step_nll, 0.0)
    n_pred = np.maximum(np.asarray(lengths) - 1, 0)
    return nll.cpu().numpy(), n_pred


def perplexity(params, model_cfg, engine_cfg, tokens, lengths) -> float:
    nll, n_pred = teacher_forced_nll(params, model_cfg, engine_cfg, tokens,
                                     lengths)
    total = n_pred.sum()
    return float(np.exp(nll.sum() / max(total, 1)))


def delta_ppl_kv(params, model_cfg: ModelConfig, engine_cfg: EngineConfig,
                 tokens: np.ndarray, lengths: np.ndarray,
                 kv_dtype: str = "int8") -> dict:
    """PPL with full-precision KV vs quantized (int8/int4) paged KV on the
    same sequences. Returns {"ppl_ref", "ppl_q", "delta_ppl"}."""
    ref_cfg = dataclasses.replace(engine_cfg, kv_dtype=model_cfg.dtype)
    q_cfg = dataclasses.replace(engine_cfg, kv_dtype=kv_dtype)
    ppl_ref = perplexity(params, model_cfg, ref_cfg, tokens, lengths)
    ppl_q = perplexity(params, model_cfg, q_cfg, tokens, lengths)
    return {"ppl_ref": ppl_ref, "ppl_q": ppl_q, "delta_ppl": ppl_q - ppl_ref}


def delta_ppl_int8_kv(params, model_cfg: ModelConfig,
                      engine_cfg: EngineConfig, tokens: np.ndarray,
                      lengths: np.ndarray) -> dict:
    """PPL with full-precision KV vs INT8 paged KV on the same sequences.
    Returns {"ppl_ref", "ppl_int8", "delta_ppl"}."""
    r = delta_ppl_kv(params, model_cfg, engine_cfg, tokens, lengths, "int8")
    return {"ppl_ref": r["ppl_ref"], "ppl_int8": r["ppl_q"],
            "delta_ppl": r["delta_ppl"]}
