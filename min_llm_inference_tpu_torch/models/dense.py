"""Dense (contiguous-KV) backend (counterpart of
min_llm_inference_tpu/models/dense.py).

Per-slot contiguous K/V caches ``[n_layers, n_slots, n_seq, emb]``, the
reference's contiguous backend. Two step functions per config:

  * ``prefill``: compact [M, S] prefill of the new slots' prompts into their
    cache rows -- deliberately the same compact shape as the paged
    backend's prefill, so both run identical projection matmuls (the
    prerequisite for token-exact dense <-> paged parity);
  * ``decode_rounds``: ``n_forward_rounds`` greedy decode rounds.

Unlike the JAX functions, which return new arrays, the caches are written
IN PLACE (the engine owns them); the functions still return the state.
Float caches only: the dense backend has no page scales, so the engine
rejects quantized KV. No kernel runs here.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..config import EngineConfig, ModelConfig, resolve_device
from ..ops.indexing import index_set_drop_
from ..ops.reference import masked_attention
from .model import decode_round_tokens, prefill_write_kv


class DenseKVState(NamedTuple):
    k_cache: torch.Tensor  # [n_layers, n_slots, n_seq, emb]
    v_cache: torch.Tensor  # [n_layers, n_slots, n_seq, emb]


def init_dense_state(model_cfg: ModelConfig, engine_cfg: EngineConfig,
                     device=None) -> DenseKVState:
    """Zeroed caches on ``device`` (``cuda`` unless the caller names
    another; raises without a GPU)."""
    dev = resolve_device(device)
    shape = (model_cfg.n_layers, engine_cfg.n_slots, model_cfg.n_seq,
             model_cfg.emb_dim)
    dtype = engine_cfg.kv_torch_dtype
    return DenseKVState(torch.zeros(shape, dtype=dtype, device=dev),
                        torch.zeros(shape, dtype=dtype, device=dev))


def _prefill(model_cfg: ModelConfig, params, state: DenseKVState, prompts,
             prompt_lengths, slot_ids) -> DenseKVState:
    """Write K/V of every prompt position of the given slots. prompts:
    [M, S] int32; prompt_lengths: [M]; slot_ids: [M] (or [M, 1]) int32
    (padding rows carry prompt length 0 and slot id n_slots: dropped).
    Positions past a prompt keep the row's old contents."""
    kc, vc = state
    B = kc.shape[1]
    S = prompts.shape[1]
    slot_ids = slot_ids.reshape(-1)
    pos_valid = (torch.arange(S, dtype=torch.int32, device=prompts.device)
                 [None, :] < prompt_lengths[:, None])[:, :, None]
    safe_ids = slot_ids.clamp(0, B - 1).long()

    def write_kv_block(li, k, v):
        for cache, new in ((kc, k), (vc, v)):
            old = cache[li][safe_ids]            # merged rows of padding drop
            index_set_drop_(cache[li], slot_ids,
                            torch.where(pos_valid, new.to(cache.dtype), old))

    prefill_write_kv(params, model_cfg, prompts, prompt_lengths,
                     write_kv_block)
    return state


def _decode_rounds(model_cfg: ModelConfig, n_rounds: int, params,
                   state: DenseKVState, lengths, last_tokens):
    """n_rounds greedy decode rounds; returns (state, lengths, last_tokens,
    tokens [B, n_rounds]) with EMPTY_ROW_TOKEN_ID in dead rows."""
    kc, vc = state
    B = lengths.shape[0]
    batch_ix = torch.arange(B, device=lengths.device)

    def write_kv(li, pos, k, v, live):
        # dead slots (pos clamped to 0) overwrite their own stale row 0:
        # harmless, reads are length-masked and re-prefill overwrites it
        kc[li].index_put_((batch_ix, pos.long()), k.to(kc.dtype))
        vc[li].index_put_((batch_ix, pos.long()), v.to(vc.dtype))

    def attend(li, q, lens):
        return masked_attention(q, kc[li], vc[li], lens, model_cfg.n_heads)

    toks = []
    for _ in range(n_rounds):
        live = lengths > 0
        tok, lengths_next = decode_round_tokens(
            params, model_cfg, lengths, last_tokens, write_kv, attend)
        last_tokens = torch.where(live, tok, last_tokens)
        lengths = lengths_next
        toks.append(tok)
    return state, lengths, last_tokens, torch.stack(toks, dim=1)


def make_dense_fns(model_cfg: ModelConfig, engine_cfg: EngineConfig):
    """(prefill, decode_rounds) for a config pair: plain functions."""
    return (functools.partial(_prefill, model_cfg),
            functools.partial(_decode_rounds, model_cfg,
                              engine_cfg.n_forward_rounds))
