"""The single-chip decode step on the flagship model.

Counterpart of the JAX package's ``entry()`` (``__graft_entry__.py``):
``entry()`` returns ``(fn, example_args)``, where ``fn(*example_args)``
runs ``n_forward_rounds`` greedy decode rounds (``models.paged.
_decode_rounds``) of the GPT-2-small-class flagship (12 layers, 12 heads,
emb 768, bf16 weights) over 256 slots on a bfloat16 paged pool of 2048
pages of 16 rows, and returns ``(state, lengths, last_tokens, tokens)``.
The weights are ``init_params(0)`` (JAX's ``init_params(PRNGKey(0))`` bit
for bit), the packed scheduler operand is drawn from
``np.random.default_rng(0)`` as the JAX entry draws it, and the pools
start zeroed. The step writes the pools in place: run it on a copy of the
state to run it twice over the same state.

    fn, args = entry()                      # on the card, "torch" attention
    state, lengths, last, tokens = fn(*args)

``attention_impl``: "torch" (the gather oracle, the JAX entry's "jnp"),
"paged" or "grouped" (the kernels). ``tiny=True`` is the small flagship
that the tests and the dryrun use (float32, float32 KV).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .config import EngineConfig, ModelConfig, resolve_device
from .models.paged import _decode_rounds, init_paged_state
from .models.params import init_params


def flagship_cfgs(tiny: bool = False):
    """(ModelConfig, EngineConfig) of the flagship, or of its tiny cut."""
    if tiny:
        model = ModelConfig(
            n_vocab=128, emb_dim=64, n_seq=32, n_layers=2, n_heads=4,
            ffn_dim=128, use_output_proj=True, use_layernorm=True,
            eof_token_id=127, dtype="float32")
        engine = EngineConfig(
            n_slots=8, n_forward_rounds=2, page_size=8, n_pages=32,
            init_num_pages=2, max_prefill_batch=8)
    else:
        # a GPT-2-small-class stack in bf16 with bf16 KV
        model = ModelConfig(
            n_vocab=1024, emb_dim=768, n_seq=128, n_layers=12, n_heads=12,
            ffn_dim=3072, use_output_proj=True, use_layernorm=True,
            eof_token_id=1023, dtype="bfloat16")
        engine = EngineConfig(
            n_slots=256, n_forward_rounds=1, page_size=16, n_pages=2048,
            kv_dtype="bfloat16", max_prefill_batch=64)
    return model, engine


def entry(device=None, *, tiny: bool = False,
          attention_impl: str = "torch"):
    """(fn, example_args): the flagship's decode step and its arguments
    (params, state, packed scheduler operand, lengths, last tokens) on
    ``device`` (``cuda`` unless the caller names another; raises without a
    GPU)."""
    dev = resolve_device(device)
    model, engine = flagship_cfgs(tiny)
    params = init_params(0, model, device=dev)
    state = init_paged_state(model, engine, device=dev)
    # the packed scheduler operand, drawn in the JAX entry's order: column
    # 0 the lengths update, 1 the last-token update, 2: the page table
    B = engine.n_slots
    W = engine.pages_per_slot(model.n_seq)
    rng = np.random.default_rng(0)
    packed = np.zeros((B, 2 + W), dtype=np.int32)
    packed[:, 0] = rng.integers(1, model.n_seq - 2, B)
    packed[:, 1] = rng.integers(0, model.n_vocab, B)
    packed[:, 2:] = rng.permutation(engine.n_pages)[:B * W].reshape(B, W)
    lengths = torch.zeros(B, dtype=torch.int32, device=dev)
    last_tokens = torch.zeros(B, dtype=torch.int32, device=dev)
    fn = functools.partial(_decode_rounds, model, engine, attention_impl)
    return fn, (params, state, torch.from_numpy(packed).to(dev), lengths,
                last_tokens)
