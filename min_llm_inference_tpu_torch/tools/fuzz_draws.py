"""The cross-engine fuzz draws: odd page sizes, pool pressures, burst
shapes, KV dtypes and prompt lengths, made from a seed with numpy.

Each draw runs one request set through AutonomousEngine on its kernel
path ("grouped") and through PagedEngine on its gather oracle ("torch"),
which must agree token for token: greedy decoding does not depend on how
either engine schedules. The draws are tests/test_fuzz_engines.py's eight
and one at bfloat16 KV; tests/test_torch_fuzz_engines.py runs them on the
CPU against the JAX package's host engine, tests/test_torch_cuda_kernels.py
through the kernels on the card."""

import zlib

import numpy as np
import torch

# (page_size, n_slots, pool_groups, rounds, kv_dtype, n_seq, vocab, flags)
DRAWS = [
    (8, 6, 6, 3, "float32", 40, 128, {}),
    (16, 12, 12, 5, "float32", 48, 256, {}),
    (16, 8, 8, 2, "int8", 64, 256, {}),
    (32, 8, 8, 4, "int8", 64, 512, {}),
    (16, 8, 8, 4, "int4", 64, 256, {}),
    (8, 10, 10, 1, "int8", 32, 128, {}),
    (16, 8, 8, 4, "int8", 64, 256, {"attn_dgrid": True}),
    (8, 6, 6, 3, "float32", 40, 128, {"attn_dgrid": True}),
    (16, 8, 8, 4, "bfloat16", 64, 256, {}),
]
EOF_BIAS = 0.05


def draw_id(draw) -> str:
    page_size, slots, _, rounds, kv, *_, flags = draw
    return f"P{page_size}-B{slots}-R{rounds}-{kv}" + "".join(
        f"-{k}" for k in flags)


def draw_setup(draw) -> dict:
    """A draw's model and engine config fields (emb 64, one head), its
    weight seed (``init_params(seed, eof_bias=EOF_BIAS)``), its prompts
    (twice the slots and three more: admission turnover) and the
    AutonomousEngine options."""
    page_size, slots, groups, rounds, kv, n_seq, vocab, flags = draw
    seed = zlib.crc32(draw_id(draw).encode())
    rng = np.random.default_rng(seed)
    n = 2 * slots + 3
    prompts = [rng.integers(0, vocab - 1, int(rng.integers(1, n_seq // 2)))
               .tolist() for _ in range(n)]
    W = -(-n_seq // page_size)
    return dict(
        model=dict(n_vocab=vocab, emb_dim=64, n_seq=n_seq,
                   eof_token_id=vocab - 1),
        engine=dict(n_slots=slots, page_size=page_size, n_pages=groups * W,
                    n_forward_rounds=rounds, kv_dtype=kv,
                    max_prefill_batch=slots, **flags),
        seed=seed % 97, prompts=prompts,
        auto_kw=dict(max_new_per_burst=slots, bursts_per_chunk=2))


def check_finished(tokens, prompts, n_seq, eof) -> None:
    """Every request generated at least one token and ended with EOF or at
    the n_seq cap."""
    assert len(tokens) == len(prompts)
    for toks, p in zip(tokens, prompts):
        assert len(toks) > len(p)
        assert toks[-1] == eof or len(toks) == n_seq


def _kv_format(x, kv_dtype: str, page_size: int):
    """K or V rows [1, L, D] of one sequence as a pool of ``kv_dtype``
    holds them, in x's dtype: float32 as they are, bfloat16 rounded,
    int8/int4 quantized against their page's scale (absmax of the page's
    row 0 x 2 / qmax, as the engines set it) and read back."""
    if kv_dtype == "float32":
        return x
    if kv_dtype == "bfloat16":
        return x.to(torch.bfloat16).to(x.dtype)
    from ..ops.quant import (PAGE_SCALE_HEADROOM, inv_scale, kv_qmax,
                             quantize_against)

    qmax = kv_qmax(kv_dtype == "int4")
    L = x.shape[1]
    s = x[0, ::page_size].float().abs().amax(-1) * float(
        np.float32(PAGE_SCALE_HEADROOM / qmax))
    s = s.repeat_interleave(page_size)[:L]
    q = quantize_against(x[0], inv_scale(s)[:, None], qmax)
    return (q.float() * s[:, None])[None].to(x.dtype)


def plain_logits(params, model, tokens, kv_dtype="float32", page_size=1):
    """The float32 logits after ``tokens`` by a plain full-sequence forward
    of the model (in its dtype), every layer's K and V as a pool of
    ``kv_dtype`` with pages of ``page_size`` rows holds them: the
    near-tie oracle of the fuzz and of chip_smoke.py."""
    from ..models import model as mm
    from ..ops.reference import feed_forward, tied_logits, token_pos_embed

    dev = params["wte"].device
    t = torch.tensor([tokens], dtype=torch.int32, device=dev)
    pos = torch.arange(len(tokens), dtype=torch.int32, device=dev)[None]
    h = token_pos_embed(t, pos, params["wte"], params["wpe"])
    lens = torch.full((1,), len(tokens), dtype=torch.int32, device=dev)
    for layer in params["layers"]:
        x = mm.layer_attn_input(layer, model, h)
        q, k, v = (feed_forward(x, layer[n]) for n in ("wq", "wk", "wv"))
        k = _kv_format(k, kv_dtype, page_size)
        v = _kv_format(v, kv_dtype, page_size)
        a = mm.causal_masked_attention(q, k, v, lens, model.n_heads)
        h = mm.layer_post(layer, model, h, a)
    return tied_logits(h[0, -1:], params["wte"])[0]


def near_tie(params, model, tokens, kv_dtype, page_size) -> tuple:
    """(gap, noise) at the token after ``tokens``: the top-2 gap of the
    plain float32 logits with the pool's K/V format, and the noise the
    format makes there (the largest logit change against float32 K/V), at
    least 1e-4 x the largest logit (float32 sums in another order). A
    token that differs between two engines is a near-tie when gap <
    noise."""
    got = plain_logits(params, model, tokens, kv_dtype, page_size)
    exact = plain_logits(params, model, tokens)
    top = torch.topk(got, 2)
    noise = max(float((got - exact).abs().max()),
                1e-4 * float(exact.abs().max()))
    return float(top.values[0] - top.values[1]), noise
