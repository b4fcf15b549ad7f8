"""The plain reference against hand-built cases of each model, and the
comparison's arithmetic. CPU only; run with

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from benchmark import spec
from benchmark.reference import check
from benchmark.reference.model import fp8_weights, quantize_pages

gpt2 = spec.arch("gpt2")
Reference, gelu_tanh = gpt2.Reference, gpt2.gelu_tanh


def _cfg(**model):
    m = dict(n_vocab=4, emb_dim=2, n_seq=16, n_layers=1, n_heads=1,
             ffn_dim=0, use_output_proj=False, use_layernorm=False,
             dtype="float32", eof_token_id=3)
    m.update(model)
    return {"model": m, "engine": {"page_size": 2, "kv_dtype": "float32"}}


def test_quantize_pages_hand_case():
    # page 0 rows 0-1, page 1 rows 2-3: scale = absmax(first row) * 2/127
    x = torch.tensor([[1.0, -2.0], [4.0, 0.5], [0.0, 0.0], [3.0, 1.0]])
    got = quantize_pages(x, 2, 127.0)
    s0 = float(np.float32(2.0) * np.float32(2.0 / 127.0))
    # row 1 clips at 127 * s0 = 4.0 exactly
    want0 = [[round(1.0 / s0) * s0, round(-2.0 / s0) * s0],
             [4.0, round(0.5 / s0) * s0]]
    assert torch.allclose(got[:2], torch.tensor(want0), rtol=1e-6)
    # an all-zero first row gives scale 0: the page reads back zeros
    assert torch.equal(got[2:], torch.zeros(2, 2))


def test_quantize_pages_int4_clips_rows_past_the_first():
    x = torch.tensor([[7.0, 0.0], [100.0, -100.0]])
    got = quantize_pages(x, 2, 7.0)
    assert torch.allclose(got[1], torch.tensor([14.0, -14.0]))


def test_reference_block_hand_case():
    """The reference's one-block model (no residual) with float32 weights
    and KV, worked by hand: h = wte[t] + wpe[p]; q, k, v = h W; attention
    of the prompt's last position over all prompt positions; logits =
    out wte^T."""
    wte = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0], [0.5, -1.0]])
    wpe = torch.zeros(16, 2)
    eye = torch.eye(2)
    w = {"wte": wte, "wpe": wpe,
         "layers": [{"wq": eye, "wk": eye, "wv": eye * 2.0}]}
    ref = Reference(_cfg(), w)
    # prompt [0, 1]; served [2]: one decode step at position 1
    logits = ref.served_logits([0, 1], [2])
    s = torch.tensor([0.0, 1.0]) / math.sqrt(2.0)   # q = e1; keys e0, e1
    p = torch.softmax(s, 0)
    out = 2.0 * (p[0] * wte[0] + p[1] * wte[1])
    assert torch.allclose(logits[0], out @ wte.t(), atol=1e-6)


def test_gpt2_block_hand_case():
    """A one-layer pre-LN block with the output projection and the FFN,
    two heads, computed step by step in numpy."""
    rng = np.random.default_rng(0)
    D, F, V = 4, 8, 5
    mats = {k: rng.standard_normal(s).astype(np.float32) * 0.5 for k, s in
            {"wq": (D, D), "wk": (D, D), "wv": (D, D), "wo": (D, D),
             "w_up": (D, F), "w_down": (F, D)}.items()}
    wte = rng.standard_normal((V, D)).astype(np.float32)
    wpe = rng.standard_normal((16, D)).astype(np.float32)
    cfg = _cfg(n_vocab=V, emb_dim=D, n_heads=2, ffn_dim=F,
               use_output_proj=True, use_layernorm=True, eof_token_id=V - 1)
    w = {"wte": torch.from_numpy(wte), "wpe": torch.from_numpy(wpe),
         "layers": [{**{k: torch.from_numpy(v) for k, v in mats.items()},
                     "ln1_g": torch.ones(D), "ln2_g": torch.ones(D)}]}
    prompt, served = [1, 3, 0], [2, 4]
    got = Reference(cfg, w).served_logits(prompt, served).numpy()

    def ln(x):
        mu = x.mean(-1, keepdims=True)
        return (x - mu) / np.sqrt(((x - mu) ** 2).mean(-1, keepdims=True)
                                  + 1e-5)

    def gelu(x):
        return 0.5 * x * (1 + np.tanh(np.sqrt(2 / np.pi)
                                      * (x + 0.044715 * x ** 3)))

    toks = prompt + served[:-1]
    h = wte[toks] + wpe[: len(toks)]
    x = ln(h)
    q, k, v = x @ mats["wq"], x @ mats["wk"], x @ mats["wv"]
    out = np.zeros_like(q)
    for t in range(len(toks)):
        for hd in range(2):
            sl = slice(2 * hd, 2 * hd + 2)
            s = q[t, sl] @ k[: t + 1, sl].T / np.sqrt(2.0)
            p = np.exp(s - s.max())
            out[t, sl] = (p / p.sum()) @ v[: t + 1, sl]
    h = h + out @ mats["wo"]
    h = h + gelu(ln(h) @ mats["w_up"]) @ mats["w_down"]
    want = h[len(prompt) - 1:] @ wte.T
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_prefill_rows_read_raw_kv_decode_rows_the_cache():
    """With a quantized cache, the prompt's positions attend over the raw
    keys and values and the served positions over the cached ones: a
    second layer sees the difference, a one-layer model does not."""
    rng = np.random.default_rng(1)
    D, V = 4, 6
    cfg = _cfg(n_vocab=V, emb_dim=D, n_layers=2, eof_token_id=V - 1)
    cfg["engine"]["kv_dtype"] = "int4"

    def lay():
        return {k: torch.from_numpy(
            rng.standard_normal((D, D)).astype(np.float32))
            for k in ("wq", "wk", "wv")}

    w = {"wte": torch.from_numpy(rng.standard_normal((V, D))
                                 .astype(np.float32)),
         "wpe": torch.from_numpy(rng.standard_normal((16, D))
                                 .astype(np.float32)),
         "layers": [lay(), lay()]}
    ref = Reference(cfg, w)
    prompt = [0, 1, 2, 3, 4]
    a = ref.served_logits(prompt, [1])
    # the same request, every prompt row treated as decoded
    ref._attend_orig = ref._attend
    ref._attend = lambda q, k, v, kq, vq, n: ref._attend_orig(
        q, k, v, kq, vq, 0)
    b = ref.served_logits(prompt, [1])
    assert not torch.allclose(a, b)


def test_gelu_is_gpt2s_gelu_new():
    x = torch.linspace(-4, 4, 101)
    assert torch.allclose(gelu_tanh(x),
                          torch.nn.functional.gelu(x, approximate="tanh"),
                          atol=1e-6)


def test_fp8_weights_lose_precision_columnwise():
    w = torch.randn(64, 8)
    q = fp8_weights(w)
    rel = ((q - w).abs() / w.abs().amax(0)).amax()
    assert 0 < rel < 2 ** -4
    assert torch.allclose(q.abs().amax(0), w.abs().amax(0), rtol=1e-6)


def test_gap_sd():
    logits = torch.tensor([[0.0, 1.0, 3.0], [2.0, 2.0, 2.0 - 1e-3]])
    g = check.gap_sd(logits, torch.tensor([2, 1]))
    assert g[0] == 0 and g[1] == 0
    g = check.gap_sd(logits, torch.tensor([0, 2]))
    assert torch.allclose(g[0], 3.0 / logits[0].std())


def test_sample_holds_the_longest():
    reqs = [([1], [2] * n) for n in (3, 9, 1, 4, 2, 5)]
    got = check.sample(reqs, 5, 3)
    assert len(got) == 3 and ([1], [2] * 9) in got
    assert got == check.sample(reqs, 5, 3)
    assert check.sample(reqs, 5, 10) == reqs


@pytest.mark.parametrize("served,bad", [
    ([5, 6, 7], 0),          # runs to the cap: 3 + 3 = 6
    ([5, 9], 0),             # stops on EOF
    ([5, 6], 1),             # stops early without EOF
    ([9, 5, 6], 1),          # serves past EOF
])
def test_length_faults(served, bad):
    assert check.length_faults([([1, 2, 3], served)], 6, 9) == bad
