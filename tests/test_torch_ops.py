"""PyTorch port vs the JAX package: reference ops, KV quantization and the
drop-mode scatter, on identical numpy inputs.

Integer and quantized results must be bit-exact given identical floats;
float32 attention agrees within rtol=1e-5, atol=1e-6 (the two frameworks
sum in different orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from min_llm_inference_tpu.ops import quant as jq
from min_llm_inference_tpu.ops import reference as jr
from min_llm_inference_tpu_torch.ops import quant as tq
from min_llm_inference_tpu_torch.ops import reference as tr
from min_llm_inference_tpu_torch.ops.indexing import index_set_drop_


def t(x):
    return torch.from_numpy(np.array(x))


def assert_exact(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def assert_close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n_heads", [1, 2, 4])
def test_pack_unpack_int4_exact(n_heads):
    rng = np.random.default_rng(n_heads)
    q = rng.integers(-7, 8, (6, 3, 32)).astype(np.float32)
    packed_j = jq.pack_int4_rows(jnp.asarray(q), n_heads)
    packed_t = tq.pack_int4_rows(t(q), n_heads)
    assert packed_t.dtype == torch.int8
    assert_exact(packed_t, packed_j)
    assert_exact(tq.unpack_int4(packed_t, n_heads),
                 jq.unpack_int4(packed_j, n_heads))
    assert_exact(tq.unpack_int4(packed_t, n_heads), q)


@pytest.mark.parametrize("qmax", [127.0, 7.0])
def test_update_page_scales_exact(qmax):
    rng = np.random.default_rng(1)
    NP = 12
    scales = rng.random(NP).astype(np.float32)
    rows = (rng.standard_normal((5, 40)) * 3).astype(np.float32)
    rows[2] = 0.0                                    # zero row -> scale 0
    row_pid = np.array([3, NP, 0, 7, NP + 5], np.int32)   # OOB = no update
    want = jq.update_page_scales(jnp.asarray(scales), jnp.asarray(rows),
                                 jnp.asarray(row_pid), qmax=qmax)
    got = tq.update_page_scales(t(scales), t(rows), t(row_pid), qmax)
    assert_exact(got, want)


@pytest.mark.parametrize("qmax", [127.0, 7.0])
def test_quantize_rows_against_pages_exact(qmax):
    rng = np.random.default_rng(2)
    P, NP = 8, 6
    scales = (rng.random(NP) * 0.05).astype(np.float32)
    scales[1] = 0.0                                  # unset page -> zeros
    vals = (rng.standard_normal((20, 16)) * 0.4).astype(np.float32)
    # exact half-way products exercise round-half-to-even
    vals[0, :4] = np.float32(scales[0]) * np.array([0.5, 1.5, 2.5, -2.5],
                                                   np.float32)
    flat_idx = rng.integers(0, NP * P + 4, 20).astype(np.int32)  # some OOB
    flat_idx[0] = 3                                  # page 0
    want = jq.quantize_rows_against_pages(
        jnp.asarray(vals), jnp.asarray(flat_idx), jnp.asarray(scales), P,
        qmax)
    got = tq.quantize_rows_against_pages(t(vals), t(flat_idx), t(scales), P,
                                         qmax)
    assert got.dtype == torch.int8
    assert_exact(got, want)


def test_dequantize_rows_exact():
    rng = np.random.default_rng(3)
    q = rng.integers(-127, 128, (4, 5, 8)).astype(np.int8)
    s = rng.random((4, 5)).astype(np.float32)
    assert_exact(tq.dequantize_rows(t(q), t(s)),
                 jq.dequantize_rows(jnp.asarray(q), jnp.asarray(s)))


@pytest.mark.parametrize("case", ["some_kept", "none_kept", "rows"])
def test_index_set_drop_matches_jax_drop_mode(case):
    rng = np.random.default_rng(4)
    if case == "rows":
        dst = rng.standard_normal((6, 3, 2)).astype(np.float32)
        idx = np.array([6, 2, 9, 0, 6], np.int32)
        vals = rng.standard_normal((5, 3, 2)).astype(np.float32)
    else:
        dst = rng.integers(0, 100, 7).astype(np.int32)
        idx = (np.array([7, 3, 8, 1], np.int32) if case == "some_kept"
               else np.array([7, 9, 7], np.int32))
        vals = rng.integers(100, 200, idx.shape[0]).astype(np.int32)
    want = jnp.asarray(dst).at[jnp.asarray(idx)].set(jnp.asarray(vals),
                                                     mode="drop")
    got = t(dst)
    index_set_drop_(got, t(idx), t(vals))
    assert_exact(got, want)


def test_greedy_next_token_exact():
    rng = np.random.default_rng(5)
    B, V, n_seq, eof = 8, 16, 10, 15
    logits = rng.standard_normal((B, V)).astype(np.float32)
    logits[1, [3, 9]] = 50.0                    # tie -> lowest index (3)
    logits[2, eof] = 60.0                       # EOF -> finished
    lengths = np.array([0, 3, 4, n_seq - 1, 5, 0, 1, 2], np.int32)  # cap
    tok_j, len_j = jr.greedy_next_token(jnp.asarray(logits),
                                        jnp.asarray(lengths), n_seq, eof)
    tok_t, len_t = tr.greedy_next_token(t(logits), t(lengths), n_seq, eof)
    assert tok_t.dtype == torch.int32 and len_t.dtype == torch.int32
    assert_exact(tok_t, tok_j)
    assert_exact(len_t, len_j)
    assert tok_t[1] == 3 and tok_t[0] == -1 and len_t[2] == 0 and len_t[3] == 0


def test_token_pos_embed_exact():
    rng = np.random.default_rng(6)
    wte = rng.standard_normal((11, 8)).astype(np.float32)
    wpe = rng.standard_normal((5, 8)).astype(np.float32)
    tokens = np.array([[0, 10, -1], [3, 12, 4]], np.int32)   # clipped ids
    pos = np.array([[0, 1, 2], [4, 6, 0]], np.int32)
    want = jr.token_pos_embed(jnp.asarray(tokens), jnp.asarray(pos),
                              jnp.asarray(wte), jnp.asarray(wpe))
    assert_exact(tr.token_pos_embed(t(tokens), t(pos), t(wte), t(wpe)), want)


@pytest.mark.parametrize("n_heads", [1, 2])
def test_masked_attention_close(n_heads):
    rng = np.random.default_rng(7)
    B, L, D = 5, 12, 16
    q = rng.standard_normal((B, D)).astype(np.float32)
    k = rng.standard_normal((B, L, D)).astype(np.float32)
    v = rng.standard_normal((B, L, D)).astype(np.float32)
    lengths = np.array([0, 1, 5, 12, 7], np.int32)
    want = jr.masked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(lengths), n_heads)
    got = tr.masked_attention(t(q), t(k), t(v), t(lengths), n_heads)
    assert_close(got, want)
    assert torch.all(got[0] == 0)


def test_masked_softmax_and_dense_ops_close():
    rng = np.random.default_rng(8)
    scores = rng.standard_normal((3, 4, 9)).astype(np.float32)
    mask = rng.random((3, 4, 9)) < 0.6
    mask[0, 0] = False                                  # fully masked row
    assert_close(tr.masked_softmax(t(scores), t(mask)),
                 jr.masked_softmax(jnp.asarray(scores), jnp.asarray(mask)))
    x = rng.standard_normal((6, 8)).astype(np.float32)
    w = rng.standard_normal((8, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    assert_close(tr.feed_forward(t(x), t(w), t(b)),
                 jr.feed_forward(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b)))
    wte = rng.standard_normal((7, 8)).astype(np.float32)
    got = tr.tied_logits(t(x), t(wte))
    assert got.dtype == torch.float32
    assert_close(got, jr.tied_logits(jnp.asarray(x), jnp.asarray(wte)))


@pytest.mark.parametrize("n_heads", [1, 2])
def test_causal_masked_attention_close(n_heads):
    from min_llm_inference_tpu.models.model import (
        causal_masked_attention as jca,
    )
    from min_llm_inference_tpu_torch.models.model import (
        causal_masked_attention as tca,
    )

    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((3, 6, 8)).astype(np.float32)
               for _ in range(3))
    lengths = np.array([6, 2, 0], np.int32)
    want = np.asarray(jca(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(lengths), n_heads))
    got = tca(t(q), t(k), t(v), t(lengths), n_heads)
    # rows at positions >= length are garbage by contract: compare valid
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[b, :n].numpy(), want[b, :n],
                                   rtol=1e-5, atol=1e-6)
