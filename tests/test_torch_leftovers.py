"""The port's last public names against the JAX package's, on identical
numpy inputs: ops/quant.py ``quantize_rows`` and
``quantize_tokens_per_page`` (mirrors of tests/test_int8_kv.py's
``test_quantize_rows_roundtrip`` and ``test_per_page_quantizer_semantics``),
models/paged.py ``combine_kv_pools``, ops/reference.py ``project_qkv``,
and ``entry()`` (the flagship decode step) at its tiny cut.

Quantized bytes and scales are bit-exact; floats agree within rtol 1e-5,
atol 1e-6 at float32 (the two frameworks sum in different orders); the
entry step's tokens and lengths are equal."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship_cfgs
from min_llm_inference_tpu import init_params as jinit_params
from min_llm_inference_tpu.models import paged as jpaged
from min_llm_inference_tpu.ops import quant as jq
from min_llm_inference_tpu.ops import reference as jr
from min_llm_inference_tpu_torch import entry as tentry
from min_llm_inference_tpu_torch.models import paged as tpaged
from min_llm_inference_tpu_torch.ops import quant as tq
from min_llm_inference_tpu_torch.ops import reference as tr


def t(x):
    return torch.from_numpy(np.array(x))


def assert_exact(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(17, 64), (3, 5, 40)])
def test_quantize_rows_roundtrip(shape):
    """Bytes and scales equal JAX's; the round trip within absmax / 127 of
    each row; a zero row comes back exact zeros."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    x.reshape(-1, shape[-1])[3] = 0.0
    qj, sj = jq.quantize_rows(jnp.asarray(x))
    qt, st = tq.quantize_rows(t(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert_exact(qt, qj)
    assert_exact(st, sj)
    back = tq.dequantize_rows(qt, st).numpy().reshape(-1, shape[-1])
    for row, want in zip(back, x.reshape(-1, shape[-1])):
        denom = np.abs(want).max()
        if denom == 0:
            assert np.all(row == 0)
        else:
            assert np.abs(row - want).max() <= denom / 127.0 + 1e-6


def test_per_page_quantizer_semantics():
    """A prefill-style write sets both touched pages' scales and no other;
    a mid-page decode append keeps its page's scale and clips; a decode
    write at a page's row 0 resets that page's scale. Every step's bytes
    and scales equal JAX's, and the caller's scales are not written."""
    rng = np.random.default_rng(0)
    NP, P, D = 6, 4, 8
    vals = rng.standard_normal((6, D)).astype(np.float32)
    pos = np.arange(6, dtype=np.int32)
    flat = np.where(pos < 4, 2 * P + pos, 5 * P + (pos - 4)).astype(np.int32)
    scales = np.zeros(NP, np.float32)

    def both(v, f, s, p):
        qj, sj = jq.quantize_tokens_per_page(
            jnp.asarray(v), jnp.asarray(f), jnp.asarray(s), P, jnp.asarray(p))
        s_in = t(s)
        qt, st = tq.quantize_tokens_per_page(t(v), t(f), s_in, P, t(p))
        assert_exact(s_in, s)
        assert_exact(qt, qj)
        assert_exact(st, sj)
        return qt.numpy(), st.numpy()

    _, new_scales = both(vals, flat, scales, pos)
    assert new_scales[2] > 0 and new_scales[5] > 0
    assert np.all(new_scales[[0, 1, 3, 4]] == 0)
    v2 = vals[:1] * 100.0
    q2, s2 = both(v2, np.array([5 * P + 2], np.int32), new_scales,
                  np.array([6], np.int32))
    assert s2[5] == new_scales[5] and q2.max() == 127
    _, s3 = both(v2, np.array([1 * P], np.int32), new_scales,
                 np.array([8], np.int32))
    assert s3[1] > 0
    # a row whose flat index lies outside the pool sets no scale
    _, s4 = both(v2, np.array([NP * P + 3], np.int32), new_scales,
                 np.array([0], np.int32))
    np.testing.assert_array_equal(s4, new_scales)


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_combine_kv_pools(dtype):
    rng = np.random.default_rng(1)
    k = (rng.standard_normal((5, 4, 6)) * 50).astype(dtype)
    v = (rng.standard_normal((5, 4, 6)) * 50).astype(dtype)
    got = tpaged.combine_kv_pools(t(k), t(v))
    assert got.shape == (5, 2, 4, 6)
    assert_exact(got, jpaged.combine_kv_pools(jnp.asarray(k), jnp.asarray(v)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_project_qkv(dtype):
    """q, k, v in the input's dtype, within float32 sums in another order
    (bf16: within one bf16 rounding of each other)."""
    rng = np.random.default_rng(2)
    D = 48
    emb = rng.standard_normal((3, 5, D)).astype(np.float32)
    ws = [(rng.standard_normal((D, D)) * 0.1).astype(np.float32)
          for _ in range(3)]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jr.project_qkv(jnp.asarray(emb, jd),
                          *(jnp.asarray(w, jd) for w in ws))
    got = tr.project_qkv(t(emb).to(td), *(t(w).to(td) for w in ws))
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(
        rtol=2 ** -7, atol=1e-6)
    for g, w in zip(got, want):
        assert g.dtype == td and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)), **tol)


def test_flagship_cfgs_are_the_jax_entry():
    for tiny in (False, True):
        jm, je = _flagship_cfgs(tiny)
        tm, te = tentry.flagship_cfgs(tiny)
        assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
        assert dataclasses.asdict(te) == dataclasses.asdict(je)


def test_entry_tiny_matches_jax_decode_step():
    """entry(tiny=True) on the CPU: the step's new tokens, lengths and last
    tokens equal JAX's ``_decode_rounds`` under "jnp" on the same weights
    (JAX's init_params(PRNGKey(0)), which the port's init_params(0)
    equals bit for bit) and scheduler operand; the K/V the step wrote
    within float32 sums of JAX's. "grouped" (the kernel path's plain
    version on the CPU) gives the same tokens."""
    fn, args = tentry.entry("cpu", tiny=True)
    params, state, packed, lengths, last = args
    model, engine = _flagship_cfgs(tiny=True)
    jparams = jinit_params(jax.random.PRNGKey(0), model)
    jstate = jpaged.init_paged_state(model, engine)
    B = engine.n_slots
    jfn = functools.partial(jpaged._decode_rounds, model, engine, "jnp")
    jout = jfn(jparams, jstate, jnp.asarray(packed.numpy()),
               jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.int32))
    jax_state, jlens, jlast, jtoks = jout
    gfn, gargs = tentry.entry("cpu", tiny=True, attention_impl="grouped")
    out = fn(*args)
    gout = gfn(*gargs)
    for st, lens, last_t, toks in (out, gout):
        assert_exact(toks, jtoks)
        assert_exact(lens, jlens)
        assert_exact(last_t, jlast)
    for pool, jpool in zip(out[0].kv_pages, jax_state.kv_pages):
        np.testing.assert_allclose(pool.numpy(), np.asarray(jpool),
                                   rtol=1e-5, atol=1e-6)
