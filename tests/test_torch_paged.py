"""PyTorch port vs the JAX package: the paged-KV writers and the gather
oracle, on identical numpy K/V rows.

Pool bytes and page scales must be bit-exact (the JAX int8 prefill takes
its fused Pallas kernel in interpret mode, which the JAX package makes
bit-identical to the plain quantize + window scatter the port uses)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from min_llm_inference_tpu import EngineConfig as JEngineConfig
from min_llm_inference_tpu import ModelConfig as JModelConfig
from min_llm_inference_tpu.models import paged as jp
from min_llm_inference_tpu_torch import EngineConfig, ModelConfig
from min_llm_inference_tpu_torch.models import paged as tp

P = 8
NP = 64
W = 4            # pages per slot: n_seq = 32
M = 6


def configs(kv_dtype, D, n_heads):
    jm = JModelConfig(n_vocab=50, emb_dim=D, n_seq=W * P, n_heads=n_heads,
                      eof_token_id=49)
    je = JEngineConfig(n_slots=M, page_size=P, n_pages=NP, kv_dtype=kv_dtype,
                       max_prefill_batch=M)
    return (jm, je, ModelConfig(**dataclasses.asdict(jm)),
            EngineConfig(**dataclasses.asdict(je)))


def assert_state_equal(st_t, st_j):
    for a, b in zip(st_t.kv_pages, st_j.kv_pages):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for side_t, side_j in ((st_t.k_scales, st_j.k_scales),
                           (st_t.v_scales, st_j.v_scales)):
        for a, b in zip(side_t, side_j):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kv_dtype,n_heads", [
    ("float32", 1), ("int8", 1), ("int8", 2), ("int4", 1), ("int4", 2),
])
@pytest.mark.parametrize("s_pre", [2 * P, 2 * P + 3])  # page multiple or not
def test_prefill_writer_bit_exact(kv_dtype, n_heads, s_pre):
    D = 32
    jm, je, tm, te = configs(kv_dtype, D, n_heads)
    rng = np.random.default_rng(s_pre + 10 * n_heads)
    k = (rng.standard_normal((M, s_pre, D)) * 0.7).astype(np.float32)
    v = (rng.standard_normal((M, s_pre, D)) * 0.7).astype(np.float32)
    # full width, mid-page, one token, padding (0), ...
    plens = np.minimum(np.array([s_pre, s_pre - 3, P + 1, 1, 0, 5], np.int32),
                       s_pre)
    granted = rng.permutation(NP)[: M * W].reshape(M, W).astype(np.int32)

    jst = jp.init_paged_state(jm, je)
    write, fin = jp.make_prefill_kv_writer(
        jst, jnp.asarray(granted), jnp.asarray(plens), s_pre, P, NP,
        n_heads=n_heads)
    write(0, jnp.asarray(k), jnp.asarray(v))

    tst = tp.init_paged_state(tm, te, device="cpu")
    twrite, tfin = tp.make_prefill_kv_writer(
        tst, torch.from_numpy(granted), torch.from_numpy(plens), s_pre, P, NP,
        n_heads=n_heads)
    twrite(0, torch.from_numpy(k), torch.from_numpy(v))
    assert_state_equal(tfin(), fin())
    # the padding row's pages are untouched
    for w in range(W):
        assert torch.all(tfin().kv_pages[0][granted[4, w]] == 0)


@pytest.mark.parametrize("kv_dtype,n_heads", [
    ("float32", 1), ("int8", 1), ("int4", 2),
])
def test_decode_write_bit_exact(kv_dtype, n_heads):
    """_write_kv_tokens (scale reset on fresh pages + quantize + scatter)
    at position lengths-1, dead slots dropped."""
    D, B = 32, 8
    jm, je, tm, te = configs(kv_dtype, D, n_heads)
    rng = np.random.default_rng(11)
    table = rng.permutation(NP)[: B * W].reshape(B, W).astype(np.int32)
    lengths = np.array([0, 1, P, P + 1, 2 * P + 1, W * P, 5, 0], np.int32)
    k = rng.standard_normal((B, D)).astype(np.float32)
    v = rng.standard_normal((B, D)).astype(np.float32)

    def run(mod, arr, state):
        lens = arr(lengths)
        live = lens > 0
        pos = (jnp.maximum(lens - 1, 0) if mod is jp
               else torch.clamp_min(lens - 1, 0))
        tbl = arr(table)
        flat = mod._flat_scatter_indices(tbl, pos, live, P, NP)
        fresh = mod.decode_fresh_pid(tbl, pos, live, P, NP)
        return mod._write_kv_tokens(
            state.kv_pages[0], state.k_scales[0], state.v_scales[0], flat,
            arr(k), arr(v), fresh, n_heads=n_heads)

    jst = jp.init_paged_state(jm, je)
    # non-zero pool and scales: stale content must survive where not written
    jst = jst._replace(kv_pages=(jnp.asarray(
        rng.integers(-100, 100, jst.kv_pages[0].shape)).astype(
            jst.kv_pages[0].dtype),))
    tst = tp.init_paged_state(tm, te, device="cpu")
    tst.kv_pages[0].copy_(torch.from_numpy(np.array(jst.kv_pages[0])))
    if kv_dtype != "float32":
        s = (rng.random(NP) * 0.1).astype(np.float32)
        jst = jst._replace(k_scales=(jnp.asarray(s),),
                           v_scales=(jnp.asarray(s * 2),))
        tst.k_scales[0].copy_(torch.from_numpy(s))
        tst.v_scales[0].copy_(torch.from_numpy(s * 2))
    want = run(jp, jnp.asarray, jst)
    got = run(tp, lambda x: torch.from_numpy(np.array(x)), tst)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kv_dtype,n_heads", [
    ("float32", 2), ("int8", 1), ("int4", 2),
])
def test_gather_oracle_close(kv_dtype, n_heads):
    D, B = 32, 6
    rng = np.random.default_rng(12)
    packed = kv_dtype == "int4"
    Dk = D // 2 if packed else D
    if kv_dtype == "float32":
        pool = rng.standard_normal((NP, 2, P, Dk)).astype(np.float32)
        ks = vs = None
    else:
        pool = rng.integers(-119 if packed else -127, 120 if packed else 128,
                            (NP, 2, P, Dk)).astype(np.int8)
        ks = (rng.random(NP) * 0.05).astype(np.float32)
        vs = (rng.random(NP) * 0.05).astype(np.float32)
    table = rng.integers(-2, NP + 2, (B, W)).astype(np.int32)  # stale ids
    lengths = np.array([0, 1, P, W * P, 9, 17], np.int32)
    q = rng.standard_normal((B, D)).astype(np.float32)

    def opt(x, f):
        return None if x is None else f(x)

    want = jp.jnp_paged_attend(
        jnp.asarray(pool), opt(ks, jnp.asarray), opt(vs, jnp.asarray),
        jnp.asarray(q), jnp.asarray(lengths), jnp.asarray(table), P, n_heads)
    got = tp.torch_paged_attend(
        torch.from_numpy(pool), opt(ks, torch.from_numpy),
        opt(vs, torch.from_numpy), torch.from_numpy(q),
        torch.from_numpy(lengths), torch.from_numpy(table), P, n_heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
