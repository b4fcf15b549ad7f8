"""The port's plain one-slot and fused-write attention against the JAX
kernels at a context (W*P = 4096) that the port's earlier Hopper kernels,
which kept every score of the context in shared memory, refused at 12
heads of emb 768: the plain versions are what the card holds the
streaming kernels against there (tests/test_torch_cuda_kernels.py,
chip_smoke.py).

On the CPU the port's wrappers run their plain versions; the JAX kernels
run in interpret mode, as tests/test_torch_paged_attention.py and
tests/test_torch_grouped_attention.py run them. Both sides take the same
numpy inputs: the written pool bytes (quantized from the same K/V rows
against the same scales) must be identical, and o, float32 sums taken in
another order by the two frameworks, must agree within 1e-4."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from min_llm_inference_tpu.models.paged import decode_fresh_pid as jax_fresh
from min_llm_inference_tpu.ops.paged_attention import (
    paged_decode_attention as jax_one_slot,
)
from min_llm_inference_tpu.ops.paged_attention_grouped import (
    paged_decode_attention_grouped as jax_grouped,
)
from min_llm_inference_tpu.ops.quant import update_page_scales as jax_scales
from min_llm_inference_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
)
from min_llm_inference_tpu_torch.ops.paged_attention_grouped import (
    paged_decode_attention_grouped,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
B, W, P, D, H = 8, 4, 1024, 64, 2


def lengths_of(rng):
    """Dead slots, 1, P-1, P, P+1, the full W*P and one in between."""
    return np.array([0, 1, P - 1, P, P + 1, W * P,
                     int(rng.integers(2 * P, W * P)), 0], np.int32)


def random_pool(rng, kv, NP):
    Dk = D // 2 if kv == "int4" else D
    if kv == "int4":
        return (16 * rng.integers(-7, 8, (NP, 2, P, Dk))
                + rng.integers(-7, 8, (NP, 2, P, Dk))).astype(np.int8)
    if kv == "int8":
        return rng.integers(-127, 128, (NP, 2, P, Dk)).astype(np.int8)
    return rng.standard_normal((NP, 2, P, Dk)).astype(np.float32)


def opt(x, f):
    return None if x is None else f(np.array(x))


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_one_slot_long_context_matches_jax(kv):
    """Fragmented table; every dead slot's row holds a live slot's pages."""
    rng = np.random.default_rng(30 + len(kv))
    NP = B * W + 3
    lengths = lengths_of(rng)
    table = rng.permutation(NP)[:B * W].reshape(B, W).astype(np.int32)
    table[0] = table[5]
    table[7] = table[2]
    pool = random_pool(rng, kv, NP)
    ks = vs = None
    if kv == "int8":
        ks = rng.uniform(0.001, 0.02, NP).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, NP).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    want = jax_one_slot(jnp.asarray(q), jnp.asarray(pool),
                        jnp.asarray(lengths), jnp.asarray(table),
                        opt(ks, jnp.asarray), opt(vs, jnp.asarray),
                        n_heads=H, interpret=True)
    got = paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(pool),
        torch.from_numpy(lengths), torch.from_numpy(table),
        opt(ks, torch.from_numpy), opt(vs, torch.from_numpy), n_heads=H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.all(got.numpy()[lengths == 0] == 0.0)


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_fused_write_long_context_matches_jax(kv):
    """Mode (b) on contiguous page groups: the new rows quantized against
    the updated page scales and written at lengths-1 (a fresh page's row 0
    for lengths 1 and P+1, a page's last row for P and W*P)."""
    rng = np.random.default_rng(40 + len(kv))
    NG = B + 2
    NP = NG * W
    packed = kv == "int4"
    lengths = lengths_of(rng)
    gids = rng.permutation(NG)[:B]
    table = (gids[:, None] * W + np.arange(W)[None, :]).astype(np.int32)
    pool = random_pool(rng, kv, NP)
    q, k_new, v_new = (rng.standard_normal((B, D)).astype(np.float32)
                       for _ in range(3))
    jl, jt = jnp.asarray(lengths), jnp.asarray(table)
    fresh = jax_fresh(jt, jnp.maximum(jl - 1, 0), jl > 0, P, NP)
    ks, vs = (np.array(jax_scales(
        jnp.asarray(rng.uniform(0.001, 0.05, NP).astype(np.float32)),
        jnp.asarray(new), fresh, qmax=7.0 if packed else 127.0))
        for new in (k_new, v_new))
    o_j, pool_j = jax_grouped(
        jnp.asarray(q), jnp.asarray(pool), jl, jt, jnp.asarray(ks),
        jnp.asarray(vs), jnp.asarray(k_new), jnp.asarray(v_new), n_heads=H,
        contiguous_pages=True, packed_int4=packed, interpret=True)
    pool_t = torch.from_numpy(pool.copy())
    o_t, _ = paged_decode_attention_grouped(
        torch.from_numpy(q), pool_t, torch.from_numpy(lengths),
        torch.from_numpy(table), torch.from_numpy(ks), torch.from_numpy(vs),
        torch.from_numpy(k_new), torch.from_numpy(v_new), n_heads=H,
        packed_int4=packed)
    np.testing.assert_array_equal(pool_t.numpy(), np.asarray(pool_j))
    assert not np.array_equal(pool_t.numpy(), pool)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    assert np.all(o_t.numpy()[lengths == 0] == 0.0)
