"""The port's one-slot paged decode attention (ops/paged_attention.py, its
plain version on the CPU) against the JAX package's Pallas kernel run in
interpret mode, and the port's decode-round callbacks of the host engines
("paged", "grouped" on a fragmented table, "torch") against the JAX
package's ("pallas", "grouped", "jnp") for one round.

Identical numpy inputs go to both. Tolerances: outputs allclose at 1e-5
(float32 sums in another order); pool bytes and page scales bit-exact."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from min_llm_inference_tpu import EngineConfig as JEngineConfig
from min_llm_inference_tpu import ModelConfig as JModelConfig
from min_llm_inference_tpu.models import paged as jp
from min_llm_inference_tpu.ops.paged_attention import (
    paged_decode_attention as jax_paged_decode_attention,
)
from min_llm_inference_tpu_torch import EngineConfig, ModelConfig
from min_llm_inference_tpu_torch.models import paged as tp
from min_llm_inference_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def fragmented_state(rng, kv, B, W, P, D, lengths):
    """A shuffled page table over a pool with spare pages; every dead slot's
    row holds a live slot's page ids (the host scheduler never clears a
    freed row). Returns numpy (q, pool, table, ks, vs)."""
    NP = B * W + 3
    table = rng.permutation(NP)[:B * W].reshape(B, W).astype(np.int32)
    live = np.nonzero(lengths > 0)[0]
    for d in np.nonzero(lengths == 0)[0]:
        if live.size:
            table[d] = table[rng.choice(live)]
    if kv == "int8":
        pool = rng.integers(-127, 128, (NP, 2, P, D)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, NP).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, NP).astype(np.float32)
    else:
        pool = rng.standard_normal((NP, 2, P, D)).astype(np.float32)
        ks = vs = None
    q = rng.standard_normal((B, D)).astype(np.float32)
    return q, pool, table, ks, vs


def opt(x, f):
    return None if x is None else f(x)


def both(q, pool, lengths, table, ks, vs, H):
    want = jax_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(lengths),
        jnp.asarray(table), opt(ks, jnp.asarray), opt(vs, jnp.asarray),
        n_heads=H, interpret=True)
    got = paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(pool),
        torch.from_numpy(lengths), torch.from_numpy(table),
        opt(ks, torch.from_numpy), opt(vs, torch.from_numpy), n_heads=H)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("B,W,P,D,H", [
    (4, 2, 8, 128, 1),
    (5, 4, 16, 128, 2),    # odd batch, multi-head
    (3, 4, 8, 128, 4),
])
def test_matches_jax_kernel(kv, B, W, P, D, H):
    """Fragmented table, a dead slot with a stale live row, a full slot."""
    rng = np.random.default_rng(B * 100 + H)
    lengths = rng.integers(1, W * P + 1, B).astype(np.int32)
    lengths[0], lengths[-1] = 0, W * P
    state = fragmented_state(rng, kv, B, W, P, D, lengths)
    q, pool, table, ks, vs = state
    got, want = both(q, pool, lengths, table, ks, vs, H)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[lengths == 0] == 0.0)


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_partial_page_lengths(kv):
    """Lengths that end mid-page and on page boundaries mask exactly."""
    rng = np.random.default_rng(7)
    B, W, P, D = 6, 4, 8, 128
    lengths = np.array([1, 7, 8, 9, 17, 32], dtype=np.int32)
    q, pool, table, ks, vs = fragmented_state(rng, kv, B, W, P, D, lengths)
    got, want = both(q, pool, lengths, table, ks, vs, 1)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_all_dead_slots(kv):
    rng = np.random.default_rng(9)
    lengths = np.zeros(4, dtype=np.int32)
    q, pool, table, ks, vs = fragmented_state(rng, kv, 4, 2, 8, 128, lengths)
    got, want = both(q, pool, lengths, table, ks, vs, 1)
    assert np.all(got == 0.0) and np.all(want == 0.0)


def test_stale_dead_row_reads_nothing():
    """A dead slot whose row points at a live slot's pages outputs zeros,
    and changing those pages changes only the live slot's output."""
    rng = np.random.default_rng(4)
    B, W, P, D = 3, 2, 8, 128
    lengths = np.array([11, 0, 5], dtype=np.int32)
    q, pool, table, _, _ = fragmented_state(rng, "float32", B, W, P, D,
                                            lengths)
    table[1] = table[0]
    got, want = both(q, pool, lengths, table, None, None, 1)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[1] == 0.0)
    pool2 = pool.copy()
    pool2[table[0, 0]] += 1.0
    got2, _ = both(q, pool2, lengths, table, None, None, 1)
    assert np.all(got2[1] == 0.0) and np.array_equal(got2[2], got[2])
    assert not np.array_equal(got2[0], got[0])


def test_rejects_packed_int4_pool():
    q = torch.zeros(2, 32)
    pool = torch.zeros(8, 2, 8, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="int4"):
        paged_decode_attention(q, pool, torch.ones(2, dtype=torch.int32),
                               torch.zeros(2, 2, dtype=torch.int32),
                               torch.ones(8), torch.ones(8))
    tm = ModelConfig(n_vocab=50, emb_dim=32, n_seq=16, eof_token_id=49)
    te = EngineConfig(n_slots=2, page_size=8, n_pages=8, kv_dtype="int4")
    with pytest.raises(ValueError, match="int4"):
        tp.make_paged_fns(tm, te, "paged")


IMPLS = [("paged", "pallas"), ("grouped", "grouped"), ("torch", "jnp")]


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("impl,jax_impl", IMPLS)
def test_round_callbacks_match_jax(kv, impl, jax_impl):
    """One decode round (write the new K/V row at lengths-1, then attend)
    over a fragmented table with stale dead rows: pool bytes and scales
    bit-exact, outputs within 1e-5."""
    B, W, P, D, H = 6, 4, 8, 128, 2
    rng = np.random.default_rng(40 + len(impl))
    lengths = np.array([0, 1, P, P + 1, 2 * P + 1, W * P], np.int32)
    q, pool, table, ks, vs = fragmented_state(rng, kv, B, W, P, D, lengths)
    k = rng.standard_normal((B, D)).astype(np.float32)
    v = rng.standard_normal((B, D)).astype(np.float32)
    NP = pool.shape[0]
    jm = JModelConfig(n_vocab=50, emb_dim=D, n_seq=W * P, n_heads=H,
                      eof_token_id=49)
    je = JEngineConfig(n_slots=B, page_size=P, n_pages=NP, kv_dtype=kv,
                       decode_ring=False)
    tm = ModelConfig(**dataclasses.asdict(jm))
    te = EngineConfig(**dataclasses.asdict(je))

    def run(mod, model, eng, name, arr):
        pools = [arr(pool)]
        kss, vss = [opt(ks, arr)], [opt(vs, arr)]
        lens = arr(lengths)
        write_kv, attend = mod.make_round_kv_callbacks(
            model, eng, name, arr(table), pools, kss, vss, lens)
        write_kv(0, None, arr(k), arr(v), None)
        out = attend(0, arr(q), lens)
        return ([np.asarray(pools[0])] + [np.asarray(x) for x in kss + vss
                                          if x is not None], np.asarray(out))

    want_bytes, want = run(jp, jm, je, jax_impl, jnp.asarray)
    got_bytes, got = run(tp, tm, te, impl,
                         lambda x: torch.from_numpy(np.array(x)))
    for a, b in zip(got_bytes, want_bytes):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[lengths == 0] == 0.0)
