"""The port's dense-view ring partial (``ops/paged_attention_dense.py``) vs
the JAX package's ``dense_paged_partial_bucketed``, on identical numpy
inputs.

The JAX function reads only a power-of-two bucket of each group's pages;
the port reads all W (masked past ring_start), so the outputs are the same.
Float32 sums in another order: live rows with context agree within 1e-4.
Rows without context follow the port's partial contract (o = 0, m = -inf,
l = 0); the JAX function returns another group's partial for a dead slot
whose stale group id points at it, which the merge discards.

The engine with ``attn_dense`` is held against the JAX engine in
tests/test_torch_ring_variants.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from min_llm_inference_tpu import EngineConfig as JEngineConfig
from min_llm_inference_tpu import ModelConfig as JModelConfig
from min_llm_inference_tpu.models import paged as jp
from min_llm_inference_tpu.ops.paged_attention_dense import (
    dense_paged_partial_bucketed as jax_dense,
)
import min_llm_inference_tpu_torch as T
from min_llm_inference_tpu_torch.models import paged as tp
from min_llm_inference_tpu_torch.ops.paged_attention_dense import (
    dense_paged_partial,
)

TOL = dict(rtol=1e-4, atol=1e-4)


def t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def j(x):
    return None if x is None else jnp.asarray(x)


def dense_case(rng, kv, H, B=8, W=4, P=8, D=32, rs=None):
    """Full-grant group rows (random groups; a dead slot's stale row points
    at a live slot's group), ring_start covering 0, page boundaries and the
    full width; pool rows at positions >= ring_start poisoned."""
    NP = (B + 2) * W
    packed = kv == "int4"
    Dk = D // 2 if packed else D
    gids = rng.permutation(NP // W)[:B]
    gids[-1] = gids[2]                            # the dead slot's stale row
    table = (gids[:, None] * W + np.arange(W)[None, :]).astype(np.int32)
    if rs is None:
        rs = np.array([0, 1, P - 1, P, P + 1, 2 * P + 3, W * P - 1, 5],
                      np.int32)
    lens = (rs + rng.integers(1, 4, B)).astype(np.int32)
    lens[-1] = 0                                  # dead, stale ring_start
    if packed:
        pool = (16 * rng.integers(-7, 8, (NP, 2, P, Dk))
                + rng.integers(-7, 8, (NP, 2, P, Dk))).astype(np.int8)
    elif kv == "int8":
        pool = rng.integers(-127, 128, (NP, 2, P, Dk)).astype(np.int8)
    else:
        pool = rng.standard_normal((NP, 2, P, Dk)).astype(np.float32)
    for b in range(B - 1):
        for pos in range(rs[b], W * P):
            pool[table[b, pos // P], :, pos % P] = 99 if kv != "float32" else 1e4
    quant = kv != "float32"
    return dict(
        q=rng.standard_normal((B, D)).astype(np.float32), pool=pool,
        ks=rng.uniform(0.01, 0.1, NP).astype(np.float32) if quant else None,
        vs=rng.uniform(0.01, 0.1, NP).astype(np.float32) if quant else None,
        rs=rs, lens=lens, table=table, packed=packed, P=P)


@pytest.mark.parametrize("kv,H", [("float32", 1), ("float32", 4),
                                  ("int8", 1), ("int8", 4), ("int4", 1),
                                  ("int4", 2)])
def test_dense_partial_matches_jax(kv, H):
    c = dense_case(np.random.default_rng(30 + H + len(kv)), kv, H)
    args = ("q", "pool", "ks", "vs", "rs", "lens", "table")
    kw = dict(n_heads=H, page_size=c["P"], packed_int4=c["packed"])
    want = jax_dense(*(j(c[a]) for a in args), **kw)
    pool = t(c["pool"])
    got = dense_paged_partial(*(pool if a == "pool" else t(c[a])
                                for a in args), **kw)
    np.testing.assert_array_equal(pool.numpy(), c["pool"])   # read-only
    empty = (c["lens"] == 0) | (c["rs"] == 0)
    o, m, l = (x.numpy() for x in got)
    for g, w in zip((o, m, l), want):
        np.testing.assert_allclose(g[~empty], np.asarray(w)[~empty], **TOL)
    assert np.all(o[empty] == 0) and np.all(l[empty] == 0)
    assert np.all(np.isneginf(m[empty]))


@pytest.mark.parametrize("width", [1, 2, 4])
def test_dense_partial_at_every_bucket(width):
    """Live contexts that fit 1, 2 and all 4 pages: the JAX function picks
    a bucket of that width, the port reads all W; the same partial."""
    P = 8
    rng = np.random.default_rng(50 + width)
    rs = rng.integers(1, width * P + 1, 8).astype(np.int32)
    c = dense_case(rng, "int8", 2, rs=rs)
    args = ("q", "pool", "ks", "vs", "rs", "lens", "table")
    kw = dict(n_heads=2, page_size=P, packed_int4=False)
    want = jax_dense(*(j(c[a]) for a in args), **kw)
    got = dense_paged_partial(*(t(c[a]) for a in args), **kw)
    live = c["lens"] > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy()[live], np.asarray(w)[live],
                                   **TOL)


@pytest.mark.parametrize("kv", ["int8", "int4", "float32"])
def test_ring_round_callbacks_dense_match_jax(kv):
    """One layer of one ring round with attn_dense: write_kv then attend
    (dense partial + merge)."""
    rng = np.random.default_rng(70 + len(kv))
    B, W, P, D, H = 8, 4, 8, 32, 2
    c = dense_case(rng, kv, H, B=B, W=W, P=P, D=D)
    NP = c["pool"].shape[0]
    jm = JModelConfig(n_vocab=50, emb_dim=D, n_seq=W * P, n_heads=H,
                      eof_token_id=49)
    je = JEngineConfig(n_slots=B, page_size=P, n_pages=NP, kv_dtype=kv,
                       n_forward_rounds=4, decode_ring=True, attn_dense=True)
    tm = T.ModelConfig(**dataclasses.asdict(jm))
    te = T.EngineConfig(**dataclasses.asdict(je))
    round_idx = 1
    rs = c["rs"]
    lens = np.where(c["lens"] > 0, np.minimum(rs + round_idx + 1, W * P),
                    0).astype(np.int32)
    ring = (rng.integers(-7, 8, (B, 8, 2 * D)).astype(np.int8)
            if kv != "float32"
            else rng.standard_normal((B, 8, 2 * D)).astype(np.float32))
    ring_sc = (rng.uniform(0.01, 0.1, (B, 128)).astype(np.float32)
               if kv != "float32" else None)
    k, v, q = (rng.standard_normal((B, D)).astype(np.float32)
               for _ in range(3))

    jl = dict(pages=[j(c["pool"])], ks=[j(c["ks"])], vs=[j(c["vs"])],
              rings=[j(ring)], scs=[j(ring_sc)])
    jw, ja = jp.make_ring_round_callbacks(
        jm, je, j(c["table"]), jl["pages"], jl["ks"], jl["vs"], jl["rings"],
        jl["scs"], j(lens), j(rs), jnp.int32(round_idx),
        contiguous_pages=True)
    jw(0, None, j(k), j(v), None)
    want = np.asarray(ja(0, j(q), j(lens)))

    tl = dict(pages=[t(c["pool"])], ks=[t(c["ks"])], vs=[t(c["vs"])],
              rings=[t(ring)], scs=[t(ring_sc)])
    tw, ta = tp.make_ring_round_callbacks(
        tm, te, t(c["table"]), tl["pages"], tl["ks"], tl["vs"], tl["rings"],
        tl["scs"], t(lens), t(rs), round_idx)
    tw(0, None, t(k), t(v), None)
    got = ta(0, t(q), t(lens)).numpy()

    np.testing.assert_array_equal(tl["rings"][0].numpy(),
                                  np.asarray(jl["rings"][0]))
    live = lens > 0
    np.testing.assert_allclose(got[live], want[live], **TOL)
