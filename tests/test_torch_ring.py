"""The port's ring-decode pieces vs the JAX package's, on identical numpy
inputs.

On the CPU the port's wrappers run their plain versions; the JAX kernels
run in interpret mode, as the JAX package's own tests run them. Flushed
pool bytes and packed rings must be bit-identical. Partials and merges are
float32 sums taken in another order by the two frameworks (einsum vs the
kernels' dots and reductions), so they agree within rtol 1e-5 (atol 1e-5
on values of order 1)."""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from min_llm_inference_tpu import EngineConfig as JEngineConfig
from min_llm_inference_tpu import ModelConfig as JModelConfig
from min_llm_inference_tpu.models import paged as jp
from min_llm_inference_tpu.ops.paged_attention_dgrid import (
    dgrid_paged_partial as jax_dgrid,
)
from min_llm_inference_tpu.ops.paged_attention_grouped import (
    paged_decode_attention_grouped as jax_grouped,
)
from min_llm_inference_tpu.ops.ring_flush import ring_flush as jax_ring_flush
from min_llm_inference_tpu_torch import EngineConfig, ModelConfig
from min_llm_inference_tpu_torch.models import paged as tp
from min_llm_inference_tpu_torch.ops.paged_attention_dgrid import (
    dgrid_paged_partial,
)
from min_llm_inference_tpu_torch.ops.paged_attention_grouped import (
    paged_decode_attention_grouped,
)
from min_llm_inference_tpu_torch.ops.ring_flush import ring_flush

TOL = dict(rtol=1e-5, atol=1e-5)


def t(x):
    """numpy (bf16 included, via its exact float32 value) -> CPU tensor."""
    if x is None:
        return None
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def j(x):
    return None if x is None else jnp.asarray(x)


def raw_bytes(x):
    """Bit pattern of a tensor or array, for bit-exact comparisons."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.uint8)
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x.view(np.uint8)


# ---------------------------------------------------------------- merge


@pytest.mark.parametrize("with_r0", [False, True])
@pytest.mark.parametrize("quantized,H", [(True, 1), (True, 4), (False, 2)])
def test_merge_ring_partial_matches_jax(with_r0, quantized, H):
    rng = np.random.default_rng(11 + 2 * H + with_r0)
    B, D, R = 9, 32, 8
    lens = rng.integers(1, 40, B).astype(np.int32)
    lens[0] = 0                                   # dead slot
    rs = np.maximum(lens - rng.integers(1, 6, B), 0).astype(np.int32)
    rs[1] = 0                                     # whole context in the ring
    r0 = rng.integers(0, 4, B).astype(np.int32) if with_r0 else None
    o_p = rng.standard_normal((B, D)).astype(np.float32)
    m_p = rng.standard_normal((B, H)).astype(np.float32) * 3
    l_p = rng.uniform(0.5, 20, (B, H)).astype(np.float32)
    # empty page partials (ring_start == 0, dead): o = 0, m = -inf, l = 0
    for b in (0, 1):
        o_p[b], m_p[b], l_p[b] = 0.0, -np.inf, 0.0
    q = rng.standard_normal((B, D)).astype(np.float32)
    if quantized:
        ring = rng.integers(-127, 128, (B, R, 2 * D)).astype(np.int8)
        ring_sc = rng.uniform(0.001, 0.05, (B, 128)).astype(np.float32)
    else:
        ring = rng.standard_normal((B, R, 2 * D)).astype(np.float32)
        ring_sc = None
    want = jp.merge_ring_partial(j(o_p), j(m_p), j(l_p), j(q), j(ring),
                                 j(ring_sc), j(rs), j(lens), H, False,
                                 ring_r0=j(r0))
    got = tp.merge_ring_partial(t(o_p), t(m_p), t(l_p), t(q), t(ring),
                                t(ring_sc), t(rs), t(lens), H, False,
                                ring_r0=t(r0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.all(got.numpy()[0] == 0.0)


@pytest.mark.parametrize("H", [1, 2])
def test_pack_ring_for_flush_bit_exact(H):
    rng = np.random.default_rng(5 + H)
    ring = rng.integers(-7, 8, (5, 8, 2 * 16)).astype(np.int8)
    want = np.asarray(jp.pack_ring_for_flush(j(ring), H))
    got = tp.pack_ring_for_flush(t(ring), H).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- flush


def flush_case(rng, kv, with_r0, B=7, W=4, P=8, R=8, n_rounds=6, Dk=16):
    """Random pool + ring over distinct pages per slot; a dead slot, ring
    spans straddling a page boundary, spans cut by n_rounds - r0."""
    NP = B * W + 5
    table = rng.permutation(NP)[:B * W].reshape(B, W).astype(np.int32)
    r0 = (rng.integers(0, n_rounds, B) if with_r0
          else np.zeros(B, np.int64)).astype(np.int32)
    rs = rng.integers(0, W * P - n_rounds, B).astype(np.int32)
    rs[1] = P - 2                                 # crosses into page 1
    lens = np.minimum(rs + rng.integers(1, n_rounds + 3, B), W * P)
    lens = lens.astype(np.int32)
    lens[2] = 0                                   # dead at flush time
    if kv == "int8":
        pool = rng.integers(-127, 128, (NP, 2, P, Dk)).astype(np.int8)
        ring = rng.integers(-127, 128, (B, R, 2 * Dk)).astype(np.int8)
    else:
        pool = rng.standard_normal((NP, 2, P, Dk)).astype(np.float32)
        ring = rng.standard_normal((B, R, 2 * Dk)).astype(np.float32)
        if kv == "bfloat16":
            pool = pool.astype(ml_dtypes.bfloat16)
            ring = ring.astype(ml_dtypes.bfloat16)
    return dict(pool=pool, ring=ring, rs=rs, lens=lens, table=table,
                r0=r0 if with_r0 else None, n_rounds=n_rounds, P=P, NP=NP)


@pytest.mark.parametrize("with_r0", [False, True])
@pytest.mark.parametrize("kv", ["int8", "float32", "bfloat16"])
def test_ring_flush_matches_jax(kv, with_r0):
    c = flush_case(np.random.default_rng(3 + 7 * with_r0 + len(kv)), kv,
                   with_r0)
    args = (j(c["ring"]), j(c["rs"]), j(c["lens"]), j(c["table"]))
    want_pallas = jax_ring_flush(j(c["pool"]), *args, n_rounds=c["n_rounds"],
                                 ring_r0=j(c["r0"]), interpret=True)
    want_xla = jp.flush_ring_to_pages(
        j(c["pool"]), args[0], args[1], args[2], c["n_rounds"], args[3],
        c["P"], c["NP"], ring_r0=j(c["r0"]))
    pool = t(c["pool"])
    got = ring_flush(pool, t(c["ring"]), t(c["rs"]), t(c["lens"]),
                     t(c["table"]), n_rounds=c["n_rounds"], ring_r0=t(c["r0"]))
    assert got is pool                            # in place
    np.testing.assert_array_equal(raw_bytes(got), raw_bytes(want_pallas))
    np.testing.assert_array_equal(raw_bytes(got), raw_bytes(want_xla))
    assert not np.array_equal(raw_bytes(got), raw_bytes(c["pool"]))
    # the dead slot's pages are untouched
    dead = c["table"][2]
    np.testing.assert_array_equal(raw_bytes(got[dead]),
                                  raw_bytes(c["pool"][dead]))


# ---------------------------------------------------------------- partials


def partial_case(rng, kv, H, B=8, W=4, P=8, D=32):
    """Full-grant group rows (random groups), ring_start covering 0 (a live
    slot whose context is all in the ring), page boundaries and the full
    width, a dead slot; pool rows at positions >= ring_start poisoned."""
    NG = B + 2
    NP = NG * W
    packed = kv == "int4"
    Dk = D // 2 if packed else D
    gids = rng.permutation(NG)[:B]
    table = (gids[:, None] * W + np.arange(W)[None, :]).astype(np.int32)
    rs = np.array([0, 1, P - 1, P, P + 1, 2 * P + 3, W * P - 1, 5], np.int32)
    lens = (rs + rng.integers(1, 4, B)).astype(np.int32)
    lens[-1] = 0                                  # dead (stale ring_start)
    if packed:
        pool = (16 * rng.integers(-7, 8, (NP, 2, P, Dk))
                + rng.integers(-7, 8, (NP, 2, P, Dk))).astype(np.int8)
    elif kv == "int8":
        pool = rng.integers(-127, 128, (NP, 2, P, Dk)).astype(np.int8)
    else:
        pool = rng.standard_normal((NP, 2, P, Dk)).astype(np.float32)
    for b in range(B):
        for pos in range(rs[b], W * P):
            pool[table[b, pos // P], :, pos % P] = 99 if kv != "float32" else 1e4
    quant = kv != "float32"
    return dict(
        q=rng.standard_normal((B, D)).astype(np.float32), pool=pool,
        ks=rng.uniform(0.01, 0.1, NP).astype(np.float32) if quant else None,
        vs=rng.uniform(0.01, 0.1, NP).astype(np.float32) if quant else None,
        rs=rs, lens=lens, table=table, packed=packed, P=P)


def check_partial(got, want, lens, rs, H):
    live = lens > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy()[live], np.asarray(w)[live],
                                   **TOL)
    o, m, l = (x.numpy() for x in got)
    empty = ~live | (rs == 0)
    assert np.all(o[empty] == 0) and np.all(l[empty] == 0)
    assert np.all(np.isneginf(m[empty]))
    assert np.all(np.isfinite(m[~empty]))


@pytest.mark.parametrize("kv,H", [("float32", 1), ("float32", 4),
                                  ("int8", 1), ("int8", 4), ("int4", 4)])
def test_grouped_mode_c_matches_jax(kv, H):
    c = partial_case(np.random.default_rng(20 + H + len(kv)), kv, H)
    want = jax_grouped(j(c["q"]), j(c["pool"]), j(c["lens"]), j(c["table"]),
                       j(c["ks"]), j(c["vs"]), ring_start=j(c["rs"]),
                       n_heads=H, packed_int4=c["packed"], interpret=True)
    pool = t(c["pool"])
    before = paged_decode_attention_grouped.launches
    got = paged_decode_attention_grouped(
        t(c["q"]), pool, t(c["lens"]), t(c["table"]), t(c["ks"]), t(c["vs"]),
        ring_start=t(c["rs"]), n_heads=H, packed_int4=c["packed"])
    assert paged_decode_attention_grouped.launches == before
    np.testing.assert_array_equal(pool.numpy(), c["pool"])   # read-only
    check_partial(got, want, c["lens"], c["rs"], H)


@pytest.mark.parametrize("kv,H", [("float32", 1), ("float32", 4),
                                  ("int8", 1), ("int8", 4)])
def test_dgrid_partial_matches_jax(kv, H):
    c = partial_case(np.random.default_rng(40 + H + len(kv)), kv, H)
    want = jax_dgrid(j(c["q"]), j(c["pool"]), j(c["ks"]), j(c["vs"]),
                     j(c["rs"]), j(c["lens"]), j(c["table"]), n_heads=H,
                     page_size=c["P"], interpret=True)
    before = dgrid_paged_partial.launches
    got = dgrid_paged_partial(t(c["q"]), t(c["pool"]), t(c["ks"]),
                              t(c["vs"]), t(c["rs"]), t(c["lens"]),
                              t(c["table"]), n_heads=H, page_size=c["P"])
    assert dgrid_paged_partial.launches == before
    check_partial(got, want, c["lens"], c["rs"], H)


def test_mode_c_rejects_fused_write():
    c = partial_case(np.random.default_rng(1), "int8", 1)
    with pytest.raises(ValueError):
        paged_decode_attention_grouped(
            t(c["q"]), t(c["pool"]), t(c["lens"]), t(c["table"]), t(c["ks"]),
            t(c["vs"]), t(c["q"]), t(c["q"]), ring_start=t(c["rs"]))


# ---------------------------------------------------------------- one round


@pytest.mark.parametrize("kv,dgrid,with_r0", [
    ("int8", True, False), ("int8", False, True), ("int4", False, False),
    ("float32", True, True),
])
def test_ring_round_callbacks_match_jax(kv, dgrid, with_r0):
    """One layer of one ring round: write_kv (scale update, quantize, ring
    column) then attend (page partial + merge), both branches."""
    rng = np.random.default_rng(60 + dgrid + 2 * with_r0 + len(kv))
    B, W, P, D, H = 8, 4, 8, 32, 4
    NP = (B + 2) * W                              # partial_case's pool
    jm = JModelConfig(n_vocab=50, emb_dim=D, n_seq=W * P, n_heads=H,
                      eof_token_id=49)
    je = JEngineConfig(n_slots=B, page_size=P, n_pages=NP, kv_dtype=kv,
                       n_forward_rounds=4, decode_ring=True, attn_dgrid=dgrid)
    tm = ModelConfig(**dataclasses.asdict(jm))
    te = EngineConfig(**dataclasses.asdict(je))
    c = partial_case(rng, kv, H, B=B, W=W, P=P, D=D)
    table = c["table"]
    round_idx = 2
    r0 = rng.integers(0, round_idx + 1, B).astype(np.int32) if with_r0 else None
    rs = c["rs"]
    lens = np.where(c["lens"] > 0, np.minimum(rs + round_idx + 1, W * P),
                    0).astype(np.int32)
    lens[3] = 17                                  # row 0 of a fresh page
    Dk = c["pool"].shape[-1]
    R = 8
    ring_w = 2 * D
    ring = (rng.integers(-7, 8, (B, R, ring_w)).astype(np.int8)
            if kv != "float32"
            else rng.standard_normal((B, R, ring_w)).astype(np.float32))
    ring_sc = (rng.uniform(0.01, 0.1, (B, 128)).astype(np.float32)
               if kv != "float32" else None)
    k = rng.standard_normal((B, D)).astype(np.float32)
    v = rng.standard_normal((B, D)).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    assert Dk == (D // 2 if kv == "int4" else D)

    jl = dict(pages=[j(c["pool"])], ks=[j(c["ks"])], vs=[j(c["vs"])],
              rings=[j(ring)], scs=[j(ring_sc)])
    jw, ja = jp.make_ring_round_callbacks(
        jm, je, j(table), jl["pages"], jl["ks"], jl["vs"], jl["rings"],
        jl["scs"], j(lens), j(rs), jnp.int32(round_idx), ring_r0=j(r0),
        contiguous_pages=True)
    jw(0, None, j(k), j(v), None)
    want = np.asarray(ja(0, j(q), j(lens)))

    tl = dict(pages=[t(c["pool"])], ks=[t(c["ks"])], vs=[t(c["vs"])],
              rings=[t(ring)], scs=[t(ring_sc)])
    tw, ta = tp.make_ring_round_callbacks(
        tm, te, t(table), tl["pages"], tl["ks"], tl["vs"], tl["rings"],
        tl["scs"], t(lens), t(rs), round_idx, ring_r0=t(r0))
    tw(0, None, t(k), t(v), None)
    got = ta(0, t(q), t(lens)).numpy()

    np.testing.assert_array_equal(tl["rings"][0].numpy(),
                                  np.asarray(jl["rings"][0]))
    if kv != "float32":
        for side in ("ks", "vs", "scs"):
            np.testing.assert_array_equal(tl[side][0].numpy(),
                                          np.asarray(jl[side][0]))
    np.testing.assert_array_equal(tl["pages"][0].numpy(), c["pool"])
    live = lens > 0
    np.testing.assert_allclose(got[live], want[live], **TOL)
