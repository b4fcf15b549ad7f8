"""The port's flat ring partial (``ops/paged_attention_flat.py``) and
``AutonomousEngine(attn_flat=True)`` vs the JAX package's.

On the CPU the port's wrapper runs its plain version; the JAX kernel runs in
interpret mode with ``pages_per_dma=1`` (one DMA per page, so any table is
valid), as tests/test_ring_attention.py runs it. Partials are float32 sums
taken in another order by the two frameworks: live rows with context agree
within 1e-4. Rows without context follow the port's partial contract (o =
0, m = -inf, l = 0), where the JAX kernel differs in two ways the merge
cannot see: it gates on ring_start only, so it computes a partial for a
dead slot with a stale ring_start > 0, and it leaves m at its mask value
(-2.4e38, l = 0) for a live slot with ring_start == 0.

The engine with ``attn_flat`` is held against the JAX engine in
tests/test_torch_ring_variants.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from min_llm_inference_tpu import EngineConfig as JEngineConfig
from min_llm_inference_tpu import ModelConfig as JModelConfig
from min_llm_inference_tpu.models import paged as jp
from min_llm_inference_tpu.ops.paged_attention_flat import (
    paged_decode_attention_flat as jax_flat,
)
import min_llm_inference_tpu_torch as T
from min_llm_inference_tpu_torch.models import paged as tp

# tiny CPU tensors: PyTorch's intra-op threads would only contend with the
# other pytest-xdist workers, one per core
torch.set_num_threads(1)
from min_llm_inference_tpu_torch.ops.paged_attention_flat import (
    paged_decode_attention_flat,
    paged_decode_attention_flat_plain,
)

TOL = dict(rtol=1e-4, atol=1e-4)


def t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def j(x):
    return None if x is None else jnp.asarray(x)


def flat_case(rng, kv, H, table_kind, B=8, W=4, P=8, D=32):
    """Random ring-partial inputs. ``table_kind``: "groups" (full-grant
    rows gid * W + arange(W)), "half" (overcommit rows: two independent
    half-groups, an ungrown row's second half repeating its first) or
    "fragmented" (distinct random pages). ring_start covers 0, page
    boundaries and the full width; one dead slot has ring_start > 0. Pool
    rows at positions >= ring_start are poisoned. One pool size for every
    table kind, so the JAX kernel compiles once per (kv, H)."""
    Hp = W // 2
    NP = (B + 2) * W
    packed = kv == "int4"
    Dk = D // 2 if packed else D
    rs = np.array([0, 1, P - 1, P, P + 1, 2 * P + 3, W * P - 1, 5], np.int32)
    lens = (rs + rng.integers(1, 4, B)).astype(np.int32)
    lens[-1] = 0                                  # dead, stale ring_start 5
    grown = np.ones(B, bool)
    if table_kind == "groups":
        gids = rng.permutation(NP // W)[:B]
        table = gids[:, None] * W + np.arange(W)[None, :]
    elif table_kind == "half":
        units = rng.permutation(NP // Hp)
        grown = rs + 3 > Hp * P                   # ungrown: first half only
        grown[[0, 3]] = True                      # grown early is fine too
        table = np.zeros((B, W), np.int64)
        for b in range(B):
            first = units[2 * b] * Hp + np.arange(Hp)
            second = (units[2 * b + 1] * Hp + np.arange(Hp) if grown[b]
                      else first)
            table[b] = np.concatenate([first, second])
    else:
        table = rng.permutation(NP)[:B * W].reshape(B, W)
    table = table.astype(np.int32)
    if packed:
        pool = (16 * rng.integers(-7, 8, (NP, 2, P, Dk))
                + rng.integers(-7, 8, (NP, 2, P, Dk))).astype(np.int8)
    elif kv == "int8":
        pool = rng.integers(-127, 128, (NP, 2, P, Dk)).astype(np.int8)
    else:
        pool = rng.standard_normal((NP, 2, P, Dk)).astype(np.float32)
    for b in range(B - 1):
        top = W * P if grown[b] else Hp * P
        for pos in range(rs[b], top):
            pool[table[b, pos // P], :, pos % P] = 99 if kv != "float32" else 1e4
    quant = kv != "float32"
    return dict(
        q=rng.standard_normal((B, D)).astype(np.float32), pool=pool,
        ks=rng.uniform(0.01, 0.1, NP).astype(np.float32) if quant else None,
        vs=rng.uniform(0.01, 0.1, NP).astype(np.float32) if quant else None,
        rs=rs, lens=lens, table=table, packed=packed)


def assert_partial(got, want, lens, rs):
    """Live rows with context within TOL of the JAX partial; dead rows and
    ring_start == 0 rows exactly the empty partial (JAX's l is 0 there
    too)."""
    empty = (lens == 0) | (rs == 0)
    o, m, l = (x.numpy() for x in got)
    for g, w in zip((o, m, l), want):
        np.testing.assert_allclose(g[~empty], np.asarray(w)[~empty], **TOL)
    assert np.all(o[empty] == 0) and np.all(l[empty] == 0)
    assert np.all(np.isneginf(m[empty]))
    assert np.all(np.isfinite(m[~empty]))
    live_empty = (lens > 0) & (rs == 0)
    assert np.all(np.asarray(want[2])[live_empty] == 0)


@pytest.mark.parametrize("table_kind", ["groups", "half", "fragmented"])
@pytest.mark.parametrize("kv,H", [("int8", 1), ("int8", 2), ("int4", 1),
                                  ("int4", 2), ("float32", 1),
                                  ("float32", 2)])
def test_flat_partial_matches_jax(kv, H, table_kind):
    c = flat_case(np.random.default_rng(7 + H + len(kv) + len(table_kind)),
                  kv, H, table_kind)
    want = jax_flat(j(c["q"]), j(c["pool"]), j(c["lens"]), j(c["table"]),
                    j(c["ks"]), j(c["vs"]), j(c["rs"]), n_heads=H,
                    pages_per_dma=1, packed_int4=c["packed"], interpret=True)
    pool = t(c["pool"])
    before = paged_decode_attention_flat.launches
    got = paged_decode_attention_flat(
        t(c["q"]), pool, t(c["lens"]), t(c["table"]), t(c["ks"]), t(c["vs"]),
        t(c["rs"]), n_heads=H, packed_int4=c["packed"])
    assert paged_decode_attention_flat.launches == before   # plain on CPU
    np.testing.assert_array_equal(pool.numpy(), c["pool"])   # read-only
    assert_partial(got, want, c["lens"], c["rs"])


def test_flat_wrapper_checks():
    c = flat_case(np.random.default_rng(1), "int8", 1, "groups")
    args = (t(c["q"]), t(c["pool"]), t(c["lens"]), t(c["table"]),
            t(c["ks"]), t(c["vs"]))
    with pytest.raises(ValueError):           # the ring partial only
        paged_decode_attention_flat(*args)
    meta = [x.to("meta") for x in args]
    with pytest.raises(ValueError):           # neither CPU nor CUDA
        paged_decode_attention_flat(*meta, t(c["rs"]).to("meta"))
    o, m, l = paged_decode_attention_flat_plain(*args, t(c["rs"]))
    assert o.shape == (8, 32) and m.shape == l.shape == (8, 1)


@pytest.mark.parametrize("kv,with_r0", [("int8", False), ("int4", True),
                                        ("float32", True)])
def test_ring_round_callbacks_flat_match_jax(kv, with_r0):
    """One layer of one ring round with attn_flat: write_kv (scale update,
    quantize, ring column) then attend (flat partial + merge)."""
    rng = np.random.default_rng(60 + with_r0 + len(kv))
    B, W, P, D, H = 8, 4, 8, 32, 2
    c = flat_case(rng, kv, H, "groups", B=B, W=W, P=P, D=D)
    NP = c["pool"].shape[0]
    jm = JModelConfig(n_vocab=50, emb_dim=D, n_seq=W * P, n_heads=H,
                      eof_token_id=49)
    je = JEngineConfig(n_slots=B, page_size=P, n_pages=NP, kv_dtype=kv,
                       n_forward_rounds=4, decode_ring=True, attn_flat=True)
    tm = T.ModelConfig(**dataclasses.asdict(jm))
    te = T.EngineConfig(**dataclasses.asdict(je))
    round_idx = 2
    r0 = rng.integers(0, round_idx + 1, B).astype(np.int32) if with_r0 else None
    rs = c["rs"]
    lens = np.where(c["lens"] > 0, np.minimum(rs + round_idx + 1, W * P),
                    0).astype(np.int32)
    lens[3] = 17                                  # row 0 of a fresh page
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
        jl["scs"], j(lens), j(rs), jnp.int32(round_idx), ring_r0=j(r0),
        contiguous_pages=True)
    jw(0, None, j(k), j(v), None)
    want = np.asarray(ja(0, j(q), j(lens)))

    tl = dict(pages=[t(c["pool"])], ks=[t(c["ks"])], vs=[t(c["vs"])],
              rings=[t(ring)], scs=[t(ring_sc)])
    tw, ta = tp.make_ring_round_callbacks(
        tm, te, t(c["table"]), tl["pages"], tl["ks"], tl["vs"], tl["rings"],
        tl["scs"], t(lens), t(rs), round_idx, ring_r0=t(r0))
    tw(0, None, t(k), t(v), None)
    got = ta(0, t(q), t(lens)).numpy()

    np.testing.assert_array_equal(tl["rings"][0].numpy(),
                                  np.asarray(jl["rings"][0]))
    live = lens > 0
    np.testing.assert_allclose(got[live], want[live], **TOL)

