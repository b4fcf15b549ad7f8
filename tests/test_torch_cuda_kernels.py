"""The port's CUDA kernels against their plain PyTorch versions, and the
burst captured as a CUDA graph against the eager burst, on the card.

Every test here is marked ``cuda`` and skips without a GPU. The file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch; tests/conftest.py imports JAX, hence ``--noconftest``:

    python -m pytest --noconftest -m cuda -q tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from min_llm_inference_tpu_torch.models.paged import decode_fresh_pid
from min_llm_inference_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_plain,
)
from min_llm_inference_tpu_torch.ops.paged_attention_dgrid import (
    dgrid_paged_partial,
    dgrid_paged_partial_plain,
)
from min_llm_inference_tpu_torch.ops.paged_attention_flat import (
    paged_decode_attention_flat,
    paged_decode_attention_flat_plain,
)
from min_llm_inference_tpu_torch.ops.paged_attention_grouped import (
    paged_decode_attention_grouped,
    paged_decode_attention_grouped_plain,
)
from min_llm_inference_tpu_torch.ops.prefill_scatter import (
    prefill_quant_scatter,
    prefill_quant_scatter_plain,
)
from min_llm_inference_tpu_torch.ops.quant import kv_qmax, update_page_scales
from min_llm_inference_tpu_torch.ops.random import (
    MASK32,
    prng_key,
    random_bits,
    split,
)
from min_llm_inference_tpu_torch.ops.reference import perturbed_scores
from min_llm_inference_tpu_torch.ops.ring_flush import (
    ring_flush,
    ring_flush_plain,
)
from min_llm_inference_tpu_torch.ops import sampling as tsamp
from min_llm_inference_tpu_torch.ops.quant import pack_int4_rows
from min_llm_inference_tpu_torch.ops.sampling import (
    SELECT_CANDIDATES,
    SELECT_NONE,
    SELECT_WHOLE_ROW,
    sample_next_token,
    sample_next_token_plain,
)
from min_llm_inference_tpu_torch.tools import int4_probe
from min_llm_inference_tpu_torch.tools.fuzz_draws import (
    DRAWS,
    EOF_BIAS,
    check_finished,
    draw_id,
    draw_setup,
    near_tie,
)
from min_llm_inference_tpu_torch.tools.sampling_edges import edge_logits
import min_llm_inference_tpu_torch as T
from min_llm_inference_tpu_torch.runtime import autonomous as tauto

# the wrappers whose launches the burst tests count
KERNELS = {"grouped": paged_decode_attention_grouped,
           "dgrid": dgrid_paged_partial, "flat": paged_decode_attention_flat,
           "prefill": prefill_quant_scatter, "sample": sample_next_token}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def stale_dead_rows(rng, table, lengths):
    """Give every dead slot the table row of a random live slot, as the host
    scheduler leaves a freed slot's row while its pages go to others."""
    live = np.nonzero(lengths > 0)[0]
    for d in np.nonzero(lengths == 0)[0]:
        table[d] = table[rng.choice(live)]


def out_of_range(rng, table, lengths, NP, P):
    """Put page ids outside the pool (-1 or NP + 5) into some live slots'
    rows: at the page of their last position (the fused write's page) for
    a few, at an earlier page for others. Reads clamp them into the pool;
    a fused write there is dropped."""
    live = np.nonzero(lengths > 0)[0]
    for i, b in enumerate(live[1::3]):
        col = (lengths[b] - 1) // P if i % 2 == 0 else 0
        table[b, col] = -1 if i % 4 < 2 else NP + 5


# the pool dtype of a float kind ("bfloat16": a float32 draw rounded)
POOL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def grouped_inputs(rng, dev, kv, B, W, P, D, in_dtype, fragmented=False,
                   lengths=None, oob=False):
    """Fused-write inputs: contiguous page groups (or, ``fragmented``, a
    shuffled table whose dead rows hold live slots' page ids), dead slots,
    page-boundary inserts (or the given ``lengths``), page ids outside the
    pool (``oob``), scales already updated for the fresh pages."""
    NG = B + 2
    NP = NG * W
    packed = kv == "int4"
    Dk = D // 2 if packed else D
    gids = rng.permutation(NG)[:B]
    table = (gids[:, None] * W + np.arange(W)[None, :]).astype(np.int32)
    if lengths is None:
        lengths = rng.integers(0, W * P + 1, B).astype(np.int32)
        lengths[:6] = [0, 1, P - 1, P, P + 1, W * P]
    lengths = np.asarray(lengths, np.int32)
    if fragmented:
        table = rng.permutation(NP)[:B * W].reshape(B, W).astype(np.int32)
        stale_dead_rows(rng, table, lengths)
    if oob:
        out_of_range(rng, table, lengths, NP, P)
    if packed:
        pool = (16 * rng.integers(-7, 8, (NP, 2, P, Dk))
                + rng.integers(-7, 8, (NP, 2, P, Dk))).astype(np.int8)
    elif kv == "int8":
        pool = rng.integers(-127, 128, (NP, 2, P, Dk)).astype(np.int8)
    else:
        pool = rng.standard_normal((NP, 2, P, Dk)).astype(np.float32)
    x = {k: torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
         .to(dev, in_dtype) for k in ("q", "k_new", "v_new")}
    x.update(pool=torch.from_numpy(pool).to(dev, POOL_DTYPES.get(kv)),
             lengths=torch.from_numpy(lengths).to(dev),
             table=torch.from_numpy(table).to(dev), ks=None, vs=None)
    if kv in ("int8", "int4"):
        live = x["lengths"] > 0
        pos = torch.clamp_min(x["lengths"] - 1, 0)
        fresh = decode_fresh_pid(x["table"], pos, live, P, NP)
        for side, new in (("ks", "k_new"), ("vs", "v_new")):
            s = torch.from_numpy(
                (rng.random(NP) * 0.05 + 0.001).astype(np.float32)).to(dev)
            x[side] = update_page_scales(s, x[new], fresh, kv_qmax(packed))
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8", "int4"])
@pytest.mark.parametrize("H,in_dtype", [(1, torch.bfloat16),
                                        (2, torch.float32)])
def test_grouped_kernel_matches_plain(cuda, kv, H, in_dtype):
    """Pool bytes bit-identical; o within 1e-5 * max(1, |o|) (float32 sums
    in another order); dead slots exactly zero; mode (a) too."""
    x = grouped_inputs(np.random.default_rng(9), cuda, kv, 64, 4, 16, 64,
                       in_dtype)
    kw = dict(n_heads=H, packed_int4=kv == "int4")
    rest = (x["lengths"], x["table"], x["ks"], x["vs"])
    pool_k, pool_p = x["pool"].clone(), x["pool"].clone()
    before = paged_decode_attention_grouped.launches
    o_k, _ = paged_decode_attention_grouped(x["q"], pool_k, *rest, x["k_new"],
                                            x["v_new"], **kw)
    o_p, _ = paged_decode_attention_grouped_plain(
        x["q"], pool_p, *rest, x["k_new"], x["v_new"], **kw)
    assert paged_decode_attention_grouped.launches == before + 1
    assert torch.equal(pool_k, pool_p)
    tol = 1e-5 * max(1.0, o_p.abs().max().item())
    assert (o_k - o_p).abs().max().item() <= tol
    assert torch.all(o_k[x["lengths"] == 0] == 0)
    o_a = paged_decode_attention_grouped(x["q"], pool_k, *rest, **kw)
    o_ap = paged_decode_attention_grouped_plain(x["q"], pool_k, *rest, **kw)
    assert (o_a - o_ap).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8", "int4"])
def test_grouped_kernel_fragmented_table(cuda, kv):
    """The host engines hand the grouped kernel fragmented tables (one page
    id per page, no contiguous run) whose dead rows hold live page ids:
    pool bytes bit-identical, o within 1e-5 * max(1, |o|)."""
    x = grouped_inputs(np.random.default_rng(31), cuda, kv, 64, 4, 16, 64,
                       torch.bfloat16, fragmented=True)
    kw = dict(n_heads=2, packed_int4=kv == "int4")
    rest = (x["lengths"], x["table"], x["ks"], x["vs"])
    pool_k, pool_p = x["pool"].clone(), x["pool"].clone()
    o_k, _ = paged_decode_attention_grouped(x["q"], pool_k, *rest, x["k_new"],
                                            x["v_new"], **kw)
    o_p, _ = paged_decode_attention_grouped_plain(
        x["q"], pool_p, *rest, x["k_new"], x["v_new"], **kw)
    assert torch.equal(pool_k, pool_p)
    assert (o_k - o_p).abs().max().item() <= 1e-5 * max(
        1.0, o_p.abs().max().item())
    assert torch.all(o_k[x["lengths"] == 0] == 0)


@pytest.mark.cuda
def test_grouped_kernel_rejects_unsupported_pool(cuda):
    """A bfloat16 pool is the kernel's (pool bytes after the fused write
    bit-identical to the plain version's, o close); a float16 pool is
    not."""
    x = grouped_inputs(np.random.default_rng(3), cuda, "float32", 8, 2, 16,
                       32, torch.float32)
    rest = (x["lengths"], x["table"])
    pool_k = x["pool"].to(torch.bfloat16)
    pool_p = pool_k.clone()
    before = paged_decode_attention_grouped.launches
    o_k, _ = paged_decode_attention_grouped(
        x["q"], pool_k, *rest, k_new=x["k_new"], v_new=x["v_new"])
    o_p, _ = paged_decode_attention_grouped_plain(
        x["q"], pool_p, *rest, k_new=x["k_new"], v_new=x["v_new"])
    assert paged_decode_attention_grouped.launches == before + 1
    assert torch.equal(pool_k.view(torch.int16), pool_p.view(torch.int16))
    assert (o_k - o_p).abs().max().item() <= 1e-5 * max(
        1.0, o_p.abs().max().item())
    with pytest.raises(ValueError):
        paged_decode_attention_grouped(
            x["q"], x["pool"].to(torch.float16), *rest,
            k_new=x["k_new"], v_new=x["v_new"])


def partial_inputs(rng, dev, kv, B, W, P, D, in_dtype):
    """Ring-partial inputs: full-grant group rows, ring_start covering 0 (a
    live slot whose context is all in the ring), page boundaries and the
    full width, dead slots with stale ring_start."""
    NG = B + 2
    NP = NG * W
    packed = kv == "int4"
    Dk = D // 2 if packed else D
    gids = rng.permutation(NG)[:B]
    table = (gids[:, None] * W + np.arange(W)[None, :]).astype(np.int32)
    rs = rng.integers(0, W * P, B).astype(np.int32)
    rs[:6] = [0, 1, P - 1, P, P + 1, W * P - 1]
    lengths = np.minimum(rs + rng.integers(1, 8, B), W * P).astype(np.int32)
    lengths[rng.random(B) < 0.1] = 0
    lengths[6] = 0
    if packed:
        pool = (16 * rng.integers(-7, 8, (NP, 2, P, Dk))
                + rng.integers(-7, 8, (NP, 2, P, Dk))).astype(np.int8)
    elif kv == "int8":
        pool = rng.integers(-127, 128, (NP, 2, P, Dk)).astype(np.int8)
    else:
        pool = rng.standard_normal((NP, 2, P, Dk)).astype(np.float32)
    x = dict(q=torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
             .to(dev, in_dtype),
             pool=torch.from_numpy(pool).to(dev, POOL_DTYPES.get(kv)),
             rs=torch.from_numpy(rs).to(dev),
             lengths=torch.from_numpy(lengths).to(dev),
             table=torch.from_numpy(table).to(dev), ks=None, vs=None)
    if kv in ("int8", "int4"):
        for side in ("ks", "vs"):
            x[side] = torch.from_numpy(
                rng.uniform(0.01, 0.1, NP).astype(np.float32)).to(dev)
    return x


def assert_partials_close(got, want, lengths, rs):
    """o, m, l within 1e-4 * max(1, |x|) (float32 sums in another order);
    empty rows (dead, ring_start == 0) exactly o = 0, m = -inf, l = 0."""
    empty = (lengths == 0) | (rs == 0)
    for g, w in zip(got, want):
        g, w = g[~empty], w[~empty]
        tol = 1e-4 * max(1.0, w.abs().max().item())
        assert (g - w).abs().max().item() <= tol
    o, m, l = got
    assert torch.all(o[empty] == 0) and torch.all(l[empty] == 0)
    assert torch.all(torch.isneginf(m[empty]))


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8", "int4"])
@pytest.mark.parametrize("H,D,in_dtype", [(1, 64, torch.bfloat16),
                                          (2, 64, torch.float32),
                                          (12, 96, torch.bfloat16)])
def test_grouped_mode_c_matches_plain(cuda, kv, H, D, in_dtype):
    x = partial_inputs(np.random.default_rng(21), cuda, kv, 64, 4, 16, D,
                       in_dtype)
    kw = dict(ring_start=x["rs"], n_heads=H, packed_int4=kv == "int4")
    args = (x["q"], x["pool"], x["lengths"], x["table"], x["ks"], x["vs"])
    pool0 = x["pool"].clone()
    before = paged_decode_attention_grouped.launches
    got = paged_decode_attention_grouped(*args, **kw)
    want = paged_decode_attention_grouped_plain(*args, **kw)
    assert paged_decode_attention_grouped.launches == before + 1
    assert torch.equal(x["pool"], pool0)          # read-only
    assert_partials_close(got, want, x["lengths"], x["rs"])


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("H,D,in_dtype", [(1, 64, torch.float32),
                                          (4, 64, torch.bfloat16),
                                          (12, 768, torch.bfloat16)])
def test_dgrid_matches_plain(cuda, kv, H, D, in_dtype):
    x = partial_inputs(np.random.default_rng(22), cuda, kv, 64, 4, 32, D,
                       in_dtype)
    args = (x["q"], x["pool"], x["ks"], x["vs"], x["rs"], x["lengths"],
            x["table"])
    before = dgrid_paged_partial.launches
    got = dgrid_paged_partial(*args, n_heads=H, page_size=32)
    want = dgrid_paged_partial_plain(*args, n_heads=H, page_size=32)
    assert dgrid_paged_partial.launches == before + 1
    assert_partials_close(got, want, x["lengths"], x["rs"])


@pytest.mark.cuda
@pytest.mark.parametrize("with_r0", [False, True])
@pytest.mark.parametrize("dtype,Dk", [(torch.int8, 768), (torch.float32, 32),
                                      (torch.bfloat16, 24), (torch.int8, 5)])
def test_ring_flush_matches_plain(cuda, dtype, Dk, with_r0):
    """Pool bytes bit-identical, on 16-byte rows and on odd byte rows."""
    rng = np.random.default_rng(23)
    B, W, P, R, n_rounds = 61, 4, 16, 16, 12
    NP = (B + 3) * W
    table = rng.permutation(NP)[:B * W].reshape(B, W).astype(np.int32)
    r0 = rng.integers(0, n_rounds, B).astype(np.int32)
    rs = rng.integers(0, W * P - n_rounds, B).astype(np.int32)
    lens = np.minimum(rs + rng.integers(1, n_rounds + 3, B), W * P)
    lens[rng.random(B) < 0.15] = 0
    pool = torch.from_numpy(rng.standard_normal((NP, 2, P, Dk)) * 50).to(
        cuda, dtype)
    ring = torch.from_numpy(rng.standard_normal((B, R, 2 * Dk)) * 50).to(
        cuda, dtype)
    args = (ring, torch.from_numpy(rs).to(cuda),
            torch.from_numpy(lens.astype(np.int32)).to(cuda),
            torch.from_numpy(table).to(cuda))
    kw = dict(n_rounds=n_rounds,
              ring_r0=torch.from_numpy(r0).to(cuda) if with_r0 else None)
    pool_k, pool_p = pool.clone(), pool.clone()
    before = ring_flush.launches
    ring_flush(pool_k, *args, **kw)
    ring_flush_plain(pool_p, *args, **kw)
    assert ring_flush.launches == before + 1
    assert torch.equal(pool_k.view(torch.uint8), pool_p.view(torch.uint8))
    assert not torch.equal(pool_k, pool)


@pytest.mark.cuda
@pytest.mark.parametrize("in_dtype,D", [(torch.bfloat16, 768),
                                        (torch.float32, 64),
                                        (torch.bfloat16, 36)])
def test_prefill_quant_scatter_matches_plain(cuda, in_dtype, D):
    """Pool bytes bit-identical; k/v as column slices of one fused
    projection, as the prefill passes them."""
    rng = np.random.default_rng(24)
    M, W_pre, P, NP = 40, 2, 32, 128
    kv = torch.from_numpy(rng.standard_normal((M, W_pre * P, 2 * D)) * 3).to(
        cuda, in_dtype)
    pid = rng.permutation(NP)[:M * W_pre].reshape(M, W_pre).astype(np.int32)
    pid[rng.random((M, W_pre)) < 0.2] = NP
    s = rng.uniform(0.005, 0.05, (2, M, W_pre)).astype(np.float32)
    s[0, 0, 0] = 0.0
    inv = torch.from_numpy(
        np.divide(np.float32(1), s, out=np.zeros_like(s), where=s > 0)).to(cuda)
    pool = torch.from_numpy(rng.integers(-127, 128, (NP, 2, P, D))
                            .astype(np.int8)).to(cuda)
    args = (kv[..., :D], kv[..., D:], torch.from_numpy(pid).to(cuda),
            inv[0].contiguous(), inv[1].contiguous())
    pool_k, pool_p = pool.clone(), pool.clone()
    before = prefill_quant_scatter.launches
    prefill_quant_scatter(pool_k, *args)
    prefill_quant_scatter_plain(pool_p, *args)
    assert prefill_quant_scatter.launches == before + 1
    assert torch.equal(pool_k, pool_p)
    assert not torch.equal(pool_k, pool)


def one_slot_inputs(rng, dev, kv, B, W, P, D, in_dtype, oob=False):
    """One-slot attention inputs as the host scheduler leaves them: a
    shuffled (fragmented) table, dead slots whose stale rows point at live
    slots' pages, lengths on page boundaries and mid-page, q a column slice
    of one fused [B, 3D] projection (``oob``: page ids outside the pool)."""
    NP = B * W + 3
    table = rng.permutation(NP)[:B * W].reshape(B, W).astype(np.int32)
    lengths = rng.integers(1, W * P + 1, B).astype(np.int32)
    lengths[:7] = [0, 1, P - 1, P, P + 1, W * P, 0]
    lengths[rng.random(B) < 0.15] = 0
    stale_dead_rows(rng, table, lengths)
    if oob:
        out_of_range(rng, table, lengths, NP, P)
    if kv == "int8":
        pool = rng.integers(-127, 128, (NP, 2, P, D)).astype(np.int8)
    else:
        pool = rng.standard_normal((NP, 2, P, D)).astype(np.float32)
    qkv = torch.from_numpy(
        rng.standard_normal((B, 3 * D)).astype(np.float32)).to(dev, in_dtype)
    x = dict(q=qkv[:, :D],
             pool=torch.from_numpy(pool).to(dev, POOL_DTYPES.get(kv)),
             lengths=torch.from_numpy(lengths).to(dev),
             table=torch.from_numpy(table).to(dev), ks=None, vs=None)
    if kv == "int8":
        for side in ("ks", "vs"):
            x[side] = torch.from_numpy(
                rng.uniform(0.001, 0.05, NP).astype(np.float32)).to(dev)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("B,W,P,H,D,in_dtype", [
    (64, 4, 16, 1, 64, torch.bfloat16),
    (64, 4, 16, 2, 64, torch.float32),
    (37, 3, 8, 4, 32, torch.float32),      # int8 dh 8: one-element loads
    (64, 4, 16, 12, 96, torch.bfloat16),
    (128, 4, 32, 1, 2048, torch.bfloat16),  # the host path's width
])
def test_one_slot_kernel_matches_plain(cuda, kv, B, W, P, H, D, in_dtype):
    """o within tol * max(1, |o|), tol 1e-5 (1e-4 at D = 2048: float32
    sums of 2048-term dots in another order); dead slots exactly zero;
    the pool unchanged."""
    x = one_slot_inputs(np.random.default_rng(B + D + H), cuda, kv, B, W, P,
                        D, in_dtype)
    args = (x["q"], x["pool"], x["lengths"], x["table"], x["ks"], x["vs"])
    pool0 = x["pool"].clone()
    before = paged_decode_attention.launches
    got = paged_decode_attention(*args, n_heads=H)
    want = paged_decode_attention_plain(*args, n_heads=H)
    assert paged_decode_attention.launches == before + 1
    assert torch.equal(x["pool"], pool0)
    tol = (1e-4 if D >= 2048 else 1e-5) * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol
    assert torch.all(got[x["lengths"] == 0] == 0)


@pytest.mark.cuda
def test_one_slot_kernel_all_dead(cuda):
    x = one_slot_inputs(np.random.default_rng(5), cuda, "int8", 16, 2, 8, 32,
                        torch.float32)
    x["lengths"].zero_()
    got = paged_decode_attention(x["q"], x["pool"], x["lengths"], x["table"],
                                 x["ks"], x["vs"])
    assert torch.all(got == 0)


@pytest.mark.cuda
def test_one_slot_kernel_rejects_unsupported_pools(cuda):
    x = one_slot_inputs(np.random.default_rng(6), cuda, "int8", 8, 2, 8, 32,
                        torch.float32)
    args = (x["lengths"], x["table"], x["ks"], x["vs"])
    with pytest.raises(ValueError):     # packed int4: feature width D/2
        paged_decode_attention(x["q"], x["pool"][..., :16].contiguous(),
                               *args)
    with pytest.raises(ValueError):     # int8 without scales
        paged_decode_attention(x["q"], x["pool"], *args[:2])
    with pytest.raises(ValueError):     # float16 pools are not the kernel's
        paged_decode_attention(x["q"], x["pool"].to(torch.float16), *args[:2])
    # a bfloat16 pool is: o close to the plain version's
    pool = x["pool"].float().mul_(0.01).to(torch.bfloat16)
    got = paged_decode_attention(x["q"], pool, *args[:2])
    want = paged_decode_attention_plain(x["q"], pool, *args[:2])
    assert (got - want).abs().max().item() <= 1e-5 * max(
        1.0, want.abs().max().item())


def half_group_table(rng, rs, W, P, NP):
    """Overcommit rows: two independent half-groups of W/2 pages; a row
    whose context fits its first half ("ungrown") repeats that half."""
    Hp = W // 2
    units = rng.permutation(NP // Hp)
    table = np.zeros((rs.shape[0], W), np.int32)
    for b in range(rs.shape[0]):
        first = units[2 * b] * Hp + np.arange(Hp)
        grown = rs[b] + 4 > Hp * P
        second = units[2 * b + 1] * Hp + np.arange(Hp) if grown else first
        table[b] = np.concatenate([first, second])
    return table


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8", "int4"])
@pytest.mark.parametrize("H,D,in_dtype,table", [
    (1, 64, torch.bfloat16, "groups"), (2, 64, torch.float32, "half"),
    (12, 96, torch.bfloat16, "groups"), (12, 96, torch.float32, "half"),
])
def test_flat_matches_plain(cuda, kv, H, D, in_dtype, table):
    """o, m, l within 1e-4 * max(1, |x|); dead rows (whatever their stale
    ring_start, some > 0) and ring_start == 0 rows empty; the pool
    unchanged; slot counts that do not fill the last block of 8."""
    rng = np.random.default_rng(25 + H + D)
    B, W, P = 61, 4, 16
    x = partial_inputs(rng, cuda, kv, B, W, P, D, in_dtype)
    x["rs"][6] = 5                    # slot 6 is dead: a stale ring_start
    if table == "half":
        rs = x["rs"].cpu().numpy()
        ln = np.minimum(x["lengths"].cpu().numpy(), np.where(
            rs + 4 > W * P // 2, W * P, rs + 3))
        x["lengths"] = torch.from_numpy(ln.astype(np.int32)).to(cuda)
        NP = x["pool"].shape[0]
        x["table"] = torch.from_numpy(
            half_group_table(rng, rs, W, P, NP)).to(cuda)
    args = (x["q"], x["pool"], x["lengths"], x["table"], x["ks"], x["vs"],
            x["rs"])
    kw = dict(n_heads=H, packed_int4=kv == "int4")
    pool0 = x["pool"].clone()
    before = paged_decode_attention_flat.launches
    got = paged_decode_attention_flat(*args, **kw)
    want = paged_decode_attention_flat_plain(*args, **kw)
    assert paged_decode_attention_flat.launches == before + 1
    assert torch.equal(x["pool"], pool0)          # read-only
    assert_partials_close(got, want, x["lengths"], x["rs"])


def run_partial(kind, x, H):
    """One ring-partial kernel call (``kind``: "dgrid" or "flat") and its
    plain version on the inputs ``x``: one launch, the pool unchanged.
    Returns (kernel result, plain result)."""
    if kind == "dgrid":
        args = (x["q"], x["pool"], x["ks"], x["vs"], x["rs"], x["lengths"],
                x["table"])
        kw = dict(n_heads=H, page_size=x["pool"].shape[2])
        kernel, plain = dgrid_paged_partial, dgrid_paged_partial_plain
    else:
        args = (x["q"], x["pool"], x["lengths"], x["table"], x["ks"], x["vs"],
                x["rs"])
        kw = dict(n_heads=H, packed_int4=x["pool"].shape[-1] * 2
                  == x["q"].shape[-1])
        kernel, plain = (paged_decode_attention_flat,
                         paged_decode_attention_flat_plain)
    pool0 = x["pool"].clone()
    before = kernel.launches
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    assert kernel.launches == before + 1
    assert torch.equal(x["pool"], pool0)          # read-only
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("kind,kv,W", [("flat", "int8", 32), ("flat", "int4", 32),
                                       ("dgrid", "int8", 256)])
def test_partial_long_context(cuda, kind, kv, W):
    """12-head contexts that the kernels of the previous design refused for
    shared memory (flat W*P = 1024, dgrid 8192): ring_start at 0, 1, P-1,
    P, P+1 and W*P, dead slots with a stale ring_start."""
    P = 32
    x = partial_inputs(np.random.default_rng(40 + W + len(kv)), cuda, kv,
                       24, W, P, 768, torch.bfloat16)
    x["rs"][7] = W * P
    x["lengths"][7] = W * P
    got, want = run_partial(kind, x, 12)
    assert_partials_close(got, want, x["lengths"], x["rs"])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dgrid", "flat"])
@pytest.mark.parametrize("B", [61, 512])
def test_partial_batch_sizes(cuda, kind, B):
    """61 slots (no multiple of anything) and the drained 512 at the gpt2s
    widths (emb 768, 12 heads, int8)."""
    x = partial_inputs(np.random.default_rng(50 + B), cuda, "int8", B, 4, 32,
                       768, torch.bfloat16)
    got, want = run_partial(kind, x, 12)
    assert_partials_close(got, want, x["lengths"], x["rs"])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dgrid", "flat"])
def test_partial_all_dead(cuda, kind):
    """Every slot dead, with stale ring_starts: every row the empty partial."""
    x = partial_inputs(np.random.default_rng(60), cuda, "int8", 16, 4, 16, 96,
                       torch.float32)
    x["lengths"].zero_()
    (o, m, l), _ = run_partial(kind, x, 12)
    assert torch.all(o == 0) and torch.all(l == 0)
    assert torch.all(torch.isneginf(m))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,kv", [("dgrid", "int8"), ("flat", "int8"),
                                     ("flat", "int4"), ("dgrid", "bfloat16"),
                                     ("flat", "bfloat16")])
def test_partial_narrow_rows(cuda, kind, kv):
    """Rows that are not a multiple of 16 bytes (emb 36 in 3 heads: 36 int8
    or 18 packed bytes) reach the kernel's plain-load path, with 4- and
    1-byte reads."""
    x = partial_inputs(np.random.default_rng(80 + len(kv)), cuda, kv, 24, 4,
                       8, 36, torch.float32)
    got, want = run_partial(kind, x, 3)
    assert_partials_close(got, want, x["lengths"], x["rs"])


@pytest.mark.cuda
def test_bf16_odd_head_width(cuda):
    """bfloat16 heads of 5 features (10-byte segments, rows of 30 bytes):
    2-byte reads and plain loads in every mode of every attention kernel.
    Fused-write pool bytes bit-identical, outputs and partials close."""
    x = grouped_inputs(np.random.default_rng(90), cuda, "bfloat16", 24, 4, 8,
                       15, torch.float32)
    rest = (x["lengths"], x["table"], None, None)
    pool_k, pool_p = x["pool"].clone(), x["pool"].clone()
    o_k, _ = paged_decode_attention_grouped(x["q"], pool_k, *rest, x["k_new"],
                                            x["v_new"], n_heads=3)
    o_p, _ = paged_decode_attention_grouped_plain(
        x["q"], pool_p, *rest, x["k_new"], x["v_new"], n_heads=3)
    assert torch.equal(pool_k.view(torch.int16), pool_p.view(torch.int16))
    assert_close(o_k, o_p)
    assert_close(paged_decode_attention_grouped(x["q"], pool_k, *rest,
                                                n_heads=3),
                 paged_decode_attention_grouped_plain(x["q"], pool_k, *rest,
                                                      n_heads=3))
    y = one_slot_inputs(np.random.default_rng(91), cuda, "bfloat16", 24, 4, 8,
                        15, torch.bfloat16)
    args = (y["q"], y["pool"], y["lengths"], y["table"])
    assert_close(paged_decode_attention(*args, n_heads=3),
                 paged_decode_attention_plain(*args, n_heads=3))
    z = partial_inputs(np.random.default_rng(92), cuda, "bfloat16", 24, 4, 8,
                       15, torch.float32)
    for kind in ("dgrid", "flat"):
        got, want = run_partial(kind, z, 3)
        assert_partials_close(got, want, z["lengths"], z["rs"])
    kw = dict(ring_start=z["rs"], n_heads=3)
    zargs = (z["q"], z["pool"], z["lengths"], z["table"])
    assert_partials_close(paged_decode_attention_grouped(*zargs, **kw),
                          paged_decode_attention_grouped_plain(*zargs, **kw),
                          z["lengths"], z["rs"])


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "int8", "int4"])
def test_flat_fragmented_table(cuda, kv):
    """Distinct random pages per slot; dead rows hold live slots' pages."""
    rng = np.random.default_rng(70 + len(kv))
    B, W = 40, 8
    x = partial_inputs(rng, cuda, kv, B, W, 16, 96, torch.bfloat16)
    table = rng.permutation(x["pool"].shape[0])[:B * W].reshape(B, W)
    stale_dead_rows(rng, table, x["lengths"].cpu().numpy())
    x["table"] = torch.from_numpy(table.astype(np.int32)).to(cuda)
    got, want = run_partial("flat", x, 12)
    assert_partials_close(got, want, x["lengths"], x["rs"])


@pytest.mark.cuda
def test_flat_rejects_unsupported_inputs(cuda):
    x = partial_inputs(np.random.default_rng(5), cuda, "int8", 8, 2, 8, 32,
                       torch.float32)
    args = (x["lengths"], x["table"], x["ks"], x["vs"], x["rs"])
    with pytest.raises(ValueError):     # float16 pools are not the kernel's
        paged_decode_attention_flat(x["q"], x["pool"].to(torch.float16),
                                    x["lengths"], x["table"],
                                    ring_start=x["rs"])
    # a bfloat16 pool is: o, m, l close to the plain version's
    pool = x["pool"].float().mul_(0.01).to(torch.bfloat16)
    got = paged_decode_attention_flat(x["q"], pool, *args[:2],
                                      ring_start=x["rs"])
    want = paged_decode_attention_flat_plain(x["q"], pool, *args[:2], None,
                                             None, x["rs"])
    assert_partials_close(got, want, x["lengths"], x["rs"])
    with pytest.raises(ValueError):     # int8 without scales
        paged_decode_attention_flat(x["q"], x["pool"], *args[:2],
                                    ring_start=x["rs"])
    with pytest.raises(ValueError):     # the ring partial only
        paged_decode_attention_flat(x["q"], x["pool"], *args[:4])


def assert_close(got, want, tol=1e-4):
    """Within tol * max(1, |want|max): float32 sums in another order."""
    lim = tol * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= lim


def check_one_slot(x, H):
    """The one-slot kernel and its plain version on the inputs ``x``: one
    launch, the pool unchanged, o within 1e-4 * max(1, |o|), dead rows
    exactly zero."""
    args = (x["q"], x["pool"], x["lengths"], x["table"], x["ks"], x["vs"])
    pool0 = x["pool"].clone()
    before = paged_decode_attention.launches
    got = paged_decode_attention(*args, n_heads=H)
    want = paged_decode_attention_plain(*args, n_heads=H)
    assert paged_decode_attention.launches == before + 1
    assert torch.equal(x["pool"], pool0)
    assert_close(got, want)
    assert torch.all(got[x["lengths"] == 0] == 0)


def check_grouped(x, H, packed, mode):
    """The grouped kernel in mode (a) or (b) and its plain version on the
    inputs ``x``: one launch; (b) pool bytes bit-identical, (a) the pool
    unchanged; o within 1e-4 * max(1, |o|); dead rows exactly zero.
    Returns the kernel's pool."""
    rest = (x["lengths"], x["table"], x["ks"], x["vs"])
    kw = dict(n_heads=H, packed_int4=packed)
    new = (x["k_new"], x["v_new"]) if mode == "b" else ()
    pool_k, pool_p = x["pool"].clone(), x["pool"].clone()
    before = paged_decode_attention_grouped.launches
    got = paged_decode_attention_grouped(x["q"], pool_k, *rest, *new, **kw)
    want = paged_decode_attention_grouped_plain(x["q"], pool_p, *rest, *new,
                                                **kw)
    assert paged_decode_attention_grouped.launches == before + 1
    if mode == "b":
        (got, _), (want, _) = got, want
    else:
        assert torch.equal(pool_k, x["pool"])
    assert torch.equal(pool_k, pool_p)
    assert_close(got, want)
    assert torch.all(got[x["lengths"] == 0] == 0)
    return pool_k


def check_mode_c(x, H):
    """The grouped kernel's ring partial (mode c) and its plain version."""
    args = (x["q"], x["pool"], x["lengths"], x["table"], x["ks"], x["vs"])
    kw = dict(ring_start=x["rs"], n_heads=H,
              packed_int4=x["pool"].shape[-1] * 2 == x["q"].shape[-1])
    pool0 = x["pool"].clone()
    got = paged_decode_attention_grouped(*args, **kw)
    want = paged_decode_attention_grouped_plain(*args, **kw)
    assert torch.equal(x["pool"], pool0)
    assert_partials_close(got, want, x["lengths"], x["rs"])


def attention_case(cuda, kind, kv, B, W, P, D, H, seed, **extra):
    """Inputs for ``kind`` ("one-slot", "a", "b", "c") and the check."""
    rng = np.random.default_rng(seed)
    if kind == "one-slot":
        check_one_slot(one_slot_inputs(rng, cuda, kv, B, W, P, D,
                                       torch.bfloat16, **extra), H)
    elif kind == "c":
        x = partial_inputs(rng, cuda, kv, B, W, P, D, torch.bfloat16)
        x["rs"][7] = W * P
        x["lengths"][7] = W * P
        check_mode_c(x, H)
    else:
        check_grouped(grouped_inputs(rng, cuda, kv, B, W, P, D,
                                     torch.bfloat16, **extra), H,
                      kv == "int4", kind)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,kv", [
    ("one-slot", "int8"), ("a", "int8"), ("a", "int4"), ("b", "int8"),
    ("b", "int4"), ("c", "int8"), ("c", "int4")])
def test_attention_long_context(cuda, kind, kv):
    """W*P = 4096 (W 128, P 32) at 12 heads of emb 768: contexts that the
    kernels which kept a whole context's scores in shared memory refused
    (one-slot above ~3,340, grouped above ~3,790); lengths at 1, P-1, P,
    P+1 and W*P."""
    attention_case(cuda, kind, kv, 24, 128, 32, 768, 12, 90 + len(kind))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,kv,D", [
    ("one-slot", "int8", 8192), ("one-slot", "float32", 8192),
    ("a", "int8", 8192), ("b", "int8", 8192), ("b", "int4", 8192),
    ("c", "int8", 8192),
    ("one-slot", "float32", 57344),    # the widest row the earlier one-slot
])                                     # kernel took: 14 slices
def test_attention_wide_rows(cuda, kind, kv, D):
    """Rows wider than one block's 4096 features, in one head, at W*P =
    128: cut into feature slices, one block each, in a cluster."""
    if D > 8192:
        attention_case(cuda, kind, kv, 8, 2, 16, D, 1, 7)
    else:
        attention_case(cuda, kind, kv, 32, 4, 32, D, 1, 8 + len(kind))


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_fused_write_positions(cuda, kv):
    """The fused write at every position class of the new row (first,
    middle and last row of a tile, first and last row of a page), with the
    last tile among the ring's first stages and past them, and write pages
    outside the pool; 50 repeats from the same pool, each with pool bytes
    identical to the plain version's and o within 1e-4 * max(1, |o|)."""
    lengths = [0, 1, 4, 8, 9, 12, 16, 17, 20, 24, 25, 31, 32, 33, 36, 40, 47,
               48, 49, 64, 65, 72, 96, 97, 100, 112, 127, 128, 0, 3]
    x = grouped_inputs(np.random.default_rng(12 + len(kv)), cuda, kv,
                       len(lengths), 4, 32, 2048, torch.bfloat16,
                       lengths=lengths, oob=True)
    rest = (x["lengths"], x["table"], x["ks"], x["vs"], x["k_new"],
            x["v_new"])
    kw = dict(n_heads=1, packed_int4=kv == "int4")
    pool_p = x["pool"].clone()
    want, _ = paged_decode_attention_grouped_plain(x["q"], pool_p, *rest,
                                                   **kw)
    assert not torch.equal(pool_p, x["pool"])
    for _ in range(50):
        pool_k = x["pool"].clone()
        got, _ = paged_decode_attention_grouped(x["q"], pool_k, *rest, **kw)
        assert torch.equal(pool_k, pool_p)
        assert_close(got, want)
        assert torch.all(got[x["lengths"] == 0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,kv", [
    ("one-slot", "int8"), ("a", "int8"), ("b", "int8"), ("b", "int4")])
@pytest.mark.parametrize("B", [61, 512])
def test_attention_batch_sizes(cuda, kind, kv, B):
    """61 slots and the drained 512 at the gpt2s widths (emb 768, 12
    heads), with page ids outside the pool in some live rows."""
    attention_case(cuda, kind, kv, B, 4, 32, 768, 12, B + len(kind),
                   oob=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["a", "b", "c"])
def test_grouped_all_dead(cuda, kind):
    """Every slot dead, table rows holding live pages: nothing is read or
    written, o = 0 (mode c: the empty partial)."""
    rng = np.random.default_rng(61)
    if kind == "c":
        x = partial_inputs(rng, cuda, "int8", 16, 4, 16, 96, torch.float32)
        x["lengths"].zero_()
        o, m, l = paged_decode_attention_grouped(
            x["q"], x["pool"], x["lengths"], x["table"], x["ks"], x["vs"],
            ring_start=x["rs"], n_heads=12)
        assert torch.all(o == 0) and torch.all(l == 0)
        assert torch.all(torch.isneginf(m))
        return
    x = grouped_inputs(rng, cuda, "int8", 16, 4, 16, 96, torch.float32,
                       lengths=np.zeros(16, np.int32))
    pool = check_grouped(x, 12, False, kind)
    assert torch.equal(pool, x["pool"])


def check_sample(logits, lengths, key, temperature, top_k, n_seq=128,
                 eof=1023, want_select=None, path=tsamp.PATH_AUTO):
    """The sampling kernel against its plain version on the same inputs:
    its raw draws equal random_bits(sub) bit for bit and its next key the
    plain split's; tokens and lengths are equal, but for at most one row
    whose two best perturbed scores (the plain version's) lie within 1e-6
    of each other, relatively, where the kernel took the other of the
    two. ``want_select``: the select every live row must take; ``path``:
    the launcher's path under top-k (the wrapper's own choice, or a warp
    or a block per row forced)."""
    B, V = logits.shape
    bits = torch.empty(B, V, dtype=torch.int32, device=logits.device)
    sel = torch.empty(B, dtype=torch.int32, device=logits.device)
    before = sample_next_token.launches
    kw = dict(n_seq=n_seq, eof_token_id=eof, temperature=temperature,
              top_k=top_k)
    if path == tsamp.PATH_AUTO:
        tok, lens, nkey = sample_next_token(logits, lengths, key,
                                            bits_out=bits, select_out=sel,
                                            **kw)
    else:
        tok, lens, nkey = tsamp._launch(logits, lengths, key, n_seq, eof,
                                        temperature, top_k, bits, sel, path)
    assert sample_next_token.launches == before + 1
    if want_select is not None:
        assert (sel[lengths > 0] == want_select).all(), sel.unique()
    ptok, plens, pkey = sample_next_token_plain(logits, lengths, key, **kw)
    torch.cuda.synchronize()
    sub = split(key)[1]
    assert torch.equal(bits.long() & MASK32, random_bits(sub, (B, V)))
    assert torch.equal(nkey, pkey)
    rows = (tok != ptok).nonzero().flatten().tolist()
    assert len(rows) <= 1, rows
    for r in rows:
        pert = perturbed_scores(logits[r:r + 1], sub, temperature, top_k)
        top = torch.topk(pert[0], 2)
        gap = float(top.values[0] - top.values[1])
        assert gap <= 1e-6 * abs(float(top.values[0])), (r, gap)
        assert int(tok[r]) in top.indices.tolist()
    keep = torch.ones(B, dtype=torch.bool, device=logits.device)
    keep[rows] = False
    assert torch.equal(lens[keep], plens[keep])
    return tok, lens


def sample_inputs(dev, seed, B, V, dead_share=0.25):
    g = torch.Generator(device="cpu").manual_seed(seed)
    logits = (torch.randn(B, V, generator=g) * 4).to(dev)
    lengths = torch.randint(1, 127, (B,), generator=g, dtype=torch.int32)
    lengths[torch.rand(B, generator=g) < dead_share] = 0
    return logits, lengths.to(dev), prng_key(seed, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("V", [1024, 50257, 60000])
@pytest.mark.parametrize("temperature,top_k", [(0.7, 0), (0.7, 16),
                                               (1.5, 0), (1.5, 16),
                                               (1.0, 1), (1.0, 1000)])
def test_sample_kernel_matches_plain(cuda, V, temperature, top_k):
    """The reference path's width (1024), gpt2s' (50257) and a wider one
    (60000); 1024 rows (256 at the widest), a quarter of them dead."""
    B = 256 if V > 50257 else 1024
    logits, lengths, key = sample_inputs(cuda, V + top_k, B, V)
    tok, lens = check_sample(logits, lengths, key, temperature, top_k)
    dead = lengths == 0
    assert (tok[dead] == T.EMPTY_ROW_TOKEN_ID).all() and (lens[dead] == 0).all()
    assert ((tok[~dead] >= 0) & (tok[~dead] < V)).all()


@pytest.mark.cuda
def test_sample_kernel_edges(cuda):
    """Every row dead; a row at n_seq - 1 and one drawing EOF end; ties at
    the top-k threshold stay in; one row; a strided row slice."""
    logits, lengths, key = sample_inputs(cuda, 3, 64, 512, dead_share=1.0)
    tok, lens = check_sample(logits, lengths, key, 1.0, 8)
    assert (tok == T.EMPTY_ROW_TOKEN_ID).all() and (lens == 0).all()
    logits = torch.full((64, 512), -20.0, device=cuda)
    logits[:, 7] = logits[:, 100] = logits[:, 300] = 5.0
    logits[1, :] = -20.0
    logits[1, 1023 % 512] = 50.0
    lengths = torch.full((64,), 5, dtype=torch.int32, device=cuda)
    lengths[0] = 127
    tok, lens = check_sample(logits, lengths, key, 1.0, 2, eof=1023 % 512)
    assert int(lens[0]) == 0 and int(tok[1]) == 1023 % 512 and lens[1] == 0
    assert set(tok[2:].tolist()) == {7, 100, 300}
    check_sample(logits[:1], lengths[:1], key, 0.7, 0)
    wide = torch.randn(32, 2048, device=cuda)
    check_sample(wide[:, :1000], lengths[:32], key, 1.5, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,V,temperature,top_k,want", [
    ("ties", 1024, 3.0, 3, SELECT_CANDIDATES),
    ("ties", 1024, 3.0, 15, SELECT_CANDIDATES),
    ("ties", 50257, 3.0, 15, SELECT_CANDIDATES),
    ("equal", 1024, 1.0, 16, SELECT_WHOLE_ROW),
    ("equal", 50257, 1.0, 16, SELECT_WHOLE_ROW),
    ("equal", 60000, 1.0, 16, SELECT_WHOLE_ROW),
    ("ninf", 1024, 1.0, 2, None),
    ("ninf", 1024, 1.0, 16, SELECT_WHOLE_ROW),
    ("ninf", 50257, 1.0, 16, SELECT_WHOLE_ROW)])
def test_sample_kernel_edge_inputs(cuda, kind, V, temperature, top_k, want):
    """Ties made by the division (the k-th value on a merged pair: both
    stay in), all-equal rows and rows of -inf with 3 finite values: the
    last two overflow the candidates and reach the whole-row select, in a
    warp (1024) and in a block (50257, 60000)."""
    B = 64
    logits = torch.from_numpy(edge_logits(kind, V + top_k, B, V,
                                          temperature)).to(cuda)
    _, lengths, key = sample_inputs(cuda, top_k, B, 8)
    tok, _ = check_sample(logits, lengths, key, temperature, top_k,
                          want_select=want)
    live = lengths > 0
    assert torch.isfinite(logits[live, tok[live].long()]).all()


# (V, top_k): top_k on each side of a warp's 32 lanes and V - 1 at widths
# not a multiple of 32; top_k 1 and V - 1 on rows narrower than a warp
# (lanes with no column), and on one column (no top-k)
AWKWARD_TOP_K = [pytest.param(V, k, id=f"{k}-{V}")
                 for k in (31, 32, 33, "V-1") for V in (1000, 1023)] + [
    pytest.param(V, k, id=f"{k}-{V}") for V in (1, 7, 31)
    for k in (1, "V-1")]


@pytest.mark.cuda
@pytest.mark.parametrize("V,top_k", AWKWARD_TOP_K)
def test_sample_kernel_awkward_top_k(cuda, V, top_k):
    """Awkward top_k values and widths (AWKWARD_TOP_K): above 32 a warp
    takes the whole-row select; below 32 columns some lanes hold none."""
    k = V - 1 if top_k == "V-1" else top_k
    logits, lengths, key = sample_inputs(cuda, V + k, 256, V)
    check_sample(logits, lengths, key, 1.5, k,
                 want_select=SELECT_WHOLE_ROW if k > 32 else None)


@pytest.mark.cuda
@pytest.mark.parametrize("side", [0, 1])
@pytest.mark.parametrize("top_k", [0, 16])
def test_sample_kernel_switch_sides(cuda, side, top_k):
    """The widest row that runs a warp per row and the narrowest that runs
    a block per row."""
    V = tsamp.narrow_max_v() + side
    logits, lengths, key = sample_inputs(cuda, V + top_k, 512, V)
    check_sample(logits, lengths, key, 1.5, top_k,
                 want_select=SELECT_CANDIDATES if top_k else SELECT_NONE)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["narrow", "wide"])
@pytest.mark.parametrize("V", [1024, 1536, 2048])
@pytest.mark.parametrize("top_k", [16, 50])
def test_sample_kernel_both_paths(cuda, path, V, top_k):
    """A warp per row and a block per row at the same widths: above 32 the
    warp takes the whole-row select, the block its 512 thread parts."""
    logits, lengths, key = sample_inputs(cuda, V + top_k, 512, V)
    want = (SELECT_WHOLE_ROW if path == "narrow" and top_k > 32
            else SELECT_CANDIDATES)
    check_sample(logits, lengths, key, 0.7, top_k, want_select=want,
                 path=tsamp.PATH_NARROW if path == "narrow"
                 else tsamp.PATH_WIDE)


@pytest.mark.cuda
@pytest.mark.parametrize("top_k,want", [(50, SELECT_CANDIDATES),
                                        (2000, SELECT_WHOLE_ROW)])
def test_sample_kernel_wide_selects(cuda, top_k, want):
    """GPT-2's vocabulary: top_k 50 takes the thread parts' threshold,
    top_k 2000 (more than the 512 parts) the whole-row select."""
    logits, lengths, key = sample_inputs(cuda, top_k, 128, 50257)
    check_sample(logits, lengths, key, 1.0, top_k, want_select=want)


@pytest.mark.cuda
def test_sample_kernel_chain_of_rounds(cuda):
    """Round after round the kernel's next key is the plain split's, so a
    burst's draws follow JAX's carry."""
    logits, lengths, key = sample_inputs(cuda, 5, 128, 1024)
    pkey = key.clone()
    for _ in range(5):
        _, _, key = sample_next_token(logits, lengths, key, n_seq=128,
                                      eof_token_id=1023, temperature=1.5,
                                      top_k=16)
        pkey = split(pkey)[0]
    assert torch.equal(key, pkey)


@pytest.mark.cuda
def test_sample_kernel_rejects_unsupported_inputs(cuda):
    logits, lengths, key = sample_inputs(cuda, 6, 8, 64)
    kw = dict(n_seq=128, eof_token_id=1023, temperature=1.0)
    with pytest.raises(ValueError, match="key"):
        sample_next_token(logits, lengths, key.int(), **kw)
    with pytest.raises(ValueError, match="float32"):
        sample_next_token(logits.bfloat16(), lengths, key, **kw)
    with pytest.raises(ValueError, match="logits"):
        sample_next_token(logits.t().contiguous().t(), lengths, key, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("page", ["seed0", "seed1", "seed2", "plus7",
                                  "minus7", "mixed7"])
def test_int4_probe_pages(cuda, page):
    """Seeds, and pages at the ends of the pools' range (every value +7,
    -7, or +-7 with random signs: the largest sums), equal to the plain
    version bit for bit."""
    if page.startswith("seed"):
        x = int4_probe.make_pages(int(page[4:]))
    else:
        sign = {"plus7": 1, "minus7": -1}.get(page)
        if sign is None:
            sign = 2 * np.random.default_rng(5).integers(
                0, 2, int4_probe.SHAPE) - 1
        vals = np.broadcast_to(7 * np.asarray(sign), int4_probe.SHAPE)
        x = pack_int4_rows(torch.from_numpy(vals.astype(np.int8)), 1)
    x = x.to(cuda)
    got = int4_probe.int4_page_self_dot(x)
    want = int4_probe.int4_page_self_dot_plain(x)
    assert torch.equal(got, want)
    if page != "mixed7" and not page.startswith("seed"):
        assert torch.all(want == 512 * 49 / 16)


@pytest.mark.cuda
def test_int4_probe_matches_plain(cuda):
    """The page's self-dot equals unpack + torch.matmul bit for bit; the
    entry point reports SUPPORTED."""
    x = int4_probe.make_pages(7).to(cuda)
    before = int4_probe.int4_page_self_dot.launches
    got = int4_probe.int4_page_self_dot(x)
    assert int4_probe.int4_page_self_dot.launches == before + 1
    assert torch.equal(got, int4_probe.int4_page_self_dot_plain(x))
    assert int4_probe.probe(cuda, strict=True)


# ------------------------------------------------- the burst as a CUDA graph
#
# AutonomousEngine on the card captures a burst into a graph (the liveness
# gate and the prefill bucket as IF nodes); `_capture=False` keeps the eager
# path, which reads both on the host. The two run the same kernels on the
# same inputs and must leave the same bytes.


def graph_model(kind):
    """A small model of the reference path's shape (one bare head) or of
    the gpt2s path's (two pre-LN layers, four heads, FFN, output
    projection), with numpy weights."""
    if kind == "gpt2s":
        model = T.ModelConfig(n_vocab=256, emb_dim=64, n_seq=64, n_layers=2,
                              n_heads=4, ffn_dim=128, use_output_proj=True,
                              use_layernorm=True, eof_token_id=255)
    else:
        model = T.ModelConfig(n_vocab=256, emb_dim=64, n_seq=64,
                              eof_token_id=255)
    rng = np.random.default_rng(5)
    D, F = model.emb_dim, model.ffn_dim

    def u(*shape):
        return (rng.uniform(-1, 1, shape) * 0.02).astype(np.float32)

    wte = u(model.n_vocab, D)
    wte[model.eof_token_id] += 0.05
    layers = []
    for _ in range(model.n_layers):
        layer = {k: u(D, D) for k in ("wq", "wk", "wv")}
        if model.use_output_proj:
            layer["wo"] = u(D, D)
        if F:
            layer.update(w_up=u(D, F), w_down=u(F, D))
        if model.use_layernorm:
            layer.update(ln1_g=np.ones(D, np.float32),
                         ln2_g=np.ones(D, np.float32))
        layers.append(layer)
    return model, {"wte": wte, "wpe": u(model.n_seq, D), "layers": layers}


GRAPH_CASES = {
    "ref": ("ref", dict(kv_dtype="int4", decode_ring=False, subbursts=2)),
    "gpt2s": ("gpt2s", dict(kv_dtype="int8", decode_ring=True,
                            attn_dgrid=True, sort_admits=True)),
    "flat": ("ref", dict(kv_dtype="int4", decode_ring=True, attn_flat=True,
                         subbursts=2)),
    "overcommit": ("ref", dict(kv_dtype="int8", decode_ring=False,
                               overcommit=True, n_pages=24)),
}


def graph_engines(dev, case, **kw):
    kind, extra = GRAPH_CASES[case]
    model, tree = graph_model(kind)
    params = T.params_from_numpy(tree, model, dev)
    cfg = T.EngineConfig(**{**dict(n_slots=16, page_size=16, n_pages=64,
                                   n_forward_rounds=4), **extra})
    return [T.AutonomousEngine(params, model, cfg, device=dev,
                               max_new_per_burst=8, _capture=c, **kw)
            for c in (True, False)]


def graph_prompts(seed, n, plen=24):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, int(rng.integers(1, plen))).tolist()
            for _ in range(n)]


def load_queue(prog, prompts):
    for i, p in enumerate(prompts):
        prog.prompts[i, :len(p)] = torch.tensor(p)
        prog.plens[i] = len(p)
    prog.n_real.fill_(len(prompts))


def assert_same_state(a, b, what):
    for i, (x, y) in enumerate(zip(tauto._state_tensors(a),
                                   tauto._state_tensors(b))):
        assert torch.equal(x, y), f"{what}: state tensor {i} differs"


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_graph_burst_equals_eager(cuda, case):
    """Burst by burst, one graph replay leaves every state byte (pools,
    scales, tables, queue, outputs) and the status as one eager CUDA burst
    does; then whole runs, the drain downshift's narrower graph included,
    give the same tokens, and the graph's launches are counted on the
    device."""
    graph_eng, eager_eng = graph_engines(cuda, case, min_drain_slots=8)
    prompts = graph_prompts(11, 40)
    progs = []
    for eng in (graph_eng, eager_eng):
        prog = eng._program(len(prompts), 32, eng._widths())
        prog.reset()
        load_queue(prog, prompts)
        progs.append(prog)
    assert set(progs[0].graphs) == {16, 8} and not progs[1].graphs
    B = graph_eng.engine_cfg.n_slots
    for k in range(60):
        assert progs[0].burst(B) == 0
        assert progs[1].burst(B) > 0            # eager: host reads
        assert_same_state(progs[0].st[B], progs[1].st[B], f"burst {k}")
        assert torch.equal(progs[0].status, progs[1].status)
        if progs[0].status[0] == 0 and progs[0].status[1] == len(prompts):
            break
    else:
        raise AssertionError("the queue never drained")
    tokens = []
    for eng in (graph_eng, eager_eng):
        # the first run captures (after an eager warm-up burst per width,
        # whose launches count on the host); the second replays
        for _ in range(2):
            store = T.ItemStorage()
            for i, p in enumerate(prompts):
                store.add_new_item(T.Request(i, list(p)))
            counted = {n: f.launches for n, f in KERNELS.items()}
            eng.stats = T.BurstStats()
            eng.run(store)
        tokens.append([store.finished[i].tokens for i in range(len(prompts))])
        st = eng.stats
        L = eng.model_cfg.n_layers
        attn = ("dgrid" if eng.engine_cfg.attn_dgrid else "flat"
                if eng.engine_cfg.attn_flat else "grouped")
        assert KERNELS[attn].launches - counted[attn] == st.rounds * L > 0
    assert tokens[0] == tokens[1]
    st = graph_eng.stats
    assert st.host_syncs == 2 + -(-st.bursts // graph_eng.chunk) + 1
    assert st.captures == 0


@pytest.mark.cuda
def test_graph_takes_every_prefill_bucket(cuda, monkeypatch):
    """Waves of 30, 100, 200 and 400 requests into 512 free slots admit
    into the prefill blocks of 64, 128, 256 and 512 rows (the eager path's
    bucket reads say so); the graph, whose IF nodes pick the block on the
    device, leaves the same bytes and tokens."""
    model, tree = graph_model("ref")
    params = T.params_from_numpy(tree, model, cuda)
    cfg = T.EngineConfig(n_slots=512, page_size=16, n_pages=2048,
                         n_forward_rounds=4, kv_dtype="int8",
                         decode_ring=False)
    seen = []
    real = tauto.device_switch

    def spy(index, branches):
        if not torch.cuda.is_current_stream_capturing():
            seen.append(int(index))
        return real(index, branches)

    monkeypatch.setattr(tauto, "device_switch", spy)
    prompts = graph_prompts(12, 730, plen=32)
    out, sessions = [], []
    for capture in (True, False):
        eng = T.AutonomousEngine(params, model, cfg, device=cuda,
                                 max_new_per_burst=512, _capture=capture)
        sess = T.StreamingSession(eng, capacity=1024, max_prompt_len=32)
        seen.clear()
        done, lo = {}, 0
        counted = KERNELS["prefill"].launches
        for wave in (30, 100, 200, 400):
            sess.submit([T.Request(i, list(prompts[i]))
                         for i in range(lo, lo + wave)])
            lo += wave
            done.update((r.id, r.tokens) for r in sess.close())
        assert len(done) == len(prompts)
        assert (KERNELS["prefill"].launches - counted
                == sess.stats.prefills * model.n_layers > 0)
        out.append(done)
        sessions.append(sess)
    assert {1, 2, 3, 4} <= set(seen)
    assert out[0] == out[1]
    assert_same_state(sessions[0].st, sessions[1].st, "after the waves")


@pytest.mark.cuda
def test_graph_gate_false_changes_nothing(cuda):
    """With nothing live or queued the replay's gate is false: every state
    byte stays, only the skip counter moves."""
    graph_eng, _ = graph_engines(cuda, "gpt2s")
    prompts = graph_prompts(13, 20)
    prog = graph_eng._program(len(prompts), 32, graph_eng._widths())
    prog.reset()
    load_queue(prog, prompts)
    B = graph_eng.engine_cfg.n_slots
    for _ in range(60):
        prog.burst(B)
        live, head, _, _, _ = prog.status.tolist()
        if live == 0 and head == len(prompts):
            break
    before = [t.clone() for t in tauto._state_tensors(prog.st[B])]
    skipped = int(prog.counts[tauto._SKIPPED])
    prog.burst(B)
    for x, y in zip(tauto._state_tensors(prog.st[B]), before):
        assert torch.equal(x, y)
    assert int(prog.counts[tauto._SKIPPED]) == skipped + 1


@pytest.mark.cuda
def test_graph_second_run_replays(cuda):
    """A second run of one queue shape replays the first run's graphs
    (no capture) and gives the same tokens."""
    graph_eng, _ = graph_engines(cuda, "flat")
    prompts = graph_prompts(14, 30)
    outs = []
    for _ in range(2):
        store = T.ItemStorage()
        for i, p in enumerate(prompts):
            store.add_new_item(T.Request(i, list(p)))
        graph_eng.run(store)
        outs.append([store.finished[i].tokens for i in range(len(prompts))])
        if len(outs) == 1:
            graphs = dict(graph_eng._run_program.graphs)
            captures = graph_eng.stats.captures
    assert outs[0] == outs[1]
    assert graph_eng.stats.captures == captures == len(graphs)
    assert graph_eng._run_program.graphs == graphs


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ref", "gpt2s"])
def test_graph_sampling_burst_equals_eager(cuda, case):
    """Sampled decoding in the graph: burst by burst, a replay leaves every
    state byte (the key included) as an eager burst does; whole runs give
    the same tokens; the sampling kernel launches once per round, counted
    on the device."""
    kw = dict(temperature=1.5, top_k=16, sample_seed=7, min_drain_slots=8)
    graph_eng, eager_eng = graph_engines(cuda, case, **kw)
    prompts = graph_prompts(15, 40)
    progs = []
    for eng in (graph_eng, eager_eng):
        prog = eng._program(len(prompts), 32, eng._widths())
        prog.reset()
        load_queue(prog, prompts)
        progs.append(prog)
    B = graph_eng.engine_cfg.n_slots
    for k in range(60):
        progs[0].burst(B)
        progs[1].burst(B)
        assert_same_state(progs[0].st[B], progs[1].st[B], f"burst {k}")
        if progs[0].status[0] == 0 and progs[0].status[1] == len(prompts):
            break
    else:
        raise AssertionError("the queue never drained")
    tokens = []
    for eng in (graph_eng, eager_eng):
        for _ in range(2):
            store = T.ItemStorage()
            for i, p in enumerate(prompts):
                store.add_new_item(T.Request(i, list(p)))
            counted = KERNELS["sample"].launches
            eng.stats = T.BurstStats()
            eng.run(store)
        tokens.append([store.finished[i].tokens for i in range(len(prompts))])
        assert KERNELS["sample"].launches - counted == eng.stats.rounds > 0
    assert tokens[0] == tokens[1]
    st = graph_eng.stats
    assert st.host_syncs == 2 + -(-st.bursts // graph_eng.chunk) + 1


def mesh_call(model, tree, cfg, prompts, tp, runs=1):
    import dataclasses

    return ("engine_run", dict(
        kind="auto", model=dataclasses.asdict(model),
        engine=dataclasses.asdict(cfg), recipe=("numpy", tree),
        prompts=prompts, tp=tp, attention="grouped", runs=runs,
        engine_kw=dict(max_new_per_burst=8)))


def single_chip_tokens(dev, model, tree, cfg, prompts):
    eng = T.AutonomousEngine(T.params_from_numpy(tree, model, dev), model,
                             cfg, device=dev, max_new_per_burst=8)
    store = T.ItemStorage()
    for i, p in enumerate(prompts):
        store.add_new_item(T.Request(i, list(p)))
    eng.run(store)
    return {i: r.tokens for i, r in store.finished.items()}


@pytest.mark.cuda
def test_mesh_ref_world_size_1_graphed(cuda):
    """ShardedAutonomousEngine at world size 1 (NCCL) on the ref case: its
    burst is a CUDA graph, its tokens the single-chip engine's, its fused
    writes one a round, on the run that replays the first run's graph."""
    from min_llm_inference_tpu_torch.parallel import run_ranks, workers

    model, tree = graph_model("ref")
    cfg = T.EngineConfig(n_slots=16, page_size=16, n_pages=64,
                         n_forward_rounds=4, kv_dtype="int4",
                         decode_ring=False, subbursts=2)
    prompts = graph_prompts(21, 40)
    want = single_chip_tokens(cuda, model, tree, cfg, prompts)
    (r,), = run_ranks(workers.run_cases, 1,
                      ([mesh_call(model, tree, cfg, prompts, 1, runs=2)],),
                      timeout=300)
    assert r["graphed"] and r["stats"]["captures"] == 0
    assert r["tokens"] == want
    assert (r["launches"]["paged_decode_attention_grouped"]
            == r["stats"]["rounds"] > 0)


@pytest.mark.cuda
def test_mesh_tp2_share_device_equals_single_chip(cuda):
    """tp = 2 with both ranks on the one card (gloo, eager bursts) on the
    gpt2s-shaped case (ring, dgrid, int8 KV): the single-chip engine's
    tokens on every rank; dgrid once a layer-round at 2 local heads."""
    from min_llm_inference_tpu_torch.parallel import run_ranks, workers

    model, tree = graph_model("gpt2s")
    cfg = T.EngineConfig(n_slots=16, page_size=16, n_pages=64,
                         n_forward_rounds=4, kv_dtype="int8",
                         decode_ring=True, attn_dgrid=True, sort_admits=True)
    prompts = graph_prompts(22, 40)
    want = single_chip_tokens(cuda, model, tree, cfg, prompts)
    results = run_ranks(workers.run_cases, 2,
                        ([mesh_call(model, tree, cfg, prompts, 2)],),
                        share_device=True, timeout=300)
    for (r,) in results:
        assert not r["graphed"]
        assert r["tokens"] == want
        assert (r["launches"]["dgrid_paged_partial"]
                == r["stats"]["rounds"] * model.n_layers > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("draw", DRAWS, ids=[draw_id(d) for d in DRAWS])
def test_fuzz_draws_through_kernels(cuda, draw):
    """tests/test_torch_fuzz_engines.py's draws on the card: AutonomousEngine
    on its kernels (a CUDA graph a burst; run twice, so the second run
    replays) and PagedEngine on the one-slot kernel ("paged", but for int4
    KV, which it does not take: "grouped") equal PagedEngine on the gather
    oracle ("torch") token for token, every request ending with EOF or at
    the n_seq cap; each kernel path launches its attention kernel. The
    kernels sum in another order than the oracle: a request may differ
    where its first differing token is a near-tie (fuzz_draws.near_tie:
    the top-2 gap below the logit noise of the pool's format; the draws'
    small random weights leave top-2 gaps of ~1e-5, below int4's noise of
    ~1e-4, and 4 of 19 requests of the int4 draw differed on the card), at
    most a quarter of the requests a path."""
    s = draw_setup(draw)
    model = T.ModelConfig(**s["model"])
    params = T.init_params(s["seed"], model, eof_bias=EOF_BIAS, device=cuda)
    cfg = T.EngineConfig(**s["engine"])
    prompts = s["prompts"]

    def tokens_of(eng, runs=1):
        for _ in range(runs):
            store = T.ItemStorage()
            for i, p in enumerate(prompts):
                store.add_new_item(T.Request(i, list(p)))
            eng.run(store)
        return [store.finished[i].tokens for i in range(len(prompts))]

    want = tokens_of(T.PagedEngine(params, model, cfg, attention_impl="torch",
                                   device=cuda))
    check_finished(want, prompts, model.n_seq, model.eof_token_id)
    host_impl = "grouped" if cfg.kv_packed else "paged"
    for make, label, kernel in (
            (lambda: T.AutonomousEngine(params, model, cfg, device=cuda,
                                        attention_impl="grouped",
                                        **s["auto_kw"]),
             "autonomous",
             KERNELS["dgrid" if cfg.attn_dgrid else "grouped"]),
            (lambda: T.PagedEngine(params, model, cfg, device=cuda,
                                   attention_impl=host_impl),
             f"host-{host_impl}",
             paged_decode_attention if host_impl == "paged"
             else KERNELS["grouped"])):
        before = kernel.launches
        got = tokens_of(make(), runs=2)
        assert kernel.launches > before, label
        check_finished(got, prompts, model.n_seq, model.eof_token_id)
        differ = [i for i in range(len(prompts)) if got[i] != want[i]]
        assert len(differ) <= len(prompts) // 4, (
            f"{label}: requests {differ} differ")
        for i in differ:
            j = next(k for k, (a, b) in enumerate(zip(got[i], want[i]))
                     if a != b)
            gap, noise = near_tie(params, model, want[i][:j], cfg.kv_dtype,
                                  cfg.page_size)
            assert gap < noise, (f"{label} request {i} token {j}: "
                                 f"{got[i][j]} vs {want[i][j]}, top-2 gap "
                                 f"{gap} not below the noise {noise}")
