"""bfloat16 KV pools: the port against the JAX package.

Op parity. Each attention wrapper of the port on a bfloat16 pool (on the
CPU it runs its plain version, which widens the pool's bf16 values to
float32 exactly as the CUDA kernel does) against the JAX function, its
Pallas kernel in interpret mode as tests/test_ring_attention.py runs it,
on the same numpy inputs: the grouped kernel's modes (a) plain, (b) fused
write and (c) ring partial, the flat and the dgrid partial, the one-slot
kernel, at 1 and 2 heads. Both read the same bf16 bytes and sum in
float32, so outputs and partials agree within 1e-4 x max(1, |x|); the
pool after the fused write is bit-identical to JAX's, which stores the
float32 row rounded to nearest even.

Engine parity. f32 models with JAX ``init_params`` weights carried over
through numpy, bf16 KV: the port's AutonomousEngine on its kernel path
("grouped") without the ring, with the ring on mode (c), on dgrid and on
the flat partial, and PagedEngine on "grouped" and "paged", each token for
token against the JAX engine of the same kind (AutonomousEngine or
PagedEngine) on its gather oracle "jnp" (which the JAX tests hold
token-exact with its kernel paths), and the ring-free AutonomousEngine
also against JAX's grouped Pallas kernel in interpret mode.

The CUDA kernels at bf16 are held against the plain versions on the card
by tests/test_torch_cuda_kernels.py and chip_smoke.py."""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from min_llm_inference_tpu import EngineConfig as JEngineConfig
from min_llm_inference_tpu import ItemStorage as JItemStorage
from min_llm_inference_tpu import ModelConfig as JModelConfig
from min_llm_inference_tpu import PagedEngine as JPagedEngine
from min_llm_inference_tpu import Request as JRequest
from min_llm_inference_tpu import init_params
from min_llm_inference_tpu.ops.paged_attention import (
    paged_decode_attention as jax_one_slot,
)
from min_llm_inference_tpu.ops.paged_attention_dgrid import (
    dgrid_paged_partial as jax_dgrid,
)
from min_llm_inference_tpu.ops.paged_attention_flat import (
    paged_decode_attention_flat as jax_flat,
)
from min_llm_inference_tpu.ops.paged_attention_grouped import (
    paged_decode_attention_grouped as jax_grouped,
)
from min_llm_inference_tpu.runtime.autonomous import (
    AutonomousEngine as JAutonomousEngine,
)
import min_llm_inference_tpu_torch as T
from min_llm_inference_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
)
from min_llm_inference_tpu_torch.ops.paged_attention_dgrid import (
    dgrid_paged_partial,
)
from min_llm_inference_tpu_torch.ops.paged_attention_flat import (
    paged_decode_attention_flat,
)
from min_llm_inference_tpu_torch.ops.paged_attention_grouped import (
    paged_decode_attention_grouped,
)

torch.set_num_threads(1)

B, W, P, D = 8, 2, 16, 32


def j(x):
    return None if x is None else jnp.asarray(x)


def t(x):
    """numpy (bf16 via its exact float32 value) -> CPU tensor."""
    if x is None:
        return None
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def bits(x):
    """The raw 16-bit patterns of a bf16 array or tensor."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def assert_close(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    lim = 1e-4 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= lim


def case(rng, table_kind="groups"):
    """A bf16 pool over contiguous page groups (or a fragmented table),
    lengths at the page edges, the full width and dead slots, ring_start
    covering 0 and the full context."""
    NP = (B + 2) * W
    if table_kind == "groups":
        gids = rng.permutation(B + 2)[:B]
        table = (gids[:, None] * W + np.arange(W)[None, :]).astype(np.int32)
    else:
        table = rng.permutation(NP)[:B * W].reshape(B, W).astype(np.int32)
    lengths = np.array([0, 1, P - 1, P, P + 1, W * P, P + 3, 0], np.int32)
    rs = np.array([0, 1, P - 1, P - 1, P, W * P - 1, 5, 3], np.int32)
    pool = rng.standard_normal((NP, 2, P, D)).astype(ml_dtypes.bfloat16)
    return dict(q=rng.standard_normal((B, D)).astype(np.float32),
                k_new=rng.standard_normal((B, D)).astype(np.float32),
                v_new=rng.standard_normal((B, D)).astype(np.float32),
                pool=pool, lengths=lengths, rs=rs, table=table)


@pytest.mark.parametrize("H", [1, 2])
def test_grouped_fused_write_matches_jax(H):
    """Mode (b): the written pool bit-identical to JAX's (f32 rows rounded
    to nearest even), o close; then mode (a) on the written pool, whose o
    is JAX's mode (b) o (the new row included)."""
    c = case(np.random.default_rng(10 + H))
    o_j, pool_j = jax_grouped(
        j(c["q"]), j(c["pool"]), j(c["lengths"]), j(c["table"]), None, None,
        j(c["k_new"]), j(c["v_new"]), n_heads=H, contiguous_pages=True,
        interpret=True)
    pool = t(c["pool"])
    o_t, pool_t = paged_decode_attention_grouped(
        t(c["q"]), pool, t(c["lengths"]), t(c["table"]), None, None,
        t(c["k_new"]), t(c["v_new"]), n_heads=H)
    assert pool_t is pool and pool.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(pool), bits(pool_j))
    assert not np.array_equal(bits(pool), bits(c["pool"]))
    assert_close(o_t, o_j)
    assert np.all(o_t.numpy()[c["lengths"] == 0] == 0)
    a_t = paged_decode_attention_grouped(t(c["q"]), pool, t(c["lengths"]),
                                         t(c["table"]), n_heads=H)
    assert_close(a_t, o_j)


def test_grouped_fused_write_bf16_rows_copy_through():
    """bf16 k_new/v_new rows land in a bf16 pool bit for bit, at each live
    slot's last position; nothing else of the pool changes."""
    c = case(np.random.default_rng(3))
    rows = {k: c[k].astype(ml_dtypes.bfloat16) for k in ("q", "k_new",
                                                         "v_new")}
    pool = t(c["pool"])
    paged_decode_attention_grouped(
        t(rows["q"]), pool, t(c["lengths"]), t(c["table"]), None, None,
        t(rows["k_new"]), t(rows["v_new"]), n_heads=2)
    want = bits(c["pool"]).copy()
    for b in np.nonzero(c["lengths"] > 0)[0]:
        L = c["lengths"][b]
        page = c["table"][b, (L - 1) // P]
        want[page, 0, (L - 1) % P] = bits(rows["k_new"][b])
        want[page, 1, (L - 1) % P] = bits(rows["v_new"][b])
    np.testing.assert_array_equal(bits(pool), want)


def check_partial(got, want, c):
    live = c["lengths"] > 0
    for g, w in zip(got, want):
        assert_close(g[torch.from_numpy(live)], np.asarray(w)[live])
    o, m, l = (x.numpy() for x in got)
    empty = ~live | (c["rs"] == 0)
    assert np.all(o[empty] == 0) and np.all(l[empty] == 0)
    assert np.all(np.isneginf(m[empty]))


@pytest.mark.parametrize("H", [1, 2])
@pytest.mark.parametrize("kind", ["grouped", "flat", "dgrid"])
def test_ring_partials_match_jax(kind, H):
    """Mode (c), the flat and the dgrid partial over positions <
    ring_start of a bf16 pool; the pool is read-only."""
    c = case(np.random.default_rng(20 + H + len(kind)))
    args = [c["q"], c["pool"], c["lengths"], c["table"], None, None]
    if kind == "grouped":
        want = jax_grouped(*map(j, args), ring_start=j(c["rs"]), n_heads=H,
                           interpret=True)
        got = paged_decode_attention_grouped(*map(t, args),
                                             ring_start=t(c["rs"]), n_heads=H)
    elif kind == "flat":
        want = jax_flat(*map(j, args), j(c["rs"]), n_heads=H, interpret=True)
        got = paged_decode_attention_flat(*map(t, args), t(c["rs"]),
                                          n_heads=H)
    else:
        dargs = [c["q"], c["pool"], None, None, c["rs"], c["lengths"],
                 c["table"]]
        want = jax_dgrid(*map(j, dargs), n_heads=H, page_size=P,
                         interpret=True)
        got = dgrid_paged_partial(*map(t, dargs), n_heads=H, page_size=P)
    check_partial(got, want, c)


@pytest.mark.parametrize("H", [1, 2])
def test_one_slot_matches_jax(H):
    """The one-slot kernel (the host path's "paged") over a fragmented
    table whose dead rows hold live slots' pages."""
    c = case(np.random.default_rng(30 + H), "fragmented")
    c["table"][0] = c["table"][3]
    args = [c["q"], c["pool"], c["lengths"], c["table"]]
    want = jax_one_slot(*map(j, args), n_heads=H, interpret=True)
    pool = t(c["pool"])
    got = paged_decode_attention(t(c["q"]), pool, *map(t, args[2:]),
                                 n_heads=H)
    assert_close(got, want)
    assert np.all(got.numpy()[c["lengths"] == 0] == 0)
    np.testing.assert_array_equal(bits(pool), bits(c["pool"]))


# ---------------------------------------------------------------- engines


@pytest.fixture(scope="module")
def models():
    out = {}
    for H, emb, ffn in ((1, 32, 0), (2, 64, 128)):
        m = JModelConfig(n_vocab=256, emb_dim=emb, n_seq=64, n_heads=H,
                         n_layers=1 if H == 1 else 2, ffn_dim=ffn,
                         use_output_proj=H > 1, use_layernorm=H > 1,
                         eof_token_id=255)
        jparams = init_params(jax.random.PRNGKey(5 + H), m, eof_bias=0.05)
        tparams = T.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams),
            T.ModelConfig(**dataclasses.asdict(m)), device="cpu")
        out[H] = (m, jparams, tparams)
    return out


def prompts_for(seed, n=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, int(rng.integers(1, 24))).tolist()
            for _ in range(n)]


_JAX_TOKENS = {}


def jax_tokens(models, H, cls, cfg, prompts, impl):
    key = (H, cls.__name__, cfg, impl, tuple(map(tuple, prompts)))
    if key not in _JAX_TOKENS:
        m, jparams, _ = models[H]
        js = JItemStorage()
        for i, p in enumerate(prompts):
            js.add_new_item(JRequest(i, list(p)))
        cls(jparams, m, cfg, attention_impl=impl).run(js)
        _JAX_TOKENS[key] = [js.finished[i].tokens for i in range(len(prompts))]
    return _JAX_TOKENS[key]


def port_tokens(models, H, cls, cfg, prompts, impl):
    m, _, tparams = models[H]
    ts = T.ItemStorage()
    for i, p in enumerate(prompts):
        ts.add_new_item(T.Request(i, list(p)))
    eng = cls(tparams, T.ModelConfig(**dataclasses.asdict(m)),
              T.EngineConfig(**dataclasses.asdict(cfg)),
              attention_impl=impl, device="cpu")
    eng.run(ts)
    assert len(ts.finished) == len(prompts)
    return [ts.finished[i].tokens for i in range(len(prompts))], eng


AUTO_CASES = [
    ("no-ring", 1, dict(decode_ring=False, subbursts=2)),
    ("ring-c", 2, dict(decode_ring=True, subbursts=2)),
    ("ring-dgrid", 2, dict(decode_ring=True, attn_dgrid=True)),
    ("ring-flat", 2, dict(decode_ring=True, attn_flat=True, subbursts=2)),
]


@pytest.mark.parametrize("label,H,extra", AUTO_CASES,
                         ids=[c[0] for c in AUTO_CASES])
def test_autonomous_engine_bf16_kv(models, label, H, extra):
    """The kernel path at bf16 KV equals JAX's AutonomousEngine on "jnp"
    token for token."""
    cfg = JEngineConfig(n_slots=8, page_size=16, n_pages=32,
                        n_forward_rounds=4, kv_dtype="bfloat16", **extra)
    prompts = prompts_for(40 + H)
    want = jax_tokens(models, H, JAutonomousEngine, cfg, prompts, "jnp")
    got, eng = port_tokens(models, H, T.AutonomousEngine, cfg, prompts,
                           "grouped")
    assert got == want


def test_autonomous_engine_bf16_kv_against_jax_kernel(models):
    """Without the ring, the port's kernel path equals JAX's grouped Pallas
    kernel (interpret mode) at bf16 KV as well."""
    cfg = JEngineConfig(n_slots=8, page_size=16, n_pages=32,
                        n_forward_rounds=4, kv_dtype="bfloat16",
                        decode_ring=False)
    prompts = prompts_for(41, n=8)
    want = jax_tokens(models, 1, JAutonomousEngine, cfg, prompts, "grouped")
    got, _ = port_tokens(models, 1, T.AutonomousEngine, cfg, prompts,
                         "grouped")
    assert got == want


@pytest.mark.parametrize("impl", ["grouped", "paged"])
@pytest.mark.parametrize("pressure", [False, True])
def test_paged_engine_bf16_kv(models, impl, pressure):
    """PagedEngine's kernel paths at bf16 KV equal JAX's PagedEngine on
    "jnp", roomy and under preemption."""
    cfg = JEngineConfig(n_slots=8, page_size=16, n_pages=6 if pressure else 32,
                        init_num_pages=1 if pressure else 2,
                        n_forward_rounds=4, kv_dtype="bfloat16",
                        max_prefill_batch=4)
    prompts = prompts_for(50, n=16)
    want = jax_tokens(models, 2, JPagedEngine, cfg, prompts, "jnp")
    got, eng = port_tokens(models, 2, T.PagedEngine, cfg, prompts, impl)
    assert got == want
    assert (eng.stats.preemptions > 0) == pressure
