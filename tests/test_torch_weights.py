"""Weight-only int8 / fp8 quantization in the port against the JAX package.

The quantizers must give JAX's bytes and scales from the same float32
matrix (IEEE ``1 / max(s, 1e-30)``, round half to even, one rounding to
float8_e4m3fn); a quantized JAX tree carried over through numpy must give
the same embeddings, projections and logits; and the engines must read
quantized leaves as the JAX engines do, token for token on float32
configs. A quantized leaf is read in bfloat16 (the JAX package's rule), so
the engines' matmuls run in bfloat16 there."""

import dataclasses

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
from min_llm_inference_tpu.models.params import fuse_qkv_params as jfuse
from min_llm_inference_tpu.ops import quant as jq
from min_llm_inference_tpu.ops import reference as jr
from min_llm_inference_tpu.runtime.autonomous import (
    AutonomousEngine as JAutonomousEngine,
)
import min_llm_inference_tpu_torch as T
from min_llm_inference_tpu_torch.models.params import fuse_qkv_params
from min_llm_inference_tpu_torch.ops import quant as tq
from min_llm_inference_tpu_torch.ops import reference as tr

torch.set_num_threads(1)

MODEL = JModelConfig(n_vocab=256, emb_dim=64, n_seq=64, eof_token_id=255)
GMODEL = JModelConfig(n_vocab=256, emb_dim=64, n_seq=64, n_layers=2,
                      n_heads=4, ffn_dim=128, use_output_proj=True,
                      use_layernorm=True, eof_token_id=255)
MODES = ["int8", "fp8"]


def raw(x):
    """The bytes of an array or tensor, to compare exactly."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.uint8) if x.element_size() == 1 else x
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype.itemsize == 1 else x


def matrix(seed, shape=(96, 40)):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[:, 3] = 0.0                          # an all-zero column: scale 0
    w[:, 7] *= 1e4                         # a column far above the rest
    w[0, 5] = np.abs(w[:, 5]).max() * 1.5  # the column's absmax row
    return w


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_weight_bit_equal(mode, seed):
    w = matrix(seed)
    jfn = jq.quantize_weight if mode == "int8" else jq.quantize_weight_fp8
    tfn = tq.quantize_weight if mode == "int8" else tq.quantize_weight_fp8
    qj, sj = jfn(jnp.asarray(w))
    qt, st = tfn(torch.from_numpy(w))
    assert qt.dtype == (torch.int8 if mode == "int8"
                        else torch.float8_e4m3fn)
    np.testing.assert_array_equal(raw(qt), raw(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        got = tq.dequantize_weight(qt, st, dtype).float().numpy()
        want = np.asarray(jq.dequantize_weight(qj, sj, jdtype), np.float32)
        np.testing.assert_array_equal(got, want)


def test_int8_rounds_half_to_even():
    """Products that land on .5 exactly round to the even integer."""
    w = np.zeros((4, 1), np.float32)
    w[:, 0] = [127.0, 2.5, -2.5, 0.5]      # scale 1: 2.5 -> 2, 0.5 -> 0
    q, s = tq.quantize_weight(torch.from_numpy(w))
    assert float(s[0]) == 1.0
    assert q[:, 0].tolist() == [127, 2, -2, 0]


@pytest.fixture(scope="module")
def trees():
    """{(model, mode): (JAX quantized tree, the port's carried over)}, and
    the dense ones under mode None."""
    out = {}
    for model in (MODEL, GMODEL):
        tm = T.ModelConfig(**dataclasses.asdict(model))
        dense = init_params(jax.random.PRNGKey(4), model, eof_bias=0.05)
        for mode in (None, *MODES):
            jtree = dense if mode is None else jq.quantize_params(dense, mode)
            out[model, mode] = (jtree, T.params_from_numpy(
                jax.tree_util.tree_map(np.asarray, jtree), tm, device="cpu"))
    return out


@pytest.mark.parametrize("mode", MODES)
def test_quantize_params_matches_the_carried_tree(trees, mode):
    """The port's quantize_params of the dense tree has the bytes of the
    JAX quantized tree carried over; fused q/k/v leaves concatenate q and
    scale as JAX's do."""
    jtree, carried = trees[GMODEL, mode]
    mine = tq.quantize_params(trees[GMODEL, None][1], mode)
    leaves_m = jax.tree_util.tree_leaves(mine)
    leaves_c = jax.tree_util.tree_leaves(carried)
    assert len(leaves_m) == len(leaves_c)
    for a, b in zip(leaves_m, leaves_c):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(raw(a), raw(b))
    assert tq.is_quantized_leaf(mine["wte"])
    assert not tq.is_quantized_leaf(mine["layers"][0]["ln1_g"])
    fj, ft = jfuse(jtree), fuse_qkv_params(carried)
    for name in ("wqkv", "wkv"):
        for part in ("q", "scale"):
            np.testing.assert_array_equal(
                raw(ft["layers"][1][name][part]),
                raw(fj["layers"][1][name][part]))


@pytest.mark.parametrize("mode", MODES)
def test_quantized_tree_gives_jax_logits(trees, mode):
    """Embedding gather, projection and tied logits on the carried-over
    quantized leaves equal JAX's on its own (float32 logits allclose;
    the gathered rows and projections in bfloat16)."""
    jtree, ttree = trees[MODEL, mode]
    rng = np.random.default_rng(5)
    tokens = rng.integers(-2, 260, (6, 5)).astype(np.int32)   # clipped ids
    pos = rng.integers(0, 70, (6, 5)).astype(np.int32)
    ej = jr.token_pos_embed(jnp.asarray(tokens), jnp.asarray(pos),
                            jtree["wte"], jtree["wpe"])
    et = tr.token_pos_embed(torch.from_numpy(tokens), torch.from_numpy(pos),
                            ttree["wte"], ttree["wpe"])
    assert et.dtype == torch.bfloat16 and ej.dtype == jnp.bfloat16
    np.testing.assert_array_equal(et.float().numpy(),
                                  np.asarray(ej, np.float32))
    x = (rng.standard_normal((6, 64)) * 0.5).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    for w in ("wq", "wv"):
        np.testing.assert_allclose(
            tr.feed_forward(xt, ttree["layers"][0][w]).numpy(),
            np.asarray(jr.feed_forward(xj, jtree["layers"][0][w])),
            rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tr.tied_logits(xt, ttree["wte"]).numpy(),
        np.asarray(jr.tied_logits(xj, jtree["wte"])), rtol=1e-5, atol=1e-5)


def test_online_softmax_matches_jax():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((5, 300)) * 8).astype(np.float32)
    x[1, :] = -1e30                         # one row far below zero
    got = tr.online_softmax(torch.from_numpy(x)).numpy()
    want = np.asarray(jr.online_softmax(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


# ---------------------------------------------------------------- engines


def prompts_for(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, int(rng.integers(1, 16))).tolist()
            for _ in range(n)]


def run_jax(cls, tree, model, cfg, prompts, **kw):
    store = JItemStorage()
    for i, p in enumerate(prompts):
        store.add_new_item(JRequest(i, list(p)))
    cls(tree, model, cfg, **kw).run(store)
    return {i: r.tokens for i, r in store.finished.items()}


def run_port(cls, tree, model, cfg, prompts, **kw):
    store = T.ItemStorage()
    for i, p in enumerate(prompts):
        store.add_new_item(T.Request(i, list(p)))
    cls(tree, T.ModelConfig(**dataclasses.asdict(model)),
        T.EngineConfig(**dataclasses.asdict(cfg)), device="cpu",
        **kw).run(store)
    return {i: r.tokens for i, r in store.finished.items()}


@pytest.mark.parametrize("model", [MODEL, GMODEL], ids=["ref", "gpt2s2"])
@pytest.mark.parametrize("mode", MODES)
def test_paged_engine_quantized_weights_match_jax(trees, model, mode):
    jtree, ttree = trees[model, mode]
    cfg = JEngineConfig(n_slots=8, page_size=16, n_pages=64,
                        max_prefill_batch=4)
    prompts = prompts_for(7, 10)
    want = run_jax(JPagedEngine, jtree, model, cfg, prompts)
    got = run_port(T.PagedEngine, ttree, model, cfg, prompts,
                   attention_impl="paged")
    assert len(got) == 10 and got == want


@pytest.mark.parametrize("model", [MODEL, GMODEL], ids=["ref", "gpt2s2"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ring", [False, True])
def test_autonomous_engine_quantized_weights_match_jax(trees, model, mode,
                                                       ring):
    jtree, ttree = trees[model, mode]
    cfg = JEngineConfig(n_slots=8, page_size=16, n_pages=32,
                        n_forward_rounds=4, subbursts=2, kv_dtype="int8",
                        decode_ring=ring)
    prompts = prompts_for(8, 12)
    want = run_jax(JAutonomousEngine, jtree, model, cfg, prompts,
                   attention_impl="jnp")
    got = run_port(T.AutonomousEngine, ttree, model, cfg, prompts,
                   attention_impl="grouped")
    assert len(got) == 12 and got == want


@pytest.mark.parametrize("mode", MODES)
def test_weight_quantized_engine_tracks_fp(trees, mode):
    """Mirror of test_quality.py::test_weight_quantized_engine_tracks_fp:
    the quantized engine's tokens agree with the dense engine's on most
    positions (int8 closely; fp8-e4m3, three mantissa bits, flips more
    near-ties of this small random model)."""
    cfg = JEngineConfig(n_slots=8, page_size=16, n_pages=64,
                        max_prefill_batch=4)
    prompts = prompts_for(9, 10)
    ref = run_port(T.PagedEngine, trees[MODEL, None][1], MODEL, cfg, prompts,
                   attention_impl="paged")
    got = run_port(T.PagedEngine, trees[MODEL, mode][1], MODEL, cfg,
                   prompts, attention_impl="paged")
    agree = total = 0
    for rid in range(10):
        m = min(len(ref[rid]), len(got[rid]))
        agree += sum(x == y for x, y in zip(ref[rid][:m], got[rid][:m]))
        total += m
    bound = 0.85 if mode == "int8" else 0.6
    assert agree / total > bound, f"{mode} agreement {agree}/{total}"
