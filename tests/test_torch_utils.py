"""The port's utilities against the JAX package's: checkpoints
(test_checkpoint.py), trace capture (test_profiling.py::test_trace_*) and
the teacher-forced quality harness (test_quality.py's perplexity and ΔPPL
tests), plus the harness's NLL against JAX's on the same weights and
sequences (within 1e-4 relative: the two frameworks' matmuls and
log-softmax differ by ulps)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from min_llm_inference_tpu import EngineConfig as JEngineConfig
from min_llm_inference_tpu import ModelConfig as JModelConfig
from min_llm_inference_tpu import init_params as jinit
from min_llm_inference_tpu.ops.quant import quantize_params as jquantize
from min_llm_inference_tpu.utils import quality as jquality
import min_llm_inference_tpu_torch as T
from min_llm_inference_tpu_torch.ops.quant import quantize_params
from min_llm_inference_tpu_torch.utils.checkpoint import (
    import_gpt2_state_dict,
    load_params,
    save_params,
)
from min_llm_inference_tpu_torch.utils.profiling import trace
from min_llm_inference_tpu_torch.utils.quality import (
    delta_ppl_int8_kv,
    delta_ppl_kv,
    perplexity,
    teacher_forced_nll,
)

torch.set_num_threads(1)

CKPT_MODEL = T.ModelConfig(n_vocab=64, emb_dim=32, n_seq=32, n_layers=2,
                           n_heads=4, ffn_dim=64, use_output_proj=True,
                           use_layernorm=True, eof_token_id=63)
QMODEL = JModelConfig(n_vocab=256, emb_dim=64, n_seq=64, eof_token_id=255)
QENGINE = JEngineConfig(n_slots=8, page_size=16, n_pages=64,
                        max_prefill_batch=4)


def trees_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.uint8) if x.element_size() == 1
                           else x, y.view(torch.uint8)
                           if y.element_size() == 1 else y)


# ---------------------------------------------------------- checkpoints


def test_save_load_roundtrip(tmp_path):
    params = T.init_params(0, CKPT_MODEL, device="cpu")
    path = str(tmp_path / "ckpt" / "params.pt")
    save_params(path, params)
    trees_equal(params, load_params(path, device="cpu"))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_save_load_quantized(tmp_path, mode):
    params = quantize_params(T.init_params(1, CKPT_MODEL, device="cpu"),
                             mode)
    path = str(tmp_path / "ckpt_q.pt")
    save_params(path, params)
    restored = load_params(path, device="cpu")
    assert restored["wte"]["q"].dtype == params["wte"]["q"].dtype
    trees_equal(params, restored)


def test_gpt2_import(rng):
    """A GPT-2-style state dict held in memory maps onto the layout and
    drives an engine end to end."""
    m = CKPT_MODEL
    D, F, V, S = m.emb_dim, m.ffn_dim, m.n_vocab, m.n_seq
    state = {"wte.weight": rng.standard_normal((V + 3, D)).astype(np.float32),
             "wpe.weight": rng.standard_normal((S + 5, D)).astype(np.float32)}
    for i in range(m.n_layers):
        state[f"h.{i}.attn.c_attn.weight"] = rng.standard_normal(
            (D, 3 * D)).astype(np.float32)
        state[f"h.{i}.attn.c_proj.weight"] = rng.standard_normal(
            (D, D)).astype(np.float32)
        state[f"h.{i}.mlp.c_fc.weight"] = rng.standard_normal(
            (D, F)).astype(np.float32)
        state[f"h.{i}.mlp.c_proj.weight"] = torch.from_numpy(
            rng.standard_normal((F, D)).astype(np.float32))  # a tensor too
        state[f"h.{i}.ln_1.weight"] = np.ones(D, np.float32)
        state[f"h.{i}.ln_2.weight"] = np.ones(D, np.float32)
        state[f"h.{i}.attn.c_attn.bias"] = np.zeros(3 * D, np.float32)

    params = import_gpt2_state_dict(state, m, dtype=torch.float32,
                                    device="cpu")
    assert params["wte"].shape == (V, D) and params["wpe"].shape == (S, D)
    np.testing.assert_array_equal(
        params["layers"][0]["wk"].numpy(),
        state["h.0.attn.c_attn.weight"][:, D:2 * D])
    cfg = T.EngineConfig(n_slots=4, page_size=8, n_pages=16,
                         max_prefill_batch=2)
    store = T.ItemStorage()
    store.add_new_item(T.Request(0, [3, 5, 7]))
    T.PagedEngine(params, m, cfg, device="cpu").run(store)
    assert len(store.finished) == 1


# ---------------------------------------------------------- trace


def test_trace_none_is_noop():
    with trace(None):
        x = torch.ones(4) + 1
    assert float(x.sum()) == 8.0


def test_trace_writes_files(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        torch.ones(8).sum()
    found = [os.path.join(dp, f) for dp, _, fs in os.walk(logdir)
             for f in fs]
    assert found, "profiler produced no trace files"


# ---------------------------------------------------------- quality


@pytest.fixture(scope="module")
def qparams():
    jparams = jinit(jax.random.PRNGKey(2), QMODEL, eof_bias=0.05)
    tm = T.ModelConfig(**dataclasses.asdict(QMODEL))
    return jparams, T.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), tm, device="cpu")


def own_sequences(tparams, rng, n, prompt_len=None, max_len=None):
    """Sequences generated by the port's float engine itself: tokens [n, T]
    and lengths."""
    store = T.ItemStorage()
    for i in range(n):
        plen = prompt_len or int(rng.integers(2, 12))
        store.add_new_item(T.Request(i, rng.integers(0, 255, plen).tolist()))
    T.PagedEngine(tparams, T.ModelConfig(**dataclasses.asdict(QMODEL)),
                  T.EngineConfig(**dataclasses.asdict(QENGINE)),
                  device="cpu").run(store)
    seqs = [store.finished[i].tokens[:max_len] for i in range(n)]
    width = max_len or max(len(s) for s in seqs)
    tokens = np.zeros((n, width), np.int32)
    lengths = np.zeros(n, np.int32)
    for i, s in enumerate(seqs):
        tokens[i, :len(s)] = s
        lengths[i] = len(s)
    return tokens, lengths


@pytest.mark.parametrize("kv_dtype", ["float32", "int8", "int4"])
@pytest.mark.parametrize("quantized", [None, "int8"])
def test_teacher_forced_nll_matches_jax(qparams, rng, kv_dtype, quantized):
    jparams, tparams = qparams
    tokens, lengths = own_sequences(tparams, rng, 6)
    lengths[0] = 2                           # one predicted token
    cfg = dataclasses.replace(QENGINE, kv_dtype=kv_dtype)
    if quantized:
        jparams = jquantize(jparams, quantized)
        tparams = quantize_params(tparams, quantized)
    want, n_want = jquality.teacher_forced_nll(jparams, QMODEL, cfg, tokens,
                                               lengths)
    got, n_got = teacher_forced_nll(
        tparams, T.ModelConfig(**dataclasses.asdict(QMODEL)),
        T.EngineConfig(**dataclasses.asdict(cfg)), tokens, lengths)
    np.testing.assert_array_equal(n_got, n_want)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4)


def test_delta_ppl_int8_kv_within_bound(qparams, rng):
    """Mirror of test_quality.py::test_delta_ppl_int8_kv_within_bound: the
    north-star bound, |ΔPPL| <= 0.1 at INT8 KV, on the model's own
    sequences; and it equals delta_ppl_kv's int8 entry."""
    _, tparams = qparams
    tokens, lengths = own_sequences(tparams, rng, 8)
    tm = T.ModelConfig(**dataclasses.asdict(QMODEL))
    te = T.EngineConfig(**dataclasses.asdict(QENGINE))
    res = delta_ppl_int8_kv(tparams, tm, te, tokens, lengths)
    assert res["ppl_ref"] > 0
    assert abs(res["delta_ppl"]) <= 0.1, res
    assert delta_ppl_kv(tparams, tm, te, tokens, lengths)["ppl_q"] == \
        res["ppl_int8"]


def test_perplexity_sanity(qparams, rng):
    """Mirror of test_quality.py::test_perplexity_sanity: the model is much
    less perplexed by its own greedy outputs than by uniform-random
    sequences."""
    _, tparams = qparams
    n, width = 4, 24
    tokens, lengths = own_sequences(tparams, rng, n, prompt_len=4,
                                    max_len=width)
    tm = T.ModelConfig(**dataclasses.asdict(QMODEL))
    te = T.EngineConfig(**dataclasses.asdict(QENGINE))
    ppl_own = perplexity(tparams, tm, te, tokens, lengths)
    rand = rng.integers(0, 256, (n, width)).astype(np.int32)
    ppl_rand = perplexity(tparams, tm, te, rand, np.full(n, width, np.int32))
    assert ppl_own < ppl_rand
