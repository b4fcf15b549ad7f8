"""The port's host-scheduled engines (PagedEngine, DenseEngine) against the
JAX package's, token for token.

Parameters come from the JAX ``init_params(PRNGKey(0), eof_bias=0.05)``
and cross through numpy (``params_from_numpy``); the same prompts go to
both engines. The port's kernel paths ("paged", "grouped") run their
wrappers' plain versions on CPU tensors; the JAX engine runs its gather
oracle ("jnp") and its one-slot Pallas kernel ("pallas", interpret mode).
Engines are held token-exact (float32 and int8 KV)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from min_llm_inference_tpu import DenseEngine as JDenseEngine
from min_llm_inference_tpu import EngineConfig as JEngineConfig
from min_llm_inference_tpu import ItemStorage as JItemStorage
from min_llm_inference_tpu import ModelConfig as JModelConfig
from min_llm_inference_tpu import PagedEngine as JPagedEngine
from min_llm_inference_tpu import Request as JRequest
from min_llm_inference_tpu import init_params
import min_llm_inference_tpu_torch as T

MODEL = JModelConfig(n_vocab=256, emb_dim=32, n_seq=64, eof_token_id=255)
TMODEL = T.ModelConfig(**dataclasses.asdict(MODEL))
# tests/test_engine.py's engine
ENGINE = JEngineConfig(n_slots=8, n_forward_rounds=1, page_size=16,
                       n_pages=8 * 4 * 2, max_prefill_batch=4)
# a small gpt2s-shaped model: multi-head, pre-LN, output projection, FFN
GMODEL = JModelConfig(n_vocab=256, emb_dim=64, n_seq=64, n_layers=2,
                      n_heads=4, ffn_dim=128, use_output_proj=True,
                      use_layernorm=True, eof_token_id=255)

_JAX_RUNS = {}


@pytest.fixture(scope="module")
def params():
    out = {}
    for model in (MODEL, GMODEL):
        jparams = init_params(jax.random.PRNGKey(0), model, eof_bias=0.05)
        out[model] = (jparams, T.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams),
            T.ModelConfig(**dataclasses.asdict(model)), device="cpu"))
    return out


def prompts_for(seed, n, max_prompt=24):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, MODEL.eof_token_id, int(rng.integers(1, max_prompt)))
            .tolist() for _ in range(n)]


def run_jax(params, cls, cfg, prompts, model=MODEL, **kw):
    """Tokens of the JAX engine, cached per configuration."""
    key = (cls.__name__, model, cfg, tuple(map(tuple, prompts)),
           tuple(sorted(kw.items())))
    if key not in _JAX_RUNS:
        store = JItemStorage()
        for i, p in enumerate(prompts):
            store.add_new_item(JRequest(i, list(p)))
        cls(params[model][0], model, cfg, **kw).run(store)
        _JAX_RUNS[key] = [store.finished[i].tokens
                          for i in range(len(prompts))]
    return _JAX_RUNS[key]


def run_port(params, cls, cfg, prompts, model=MODEL, **kw):
    store = T.ItemStorage()
    for i, p in enumerate(prompts):
        store.add_new_item(T.Request(i, list(p)))
    eng = cls(params[model][1], T.ModelConfig(**dataclasses.asdict(model)),
              T.EngineConfig(**dataclasses.asdict(cfg)), device="cpu", **kw)
    eng.run(store)
    assert len(store.finished) == len(prompts)
    return [store.finished[i].tokens for i in range(len(prompts))], eng


def assert_same(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"request {i}: {g} vs {w}"


@pytest.mark.parametrize("rounds", [1, 4])
@pytest.mark.parametrize("impl", ["paged", "torch", "grouped"])
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_paged_engine_matches_jax(params, kv, impl, rounds):
    cfg = dataclasses.replace(ENGINE, kv_dtype=kv, n_forward_rounds=rounds)
    prompts = prompts_for(rounds, 20)
    want = run_jax(params, JPagedEngine, cfg, prompts, attention_impl="jnp")
    got, eng = run_port(params, T.PagedEngine, cfg, prompts,
                        attention_impl=impl)
    assert_same(got, want)
    # one pull per burst, one upload per burst and per prefill bucket
    st = eng.stats
    assert st.host_syncs == st.bursts > 0
    assert st.rounds == st.bursts * rounds
    assert st.uploads == st.bursts + st.prefills


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_paged_kernel_path_matches_jax_pallas(params, kv):
    """The port's "paged" path and the JAX engine's one-slot Pallas kernel
    ("pallas", interpret mode) give the same tokens."""
    cfg = dataclasses.replace(ENGINE, kv_dtype=kv, n_forward_rounds=4)
    prompts = prompts_for(4, 20)
    want = run_jax(params, JPagedEngine, cfg, prompts,
                   attention_impl="pallas")
    assert want == run_jax(params, JPagedEngine, cfg, prompts,
                           attention_impl="jnp")
    got, _ = run_port(params, T.PagedEngine, cfg, prompts,
                      attention_impl="paged")
    assert_same(got, want)


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_paged_engine_under_page_pressure(params, kv):
    """A tiny pool with one-page grants forces admission control, growth
    and preemption (recompute-on-preempt); every request still finishes
    with the JAX engine's tokens (and, float32, the dense engine's)."""
    cfg = dataclasses.replace(ENGINE, kv_dtype=kv, n_pages=6,
                              init_num_pages=2, n_forward_rounds=4)
    prompts = prompts_for(0, 20)
    want = run_jax(params, JPagedEngine, cfg, prompts, attention_impl="jnp")
    got, eng = run_port(params, T.PagedEngine, cfg, prompts,
                        attention_impl="paged")
    assert eng.stats.preemptions > 0
    assert_same(got, want)
    if kv == "float32":
        dense = run_jax(params, JDenseEngine,
                        dataclasses.replace(ENGINE, n_forward_rounds=4),
                        prompts)
        assert_same(got, dense)


def test_paged_multi_round_matches_single_round(params):
    prompts = prompts_for(11, 16)
    one, _ = run_port(params, T.PagedEngine, ENGINE, prompts,
                      attention_impl="paged")
    four, _ = run_port(params, T.PagedEngine,
                       dataclasses.replace(ENGINE, n_forward_rounds=4),
                       prompts, attention_impl="paged")
    assert_same(four, one)


@pytest.mark.parametrize("rounds", [1, 4])
def test_dense_engine_matches_jax(params, rounds):
    cfg = dataclasses.replace(ENGINE, n_forward_rounds=rounds)
    prompts = prompts_for(20 + rounds, 20)
    want = run_jax(params, JDenseEngine, cfg, prompts)
    got, eng = run_port(params, T.DenseEngine, cfg, prompts)
    assert_same(got, want)
    assert eng.stats.host_syncs == eng.stats.bursts > 0


def test_dense_vs_paged_token_exact_parity(params):
    """The golden property on the port alone: identical requests through
    the dense and the paged backend give identical sequences."""
    prompts = prompts_for(30, 24)
    dense, _ = run_port(params, T.DenseEngine, ENGINE, prompts)
    paged, _ = run_port(params, T.PagedEngine, ENGINE, prompts,
                        attention_impl="paged")
    assert_same(paged, dense)


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_dense_engine_rejects_quantized_kv(params, kv):
    with pytest.raises(ValueError, match="quantized KV"):
        T.DenseEngine(params[MODEL][1], TMODEL,
                      T.EngineConfig(**dataclasses.asdict(
                          dataclasses.replace(ENGINE, kv_dtype=kv))),
                      device="cpu")


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_gpt2s_shaped_model_matches_jax(params, kv):
    cfg = dataclasses.replace(ENGINE, kv_dtype=kv, n_forward_rounds=4)
    prompts = prompts_for(40, 16)
    want = run_jax(params, JPagedEngine, cfg, prompts, model=GMODEL,
                   attention_impl="jnp")
    got, _ = run_port(params, T.PagedEngine, cfg, prompts, model=GMODEL,
                      attention_impl="paged")
    assert_same(got, want)


@pytest.mark.parametrize("cls", ["DenseEngine", "PagedEngine"])
def test_engine_terminates_and_counts(params, cls):
    """tests/test_engine.py's termination check on the port's engines:
    every request finishes at EOF or the n_seq cap, and the throughput
    counter saw every generated token and every first token."""
    counter = T.get_global_throughput_counter()
    counter.reset()
    prompts = prompts_for(50, 20, max_prompt=20)
    got, _ = run_port(params, getattr(T, cls), ENGINE, prompts)
    gen = sum(len(g) - len(p) for g, p in zip(got, prompts))
    assert counter.total_tokens == gen > 0
    assert len(counter.ttfts) == len(prompts)
    for toks in got:
        assert len(toks) <= MODEL.n_seq
        assert toks[-1] == MODEL.eof_token_id or len(toks) == MODEL.n_seq


def test_engine_rejects_params_on_another_device(params):
    meta = {k: v for k, v in params[MODEL][1].items()}
    meta["wte"] = meta["wte"].to("meta")
    with pytest.raises(ValueError, match="params are on"):
        T.PagedEngine(meta, TMODEL, T.EngineConfig(
            **dataclasses.asdict(ENGINE)), device="cpu")
