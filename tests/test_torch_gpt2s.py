"""The port's AutonomousEngine vs the JAX package's on a gpt2s-shaped model,
token for token: 2 layers, 4 heads, emb 64, FFN 128 (tanh GELU), pre-LN,
output projection, weights from the JAX ``init_params`` carried over
through numpy.

Both engines run their kernel path (``attention_impl="grouped"``): the JAX
one its Pallas kernels in interpret mode, the port its wrappers, which take
the plain versions on CPU tensors. The cases cover the gpt2s path (int8
ring + dgrid + sort_admits), the burst-wide ring with ``ring_r0``, the
per-sub-burst ring, the int4 ring (grouped mode c), the float32 ring and
the no-ring general model."""

import dataclasses

import numpy as np
import pytest

import jax

from min_llm_inference_tpu import EngineConfig as JEngineConfig
from min_llm_inference_tpu import ItemStorage as JItemStorage
from min_llm_inference_tpu import ModelConfig as JModelConfig
from min_llm_inference_tpu import Request as JRequest
from min_llm_inference_tpu import init_params
from min_llm_inference_tpu.runtime.autonomous import (
    AutonomousEngine as JAutonomousEngine,
)
import min_llm_inference_tpu_torch as T

MODEL = JModelConfig(n_vocab=256, emb_dim=64, n_seq=64, n_layers=2,
                     n_heads=4, ffn_dim=128, use_output_proj=True,
                     use_layernorm=True, eof_token_id=255)
TMODEL = T.ModelConfig(**dataclasses.asdict(MODEL))


@pytest.fixture(scope="module")
def params():
    jparams = init_params(jax.random.PRNGKey(0), MODEL, eof_bias=0.05)
    tparams = T.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                  TMODEL, device="cpu")
    return jparams, tparams


@pytest.mark.parametrize("change", [
    dict(kv_dtype="int8", attn_dgrid=True, sort_admits=True),
    dict(kv_dtype="int8", subbursts=2),
    dict(kv_dtype="int8", subbursts=2, burst_flush=False),
    dict(kv_dtype="int4"),
    dict(kv_dtype="float32", attn_dgrid=True),
    dict(kv_dtype="int8", decode_ring=False),
], ids=["int8-dgrid-sort", "int8-burst-ring", "int8-subburst-ring",
        "int4-ring", "f32-dgrid", "int8-no-ring"])
def test_gpt2s_engine_matches_jax_engine(params, change):
    """12 requests over 8 slots: slots turn over and page groups recycle."""
    jparams, tparams = params
    cfg = dataclasses.replace(
        JEngineConfig(n_slots=8, page_size=16, n_pages=32,
                      n_forward_rounds=4, decode_ring=True), **change)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, MODEL.eof_token_id, int(rng.integers(1, 24)))
               .tolist() for _ in range(12)]
    js = JItemStorage()
    for i, p in enumerate(prompts):
        js.add_new_item(JRequest(i, list(p)))
    JAutonomousEngine(jparams, MODEL, cfg, attention_impl="grouped").run(js)
    ts = T.ItemStorage()
    for i, p in enumerate(prompts):
        ts.add_new_item(T.Request(i, list(p)))
    eng = T.AutonomousEngine(tparams, TMODEL,
                             T.EngineConfig(**dataclasses.asdict(cfg)),
                             attention_impl="grouped", device="cpu")
    eng.run(ts)
    assert len(ts.finished) == len(prompts)
    for i in range(len(prompts)):
        assert ts.finished[i].tokens == js.finished[i].tokens, i
    generated = sum(len(ts.finished[i].tokens) - len(p)
                    for i, p in enumerate(prompts))
    assert generated > len(prompts)
    # the ring adds no host sync and nothing is read inside a burst: two
    # input uploads, one status read per chunk, one output read; skipped
    # bursts, rounds and prefill blocks are counted on the device
    st = eng.stats
    executed = st.bursts - st.skipped
    assert st.host_syncs == 2 + -(-st.bursts // eng.chunk) + 1
    assert st.rounds == executed * cfg.n_forward_rounds
    assert 0 < st.prefills <= executed * cfg.subbursts
