"""The port's AutonomousEngine with the flat and the dense ring partial vs
the JAX package's engine, token for token.

Parameters come from the JAX ``init_params`` and cross through numpy. The
port runs its kernel path (``attention_impl="grouped"``: ring decode with
``attn_flat`` or ``attn_dense``; on CPU tensors the flat wrapper takes its
plain version, the dense partial is plain PyTorch on every device). The
JAX engine runs the same formulation (its flat kernel in interpret mode,
~17 s a run, or its XLA dense view) or, where marked, its gather oracle
"jnp", which the JAX tests hold token-exact with its ring paths."""

import dataclasses

import numpy as np
import pytest
import torch

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

# tiny CPU tensors: PyTorch's intra-op threads would only contend with the
# other pytest-xdist workers, one per core
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    out = {}
    for H in (1, 2):
        m = JModelConfig(n_vocab=256, emb_dim=32, n_seq=64, n_heads=H,
                         eof_token_id=255)
        jparams = init_params(jax.random.PRNGKey(H), m, eof_bias=0.05)
        tparams = T.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams),
            T.ModelConfig(**dataclasses.asdict(m)), device="cpu")
        out[H] = (m, jparams, tparams)
    return out


def check_engines(models, H, cfg, jax_impl, seed):
    """12 requests over 8 slots: the port's tokens equal the JAX engine's,
    and the ring adds no host sync."""
    m, jparams, tparams = models[H]
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 255, int(rng.integers(1, 24))).tolist()
               for _ in range(12)]
    js = JItemStorage()
    for i, p in enumerate(prompts):
        js.add_new_item(JRequest(i, list(p)))
    JAutonomousEngine(jparams, m, cfg, attention_impl=jax_impl).run(js)
    ts = T.ItemStorage()
    for i, p in enumerate(prompts):
        ts.add_new_item(T.Request(i, list(p)))
    eng = T.AutonomousEngine(tparams, T.ModelConfig(**dataclasses.asdict(m)),
                             T.EngineConfig(**dataclasses.asdict(cfg)),
                             attention_impl="grouped", device="cpu")
    eng.run(ts)
    assert len(ts.finished) == len(prompts)
    for i in range(len(prompts)):
        assert ts.finished[i].tokens == js.finished[i].tokens, i
    # nothing is read inside a burst: two input uploads, one status read
    # per chunk, one output read; the device counts the rest
    st = eng.stats
    executed = st.bursts - st.skipped
    assert st.host_syncs == 2 + -(-st.bursts // eng.chunk) + 1
    assert st.rounds == executed * cfg.n_forward_rounds
    assert 0 < st.prefills <= executed * cfg.subbursts


@pytest.mark.parametrize("kv,H,jax_impl", [
    ("int8", 2, "grouped"), ("int8", 1, "jnp"), ("int4", 1, "grouped"),
    ("int4", 2, "jnp"), ("float32", 1, "jnp"), ("float32", 2, "jnp"),
])
def test_flat_engine_matches_jax_engine(models, kv, H, jax_impl):
    """A burst-wide ring over 2 sub-bursts on the flat partial."""
    cfg = JEngineConfig(n_slots=8, page_size=16, n_pages=32,
                        n_forward_rounds=4, subbursts=2, kv_dtype=kv,
                        decode_ring=True, attn_flat=True)
    check_engines(models, H, cfg, jax_impl, seed=5 + H)


@pytest.mark.parametrize("kv,H,subbursts", [
    ("int8", 2, 2), ("int4", 1, 1), ("int4", 2, 2), ("float32", 1, 1),
])
def test_dense_engine_matches_jax_engine(models, kv, H, subbursts):
    """The ring on the dense-view partial; the JAX engine runs its own."""
    cfg = JEngineConfig(n_slots=8, page_size=16, n_pages=32,
                        n_forward_rounds=4, subbursts=subbursts, kv_dtype=kv,
                        decode_ring=True, attn_dense=True)
    check_engines(models, H, cfg, "grouped", seed=9 + H)
