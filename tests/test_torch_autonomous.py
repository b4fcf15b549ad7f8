"""The port's AutonomousEngine vs the JAX package's, token for token.

Parameters come from the JAX ``init_params`` and cross through numpy
(``params_from_numpy``); the same prompts go to both engines. The port runs
its kernel path (attention_impl="grouped", whose wrapper takes the plain
version on CPU tensors); the JAX engine runs its gather oracle ("jnp")."""

import dataclasses
import subprocess
import sys
import textwrap

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
from min_llm_inference_tpu_torch.runtime import autonomous as tauto

MODEL = JModelConfig(n_vocab=256, emb_dim=32, n_seq=64, eof_token_id=255)
TMODEL = T.ModelConfig(**dataclasses.asdict(MODEL))


@pytest.fixture(scope="module")
def params():
    jparams = init_params(jax.random.PRNGKey(0), MODEL, eof_bias=0.05)
    tparams = T.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                  TMODEL, device="cpu")
    return jparams, tparams


def prompts_for(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, MODEL.eof_token_id, int(rng.integers(1, 24)))
            .tolist() for _ in range(n)]


def run_both(params, cfg, prompts, **engine_kw):
    jparams, tparams = params
    js = JItemStorage()
    for i, p in enumerate(prompts):
        js.add_new_item(JRequest(i, list(p)))
    JAutonomousEngine(jparams, MODEL, cfg, attention_impl="jnp",
                      **engine_kw).run(js)
    ts = T.ItemStorage()
    for i, p in enumerate(prompts):
        ts.add_new_item(T.Request(i, list(p)))
    eng = T.AutonomousEngine(tparams, TMODEL,
                             T.EngineConfig(**dataclasses.asdict(cfg)),
                             attention_impl="grouped", device="cpu",
                             **engine_kw)
    eng.run(ts)
    assert len(ts.finished) == len(prompts)
    for i in range(len(prompts)):
        assert ts.finished[i].tokens == js.finished[i].tokens, i
    return eng


@pytest.mark.parametrize("kv_dtype", ["float32", "int8", "int4"])
@pytest.mark.parametrize("rounds,subbursts",
                         [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_engine_matches_jax_engine(params, kv_dtype, rounds, subbursts):
    """12 requests over 8 slots: slots turn over and pages recycle."""
    cfg = JEngineConfig(n_slots=8, page_size=16, n_pages=32,
                        n_forward_rounds=rounds, subbursts=subbursts,
                        kv_dtype=kv_dtype, decode_ring=False)
    eng = run_both(params, cfg, prompts_for(rounds + 10 * subbursts, 12))
    st = eng.stats
    # skipped bursts, rounds and prefill blocks are counted on the device
    executed = st.bursts - st.skipped
    assert st.rounds == executed * rounds > 0
    assert 0 < st.prefills <= executed * subbursts
    # nothing is read inside a burst: two input uploads, one status read
    # per chunk, one output read
    assert st.host_syncs == 2 + -(-st.bursts // eng.chunk) + 1


def test_engine_drain_downshift_matches_jax(params, monkeypatch):
    calls = []
    real = tauto._compact_slice

    def spy(st, b_new):
        calls.append(b_new)
        return real(st, b_new)

    monkeypatch.setattr(tauto, "_compact_slice", spy)
    cfg = JEngineConfig(n_slots=16, page_size=16, n_pages=64,
                        n_forward_rounds=4, kv_dtype="int4",
                        decode_ring=False)
    run_both(params, cfg, prompts_for(5, 20), min_drain_slots=8,
             bursts_per_chunk=1)
    assert calls and calls[0] == 8


def test_port_imports_neither_jax_nor_the_jax_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        before = set(sys.modules)
        import min_llm_inference_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        import chip_smoke
        new = set(sys.modules) - before
        bad = sorted(m for m in new if m.split(".")[0] in
                     ("jax", "jaxlib", "min_llm_inference_tpu", "optax",
                      "transformers"))
        assert not bad, bad
        print("ok", len(new))
    """)
    root = __file__.rsplit("/tests/", 1)[0]
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_raise_without_a_gpu(params):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    cfg = T.EngineConfig(n_slots=8, page_size=16, n_pages=32,
                         decode_ring=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_paged_state(TMODEL, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_auto_state(TMODEL, cfg, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.params_from_numpy({"wte": np.zeros((256, 32)),
                             "wpe": np.zeros((64, 32)), "layers": []}, TMODEL)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.AutonomousEngine(params[1], TMODEL, cfg)
    for engine in (T.PagedEngine, T.NativePagedEngine, T.DenseEngine):
        with pytest.raises(RuntimeError, match="CUDA"):
            engine(params[1], TMODEL, cfg)
