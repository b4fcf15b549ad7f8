"""The cross-engine fuzz of tests/test_fuzz_engines.py on the port: each
draw (min_llm_inference_tpu_torch/tools/fuzz_draws.py: its eight and one
at bfloat16 KV) runs one request set through the port's AutonomousEngine
on its kernel path ("grouped"; on the CPU the wrappers run their plain
versions) and its PagedEngine on the gather oracle ("torch"), and both
must equal the JAX package's PagedEngine on "jnp" token for token, every
request ending with EOF or at the n_seq cap. The weights are the JAX
``init_params`` of the draw's seed; the port's ``init_params`` gives them
bit for bit. tests/test_torch_cuda_kernels.py runs the same draws through
the kernels on the card."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from min_llm_inference_tpu import EngineConfig as JEngineConfig
from min_llm_inference_tpu import ItemStorage as JItemStorage
from min_llm_inference_tpu import ModelConfig as JModelConfig
from min_llm_inference_tpu import PagedEngine as JPagedEngine
from min_llm_inference_tpu import Request as JRequest
from min_llm_inference_tpu import init_params
import min_llm_inference_tpu_torch as T
from min_llm_inference_tpu_torch.tools.fuzz_draws import (
    DRAWS,
    EOF_BIAS,
    check_finished,
    draw_id,
    draw_setup,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("draw", DRAWS, ids=[draw_id(d) for d in DRAWS])
def test_fuzz_autonomous_vs_host_vs_jax(draw):
    s = draw_setup(draw)
    jmodel = JModelConfig(**s["model"])
    jparams = init_params(jax.random.PRNGKey(s["seed"]), jmodel,
                          eof_bias=EOF_BIAS)
    model = T.ModelConfig(**dataclasses.asdict(jmodel))
    params = T.init_params(s["seed"], model, eof_bias=EOF_BIAS, device="cpu")
    for name, leaf in (("wte", params["wte"]), ("wpe", params["wpe"])):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jparams[name]))
    cfg = T.EngineConfig(**s["engine"])
    prompts = s["prompts"]

    js = JItemStorage()
    for i, p in enumerate(prompts):
        js.add_new_item(JRequest(i, list(p)))
    JPagedEngine(jparams, jmodel, JEngineConfig(**s["engine"]),
                 attention_impl="jnp").run(js)
    want = [js.finished[i].tokens for i in range(len(prompts))]

    outs = {}
    for label, cls, kw in (
            ("auto", T.AutonomousEngine,
             dict(attention_impl="grouped", **s["auto_kw"])),
            ("host", T.PagedEngine, dict(attention_impl="torch"))):
        store = T.ItemStorage()
        for i, p in enumerate(prompts):
            store.add_new_item(T.Request(i, list(p)))
        cls(params, model, cfg, device="cpu", **kw).run(store)
        outs[label] = [store.finished[i].tokens for i in range(len(prompts))]
    check_finished(outs["auto"], prompts, model.n_seq, model.eof_token_id)
    for i in range(len(prompts)):
        assert outs["auto"][i] == outs["host"][i], f"request {i}"
        assert outs["host"][i] == want[i], f"request {i}"
