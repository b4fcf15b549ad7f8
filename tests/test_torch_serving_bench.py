"""The port's serving bench (min_llm_inference_tpu_torch.tools.serving_bench)
on the CPU at a tiny size: the chunked, pipelined and open-loop runs finish
every request with the tokens of the port's one-shot AutonomousEngine and
of the JAX package's (float32, its gather oracle "jnp"), on the same
requests and bench.py's weights; the line has tools/serving_bench.py's
keys (read from its source: the script is not run)."""

import ast
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import bench
from min_llm_inference_tpu import EngineConfig as JEngineConfig
from min_llm_inference_tpu import ItemStorage as JItemStorage
from min_llm_inference_tpu import ModelConfig as JModelConfig
from min_llm_inference_tpu import Request as JRequest
from min_llm_inference_tpu.runtime.autonomous import (
    AutonomousEngine as JAutonomousEngine,
)
import min_llm_inference_tpu_torch as T
from min_llm_inference_tpu_torch import bench as tbench
from min_llm_inference_tpu_torch.tools import serving_bench as tserve

torch.set_num_threads(1)

TINY = ["--slots", "8", "--pages", "48", "--seq", "64", "--emb", "32",
        "--vocab", "64", "--requests", "24", "--waves", "3", "--rounds", "4",
        "--max-prompt", "20", "--bursts-per-chunk", "2", "--device", "cpu"]
MODES = {"chunked": [], "pipelined": ["--pipelined"],
         "open-loop": ["--arrival-rate", "4000"],
         "open-loop-pipelined": ["--arrival-rate", "4000", "--pipelined"],
         "overcommit": ["--overcommit", "--pages", "12"]}
SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "serving_bench.py")


def script_keys():
    """The keys of the result dict of tools/serving_bench.py, nested dicts
    as (key, keys) pairs."""
    tree = ast.parse(open(SCRIPT).read())
    node = next(n.value for n in ast.walk(tree)
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "result")

    def keys(d):
        return frozenset(
            (k.value, keys(v) if isinstance(v, ast.Dict) else None)
            for k, v in zip(d.keys, d.values))

    return keys(node)


def line_keys(d):
    return frozenset((k, line_keys(v) if isinstance(v, dict) else None)
                     for k, v in d.items())


def run_f32(flags):
    """The serving bench of ``flags`` on the float32 reference model:
    (result, {id: finished request}, model config, engine config)."""
    args = tserve.parser().parse_args(flags)
    model_cfg, engine_cfg = tserve.resolve(args)
    model_cfg = dataclasses.replace(model_cfg, dtype="float32")
    result, done = tserve.serve(args, model_cfg, engine_cfg)
    return result, done, model_cfg, engine_cfg


@pytest.mark.parametrize("mode", list(MODES))
def test_serving_bench_matches_oneshot_and_jax(mode):
    result, done, model_cfg, engine_cfg = run_f32(TINY + MODES[mode])
    n = 24
    assert sorted(done) == list(range(n))
    assert result["total_tokens"] == sum(
        len(r.tokens) - r.prompt_len for r in done.values())
    assert line_keys(result) == script_keys()
    assert result["mode"] == ("pipelined" if "--pipelined" in MODES[mode]
                              else "chunked")
    assert result["config"]["device"] == "cpu"
    prompts = [done[i].tokens[:done[i].prompt_len] for i in range(n)]
    got = {i: done[i].tokens for i in range(n)}

    # the port's one-shot engine on the same requests and weights
    params = tbench.bench_params(np.random.default_rng(0), model_cfg,
                                  device="cpu")
    store = tbench.make_store(prompts)
    T.AutonomousEngine(params, model_cfg, engine_cfg,
                       device="cpu").run(store)
    assert {i: r.tokens for i, r in store.finished.items()} == got

    # the JAX package's one-shot engine, on bench.py's own weights
    jmodel = JModelConfig(**dataclasses.asdict(model_cfg))
    jparams = bench.bench_params(np.random.default_rng(0), jmodel)
    jstore = JItemStorage()
    for i, p in enumerate(prompts):
        jstore.add_new_item(JRequest(i, list(p)))
    JAutonomousEngine(jparams, jmodel,
                      JEngineConfig(**dataclasses.asdict(engine_cfg)),
                      attention_impl="jnp").run(jstore)
    assert {i: r.tokens for i, r in jstore.finished.items()} == got


def test_serving_bench_main_prints_one_line(tmp_path, capsys):
    """main() prints the one JSON line and writes it to --out."""
    out = tmp_path / "serving.json"
    assert tserve.main(TINY + ["--out", str(out)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == json.loads(out.read_text())
    assert line_keys(json.loads(lines[0])) == script_keys()
