"""The port's examples against the JAX package's, on the CPU.

The demo (min_llm_inference_tpu_torch.examples.demo_engine) prints the
lines of examples/demo_engine.py but for the device line and the times:
the same finished counts, token totals, sample requests and parity lines.
The scaling harness (min_llm_inference_tpu_torch.examples.scaling_bench)
at 2 and 4 gloo ranks (tp 2; dp 2 x tp 2) makes the token totals of
examples/scaling_bench.py's ``run()`` at the same mesh sizes on the
conftest's virtual CPU devices. The JAX scripts are loaded from their
files and called as they are."""

import dataclasses
import importlib.util
import io
import os
import re
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from min_llm_inference_tpu import EngineConfig as JEngineConfig
from min_llm_inference_tpu import ModelConfig as JModelConfig
from min_llm_inference_tpu import init_params
from min_llm_inference_tpu.parallel import engine as jengine
from min_llm_inference_tpu_torch.examples import demo_engine as tdemo
from min_llm_inference_tpu_torch.examples import scaling_bench as tscale

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def comparable(text):
    """The demo's lines without the device line and the times: a
    throughput line keeps its token total, TTFT lines go."""
    out = []
    for ln in text.strip().splitlines():
        if ln.startswith(("devices:", "device:")) or "p50 TTFT" in ln:
            continue
        m = re.match(r"(total tokens: \d+), seconds:", ln)
        out.append(m.group(1) if m else ln)
    return out


@pytest.mark.parametrize("flags", [
    ["--backend", "all"],
    ["--backend", "both", "--attention", "pallas"],
    ["--backend", "auto", "--temperature", "0.8", "--top-k", "8",
     "--seed", "3"],
], ids=["all", "both-pallas", "auto-sampled"])
def test_demo_prints_jax_demo_lines(monkeypatch, capsys, flags):
    jdemo = load("demo_engine")
    monkeypatch.setattr(sys, "argv", ["demo_engine.py", *flags])
    out = io.StringIO()
    with redirect_stdout(out):
        jdemo.main()
    want = comparable(out.getvalue())
    capsys.readouterr()
    assert tdemo.main(flags + ["--device", "cpu"]) == 0
    got = comparable(capsys.readouterr().out)
    assert got == want
    if flags == ["--backend", "all"]:
        assert sum("token parity: OK" in ln for ln in got) == 4
        assert sum("finished 32/32" in ln for ln in got) == 5


class CopyingJnp:
    """jax.numpy whose ``asarray`` copies a numpy operand first, for the
    JAX harness's ShardedPagedEngine. It uploads its packed scheduler
    operand with ``jnp.asarray(self._packed)`` and then overwrites the
    array's length column (min_llm_inference_tpu/parallel/engine.py:
    194-199). On the CPU backend ``asarray`` may alias the numpy buffer, so
    the sharded step on the virtual devices can read the overwritten
    column: then no slot goes live and ``run()`` never returns, which the
    2-device paged mesh did in most runs. An upload to a TPU copies, as
    this does; the engine's arithmetic is untouched."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(x, *args, **kwargs):
        if isinstance(x, np.ndarray):
            x = x.copy()
        return jnp.asarray(x, *args, **kwargs)


@pytest.mark.parametrize("engine", ["auto", "paged"])
def test_scaling_harness_matches_jax_run(monkeypatch, capsys, engine):
    """Two mesh sizes, one line each; each size's token total equals the
    JAX harness's run() on the same requests and mesh size."""
    jscale = load("scaling_bench")
    n_req = 32
    totals = {}
    real_run = tscale.run

    def run(n_devices, tp, requests, eng, *a, **k):
        out = real_run(n_devices, tp, requests, eng, *a, **k)
        totals[n_devices] = (out[1], requests)
        return out

    monkeypatch.setattr(tscale, "run", run)
    assert tscale.main(["--tp", "2", "--requests", str(n_req), "--engine",
                        engine, "--device", "cpu", "--n-devices", "4"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "devices= 2 (dp=1 x tp=2)", "devices= 4 (dp=2 x tp=2)"]
    assert "efficiency 100.0%" in lines[0]

    monkeypatch.setattr(jengine, "jnp", CopyingJnp())
    model = JModelConfig(**dataclasses.asdict(tscale.MODEL))
    params = init_params(jax.random.PRNGKey(0), model, eof_bias=0.02)
    for n in (2, 4):
        total, requests = totals[n]
        cfg = JEngineConfig(**dataclasses.asdict(
            tscale.engine_config(16, n // 2)))
        _, jtotal = jscale.run(params, model, cfg, n, 2, requests, None,
                               engine)
        assert total == jtotal
