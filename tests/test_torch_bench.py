"""The port's bench (min_llm_inference_tpu_torch.bench) against bench.py.

bench.py is imported as it is and its ``main()`` run with argv patched;
``run_once`` (and, where only the configs matter, the weight makers) are
monkeypatched to record what main() hands them. Held: the resolved
configs field for field for each listed flag set, the weights bit for bit,
the warm and timed prompts, and tiny CPU runs whose per-run token totals
equal bench.py's, on one engine and one program across warm and timed
runs."""

import dataclasses
import io
import json
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import bench
import min_llm_inference_tpu
from min_llm_inference_tpu import ModelConfig as JModelConfig
from min_llm_inference_tpu_torch import bench as tbench
from min_llm_inference_tpu_torch.runtime.autonomous import AutonomousEngine

torch.set_num_threads(1)

# bench.py's workloads (README.md, ROADMAP) and the flag sets whose
# resolution takes a subtle branch (int4 fallback, dgrid preconditions)
FLAG_SETS = [
    [],
    ["--model", "gpt2s"],
    ["--engine", "host", "--attention", "pallas"],
    ["--ring"],
    ["--overcommit", "--pages", "3072", "--warm-requests", "2048"],
    ["--engine", "host", "--kv-dtype", "bfloat16", "--rounds", "32"],
    ["--attention", "jnp"],
    ["--model", "gpt2s", "--no-ring"],
    ["--model", "gpt2s", "--overcommit"],
    ["--kv-dtype", "int8", "--ring"],
]
TINY = ["--dtype", "float32", "--slots", "8", "--pages", "64", "--seq",
        "32", "--emb", "64", "--vocab", "64", "--requests", "24",
        "--repeats", "2", "--rounds", "4", "--page-size", "8"]


def jax_main(monkeypatch, flags, stub_weights=True, wrap=False):
    """bench.py's main() on ``flags``: returns ([run_once's arguments of
    each call], [each call's token total], its JSON line). run_once is
    recorded (and, unless ``wrap``, not run); ``stub_weights`` skips the
    weight draws (init_params, and bench_params)."""
    calls, totals = [], []
    real = bench.run_once

    def record(params, model_cfg, engine_cfg, store, attention,
               engine_kind="host", rounds_chunk=4, capacity=None,
               max_new=128, min_drain=None):
        prompts = [list(r.tokens) for r in store._new]
        calls.append(dict(model_cfg=model_cfg, engine_cfg=engine_cfg,
                          prompts=prompts, attention=attention,
                          engine_kind=engine_kind, rounds_chunk=rounds_chunk,
                          capacity=capacity, max_new=max_new,
                          min_drain=min_drain))
        if not wrap:
            return bench.get_global_throughput_counter()
        counter = real(params, model_cfg, engine_cfg, store, attention,
                       engine_kind, rounds_chunk, capacity, max_new,
                       min_drain)
        totals.append(counter.total_tokens)
        return counter

    monkeypatch.setattr(bench, "run_once", record)
    if stub_weights:
        monkeypatch.setattr(min_llm_inference_tpu, "init_params",
                            lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["bench.py", *flags])
    out = io.StringIO()
    with redirect_stdout(out):
        bench.main()
    return calls, totals, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: " ".join(f) or
                         "defaults")
def test_resolve_matches_bench_py(monkeypatch, flags):
    """Every ModelConfig and EngineConfig field, the attention (mapped),
    chunk, capacity, admissions per burst, drain floor, warm-run size and
    the number of timed runs equal what bench.py's main() hands run_once."""
    # the full-width weight draw is not needed for the configs
    monkeypatch.setattr(bench, "bench_params", lambda rng, cfg: None)
    calls, _, _ = jax_main(monkeypatch, flags)
    model_cfg, engine_cfg, opts = tbench.resolve(
        tbench.parser().parse_args(flags))
    assert dataclasses.asdict(model_cfg) == dataclasses.asdict(
        calls[0]["model_cfg"])
    assert dataclasses.asdict(engine_cfg) == dataclasses.asdict(
        calls[0]["engine_cfg"])
    want = calls[0]
    assert tbench.ATTENTION[want["attention"]] == opts.attention
    assert (want["engine_kind"], want["rounds_chunk"], want["capacity"],
            want["max_new"], want["min_drain"]) == (
        opts.engine, opts.bursts_per_chunk, opts.requests, opts.max_new,
        opts.min_drain_slots)
    assert len(want["prompts"]) == opts.n_warm
    assert len(calls) == 1 + opts.repeats
    assert all(len(c["prompts"]) == opts.requests for c in calls[1:])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bench_params_bit_equal(dtype):
    """The port's bench_params equal bench.py's bit for bit (bf16 bits as
    int16), drawn from the same generator state."""
    cfg = dict(n_vocab=48, emb_dim=40, n_seq=24, eof_token_id=47,
               dtype=dtype)
    jp = bench.bench_params(np.random.default_rng(0), JModelConfig(**cfg))
    tp = tbench.bench_params(np.random.default_rng(0),
                             tbench.ModelConfig(**cfg), device="cpu")
    view = torch.int16 if dtype == "bfloat16" else torch.int32
    npview = np.int16 if dtype == "bfloat16" else np.int32

    def eq(j, t):
        assert t.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(t.view(view).numpy(),
                                      np.asarray(j).view(npview))

    eq(jp["wte"], tp["wte"])
    eq(jp["wpe"], tp["wpe"])
    for name in ("wq", "wk", "wv"):
        eq(jp["layers"][0][name], tp["layers"][0][name])


class _Recorder:
    """Stands in for the bench's engine: records each store's prompts."""

    def __init__(self):
        self.stores = []
        self.stats = None

    def run(self, store):
        self.stores.append([list(r.tokens) for r in store._new])
        for req in store.pop_new_items(1 << 30):
            req.tokens.append(0)
            store.add_finished(req)


@pytest.mark.parametrize("flags", [
    ["--emb", "32", "--vocab", "64", "--seq", "40", "--requests", "30"],
    ["--model", "gpt2s", "--vocab", "64", "--seq", "40", "--requests",
     "30", "--slots", "16"],
    ["--emb", "32", "--vocab", "64", "--requests", "30", "--no-warmup"],
], ids=["ref", "gpt2s", "no-warmup"])
def test_prompts_match_bench_py(monkeypatch, flags):
    """The warm store and each timed store hold bench.py's prompts, drawn
    from one generator after the weights (the reference model's; gpt2s
    draws no weights from it)."""
    flags = flags + ["--repeats", "2"]
    calls, _, _ = jax_main(monkeypatch, flags)
    rec = _Recorder()
    monkeypatch.setattr(tbench, "init_params", lambda *a, **k: None)
    monkeypatch.setattr(tbench, "make_engine", lambda *a, **k: rec)
    tbench.run(tbench.parser().parse_args(flags + ["--device", "cpu"]))
    assert rec.stores == [c["prompts"] for c in calls]


@pytest.mark.parametrize("flags", [[], ["--engine", "host", "--attention",
                                        "jnp"]], ids=["auto", "host-jnp"])
def test_tiny_run_matches_bench_py(monkeypatch, capsys, flags):
    """A tiny float32 run on the CPU prints one line with bench.py's keys;
    each timed run's token total equals bench.py's at the same flags; one
    engine is built, and (auto) one program made, across the warm and the
    timed runs."""
    _, jtotals, jline = jax_main(monkeypatch, TINY + flags,
                                 stub_weights=False, wrap=True)
    built, programs, runs = [], [], []
    real_make, real_program = tbench.make_engine, AutonomousEngine._program
    real_run = tbench.run

    def make(*a, **k):
        built.append(real_make(*a, **k))
        return built[-1]

    def program(self, *a, **k):
        programs.append(a)
        return real_program(self, *a, **k)

    def run(args):
        runs.append(real_run(args))
        return runs[-1]

    monkeypatch.setattr(tbench, "make_engine", make)
    monkeypatch.setattr(tbench, "run", run)
    monkeypatch.setattr(AutonomousEngine, "_program", program)
    capsys.readouterr()
    assert tbench.main(TINY + flags + ["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    (result, extra), = runs
    assert line == result
    assert set(line) == set(jline) and set(line["config"]) == set(
        jline["config"])
    assert line["config"]["device"] == "cpu"
    assert {k: v for k, v in line["config"].items() if k != "device"} == {
        k: v for k, v in jline["config"].items() if k != "device"}
    assert [r["total_tokens"] for r in extra["runs"]] == jtotals[1:]
    assert line["total_tokens"] in jtotals[1:]
    assert len(built) == 1
    assert len(programs) == (0 if flags else 1)
    assert extra["timed_captures"] == 0


def test_no_gpu_raises(monkeypatch):
    """Without a GPU and without --device cpu the bench raises before it
    builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(tbench, "make_engine",
                        lambda *a, **k: built.append(1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main(["--slots", "8", "--requests", "8"])
    assert not built
