"""What the benchmark may load, and that it finds its data by name.

- No module of the benchmark imports ``jax``, ``jaxlib``, ``flax`` or the
  JAX package ``min_llm_inference_tpu``: top-level names are compared
  whole, since the port's name begins with the JAX package's.
- ``benchmark/reference/`` and ``benchmark/archs/`` (the models' plain
  references) import nothing of the port.
- Every configuration, architecture, traffic mix, loop and metric that
  BENCHMARK.json names is a file of its own, and a new one is found by
  name with no edit to a file already there.
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import spec

HERE = spec.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "min_llm_inference_tpu"}
PORT = "min_llm_inference_tpu_torch"
ARCH_PROVIDES = ("make_weights", "Reference", "model_flops",
                 "attention_bound_s")


def _sources(sub: str = "") -> list:
    out = []
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _top_level_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(
    p, HERE))
def test_no_jax(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", _sources("reference") + _sources("archs"),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in _top_level_imports(path)


def test_whole_names_only():
    """The port's top-level name is not the JAX package's."""
    assert PORT.split(".")[0] not in FORBIDDEN


def test_a_run_loads_no_jax():
    """The harness, its loops and metrics, imported in a fresh process,
    leave no forbidden module in sys.modules."""
    code = ("import sys; from benchmark import harness, spec; "
            "b = spec.benchmark(); "
            "[spec.loop(spec.traffic(w['traffic'])['loop']) "
            "for w in b['workloads']]; "
            "[spec.metric(m['name']) for g in ('end_to_end', 'per_layer') "
            "for m in b[g]]; "
            "[spec.arch(spec.config(c['name'])['arch']) "
            "for c in b['configs']]; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_every_named_file_exists():
    b = spec.benchmark()
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(spec.ROOT, c["file"]))
        cfg = spec.config(c["name"])
        assert cfg["name"] == c["name"]
        arch = spec.arch(cfg["arch"])
        for fn in ARCH_PROVIDES:
            assert callable(getattr(arch, fn))
    for w in b["workloads"]:
        t = spec.traffic(w["traffic"])
        assert callable(spec.loop(t["loop"]).window)
    for g in ("end_to_end", "per_layer"):
        for m in b[g]:
            assert callable(spec.metric(m["name"]).read)


def test_new_files_are_found_by_name(tmp_path):
    """A copy of the benchmark gains a traffic mix, a metric and a cell as
    new files and new entries only; its harness finds them."""
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = spec.benchmark()
    new_t = dict(spec.traffic("batch-2048-short"), requests_per_batch=512)
    (tmp_path / "benchmark" / "traffic" / "batch-512-short.json").write_text(
        json.dumps(new_t))
    (tmp_path / "benchmark" / "metrics" / "tokens_a_batch.py").write_text(
        "def read(run):\n    return sum(run.window['tokens']) / "
        "len(run.window['tokens'])\n")
    b["workloads"].append({"name": "ref-block.batch-512",
                           "config": "ref-block",
                           "traffic": "batch-512-short", "chips": 1,
                           "why": "a test cell"})
    b["per_layer"].append({"name": "tokens_a_batch", "unit": "tokens",
                           "better": "higher", "source": "program_counter",
                           "layer": "scheduler", "moves": "output_tok_s",
                           "workloads": ["ref-block.batch-512"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = ("from benchmark import spec; b = spec.benchmark(); "
            "c = spec.cell(b, 'ref-block.batch-512'); "
            "print(spec.traffic(c['traffic'])['requests_per_batch'], "
            "[m['name'] for m in spec.metrics_of(b, c['name'], "
            "'per_layer')], "
            "spec.metric('tokens_a_batch').read(type('R', (), "
            "{'window': {'tokens': [4, 6]}})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["512", "['tokens_a_batch']", "5.0"]


ECHO_ARCH = '''"""A test architecture: GPT-2's, announcing each call."""
import sys

from benchmark import spec

_gpt2 = spec.arch("gpt2")


def _say(what):
    print("echo:" + what, file=sys.stderr)


def make_weights(cfg, seed, device):
    _say("make_weights")
    return _gpt2.make_weights(cfg, seed, device)


class Reference(_gpt2.Reference):
    def __init__(self, cfg, weights, weight_fn=None):
        _say("Reference")
        super().__init__(cfg, weights, weight_fn)


def model_flops(model, prompt_len, n_served):
    _say("model_flops")
    return _gpt2.model_flops(model, prompt_len, n_served)


def attention_bound_s(cfg, requests):
    _say("attention_bound_s")
    return _gpt2.attention_bound_s(cfg, requests)
'''


def test_new_arch_is_found_by_name(tmp_path):
    """A copy of the benchmark gains a configuration whose ``arch`` names a
    module the harness has never seen, as new files and new entries only:
    the harness draws its weights, the check builds its reference, and
    ``mfu_pct`` and ``attn_roofline_pct`` take their counts from it."""
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "benchmark" / "archs" / "echo.py").write_text(ECHO_ARCH)
    cfg = dict(spec.config("ref-block"), name="echo-block", arch="echo")
    (tmp_path / "benchmark" / "configs" / "echo-block.json").write_text(
        json.dumps(cfg))
    b = spec.benchmark()
    b["configs"].append(dict(b["configs"][0], name="echo-block",
                             file="benchmark/configs/echo-block.json"))
    b["workloads"].append({"name": "echo-block.batch",
                           "config": "echo-block",
                           "traffic": "batch-2048-short", "chips": 1,
                           "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = (
        "import types\n"
        "from benchmark import harness, spec\n"
        "from benchmark.tests import tiny\n"
        "cfg, tr = tiny.cell('echo-block.batch')\n"
        "res, _ = harness.run('echo-block.batch', 2**31 + 29, 0.3, False, "
        "'cpu', cfg=cfg, traffic=tr)\n"
        "reqs = [([1, 2, 3], [4, 5])]\n"
        "kernel = cfg['attention']['kernels'][0]\n"
        "run = types.SimpleNamespace(cfg=cfg, window={'walls': [1.0], "
        "'requests': reqs}, profile={'kernels': {kernel: [1, 1e-3]}, "
        "'requests': reqs})\n"
        "print(res['correct'], spec.metric('mfu_pct').read(run) > 0, "
        "spec.metric('attn_roofline_pct').read(run) > 0)\n")
    # the copy's benchmark first, the port from this checkout
    path = os.pathsep.join([str(tmp_path), spec.ROOT])
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": path})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "True", "True"]
    said = {line for line in out.stderr.splitlines()
            if line.startswith("echo:")}
    assert said == {"echo:" + fn for fn in ARCH_PROVIDES}
