"""What the program counted over a window (``harness.ProgramWindow``) and
the per-layer readers of it: each reads a synthetic ``run.program`` and
reads nothing where its span or counter is absent. On the card, a traced
run's window holds the program's device spans."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from benchmark import harness, spec
from benchmark.tests import tiny

SEED = 2**31 + 23
PROGRAM = {
    "device_s": {"burst": 40.0, "admit": 0.5, "prefill": 6.0, "ring": 12.0,
                 "logits": 8.0},
    "slot_rounds": 4000,
    "served_tokens": 2792,
    "ttfts": [0.010 * i for i in range(1, 101)],
    "launches": {"prefill_causal_attention": 11},
}
WANT = {
    "prefill_pct": 15.0,
    "ring_pct": 30.0,
    "logits_pct": 20.0,
    "live_slot_pct": 69.8,
    "queue_wait_p95_ms.serve": float(np.quantile(PROGRAM["ttfts"], 0.95))
    * 1e3,
}
# what each reader needs: removing it leaves the reader nothing to read
NEEDS = {
    "prefill_pct": ("device_s", "prefill"),
    "ring_pct": ("device_s", "ring"),
    "logits_pct": ("device_s", "logits"),
    "live_slot_pct": ("slot_rounds", None),
    "queue_wait_p95_ms.serve": ("ttfts", None),
}


def _run(program):
    return types.SimpleNamespace(program=program)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_synthetic_window(name):
    got = spec.metric(name).read(_run(PROGRAM))
    assert got == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_nothing_where_its_input_is_absent(name):
    key, span = NEEDS[name]
    p = {k: (dict(v) if isinstance(v, dict) else v)
         for k, v in PROGRAM.items()}
    if span is None:
        p[key] = [] if key == "ttfts" else 0
    else:
        del p[key][span]
    assert spec.metric(name).read(_run(p)) is None
    assert spec.metric(name).read(_run(None)) is None


@pytest.mark.parametrize("name", ["prefill_pct", "ring_pct", "logits_pct"])
def test_span_share_needs_the_burst(name):
    p = {**PROGRAM, "device_s": {k: v for k, v in PROGRAM["device_s"].items()
                                 if k != "burst"}}
    assert spec.metric(name).read(_run(p)) is None


def test_every_reader_has_an_entry():
    b = spec.benchmark()
    per_layer = {m["name"]: m for m in b["per_layer"]}
    for name in WANT:
        assert name in per_layer
        assert per_layer[name]["workloads"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_traced_window_holds_the_burst_span(cuda, monkeypatch):
    """A traced run of ref-block.batch at its own widths (a short window of
    small batches) hands the readers the program's device spans: ``burst``
    and the regions inside it, which the span readers report."""
    seen = []
    close = harness.ProgramWindow.close

    def spy(self, win):
        seen.append(close(self, win))
        return seen[-1]

    monkeypatch.setattr(harness.ProgramWindow, "close", spy)
    name = "ref-block.batch"
    cfg = spec.config(spec.cell(spec.benchmark(), name)["config"])
    tr = tiny.traffic(spec.cell(spec.benchmark(), name)["traffic"],
                      cfg["model"]["n_seq"])
    res, _ = harness.run(name, SEED, 0.5, True, cuda, cfg=cfg, traffic=tr)
    assert res["correct"], res["check"]
    (program,) = seen
    spans = program["device_s"]
    assert spans["burst"] > 0
    assert 0 < spans["prefill"] < spans["burst"]
    assert 0 < spans["logits"] < spans["burst"]
    assert 0 < program["served_tokens"] <= program["slot_rounds"]
    for m in ("prefill_pct", "logits_pct", "live_slot_pct"):
        assert 0 < res["metrics"][m]["value"] <= 100
