"""Whole runs of every cell on the CPU at test size (tests/tiny.py): the
harness's set-up, window, traced stretch, check and result line, with the
program's plain kernels. Then the same runs with the timed path broken
underneath, which must come out not correct, and the control, which must
read above the configuration's limit.

The look for a card (run.py) is skipped: the harness runs on ``cpu``.
"""

from __future__ import annotations

import pytest
import torch

import min_llm_inference_tpu_torch.models.model as port_model
import min_llm_inference_tpu_torch.runtime.autonomous as port_auto
from benchmark import harness, spec
from benchmark.tests import tiny

SEED = 2**31 + 5
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
RING_CELLS = [c for c in CELLS
              if spec.config(spec.cell(spec.benchmark(), c)["config"])
              ["engine"]["decode_ring"]]


def _run(cell, traced=False, control=False):
    cfg, tr = tiny.cell(cell)
    # an open loop's window holds two status reads or more on the CPU
    seconds = 1.0 if tr["loop"] == "open_loop" else 0.3
    return harness.run(cell, SEED, seconds, traced, "cpu", cfg=cfg,
                       traffic=tr, control=control)


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cell, traced):
    res, checks = _run(cell, traced)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "check"
    bench = spec.benchmark()
    want = {m["name"] for m in spec.metrics_of(
        bench, cell, "per_layer" if traced else "end_to_end")}
    # the CPU has no device trace and captures no graph, so no device
    # span: those metrics are left out, not zero
    device_only = {n for n in want
                   if n.split(".")[0] in ("device_idle_pct",
                                          "attn_roofline_pct",
                                          "prefill_pct", "ring_pct",
                                          "logits_pct")}
    assert want - device_only <= set(res["metrics"]) <= want
    for m in res["metrics"].values():
        assert m["value"] > 0


def _alter_tokens(monkeypatch):
    orig = port_model.greedy_next_token

    def altered(logits, lengths, n_seq, eof):
        tok, new_len = orig(logits, lengths, n_seq, eof)
        bad = (lengths > 0) & (lengths % 5 == 0) & (tok != eof)
        return torch.where(bad, (tok + 1) % eof, tok), new_len

    monkeypatch.setattr(port_model, "greedy_next_token", altered)


def _drop_prefill_writes(monkeypatch):
    orig = port_auto.make_prefill_kv_writer

    def writer(*args, **kw):
        _, finalize = orig(*args, **kw)
        return (lambda li, k, v: None), finalize

    monkeypatch.setattr(port_auto, "make_prefill_kv_writer", writer)


def _drop_ring_flush(monkeypatch):
    monkeypatch.setattr(port_auto, "ring_flush", lambda *a, **kw: None)


FAULTS = {"token_altered": _alter_tokens,
          "prefill_state_unchanged": _drop_prefill_writes}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res, _ = _run(cell)
    assert not res["correct"]
    assert res["check"]["gap_sd"]["value"] > res["check"]["gap_sd"]["limit"]


@pytest.mark.parametrize("cell", RING_CELLS)
def test_ring_flush_skipped_is_not_correct(cell, monkeypatch):
    _drop_ring_flush(monkeypatch)
    res, _ = _run(cell)
    assert not res["correct"]


@pytest.mark.parametrize("config", sorted(
    {spec.cell(spec.benchmark(), c)["config"] for c in CELLS}))
def test_control_reads_above_the_limit(config):
    """The reference at float8 weights in the program's place, at test
    size, judged by the run's own checks and limits: it comes out not
    correct, while the program comes out correct."""
    cell = next(c for c in CELLS
                if spec.cell(spec.benchmark(), c)["config"] == config)
    res, _ = _run(cell, control=True)
    limit = res["check"]["gap_sd"]["limit"]
    assert res["correct"]
    assert res["check"]["gap_sd"]["value"] <= limit
    ctl = res["control"]
    assert not ctl["correct"]
    assert ctl["check"]["gap_sd"]["limit"] == limit
    assert ctl["check"]["gap_sd"]["value"] > limit
    assert list(res)[-1] == "check"
