"""The readers deepseek-v2-lite.long-context adds, on synthetic windows and
traces: the two span shares, and ``moe_roofline_pct``, which reads only
where the named grouped-product kernels launched exactly twice the
expert-layer calls that the decode attention's launches and the requests
imply."""

from __future__ import annotations

import types

import pytest

from benchmark import spec

CFG = spec.config("deepseek-v2-lite")
ATTN = CFG["attention"]["kernels"]
MOE = CFG["moe"]["kernels"]
ROUNDS = 752
# 256 requests: 16 prefill blocks of 16
REQUESTS = [([1] * 3700, [2] * 300)] * 256
CALLS = ROUNDS * 26 + 16 * 25


def _trace(moe_launches=(2 * CALLS - 800, 800), attn_calls=ROUNDS * 27):
    kernels = {ATTN[0]: (attn_calls, 4.0), ATTN[1]: (attn_calls, 0.5),
               "some_other_kernel": (123, 1.0)}
    kernels.update({name: (n, 20.0) for name, n in zip(MOE, moe_launches)})
    return types.SimpleNamespace(
        cfg=CFG, profile={"kernels": kernels, "requests": REQUESTS})


def test_moe_calls_counts_rounds_and_prefill_blocks():
    arch = spec.arch("deepseek_v2")
    assert arch.moe_calls(CFG, REQUESTS, ROUNDS * 27) == CALLS
    assert arch.moe_calls(CFG, REQUESTS, ROUNDS * 27 + 1) is None
    assert arch.moe_calls(CFG, REQUESTS, 0) is None


def test_moe_roofline_reads_the_bound_over_the_named_kernels():
    got = spec.metric("moe_roofline_pct").read(_trace())
    bound = spec.arch("deepseek_v2").moe_bound_s(CFG, REQUESTS, CALLS)
    assert got == pytest.approx(100.0 * bound / 40.0, rel=1e-12)
    assert 0 < got < 100


@pytest.mark.parametrize("launches,attn_calls", [
    ((2 * CALLS - 801, 800), ROUNDS * 27),      # odd: a product unnamed
    ((2 * CALLS - 800, 798), ROUNDS * 27),      # a call short
    ((2 * CALLS, 800), ROUNDS * 27),            # a third tile's launches
    ((2 * CALLS - 800, 800), ROUNDS * 27 - 5),  # no whole round
    ((2 * CALLS - 800, 800), 0),                # no decode attention
])
def test_moe_roofline_reads_nothing_when_launches_disagree(launches,
                                                           attn_calls):
    run = _trace(launches, attn_calls)
    assert spec.metric("moe_roofline_pct").read(run) is None


def test_moe_roofline_reads_nothing_without_its_kernels():
    run = _trace()
    run.profile["kernels"] = {k: v for k, v in run.profile["kernels"].items()
                              if k not in MOE}
    assert spec.metric("moe_roofline_pct").read(run) is None


@pytest.mark.parametrize("name,span", [("mla_pct", "mla"),
                                       ("moe_pct", "moe")])
def test_span_share_of_burst(name, span):
    program = {"device_s": {"burst": 40.0, span: 10.0}}
    run = types.SimpleNamespace(program=program)
    assert spec.metric(name).read(run) == pytest.approx(25.0, rel=1e-12)
    del program["device_s"][span]
    assert spec.metric(name).read(run) is None
