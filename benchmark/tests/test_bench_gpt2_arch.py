"""GPT-2's architecture module (``archs/gpt2.py``) against values recorded
from the same code before it moved there (``weights.make``,
``reference.model.Reference`` and ``roofline``'s two counts): the weights
drawn from one seed, the reference's and the control's logits of one
request, bit for bit, at the test sizes of ``tiny.py`` (CPU), and the
counts at the test sizes and the configurations' own.

Every number here was recorded once; a change to the draw order, the
reference's arithmetic or the counts shows as a mismatch.
"""

from __future__ import annotations

import hashlib

import pytest
import torch

from benchmark import spec
from benchmark.reference.model import fp8_weights
from benchmark.tests import tiny

gpt2 = spec.arch("gpt2")
SEED = 2**31 + 17
REQUEST = {
    "ref-block": ([5, 17, 3, 250, 9, 77, 1, 0, 31],
                  [4, 8, 15, 16, 23, 42, 108]),
    "gpt2-small": ([5, 17, 3, 250, 9, 77, 1, 0, 31, 400, 12],
                   [4, 8, 15, 16, 23, 42, 108, 500, 2]),
}
# (prompt, served) pairs for the decode-attention bound
BOUND_REQUESTS = [([1] * 7, [2] * 40), ([3] * 100, [4] * 3),
                  ([5] * 33, [6] * 17)]
FLOPS_REQUESTS = [(1, 1), (9, 7), (100, 28)]
RECORDED = {
    "ref-block": {
        "weights": "c41a9d74098079100d06f53a21f97bfb"
                   "8300e3d1f89fe6fca82d439d68b60c3c",
        "logits": "031bdc74c5ca5fac75e84bf0b0772525"
                  "aa3ba162303cc6986dc38a3e7170cb11",
        "control_logits": "35ed2a6060664894807046216c5c21ee"
                          "6c72a1262c74fde811144e24e975add2",
        # test size, then the configuration's own
        "model_flops": [525312.0, 5853184.0, 43886592.0,
                        29368320.0, 340426752.0, 2509062144.0],
        "attention_bound_s": [2.0372537313432837e-07,
                              1.6267701492537313e-06],
    },
    "gpt2-small": {
        "weights": "e9c2b14a02b8e1411c467c97e4b499b3"
                   "991564fd80707bb0d85bf8ebe2d4005b",
        "logits": "0f861049898e9c84c884b1bc8e2f9731"
                  "15a4bb4062e4e269c8a4c2e08ea79e06",
        "control_logits": "3b86a0f1081cc3ebc66e0ffa4576b945"
                          "ece9a87a4f526da09d6dd6176669b413",
        "model_flops": [3738624.0, 48903168.0, 403127808.0,
                        247100928.0, 2998344192.0, 22851428352.0],
        "attention_bound_s": [8.235940298507462e-07,
                              9.868685373134329e-06],
    },
}
CONFIGS = sorted(RECORDED)


def _sha(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _leaves(tree) -> list:
    out = [tree["wte"], tree["wpe"]]
    for layer in tree["layers"]:
        out += [layer[k] for k in sorted(layer)]
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_as_recorded(name):
    w = gpt2.make_weights(tiny.config(name), SEED, torch.device("cpu"))
    assert _sha(_leaves(w)) == RECORDED[name]["weights"]


@pytest.mark.parametrize("control", [False, True], ids=["ref", "control"])
@pytest.mark.parametrize("name", CONFIGS)
def test_reference_logits_as_recorded(name, control):
    cfg = tiny.config(name)
    w = gpt2.make_weights(cfg, SEED, torch.device("cpu"))
    ref = gpt2.Reference(cfg, w, weight_fn=fp8_weights if control else None)
    got = ref.served_logits(*REQUEST[name])
    assert got.dtype == torch.float32
    assert got.shape == (len(REQUEST[name][1]), cfg["model"]["n_vocab"])
    key = "control_logits" if control else "logits"
    assert _sha([got.view(torch.int32)]) == RECORDED[name][key]


@pytest.mark.parametrize("name", CONFIGS)
def test_counts_as_recorded(name):
    cfgs = (tiny.config(name), spec.config(name))
    flops = [gpt2.model_flops(c["model"], a, b) for c in cfgs
             for a, b in FLOPS_REQUESTS]
    assert flops == RECORDED[name]["model_flops"]
    bounds = [gpt2.attention_bound_s(c, BOUND_REQUESTS) for c in cfgs]
    assert bounds == RECORDED[name]["attention_bound_s"]
