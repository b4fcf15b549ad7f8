"""mfu_pct (model step): the model FLOPs of the window's requests (their
real prompt and served tokens, no padding; the ``model_flops`` of the
configuration's ``arch``) over the window's batch walls times the card's
bf16 peak. Batch loops only."""

from benchmark import spec
from benchmark.roofline import BF16_FLOPS


def read(run):
    w = run.window
    if "walls" not in w:
        return None
    m = run.cfg["model"]
    model_flops = spec.arch(run.cfg["arch"]).model_flops
    flops = sum(model_flops(m, len(p), len(s)) for p, s in w["requests"])
    return 100.0 * flops / (sum(w["walls"]) * BF16_FLOPS)
