"""The comparison that decides ``correct`` for a served model.

Once the window has closed, a sample of the finished requests, drawn from
the seed and holding the one with the most served tokens, goes through the
plain reference (the ``Reference`` of the configuration's ``arch``) once
each: prompt, then the served tokens. At every served position the
reference's logits say how far the served token lies below the reference's
best token, in standard deviations of that position's logits
(``gap_sd``). Greedy decoding serves the best token, so a sound program
reads about 0; a wrong token reads far above it.

The control puts the reference in the program's place at the precision one
step below the configuration's (weights in float8 e4m3 instead of
bfloat16): at each position its best token is read against the reference
in the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import spec
from .model import fp8_weights


def sample(requests: list, seed: int, n: int) -> list:
    """``n`` of ``requests`` (each ``(prompt, served)``), drawn from
    ``seed``, the one with the most served tokens always among them."""
    if len(requests) <= n:
        return list(requests)
    longest = max(range(len(requests)), key=lambda i: len(requests[i][1]))
    rng = np.random.default_rng([seed, 7])
    rest = [i for i in rng.permutation(len(requests)) if i != longest]
    return [requests[i] for i in [longest] + rest[: n - 1]]


def gap_sd(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per position: (best logit - the token's logit) / std of the
    position's logits."""
    best = logits.max(dim=-1).values
    got = logits.gather(1, tokens[:, None].long())[:, 0]
    return (best - got) / logits.std(dim=-1)


def length_faults(requests: list, n_seq: int, eof: int) -> int:
    """Requests that stopped neither at the cap nor on the EOF token, or
    ran past the cap or served a token after EOF."""
    bad = 0
    for prompt, served in requests:
        n = len(prompt) + len(served)
        early_eof = eof in list(served[:-1])
        stop_ok = n == n_seq or (len(served) > 0 and served[-1] == eof)
        if len(served) == 0 or n > n_seq or early_eof or not stop_ok:
            bad += 1
    return bad


@torch.no_grad()
def read(cfg: dict, weights: dict, requests: list,
         control: bool = False) -> dict:
    """The numbers compared for ``requests`` (``(prompt, served)`` pairs):
    ``max_gap_sd`` of the served tokens (``control``: also of the
    control's tokens, as ``control_max_gap_sd``), the served tokens
    compared, and the length-rule faults."""
    Reference = spec.arch(cfg["arch"]).Reference
    ref = Reference(cfg, weights)
    ctl = Reference(cfg, weights, weight_fn=fp8_weights) if control else None
    worst, worst_ctl, n_tok = 0.0, 0.0, 0
    for prompt, served in requests:
        logits = ref.served_logits(prompt, served)
        toks = torch.as_tensor(served, device=logits.device)
        worst = max(worst, float(gap_sd(logits, toks).max()))
        n_tok += len(served)
        if ctl is not None:
            ctl_tok = ctl.served_logits(prompt, served).argmax(dim=-1)
            worst_ctl = max(worst_ctl, float(gap_sd(logits, ctl_tok).max()))
            del ctl_tok
        del logits
    m = cfg["model"]
    out = {"max_gap_sd": worst, "served_tokens": n_tok,
           "length_faults": length_faults(requests, m["n_seq"],
                                          m["eof_token_id"])}
    if control:
        out["control_max_gap_sd"] = worst_ctl
    return out
