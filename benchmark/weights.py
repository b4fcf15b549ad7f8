"""The weights of a run, made on the device from ``--seed``.

One ``torch.Generator`` on the run's device draws every matrix of the
model in one call into one float32 buffer, which is cast once to the
dtype the model is served in and cut into views, in this order: ``wte``,
``wpe``, then per layer ``wq``, ``wk``, ``wv``, ``wo``, ``w_up``,
``w_down`` (those the model has). Layer-norm gains are ones, as GPT-2's
initialisation makes them.

The draw is the configuration's ``weights`` group: ``{"dist": "normal",
"std": s}``.
"""

from __future__ import annotations

import torch


def shapes(model: dict) -> list:
    """(layer index or None, name, shape) of every drawn matrix."""
    V, D, S = model["n_vocab"], model["emb_dim"], model["n_seq"]
    F = model["ffn_dim"]
    out = [(None, "wte", (V, D)), (None, "wpe", (S, D))]
    for li in range(model["n_layers"]):
        out += [(li, n, (D, D)) for n in ("wq", "wk", "wv")]
        if model["use_output_proj"]:
            out.append((li, "wo", (D, D)))
        if F > 0:
            out += [(li, "w_up", (D, F)), (li, "w_down", (F, D))]
    return out


def make(cfg: dict, seed: int, device) -> dict:
    """The parameter tree ``{"wte", "wpe", "layers": [...]}`` of ``cfg``
    drawn from ``seed`` on ``device``, in the model's dtype."""
    model, draw = cfg["model"], cfg["weights"]
    dtype = getattr(torch, model["dtype"])
    plan = shapes(model)
    total = sum(s[0] * s[1] for _, _, s in plan)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    buf = torch.empty(total, dtype=torch.float32, device=device)
    if draw["dist"] != "normal":
        raise ValueError(f"unknown weight draw {draw['dist']!r}")
    buf.normal_(0.0, draw["std"], generator=gen)
    buf = buf.to(dtype)
    tree = {"layers": [{} for _ in range(model["n_layers"])]}
    at = 0
    for li, name, (r, c) in plan:
        view = buf[at: at + r * c].view(r, c)
        at += r * c
        (tree if li is None else tree["layers"][li])[name] = view
    if model["use_layernorm"]:
        D = model["emb_dim"]
        for layer in tree["layers"]:
            layer["ln1_g"] = torch.ones(D, dtype=dtype, device=device)
            layer["ln2_g"] = torch.ones(D, dtype=dtype, device=device)
    return tree
