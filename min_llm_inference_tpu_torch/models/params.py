"""Model parameters: the layout of min_llm_inference_tpu/models/params.py as
a plain dict of tensors, ``{"wte", "wpe", "layers": [{"wq", "wk", "wv",
...}]}``; ``init_params``, which draws JAX's own weights bit for bit
(ops/random); and the bridge that loads parameter trees made as numpy
arrays (by the JAX package, plain or weight-quantized, or by a seeded
numpy generator)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..config import ModelConfig, resolve_device
from ..ops.quant import is_quantized_leaf
from ..ops.random import prng_key, split, uniform

Params = Dict[str, Any]


def init_params(seed_or_key, cfg: ModelConfig, *, scale: float = 0.02,
                eof_bias: float = 0.0, device=None) -> Params:
    """Random parameters, equal bit for bit to the JAX package's
    ``init_params(jax.random.PRNGKey(seed), cfg, ...)``: the key is split
    into 3 + 6 * n_layers keys, taken in the same order, and each matrix is
    ``uniform(-1, 1) * scale`` in float32 cast to ``cfg.dtype``.
    ``eof_bias`` > 0 adds to the EOF token's embedding row (in
    ``cfg.dtype``) so greedy decodes end sooner. ``seed_or_key``: an int
    seed or an ops.random key; ``device``: ``cuda`` unless the caller
    names another (raises without a GPU)."""
    cfg.validate()
    dev = resolve_device(device)
    dtype = cfg.torch_dtype
    key = (prng_key(seed_or_key, dev) if isinstance(seed_or_key, int)
           else seed_or_key.to(dev))
    keys = iter(split(key, 3 + 6 * cfg.n_layers))

    def rand(shape):
        return (uniform(next(keys), shape, -1.0, 1.0) * scale).to(dtype)

    wte = rand((cfg.n_vocab, cfg.emb_dim))
    if eof_bias > 0.0:
        wte[cfg.eof_token_id] += torch.full((), eof_bias, dtype=dtype,
                                            device=dev)
    wpe = rand((cfg.n_seq, cfg.emb_dim))
    D = cfg.emb_dim
    layers = []
    for _ in range(cfg.n_layers):
        layer = {"wq": rand((D, D)), "wk": rand((D, D)), "wv": rand((D, D))}
        if cfg.use_output_proj:
            layer["wo"] = rand((D, D))
        if cfg.ffn_dim > 0:
            layer["w_up"] = rand((D, cfg.ffn_dim))
            layer["w_down"] = rand((cfg.ffn_dim, D))
        if cfg.use_layernorm:
            layer["ln1_g"] = torch.ones(D, dtype=dtype, device=dev)
            layer["ln2_g"] = torch.ones(D, dtype=dtype, device=dev)
        layers.append(layer)
    return {"wte": wte, "wpe": wpe, "layers": layers}


def params_from_numpy(tree: Params, cfg: ModelConfig, device=None) -> Params:
    """Numpy parameter tree -> tensors on ``device`` (``cuda`` unless the
    caller names another; raises without a GPU). Dense leaves become
    ``cfg.dtype``; weight-quantized ``{"q", "scale"}`` leaves keep their
    int8 or float8_e4m3fn bytes and float32 scales.

    A bf16 array arrives as ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` rejects, so every dense leaf goes through float32
    (exact for bf16) and is copied (JAX hands out read-only views); fp8
    bytes go through uint8."""
    cfg.validate()
    dev = resolve_device(device)
    dtype = cfg.torch_dtype

    def conv(x):
        if is_quantized_leaf(x):
            q = np.array(x["q"], copy=True)
            if q.dtype == np.int8:
                qt = torch.from_numpy(q)
            else:
                qt = torch.from_numpy(q.view(np.uint8)).view(
                    torch.float8_e4m3fn)
            return {"q": qt.to(dev),
                    "scale": torch.from_numpy(np.array(
                        x["scale"], dtype=np.float32)).to(dev)}
        arr = np.array(x, dtype=np.float32, copy=True)
        return torch.from_numpy(arr).to(device=dev, dtype=dtype)

    return {
        "wte": conv(tree["wte"]),
        "wpe": conv(tree["wpe"]),
        "layers": [{k: conv(v) for k, v in layer.items()}
                   for layer in tree["layers"]],
    }


def params_device(params: Params) -> torch.device:
    """The device of a parameter tree (of its token table)."""
    wte = params["wte"]
    return (wte["q"] if is_quantized_leaf(wte) else wte).device


def params_checksum(params: Params) -> str:
    """sha256 of every leaf's bytes in the tree's order (wte, wpe, then
    each layer's leaves by name; a quantized leaf as q then scale): equal
    for two trees exactly when their bits are, whichever device or
    framework made them (a JAX tree via params_from_numpy)."""
    import hashlib

    h = hashlib.sha256()

    def feed(x):
        if is_quantized_leaf(x):
            feed(x["q"])
            feed(x["scale"])
            return
        t = x.detach().contiguous().cpu()
        if t.element_size() == 2:
            t = t.view(torch.int16)
        elif t.element_size() == 1:
            t = t.view(torch.uint8)
        h.update(t.numpy().tobytes())

    feed(params["wte"])
    feed(params["wpe"])
    for layer in params["layers"]:
        for name in sorted(layer):
            feed(layer[name])
    return h.hexdigest()


def fuse_qkv_params(params: Params) -> Params:
    """Add fused projection weights per layer: wqkv = [wq|wk|wv] along the
    output dim (one matmul per decode round) and wkv = [wk|wv] (prefill).
    Weight-quantized leaves fuse too (their per-column scales
    concatenate). Returns a new dict; the unfused weights stay."""
    def cat(ws):
        if is_quantized_leaf(ws[0]):
            return {"q": torch.cat([w["q"] for w in ws], dim=1),
                    "scale": torch.cat([w["scale"] for w in ws], dim=0)}
        return torch.cat(ws, dim=1)

    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        nl = dict(layer)
        nl["wqkv"] = cat([layer["wq"], layer["wk"], layer["wv"]])
        nl["wkv"] = cat([layer["wk"], layer["wv"]])
        out["layers"].append(nl)
    return out
