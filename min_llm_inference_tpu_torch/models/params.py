"""Model parameters: the layout of min_llm_inference_tpu/models/params.py as
a plain dict of tensors, ``{"wte", "wpe", "layers": [{"wq", "wk", "wv",
...}]}``, and the bridge that loads parameters made as numpy arrays (by
the JAX package's ``init_params`` or by a seeded numpy generator)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..config import ModelConfig, resolve_device

Params = Dict[str, Any]


def params_from_numpy(tree: Params, cfg: ModelConfig, device=None) -> Params:
    """Numpy parameter tree -> tensors of ``cfg.dtype`` on ``device``
    (``cuda`` unless the caller names another; raises without a GPU).

    A bf16 array arrives as ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` rejects, so every leaf goes through float32 (exact
    for bf16) and is copied (JAX hands out read-only views)."""
    cfg.validate()
    dev = resolve_device(device)
    dtype = cfg.torch_dtype

    def conv(x):
        arr = np.array(x, dtype=np.float32, copy=True)
        return torch.from_numpy(arr).to(device=dev, dtype=dtype)

    return {
        "wte": conv(tree["wte"]),
        "wpe": conv(tree["wpe"]),
        "layers": [{k: conv(v) for k, v in layer.items()}
                   for layer in tree["layers"]],
    }


def fuse_qkv_params(params: Params) -> Params:
    """Add fused projection weights per layer: wqkv = [wq|wk|wv] along the
    output dim (one matmul per decode round) and wkv = [wk|wv] (prefill).
    Returns a new dict; the unfused weights stay."""
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        nl = dict(layer)
        nl["wqkv"] = torch.cat([layer["wq"], layer["wk"], layer["wv"]], dim=1)
        nl["wkv"] = torch.cat([layer["wk"], layer["wv"]], dim=1)
        out["layers"].append(nl)
    return out
