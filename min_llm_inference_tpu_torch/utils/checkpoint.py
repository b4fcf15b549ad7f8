"""Weight checkpoints (counterpart of min_llm_inference_tpu/utils/
checkpoint.py, which uses orbax): save and load a parameter tree, plain
or weight-quantized, with ``torch.save``/``torch.load``, and map a
GPT-2-style state dict held in memory onto the model's layout."""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import ModelConfig, resolve_device


def save_params(path: str, params) -> None:
    """Write a parameter tree (tensors, {"q", "scale"} leaves, lists and
    dicts) to ``path``; the parent directory is created."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(params, path)


def load_params(path: str, device=None):
    """The tree saved at ``path``, every tensor on ``device`` (``cuda``
    unless the caller names another; raises without a GPU)."""
    dev = resolve_device(device)
    return torch.load(os.path.abspath(path), map_location=dev,
                      weights_only=True)


def import_gpt2_state_dict(state: dict, cfg: ModelConfig, dtype=None,
                           device=None):
    """Map a GPT-2-style state dict (numpy arrays or tensors, in memory)
    onto the params layout of a ModelConfig with use_output_proj=True,
    ffn_dim > 0 and use_layernorm=True. Keys per layer i:
      h.{i}.attn.c_attn.weight [D, 3D], h.{i}.attn.c_proj.weight [D, D],
      h.{i}.mlp.c_fc.weight [D, F], h.{i}.mlp.c_proj.weight [F, D],
      h.{i}.ln_1.weight [D], h.{i}.ln_2.weight [D]
    plus wte.weight [V, D] and wpe.weight [S, D] (cut to n_vocab and
    n_seq rows). Biases are not part of this model family and are ignored.
    ``dtype``: a torch dtype (default ``cfg.dtype``)."""
    dev = resolve_device(device)
    dt = dtype or cfg.torch_dtype
    D = cfg.emb_dim

    def arr(key):
        x = state[key]
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, dtype=np.float32))
        return x.to(device=dev, dtype=dt)

    layers = []
    for i in range(cfg.n_layers):
        c_attn = arr(f"h.{i}.attn.c_attn.weight")  # [D, 3D]
        layers.append({
            "wq": c_attn[:, :D].contiguous(),
            "wk": c_attn[:, D:2 * D].contiguous(),
            "wv": c_attn[:, 2 * D:].contiguous(),
            "wo": arr(f"h.{i}.attn.c_proj.weight"),
            "w_up": arr(f"h.{i}.mlp.c_fc.weight"),
            "w_down": arr(f"h.{i}.mlp.c_proj.weight"),
            "ln1_g": arr(f"h.{i}.ln_1.weight"),
            "ln2_g": arr(f"h.{i}.ln_2.weight"),
        })
    return {
        "wte": arr("wte.weight")[: cfg.n_vocab].contiguous(),
        "wpe": arr("wpe.weight")[: cfg.n_seq].contiguous(),
        "layers": layers,
    }
