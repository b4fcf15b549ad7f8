"""The plain reference of the benchmark's models: a float32 forward pass in
plain PyTorch, written from the configuration file alone.

It imports nothing of the program under test. It reads the weights the
benchmark made from the seed (the same tensors the program was handed) and
works out everything else again: the projections, the per-page KV
quantization and its scales, the attention, the tied logits.

What it computes, for one request given its prompt and the tokens the
program served: the logits at every position that produced a served token,
as the serving engine defines the request's life.

- The prompt's positions 0 .. L-2 are prefilled: their keys and values come
  from a causal pass over the prompt in which attention reads the keys and
  values as computed (unquantized).
- Positions L-1 onwards are decoded one token at a time: attention reads the
  keys and values as the cache stores them, quantized per page.
- A quantized page's scale is set by the row at the page's first position:
  ``absmax(row) * 2 / qmax`` (``qmax`` 127 for int8, 7 for int4); every
  row of the page is ``clip(round_half_even(x / scale), -qmax, qmax)``,
  read back as ``q * scale``.

Arithmetic is float32 with TF32 off. Each tensor a layer produces is stored
in the configuration's dtype (``round_to``), as a model served in that dtype
stores it; sums inside a matrix product stay float32. The logits are
float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

QMAX = {"int8": 127.0, "int4": 7.0}
PAGE_HEADROOM = 2.0
LN_EPS = 1e-5
FP8_MAX = 448.0


def no_tf32() -> None:
    """Keep float32 matrix products in float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_to(dtype: str):
    """The rounding applied to every stored activation: to ``dtype`` and
    back to float32 (``float32``: none)."""
    if dtype == "float32":
        return lambda x: x
    td = getattr(torch, dtype)
    return lambda x: x.to(td).to(torch.float32)


def fp8_weights(w: torch.Tensor) -> torch.Tensor:
    """A weight matrix [D_in, D_out] as float8 e4m3 with one float32 scale
    per output column (absmax / 448), read back in float32: the control's
    precision, one step below bfloat16."""
    wf = w.float()
    scale = wf.abs().amax(dim=0) / FP8_MAX
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = (wf / safe[None, :]).to(torch.float8_e4m3fn)
    return q.float() * scale[None, :]


def layer_norm(x, gain):
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * gain


def gelu_tanh(x):
    """GPT-2's ``gelu_new``."""
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def quantize_pages(x, page_size: int, qmax: float):
    """Rows x [T, D] of one request's cache, position t in page t // P:
    each page's scale from its first row, every row quantized against its
    page's scale and read back. Returns the dequantized rows."""
    T, D = x.shape
    starts = torch.arange(0, T, page_size, device=x.device)
    cand = x[starts].abs().amax(dim=-1) * float(
        np.float32(PAGE_HEADROOM / qmax))
    scale = cand.repeat_interleave(page_size)[:T]
    inv = torch.where(scale > 0, 1.0 / torch.where(scale > 0, scale, 1.0),
                      0.0)
    q = torch.clamp(torch.round(x * inv[:, None]), -qmax, qmax)
    return q * scale[:, None]


class Reference:
    """The model of one configuration file (``cfg``, its ``model`` and
    ``engine`` groups) over float32 copies of ``weights`` (the tree the
    benchmark made: ``wte``, ``wpe`` and per layer ``wq``, ``wk``, ``wv``
    and, where the model has them, ``wo``, ``w_up``, ``w_down``,
    ``ln1_g``, ``ln2_g``). ``weight_fn`` maps each 2-D weight (the
    control's lower precision)."""

    def __init__(self, cfg: dict, weights: dict, weight_fn=None):
        m, e = cfg["model"], cfg["engine"]
        self.n_heads = m["n_heads"]
        self.use_ln = m["use_layernorm"]
        self.use_wo = m["use_output_proj"]
        self.ffn = m["ffn_dim"] > 0
        self.residual = (m["n_layers"] > 1 or self.ffn or self.use_wo
                         or self.use_ln)
        self.page_size = e["page_size"]
        self.qmax = QMAX.get(e["kv_dtype"])
        self.rnd = round_to(m["dtype"])

        def conv(w):
            w = w.float()
            if weight_fn is not None and w.dim() == 2:
                w = weight_fn(w)
            return w

        self.wte = conv(weights["wte"])
        self.wpe = conv(weights["wpe"])
        self.layers = [{k: conv(v) for k, v in layer.items()}
                       for layer in weights["layers"]]

    def _cache(self, x):
        if self.qmax is None:
            return x
        return quantize_pages(x, self.page_size, self.qmax)

    def _attend(self, q, k, v, kq, vq, n_prefill):
        """Causal attention of every position; query rows < n_prefill read
        the raw k, v, the others the cache's kq, vq."""
        T, D = q.shape
        H = self.n_heads
        dh = D // H
        scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
        qh = q.view(T, H, dh).transpose(0, 1)

        def probs_v(kk, vv, rows):
            kh = kk.view(T, H, dh).transpose(0, 1)
            vh = vv.view(T, H, dh).transpose(0, 1)
            s = torch.matmul(qh[:, rows], kh.transpose(1, 2)) * scale
            mask = (torch.arange(T, device=q.device)[None, :]
                    <= rows[:, None])
            s = torch.where(mask[None], s, float("-inf"))
            p = torch.softmax(s, dim=-1)
            return torch.matmul(p, vh).transpose(0, 1).reshape(-1, D)

        ar = torch.arange(T, device=q.device)
        out = torch.empty_like(q)
        if n_prefill > 0:
            out[:n_prefill] = probs_v(k, v, ar[:n_prefill])
        out[n_prefill:] = probs_v(kq, vq, ar[n_prefill:])
        return out

    @torch.no_grad()
    def served_logits(self, prompt, served) -> torch.Tensor:
        """Logits [n, V] (float32) of the positions that produced the n
        served tokens, the request fed its prompt and then its served
        tokens but the last."""
        L = len(prompt)
        toks = torch.as_tensor(
            np.concatenate([np.asarray(prompt, dtype=np.int64),
                            np.asarray(served[:-1], dtype=np.int64)]),
            device=self.wte.device)
        T = toks.numel()
        rnd = self.rnd
        pos = torch.arange(T, device=toks.device)
        h = rnd(self.wte[toks] + self.wpe[pos])
        for layer in self.layers:
            x = rnd(layer_norm(h, layer["ln1_g"])) if self.use_ln else h
            q = rnd(x @ layer["wq"])
            k = rnd(x @ layer["wk"])
            v = rnd(x @ layer["wv"])
            a = rnd(self._attend(q, k, v, self._cache(k), self._cache(v),
                                 L - 1))
            if self.use_wo:
                a = rnd(a @ layer["wo"])
            if not self.residual:
                h = a
                continue
            h = rnd(h + a)
            if self.ffn:
                x2 = rnd(layer_norm(h, layer["ln2_g"])) if self.use_ln else h
                u = rnd(gelu_tanh(rnd(x2 @ layer["w_up"])))
                h = rnd(h + rnd(u @ layer["w_down"]))
        return h[L - 1:] @ self.wte.t()
