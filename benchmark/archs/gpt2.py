"""GPT-2's block as the port serves it, and the reference block in its
parity mode (one layer, one head, no residual, no layer norm, no FFN):
its weights, its plain reference and its counts.

Weights. One ``torch.Generator`` on the run's device draws every matrix of
the model in one call into one float32 buffer, which is cast once to the
dtype the model is served in and cut into views, in this order: ``wte``,
``wpe``, then per layer ``wq``, ``wk``, ``wv``, ``wo``, ``w_up``,
``w_down`` (those the model has). Layer-norm gains are ones, as GPT-2's
initialisation makes them. The draw is the configuration's ``weights``
group: ``{"dist": "normal", "std": s}``.

Reference. A float32 forward pass in plain PyTorch, written from the
configuration file alone. It reads the weights the benchmark made from the
seed (the same tensors the program was handed) and works out everything
else again: the projections, the per-page KV quantization and its scales,
the attention, the tied logits. For one request given its prompt and the
tokens the program served, it gives the logits at every position that
produced a served token, as the serving engine defines the request's life:

- The prompt's positions 0 .. L-2 are prefilled: their keys and values come
  from a causal pass over the prompt in which attention reads the keys and
  values as computed (unquantized).
- Positions L-1 onwards are decoded one token at a time: attention reads the
  keys and values as the cache stores them, quantized per page
  (``reference.model.quantize_pages``).

Arithmetic is float32 with TF32 off. Each tensor a layer produces is stored
in the configuration's dtype (``round_to``), as a model served in that dtype
stores it; sums inside a matrix product stay float32. The logits are
float32.

Counts. The decode attention's least time copies ``chip_smoke.py``'s
``grouped_bound`` and ``partial_bound``: each input byte read once, each
output byte written once, over the HBM bandwidth, or the float32
multiply-adds over the float32 peak, whichever is larger. They count what
the live slots need: a dead slot's row in a call is work no request asked
for, so it is left out (the least time is never overstated).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.model import QMAX, quantize_pages, round_to
from benchmark.roofline import bound_s

LN_EPS = 1e-5


# ---------------------------------------------------------------- weights

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


def make_weights(cfg: dict, seed: int, device) -> dict:
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


# -------------------------------------------------------------- reference

def layer_norm(x, gain):
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * gain


def gelu_tanh(x):
    """GPT-2's ``gelu_new``."""
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


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


# ----------------------------------------------------------------- counts

def decode_contexts(prompt_len: int, n_served: int) -> np.ndarray:
    """The context length of each decode step of one request: the step that
    serves token j attends over positions 0 .. L-1+j, so L+j rows."""
    return prompt_len + np.arange(n_served, dtype=np.int64)


def ring_partial_rows(prompt_len: int, n_served: int, span: int):
    """The pool rows the page partial reads at each decode step of one
    request under ring decode with one admission a span: a request is
    admitted at a span's start and its ring holds the span's new rows, so
    at its step i the pages hold positions < L - 1 + span * (i // span)."""
    i = np.arange(n_served, dtype=np.int64)
    return prompt_len - 1 + span * (i // span)


def _pages(rows: np.ndarray, page: int) -> int:
    return int(np.ceil(rows / page).sum())


def grouped_bound_s(ctx: np.ndarray, D: int, Dk: int, W: int, P: int,
                    in_bytes: int, pool_bytes: int, scaled: bool,
                    n_layers: int = 1) -> float:
    """Least time of the fused-write attention over live slot-steps with
    contexts ``ctx`` (each slot-step: q, the new k and v read, the
    context's K and V rows read, the new row written, the pages' scales,
    o written in float32, the length and the page-table row), per layer."""
    rows = int(ctx.sum())
    n = ctx.size
    nbytes = (3 * n * D * in_bytes + 2 * rows * Dk * pool_bytes
              + (2 * _pages(ctx, P) * 4 if scaled else 0)
              + n * (D * 4 + 4 + W * 4))
    return n_layers * bound_s(nbytes, 4 * rows * D)


def partial_bound_s(rs: np.ndarray, D: int, Dk: int, H: int, P: int,
                    in_bytes: int, pool_bytes: int, scaled: bool,
                    n_layers: int = 1) -> float:
    """Least time of the ring's page partial over live slot-steps that read
    ``rs`` pool rows each (q read; K and V rows and their pages' scales
    read; o, m, l written in float32; length, ring start and one table
    entry read), per layer."""
    rows = int(rs.sum())
    n = rs.size
    nbytes = (n * D * in_bytes + 2 * rows * Dk * pool_bytes
              + (2 * _pages(rs, P) * 4 if scaled else 0)
              + n * ((D + 2 * H) * 4 + 2 * 4 + 4))
    return n_layers * bound_s(nbytes, 4 * rows * D)


def attention_bound_s(cfg: dict, requests: list) -> float:
    """Least time of the decode attention of ``requests`` (``(prompt,
    served)`` pairs) under the configuration's kernel (``cfg["attention"]
    ["bound"]``: ``grouped`` or ``partial``)."""
    m, e = cfg["model"], cfg["engine"]
    D, H, P = m["emb_dim"], m["n_heads"], e["page_size"]
    packed = e["kv_dtype"] == "int4"
    Dk = D // 2 if packed else D
    in_bytes = 2 if m["dtype"] == "bfloat16" else 4
    pool_bytes = {"int8": 1, "int4": 1, "bfloat16": 2}.get(e["kv_dtype"], 4)
    scaled = e["kv_dtype"] in ("int8", "int4")
    L = m["n_layers"]
    if cfg["attention"]["bound"] == "grouped":
        ctx = np.concatenate([decode_contexts(len(p), len(s))
                              for p, s in requests])
        W = -(-m["n_seq"] // P)
        return grouped_bound_s(ctx, D, Dk, W, P, in_bytes, pool_bytes,
                               scaled, L)
    span = e["n_forward_rounds"] // e["subbursts"]
    rs = np.concatenate([ring_partial_rows(len(p), len(s), span)
                         for p, s in requests])
    return partial_bound_s(rs, D, Dk, H, P, in_bytes, pool_bytes, scaled, L)


def model_flops(model: dict, prompt_len: int, n_served: int) -> float:
    """The FLOPs one request needs, padding left out: every prompt position
    but the last is prefilled (all layers; the last layer needs only its
    keys and values), every decode step runs every layer and the tied
    logits. A matrix product of m x k by k x n is 2mkn; attention over c
    positions is 4 * D * c."""
    D, V, F = model["emb_dim"], model["n_vocab"], model["ffn_dim"]
    nl = model["n_layers"]
    proj = 2 * D * D * (3 + (1 if model["use_output_proj"] else 0))
    ffn = 4 * D * F
    n_pre = prompt_len - 1
    pre_ctx = n_pre * (n_pre + 1) / 2          # positions 0 .. L-2 attend
    flops = (nl - 1) * (n_pre * (proj + ffn) + 4 * D * pre_ctx)
    flops += n_pre * 4 * D * D                 # the last layer's k and v
    ctx = decode_contexts(prompt_len, n_served)
    flops += n_served * (nl * (proj + ffn) + 2 * D * V)
    flops += nl * 4 * D * float(ctx.sum())
    return float(flops)
