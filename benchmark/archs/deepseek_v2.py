"""DeepSeek-V2's decoder (multi-head latent attention with YaRN RoPE, a
dense SwiGLU layer, then routed and shared SwiGLU experts, RMSNorm, an
untied head): its weights, its plain reference and its counts, under the
memory contract of ``archs/__init__.py``.

Weights. One ``torch.Generator`` on the run's device, seeded with the
seed, draws the model matrix by matrix, each straight into the served
dtype (no float32 copy of the whole model): ``wte``, then per layer
``wq``, ``w_dkv``, ``w_ukv``, ``wo`` and the dense ``w_gate_up``,
``w_down`` or the router ``w_router``, the experts' ``we_gate_up``,
``we_down`` and the shared ``ws_gate_up``, ``ws_down``; last ``lm_head``.
Norm gains are ones. The draw is the configuration's ``weights`` group:
``{"dist": "normal", "std": s}``. Every matrix is ``[in, out]``;
``w_ukv``'s columns are every head's k_nope and then every head's v, and
each SwiGLU's gate and up projections are one matrix, gate first.

Reference. A copy of the plain float32 forward pass that the program's
tests hold it to (written from the published modelling code; nothing of
the program is imported), non-absorbed: per head, q = [q_nope,
rope(q_pe)] against k = [k_nope, rope(k_pe)] and v, over the whole
sequence of a request, causal. Products are float32 with TF32 off; one
layer at a time is read as float32 inside ``served_logits``; every tensor
a served model stores (activations, the latent row's c_kv and k_pe) is
rounded to the configuration's dtype (``round_to``). Departures from the
published code, each leaving the function the same: the column layouts
above; RoPE rotates the pairs (x[2i], x[2i+1]) in place where the
published code de-interleaves them first (the same permutation of q and
k); cos and sin stay float32; the routed experts' weighted sum runs per
expert, in float32.

Counts. ``model_flops``: two FLOPs a weight a real token (the weights that
token goes through: its 6 routed experts, the shared ones, the router)
plus causal attention. ``attention_bound_s``: the latent rows each decode
round reads (and its queries and outputs) against the HBM peak, or MLA's
multiply-adds against ``roofline.BF16_FLOPS``, whichever is larger.
``moe_bound_s``: the routed experts' grouped products, each expert's
weights read once a layer call, the real rows in and out, their FLOPs at
the bf16 peak; ``moe_calls``: the expert-layer calls those products
should number, from the decode attention's calls and the requests.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.model import round_to
from benchmark.roofline import BF16_FLOPS, HBM_BYTES_PER_S


def _dims(m: dict) -> tuple:
    return (m["emb_dim"], m["n_heads"], m["kv_lora_rank"],
            m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"])


# ---------------------------------------------------------------- weights

def shapes(m: dict) -> list:
    """(layer index or None, name, shape) of every drawn matrix, in draw
    order."""
    D, H, C, dn, dr, dv = _dims(m)
    E, Fm = m["n_routed_experts"], m["moe_intermediate_size"]
    Fs = Fm * m["n_shared_experts"]
    out = [(None, "wte", (m["n_vocab"], D))]
    for li in range(m["n_layers"]):
        out += [(li, "wq", (D, H * (dn + dr))), (li, "w_dkv", (D, C + dr)),
                (li, "w_ukv", (C, H * (dn + dv))), (li, "wo", (H * dv, D))]
        if li < m["first_k_dense_replace"]:
            out += [(li, "w_gate_up", (D, 2 * m["ffn_dim"])),
                    (li, "w_down", (m["ffn_dim"], D))]
        else:
            out += [(li, "w_router", (D, E)),
                    (li, "we_gate_up", (E, D, 2 * Fm)),
                    (li, "we_down", (E, Fm, D)),
                    (li, "ws_gate_up", (D, 2 * Fs)), (li, "ws_down", (Fs, D))]
    return out + [(None, "lm_head", (D, m["n_vocab"]))]


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The parameter tree of ``cfg`` drawn from ``seed`` on ``device`` in
    the model's dtype, matrix by matrix."""
    m, draw = cfg["model"], cfg["weights"]
    if draw["dist"] != "normal":
        raise ValueError(f"unknown weight draw {draw['dist']!r}")
    dtype = getattr(torch, m["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    tree = {"layers": [{} for _ in range(m["n_layers"])]}
    for li, name, shape in shapes(m):
        w = torch.empty(shape, dtype=dtype, device=device)
        w.normal_(0.0, draw["std"], generator=gen)
        (tree if li is None else tree["layers"][li])[name] = w
    D, C = m["emb_dim"], m["kv_lora_rank"]
    for layer in tree["layers"]:
        for name, n in (("attn_norm_g", D), ("kv_norm_g", C),
                        ("mlp_norm_g", D)):
            layer[name] = torch.ones(n, dtype=dtype, device=device)
    tree["norm_g"] = torch.ones(D, dtype=dtype, device=device)
    return tree


# -------------------------------------------------------------- reference

def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(m: dict) -> torch.Tensor:
    """[dr / 2] rates: 1 / theta^(2i/dr), interpolated by ``factor`` along a
    ramp between the correction dims of beta_fast and beta_slow."""
    rs, dim, base = m["rope_scaling"], m["qk_rope_head_dim"], m["rope_theta"]
    orig = rs["original_max_position_embeddings"]

    def corr(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    expo = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / (float(base) ** expo)
    inter = 1.0 / (float(rs["factor"]) * float(base) ** expo)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / (high - low)).clamp(0, 1)
    return inter * ramp + extra * (1 - ramp)


def softmax_scale(m: dict) -> float:
    rs = m["rope_scaling"]
    g = yarn_mscale(float(rs["factor"]), float(rs["mscale_all_dim"]))
    return (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5 * g * g


def rope_cos_sin(m: dict, positions):
    rs = m["rope_scaling"]
    f = float(rs["factor"])
    gain = (yarn_mscale(f, float(rs["mscale"]))
            / yarn_mscale(f, float(rs["mscale_all_dim"])))
    ang = (positions.to(torch.float32)[:, None]
           * yarn_inv_freq(m).to(positions.device)[None, :])
    return torch.cos(ang) * gain, torch.sin(ang) * gain


def rope(x, cos, sin):
    """x [T, ..., dim], each pair (x[2i], x[2i+1]) rotated by angle i."""
    shape = x.shape
    xp = x.reshape(shape[0], -1, shape[-1] // 2, 2)
    c, s = cos[:, None, :], sin[:, None, :]
    a, b = xp[..., 0], xp[..., 1]
    return torch.stack([a * c - b * s, a * s + b * c], dim=-1).reshape(shape)


def rms_norm(x, gain, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * gain


def swiglu(x, w_gate_up, w_down):
    gu = x @ w_gate_up
    f = gu.shape[-1] // 2
    return (torch.nn.functional.silu(gu[..., :f]) * gu[..., f:]) @ w_down


class Reference:
    """The model of one configuration file over the benchmark's weight
    tree, read one layer at a time as float32; ``weight_fn`` maps each
    2-D weight (each expert's matrices one by one): the control's lower
    precision."""

    def __init__(self, cfg: dict, weights: dict, weight_fn=None):
        self.m = cfg["model"]
        self.weights = weights
        self.weight_fn = weight_fn
        self.rnd = round_to(self.m["dtype"])

    def _f32(self, w):
        w = w.float()
        fn = self.weight_fn
        if fn is None or w.dim() == 1:
            return w
        if w.dim() == 2:
            return fn(w)
        return torch.stack([fn(x) for x in w])

    def _mla(self, x, lw, cos, sin):
        m, rnd = self.m, self.rnd
        T = x.shape[0]
        D, H, C, dn, dr, dv = _dims(m)
        q = rnd(x @ lw["wq"]).view(T, H, dn + dr)
        dkv = rnd(x @ lw["w_dkv"])
        c_kv = rnd(rms_norm(dkv[:, :C], lw["kv_norm_g"], m["rms_norm_eps"]))
        k_pe = rnd(rope(dkv[:, None, C:], cos, sin))
        kv = rnd(c_kv @ lw["w_ukv"])
        k = torch.cat([kv[:, :H * dn].view(T, H, dn), k_pe.expand(T, H, dr)],
                      dim=-1)
        v = kv[:, H * dn:].view(T, H, dv)
        qh = torch.cat([q[..., :dn], rnd(rope(q[..., dn:], cos, sin))], -1)
        s = torch.einsum("ihd,jhd->hij", qh, k) * softmax_scale(m)
        causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        del s
        o = rnd(torch.einsum("hij,jhd->ihd", p, v).reshape(T, H * dv))
        return o @ lw["wo"]

    def _moe(self, x, lw):
        m, rnd = self.m, self.rnd
        scores = torch.softmax(x @ lw["w_router"], dim=-1)
        w, idx = torch.topk(scores, m["num_experts_per_tok"], dim=-1)
        if m["norm_topk_prob"]:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        w = w * m["routed_scaling_factor"]
        out = torch.zeros_like(x)
        for e in range(lw["we_gate_up"].shape[0]):
            tok, slot = torch.nonzero(idx == e, as_tuple=True)
            if tok.numel():
                y = rnd(swiglu(x[tok], lw["we_gate_up"][e], lw["we_down"][e]))
                out.index_add_(0, tok, y * w[tok, slot][:, None])
        return rnd(out) + rnd(swiglu(x, lw["ws_gate_up"], lw["ws_down"]))

    @torch.no_grad()
    def served_logits(self, prompt, served) -> torch.Tensor:
        """Logits [n, V] (float32) of the positions that produced the n
        served tokens: the request's prompt and its served tokens but the
        last, through the whole model, causal."""
        m, rnd = self.m, self.rnd
        dev = self.weights["wte"].device
        toks = torch.as_tensor(
            np.concatenate([np.asarray(prompt, dtype=np.int64),
                            np.asarray(served[:-1], dtype=np.int64)]),
            device=dev)
        T = toks.numel()
        cos, sin = rope_cos_sin(m, torch.arange(T, device=dev))
        eps = m["rms_norm_eps"]
        h = rnd(self.weights["wte"][toks].float())
        for li, layer in enumerate(self.weights["layers"]):
            lw = {k: self._f32(v) for k, v in layer.items()}
            x = rnd(rms_norm(h, lw["attn_norm_g"], eps))
            h = rnd(h + rnd(self._mla(x, lw, cos, sin)))
            x = rnd(rms_norm(h, lw["mlp_norm_g"], eps))
            if li < m["first_k_dense_replace"]:
                y = swiglu(x, lw["w_gate_up"], lw["w_down"])
            else:
                y = self._moe(x, lw)
            h = rnd(h + rnd(y))
            del lw, x, y
        x = rnd(rms_norm(h[len(prompt) - 1:],
                         self.weights["norm_g"].float(), eps))
        return x @ self._f32(self.weights["lm_head"])


# ----------------------------------------------------------------- counts

def _layer_weights(m: dict, li: int) -> tuple:
    """(attention weights, MLP weights a real token goes through) of layer
    li: the four projections; the dense MLP, or the router, k routed
    experts and the shared ones."""
    D, H, C, dn, dr, dv = _dims(m)
    attn = D * H * (dn + dr) + D * (C + dr) + C * H * (dn + dv) + H * dv * D
    if li < m["first_k_dense_replace"]:
        return attn, 3 * D * m["ffn_dim"]
    Fm = m["moe_intermediate_size"]
    k, s = m["num_experts_per_tok"], m["n_shared_experts"]
    return attn, D * m["n_routed_experts"] + 3 * D * Fm * (k + s)


def model_flops(model: dict, prompt_len: int, n_served: int) -> float:
    """The FLOPs one request needs, padding left out: every prompt position
    but the last is prefilled (all layers; the last layer needs only its
    latent row), every decode step runs every layer and the head. Two
    FLOPs a weight a token; causal attention at context c is 2 H (dk + dv)
    c a layer (q . k and p . v)."""
    D, H, C, dn, dr, dv = _dims(model)
    nl, V = model["n_layers"], model["n_vocab"]
    per_tok = sum(sum(_layer_weights(model, li)) for li in range(nl))
    last = sum(_layer_weights(model, nl - 1))
    att = 2 * H * (dn + dr + dv)
    n_pre = prompt_len - 1
    pre_ctx = n_pre * (n_pre + 1) / 2
    flops = n_pre * 2 * (per_tok - last + D * (C + dr))
    flops += (nl - 1) * att * pre_ctx
    ctx = prompt_len + np.arange(n_served, dtype=np.int64)
    flops += n_served * 2 * (per_tok + D * V)
    flops += nl * att * float(ctx.sum())
    return float(flops)


def attention_bound_s(cfg: dict, requests: list) -> float:
    """Least time of the absorbed latent decode attention of ``requests``
    (``(prompt, served)`` pairs): each decode step of each layer reads its
    context's latent rows (L + j of them at step j), its 16 queries of
    576 and writes 16 outputs of 512, in bf16; its multiply-adds are
    H (C + dr + C) a row, at the bf16 tensor-core peak."""
    m = cfg["model"]
    D, H, C, dn, dr, dv = _dims(m)
    el = 2
    rows = sum(float((len(p) + np.arange(len(s))).sum()) for p, s in requests)
    steps = sum(len(s) for _, s in requests)
    nl = m["n_layers"]
    nbytes = nl * (rows * (C + dr) * el + steps * H * (C + dr + C) * el)
    flops = nl * rows * 2 * H * (C + dr + C)
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)


def moe_bound_s(cfg: dict, requests: list, calls: int) -> float:
    """Least time of the routed experts' grouped products over a stretch
    that served ``requests`` in ``calls`` expert-layer calls (prefill and
    decode): each call reads every expert's weights once; the real rows
    (decode: a served token a layer; prefill: a prompt position a layer
    but the last) are read in and written out, and cost 6 D Fm FLOPs each
    (gate, up, down) at the bf16 peak. Prefill calls (a block of up to
    ``max_new_per_burst`` admissions each, every expert layer but the
    last) are bound apart from decode calls."""
    m = cfg["model"]
    D, Fm, E = m["emb_dim"], m["moe_intermediate_size"], m["n_routed_experts"]
    k, nl = m["num_experts_per_tok"], m["n_layers"]
    n_moe = nl - m["first_k_dense_replace"]
    el = 2
    w_bytes = E * 3 * D * Fm * el
    row_bytes = (2 * D + 3 * Fm) * el
    row_flops = 6 * D * Fm
    blocks = -(-len(requests) // cfg["runner"]["max_new_per_burst"])
    c_pre = blocks * (n_moe - 1)
    c_dec = max(calls - c_pre, 0)
    r_dec = sum(len(s) for _, s in requests) * k * n_moe
    r_pre = sum(len(p) for p, _ in requests) * k * (n_moe - 1)

    def bound(c, r):
        return max((c * w_bytes + r * row_bytes) / HBM_BYTES_PER_S,
                   r * row_flops / BF16_FLOPS)

    return bound(c_dec, r_dec) + bound(c_pre, r_pre)


def moe_calls(cfg: dict, requests: list, attention_calls: int):
    """Expert-layer calls of a stretch that served ``requests`` and called
    the latent decode attention ``attention_calls`` times (one a layer a
    decode round): every expert layer a round, and every expert layer but
    the last a prefill block of up to ``max_new_per_burst`` admissions.
    None where ``attention_calls`` is no whole number of rounds."""
    m = cfg["model"]
    nl = m["n_layers"]
    if attention_calls <= 0 or attention_calls % nl:
        return None
    n_moe = nl - m["first_k_dense_replace"]
    blocks = -(-len(requests) // cfg["runner"]["max_new_per_burst"])
    return attention_calls // nl * n_moe + blocks * (n_moe - 1)
