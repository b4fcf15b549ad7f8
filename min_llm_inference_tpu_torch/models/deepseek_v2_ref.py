"""DeepSeek-V2's decoder as a plain float32 forward pass: the reference the
port's DeepSeek-V2 path is held to (models/deepseek_v2.py).

It imports torch and math only: nothing of the port's kernels (``ops/``,
``csrc/``), no cache and no batching. One sequence of token ids goes in,
float32 logits of every position come out. Attention is computed as
published, per head over full keys and values (``k = [k_nope, k_pe]``,
``v`` from ``kv_b_proj``), never through the absorbed latent form that the
program decodes with. Products are float32 with TF32 off (``no_tf32``).

Configuration: a mapping with the port's ``DeepSeekV2Config`` keys
(``emb_dim``, ``n_heads``, ``n_layers``, ``n_vocab``, ``ffn_dim``,
``kv_lora_rank``, ``qk_nope_head_dim``, ``qk_rope_head_dim``,
``v_head_dim``, ``rope_theta``, ``rope_scaling``, ``rms_norm_eps``,
``n_routed_experts``, ``num_experts_per_tok``, ``moe_intermediate_size``,
``n_shared_experts``, ``first_k_dense_replace``, ``norm_topk_prob``,
``routed_scaling_factor``).

Weights: the port's tree (any dtype; read as float32 one layer at a time),
every matrix ``[in, out]`` so that a product is ``x @ w``:
``wte`` [V, D], ``lm_head`` [D, V], ``norm_g`` [D] and per layer
``attn_norm_g``, ``wq`` [D, H(dn+dr)], ``w_dkv`` [D, C+dr], ``kv_norm_g``
[C], ``w_ukv`` [C, H dn + H dv], ``wo`` [H dv, D], ``mlp_norm_g``, then
either the dense ``w_gate_up`` [D, 2F] and ``w_down`` [F, D], or the
router ``w_router`` [D, E], the routed experts ``we_gate_up`` [E, D, 2Fm]
and ``we_down`` [E, Fm, D] and the shared ``ws_gate_up`` [D, 2Fs] and
``ws_down`` [Fs, D] (Fs = Fm x n_shared_experts).

Departures from the published modelling code (modeling_deepseek.py), each
leaving the function the same:
  * ``kv_b_proj``'s output columns are laid out as every head's k_nope and
    then every head's v (published: per head, k_nope then v), and each
    SwiGLU's gate and up projections are one [in, 2F] matrix, gate first;
  * RoPE rotates the pairs (x[2i], x[2i+1]) in place; the published code
    first de-interleaves them into halves, the same permutation for q and
    k, so every q . k is the same;
  * cos and sin stay float32 (published: rounded to the model's dtype);
    with YaRN's ``mscale == mscale_all_dim`` their gain is 1;
  * the routed experts' weighted sum runs per expert over its tokens, in
    float32 (published: the same sum after a gather).
"""

from __future__ import annotations

import math

import torch


def no_tf32() -> None:
    """Keep float32 matrix products in float32 on a CUDA card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def yarn_mscale(scale: float, mscale: float) -> float:
    """YaRN's attention gain: 0.1 mscale ln(scale) + 1 above scale 1."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_correction_dim(rotations: float, dim: int, base: float,
                        max_pos: int) -> float:
    """The rotary dimension whose wavelength makes ``rotations`` turns over
    ``max_pos`` positions."""
    return (dim * math.log(max_pos / (rotations * 2 * math.pi))
            / (2 * math.log(base)))


def yarn_range(cfg) -> tuple:
    """(low, high): the first pair index that YaRN interpolates partly and
    the first it interpolates fully, clamped to [0, dim - 1]."""
    rs, dim = cfg["rope_scaling"], cfg["qk_rope_head_dim"]
    orig = rs["original_max_position_embeddings"]
    base = cfg["rope_theta"]
    low = math.floor(yarn_correction_dim(rs["beta_fast"], dim, base, orig))
    high = math.ceil(yarn_correction_dim(rs["beta_slow"], dim, base, orig))
    return max(low, 0), min(high, dim - 1)


def yarn_inv_freq(cfg) -> torch.Tensor:
    """[dim / 2] float32 angular rates of the rotary pairs: each pair's
    rate blends the extrapolated 1 / theta^(2i/dim) with the interpolated
    one (divided by ``factor``) by a linear ramp from ``low`` to ``high``."""
    rs, dim = cfg["rope_scaling"], cfg["qk_rope_head_dim"]
    base = float(cfg["rope_theta"])
    expo = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    freq_extra = 1.0 / (base ** expo)
    freq_inter = 1.0 / (float(rs["factor"]) * base ** expo)
    low, high = yarn_range(cfg)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / (high - low)).clamp(0, 1)
    return freq_inter * ramp + freq_extra * (1 - ramp)


def softmax_scale(cfg) -> float:
    """The score scale: (nope + rope)^-0.5 times YaRN's squared gain."""
    rs = cfg["rope_scaling"]
    m = yarn_mscale(float(rs["factor"]), float(rs["mscale_all_dim"]))
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def rope_cos_sin(cfg, positions: torch.Tensor) -> tuple:
    """(cos, sin) [T, dim / 2] float32 of ``positions``, times YaRN's gain
    mscale / mscale_all_dim."""
    rs = cfg["rope_scaling"]
    f = float(rs["factor"])
    gain = (yarn_mscale(f, float(rs["mscale"]))
            / yarn_mscale(f, float(rs["mscale_all_dim"])))
    inv = yarn_inv_freq(cfg).to(positions.device)
    ang = positions.to(torch.float32)[:, None] * inv[None, :]
    return torch.cos(ang) * gain, torch.sin(ang) * gain


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [T, ..., dim] with each pair (x[2i], x[2i+1]) rotated by the
    position's angle i; cos, sin [T, dim / 2]."""
    shape = x.shape
    xp = x.reshape(shape[0], -1, shape[-1] // 2, 2)
    c, s = cos[:, None, :], sin[:, None, :]
    a, b = xp[..., 0], xp[..., 1]
    return torch.stack([a * c - b * s, a * s + b * c], dim=-1).reshape(shape)


def rms_norm(x, gain, eps: float):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * gain


def swiglu(x, w_gate_up, w_down):
    """W_down (silu(x W_gate) * (x W_up)); w_gate_up is [in, 2F], gate
    first."""
    gu = x @ w_gate_up
    f = gu.shape[-1] // 2
    return (torch.nn.functional.silu(gu[..., :f]) * gu[..., f:]) @ w_down


def route(cfg, x, w_router):
    """The published gate: float32 logits, softmax over the experts, the
    ``num_experts_per_tok`` largest weights (greedy), renormalised only
    with ``norm_topk_prob``, times ``routed_scaling_factor``. Returns
    (weights [T, k] float32, expert ids [T, k])."""
    scores = torch.softmax(x.float() @ w_router.float(), dim=-1)
    w, idx = torch.topk(scores, cfg["num_experts_per_tok"], dim=-1)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return w * cfg["routed_scaling_factor"], idx


def moe(cfg, x, lw, rnd=lambda t: t):
    """Routed experts plus shared experts of one layer: each token's
    weighted sum over its experts' SwiGLU outputs (each output stored in
    the served dtype by ``rnd``), plus the shared SwiGLU."""
    w, idx = route(cfg, x, lw["w_router"])
    out = torch.zeros_like(x)
    for e in range(lw["we_gate_up"].shape[0]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = rnd(swiglu(x[tok], lw["we_gate_up"][e], lw["we_down"][e]))
        out.index_add_(0, tok, y * w[tok, slot][:, None])
    return rnd(out) + rnd(swiglu(x, lw["ws_gate_up"], lw["ws_down"]))


def mla(cfg, x, lw, cos, sin, rnd=lambda t: t):
    """Causal multi-head latent attention of a whole sequence x [T, D],
    non-absorbed: per head, q = [q_nope, rope(q_pe)], k = [k_nope,
    rope(k_pe)] (k_pe shared by the heads), v from the normed latent.
    ``rnd`` rounds what a served model stores (the latent row among it)."""
    T = x.shape[0]
    H, dn = cfg["n_heads"], cfg["qk_nope_head_dim"]
    dr = cfg["qk_rope_head_dim"]
    dv, C = cfg["v_head_dim"], cfg["kv_lora_rank"]
    q = rnd(x @ lw["wq"]).view(T, H, dn + dr)
    dkv = rnd(x @ lw["w_dkv"])
    c_kv = rnd(rms_norm(dkv[:, :C], lw["kv_norm_g"], cfg["rms_norm_eps"]))
    k_pe = rnd(rope(dkv[:, None, C:], cos, sin))           # [T, 1, dr]
    kv = rnd(c_kv @ lw["w_ukv"])
    k_nope = kv[:, :H * dn].view(T, H, dn)
    v = kv[:, H * dn:].view(T, H, dv)
    q_pe = rnd(rope(q[..., dn:], cos, sin))
    k = torch.cat([k_nope, k_pe.expand(T, H, dr)], dim=-1)
    qh = torch.cat([q[..., :dn], q_pe], dim=-1)
    s = torch.einsum("ihd,jhd->hij", qh, k) * softmax_scale(cfg)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = rnd(torch.einsum("hij,jhd->ihd", p, v).reshape(T, H * dv))
    return o @ lw["wo"]


def layer_f32(layer: dict, weight_fn=None) -> dict:
    """One layer's weights as float32; ``weight_fn`` maps each 2-D matrix
    (each expert's matrix on its own), never a norm gain."""
    out = {}
    for name, w in layer.items():
        w = w.float()
        if weight_fn is not None and w.dim() == 2:
            w = weight_fn(w)
        elif weight_fn is not None and w.dim() == 3:
            w = torch.stack([weight_fn(m) for m in w])
        out[name] = w
    return out


def block(cfg, li: int, h, lw, cos, sin, rnd=lambda t: t):
    """Layer ``li`` on the residual stream h [T, D]: h + MLA(RMSNorm(h)),
    then + the dense MLP (the first ``first_k_dense_replace`` layers) or
    the experts of RMSNorm of that."""
    eps = cfg["rms_norm_eps"]
    x = rnd(rms_norm(h, lw["attn_norm_g"], eps))
    h = rnd(h + rnd(mla(cfg, x, lw, cos, sin, rnd)))
    x = rnd(rms_norm(h, lw["mlp_norm_g"], eps))
    if li < cfg["first_k_dense_replace"]:
        y = swiglu(x, lw["w_gate_up"], lw["w_down"])
    else:
        y = moe(cfg, x, lw, rnd)
    return rnd(h + rnd(y))


@torch.no_grad()
def forward(cfg, weights: dict, tokens, rnd=lambda t: t, weight_fn=None,
            first: int = 0) -> torch.Tensor:
    """Float32 logits [T - first, V] of positions ``first`` .. T-1 of the
    sequence ``tokens`` [T] (int64 on the weights' device). ``rnd``
    rounds every stored activation (identity: none); ``weight_fn`` maps
    each matrix (a lower precision). Layers are read one at a time."""
    no_tf32()
    T = tokens.shape[0]
    pos = torch.arange(T, device=tokens.device)
    cos, sin = rope_cos_sin(cfg, pos)
    h = rnd(weights["wte"][tokens].float())
    for li, layer in enumerate(weights["layers"]):
        lw = layer_f32(layer, weight_fn)
        h = block(cfg, li, h, lw, cos, sin, rnd)
        del lw
    head = weights["lm_head"].float()
    if weight_fn is not None:
        head = weight_fn(head)
    x = rnd(rms_norm(h[first:], weights["norm_g"].float(),
                     cfg["rms_norm_eps"]))
    return x @ head
