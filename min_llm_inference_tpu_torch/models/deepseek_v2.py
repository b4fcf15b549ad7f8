"""DeepSeek-V2's decoder on the port's serving path (``DeepSeekV2Config``):
multi-head latent attention with YaRN RoPE over a paged latent pool, a
dense SwiGLU MLP in the first layers, routed and shared SwiGLU experts in
the rest, RMSNorm and an untied head.

Written at the seams of models/model.py, so that AutonomousEngine's burst
drives it as it drives GPT-2's block: ``decode_round_tokens`` (one round
over ``write_kv``/``attend`` callbacks) and ``prefill_write_kv`` (a prompt
block over a ``write_kv_block`` callback). Every layer runs ``h = x +
MLA(RMSNorm(x))`` then ``h + MLP(RMSNorm(h))``; a final RMSNorm and the
untied ``lm_head`` give float32 logits. There is no position embedding.

Attention. Prefill attends per head over full keys, k = [k_nope,
rope(k_pe)] (192 wide, k_pe shared by the heads) and v (128), through the
causal prefill kernel (ops/prefill_attention; its plain version on the
CPU). Decode attends in the absorbed form, equal in exact arithmetic: each
head's q_nope is carried into the latent space by W_UK (q_lat, 512), the
score of a token is scale * (q_lat . c_kv + q_pe . k_pe) against the one
latent row the pool holds for it, and the head's output o_lat = sum p c_kv
goes back out through W_UV (ops/mla_decode; the pool's row is c_kv then
k_pe, written before the round attends).

Experts (ops/moe.py): float32 router logits and softmax, the top k weights
(greedy, not renormalised, times ``routed_scaling_factor``), a device-side
sort of the T x k rows by expert and a grouped SwiGLU over them, the
weighted sum in float32, plus the shared experts' SwiGLU. Static shapes:
nothing is read to the host, so the burst's CUDA graph captures it.

The weight tree is models/deepseek_v2_ref.py's (the plain reference this
path is tested against); ``prepare_params`` adds what the path derives from
it once: W_UK and W_UV per head for the absorbed decode and the YaRN cos and
sin tables.

Device spans (utils/profiling): ``mla`` covers a decode round's attention
block (projections, rope, absorption, the latent write, the kernel, W_UV
and the output projection), ``moe`` its expert layers (gate, sort, grouped
products, combine, shared experts); the prefill block sits inside the
burst's ``prefill`` span and the head inside ``logits``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import DeepSeekV2Config
from ..ops import prefill_attention
from ..ops.moe import routed_experts, swiglu
from ..ops.reference import greedy_next_token
from ..utils.profiling import phase
from . import deepseek_v2_ref as ref


def shapes(cfg: DeepSeekV2Config) -> list:
    """(layer index or None, name, shape) of every drawn matrix of the
    tree, in draw order (models/deepseek_v2_ref.py names them)."""
    D, H, C = cfg.emb_dim, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    E, Fm = cfg.n_routed_experts, cfg.moe_intermediate_size
    Fs = Fm * cfg.n_shared_experts
    out = [(None, "wte", (cfg.n_vocab, D))]
    for li in range(cfg.n_layers):
        out += [(li, "wq", (D, H * (dn + dr))), (li, "w_dkv", (D, C + dr)),
                (li, "w_ukv", (C, H * (dn + dv))), (li, "wo", (H * dv, D))]
        if li < cfg.first_k_dense_replace:
            out += [(li, "w_gate_up", (D, 2 * cfg.ffn_dim)),
                    (li, "w_down", (cfg.ffn_dim, D))]
        else:
            out += [(li, "w_router", (D, E)),
                    (li, "we_gate_up", (E, D, 2 * Fm)),
                    (li, "we_down", (E, Fm, D)),
                    (li, "ws_gate_up", (D, 2 * Fs)), (li, "ws_down", (Fs, D))]
    return out + [(None, "lm_head", (D, cfg.n_vocab))]


def init_params(cfg: DeepSeekV2Config, seed: int, device=None,
                std: float = 0.02) -> dict:
    """Random weights N(0, std) in the model's dtype, drawn matrix by
    matrix on ``device`` from one generator seeded with ``seed`` (no
    float32 copy of the whole model), norm gains of ones."""
    dev = torch.device("cpu" if device is None else device)
    dtype = cfg.torch_dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    tree = {"layers": [{} for _ in range(cfg.n_layers)]}
    for li, name, shape in shapes(cfg):
        w = torch.empty(shape, dtype=dtype, device=dev)
        w.normal_(0.0, std, generator=gen)
        (tree if li is None else tree["layers"][li])[name] = w
    for layer in tree["layers"]:
        for name, n in (("attn_norm_g", cfg.emb_dim),
                        ("kv_norm_g", cfg.kv_lora_rank),
                        ("mlp_norm_g", cfg.emb_dim)):
            layer[name] = torch.ones(n, dtype=dtype, device=dev)
    tree["norm_g"] = torch.ones(cfg.emb_dim, dtype=dtype, device=dev)
    return tree


def prepare_params(params: dict, cfg: DeepSeekV2Config) -> dict:
    """The tree the path serves: ``params`` (unchanged) plus, per layer,
    ``w_uk_t`` [H, dn, C] and ``w_uv`` [H, C, dv] (W_UK and W_UV of each
    head, contiguous, from ``w_ukv``), the float32 ``rope_cos`` and
    ``rope_sin`` tables [n_seq, dr / 2] and the score scale
    ``mla_scale``."""
    H, dn, dv = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    C = cfg.kv_lora_rank
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        w = layer["w_ukv"]
        nl = dict(layer)
        nl["w_uk_t"] = w[:, :H * dn].reshape(C, H, dn).permute(1, 2, 0) \
            .contiguous()
        nl["w_uv"] = w[:, H * dn:].reshape(C, H, dv).permute(1, 0, 2) \
            .contiguous()
        out["layers"].append(nl)
    dev = params["wte"].device
    cos, sin = ref.rope_cos_sin(_cfg_map(cfg), torch.arange(cfg.n_seq,
                                                            device=dev))
    out["rope_cos"], out["rope_sin"] = cos, sin
    out["mla_scale"] = ref.softmax_scale(_cfg_map(cfg))
    return out


def _cfg_map(cfg: DeepSeekV2Config) -> dict:
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def rms_norm(x, gain, eps: float):
    """The published RMSNorm: float32 statistics, the normed row cast back
    to x's dtype, times the gain."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return y.to(x.dtype) * gain


def rope(x, cos, sin):
    """x [..., dr] with each pair (x[2i], x[2i+1]) rotated in float32 by
    the angle of its position; cos, sin [..., dr/2] broadcast against x's
    pairs. Returns x's dtype."""
    xf = x.float().unflatten(-1, (-1, 2))
    a, b = xf[..., 0], xf[..., 1]
    return torch.stack([a * cos - b * sin, a * sin + b * cos],
                       dim=-1).flatten(-2).to(x.dtype)


def head_logits(h, lm_head):
    """Float32 logits of the untied head: bf16 products accumulated and
    returned in float32 on CUDA; float32 elsewhere."""
    if h.device.type == "cuda" and h.dtype == torch.bfloat16:
        return torch.mm(h, lm_head, out_dtype=torch.float32)
    return torch.matmul(h.float(), lm_head.float())


def mlp(layer, li: int, cfg: DeepSeekV2Config, x, expert_counts=None):
    """Layer li's MLP of x [T, D]: the dense SwiGLU of the first layers,
    else the routed experts plus the shared ones."""
    if li < cfg.first_k_dense_replace:
        return swiglu(x, layer["w_gate_up"], layer["w_down"])
    y = routed_experts(x, layer["w_router"], layer["we_gate_up"],
                       layer["we_down"], cfg.num_experts_per_tok,
                       cfg.norm_topk_prob, cfg.routed_scaling_factor,
                       expert_counts)
    return y + swiglu(x, layer["ws_gate_up"], layer["ws_down"])


def latent_row(layer, cfg: DeepSeekV2Config, x, cos, sin):
    """The latent row of x [..., D]: RMSNorm(c_kv) then rope(k_pe)."""
    C = cfg.kv_lora_rank
    dkv = torch.matmul(x, layer["w_dkv"])
    c_kv = rms_norm(dkv[..., :C], layer["kv_norm_g"], cfg.rms_norm_eps)
    return torch.cat([c_kv, rope(dkv[..., C:], cos, sin)], dim=-1)


def queries(layer, cfg: DeepSeekV2Config, x, cos, sin):
    """q of x [..., D] as [..., H, dn + dr], its q_pe roped."""
    dn = cfg.qk_nope_head_dim
    q = torch.matmul(x, layer["wq"]).unflatten(-1, (cfg.n_heads, -1))
    q_pe = rope(q[..., dn:], cos.unsqueeze(-2), sin.unsqueeze(-2))
    return torch.cat([q[..., :dn], q_pe], dim=-1)


def decode_round_tokens(
    params,
    cfg: DeepSeekV2Config,
    lengths,
    last_tokens,
    write_kv: Callable,
    attend: Callable,
    ctx=None,
    next_token_fn: Callable | None = None,
    expert_counts=None,
):
    """One decode round for every batch slot, as models/model.py's: the
    token at position lengths-1 goes through the model, its latent row
    goes to ``write_kv(li, pos, row [B, Dl], live)`` and the absorbed
    queries to ``attend(li, q [B, H, Dl], lengths) -> o_lat [B, H, C]``.
    ``expert_counts``: the experts' row counters (ops/moe). Returns
    (next_tokens, new_lengths), or next_token_fn's result."""
    H, dn = cfg.n_heads, cfg.qk_nope_head_dim
    B = lengths.shape[0]
    pos = torch.clamp_min(lengths - 1, 0).long()
    live = lengths > 0
    cos, sin = params["rope_cos"][pos], params["rope_sin"][pos]
    h = params["wte"][last_tokens.clamp(0, cfg.n_vocab - 1).long()]
    eps = cfg.rms_norm_eps
    for li, layer in enumerate(params["layers"]):
        with phase("mla"):
            x = rms_norm(h, layer["attn_norm_g"], eps)
            write_kv(li, pos, latent_row(layer, cfg, x, cos, sin), live)
            q = queries(layer, cfg, x, cos, sin)             # [B, H, dn+dr]
            q_lat = torch.bmm(q[..., :dn].transpose(0, 1), layer["w_uk_t"])
            qa = torch.cat([q_lat.transpose(0, 1), q[..., dn:]], dim=-1)
            o_lat = attend(li, qa, lengths)                   # [B, H, C]
            o = torch.bmm(o_lat.transpose(0, 1), layer["w_uv"])
            h = h + torch.matmul(o.transpose(0, 1).reshape(B, -1),
                                 layer["wo"])
        x = rms_norm(h, layer["mlp_norm_g"], eps)
        if li < cfg.first_k_dense_replace:
            h = h + mlp(layer, li, cfg, x)
        else:
            with phase("moe"):
                h = h + mlp(layer, li, cfg, x, expert_counts)
    with phase("logits"):
        logits = head_logits(rms_norm(h, params["norm_g"], eps),
                             params["lm_head"])
        if next_token_fn is not None:
            return next_token_fn(logits, lengths)
        return greedy_next_token(logits, lengths, cfg.n_seq,
                                 cfg.eof_token_id)


def causal_attention(q, k, v, lengths, n_heads: int, scale: float):
    """Causal attention of a prompt block in float32 (the prefill kernel's
    plain version at any widths): q, k [M, S, H dk], v [M, S, H dv];
    position i attends to j <= i, j < length. Returns [M, S, H dv] in q's
    dtype; rows at or past a length are garbage (callers mask them)."""
    M, S, _ = q.shape
    qh = q.unflatten(-1, (n_heads, -1)).float()
    kh = k.unflatten(-1, (n_heads, -1)).float()
    vh = v.unflatten(-1, (n_heads, -1)).float()
    s = torch.einsum("bihd,bjhd->bhij", qh, kh) * scale
    ar = torch.arange(S, device=q.device)
    mask = ((ar[None, :] <= ar[:, None])[None]
            & (ar[None, None, :] < lengths[:, None, None]))[:, None]
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    p = torch.nan_to_num(p)
    return torch.einsum("bhij,bjhd->bihd", p, vh).flatten(-2).to(q.dtype)


def prefill_write_kv(
    params,
    cfg: DeepSeekV2Config,
    prompts,
    prompt_lengths,
    write_kv_block: Callable,
    expert_counts=None,
):
    """Prefill a prompt block [M, S]: every layer's latent rows go to
    ``write_kv_block(li, rows [M, S, Dl])`` (the writer masks positions >=
    prompt_lengths). Attention is the non-absorbed causal form, through the
    prefill kernel where ``kernel_takes`` holds (CUDA, bfloat16, dk 192 /
    dv 128), else ``causal_attention``. The last layer writes its rows and
    stops: the first token comes from the decode round."""
    M, S = prompts.shape
    H, dn = cfg.n_heads, cfg.qk_nope_head_dim
    eps = cfg.rms_norm_eps
    cos, sin = params["rope_cos"][:S], params["rope_sin"][:S]
    scale = params["mla_scale"]
    h = params["wte"][prompts.clamp(0, cfg.n_vocab - 1).long()]
    n_layers = len(params["layers"])
    for li, layer in enumerate(params["layers"]):
        x = rms_norm(h, layer["attn_norm_g"], eps)
        row = latent_row(layer, cfg, x, cos, sin)
        write_kv_block(li, row)
        if li + 1 == n_layers:
            break
        C = cfg.kv_lora_rank
        q = queries(layer, cfg, x, cos, sin).flatten(-2)     # [M, S, H dk]
        kv = torch.matmul(row[..., :C], layer["w_ukv"])
        k_pe = row[..., None, C:].expand(M, S, H, cfg.qk_rope_head_dim)
        k = torch.cat([kv[..., :H * dn].unflatten(-1, (H, dn)), k_pe],
                      dim=-1).flatten(-2)
        v = kv[..., H * dn:]
        if prefill_attention.kernel_takes(q.device, q.dtype, cfg.head_dim,
                                          cfg.v_head_dim):
            o = prefill_attention.prefill_causal_attention(
                q, k, v, prompt_lengths, H, scale=scale)
        else:
            o = causal_attention(q, k, v, prompt_lengths, H, scale)
        h = h + torch.matmul(o, layer["wo"])
        x = rms_norm(h, layer["mlp_norm_g"], eps)
        y = mlp(layer, li, cfg, x.reshape(M * S, -1), expert_counts)
        h = h + y.view(M, S, -1)
