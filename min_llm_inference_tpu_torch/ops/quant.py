"""Quantization ops: int8 and packed int4 KV pages with per-page scales,
and weight-only int8 / fp8 (e4m3) matrices with per-output-column scales.

Counterpart of min_llm_inference_tpu/ops/quant.py; every function here
must give the JAX function's bytes on identical float inputs.
The float32 arithmetic is spelled out (``ones / s``, scalars rounded to
float32 first) so that CPU and CUDA both do exactly one IEEE operation
where JAX does one.
"""

from __future__ import annotations

import numpy as np
import torch

from .indexing import index_set_drop_

INT8_MAX = 127.0
INT4_MAX = 7.0
PAGE_SCALE_HEADROOM = 2.0


def kv_qmax(packed: bool) -> float:
    """Quantization range of a KV pool: int8 rows, or int4 values packed
    two per byte (kv_dtype="int4")."""
    return INT4_MAX if packed else INT8_MAX


def inv_scale(s):
    """Reciprocal of a page scale, 0 for an unset (zero) scale."""
    safe = s.clamp_min(1e-30)
    return torch.where(s > 0, torch.ones_like(safe) / safe, 0.0)


def quantize_against(x, inv, qmax: float):
    """clip(round(x * inv), +-qmax) as int8; round is half to even, as
    jnp.round. x: [..., D]; inv broadcasts against x."""
    return torch.clamp(torch.round(x.float() * inv), -qmax, qmax).to(torch.int8)


def pack_int4_rows(q, n_heads: int):
    """Pack integer values in [-7, 7] two per byte, arithmetically:
    byte = 16*hi + lo. Per head of width dh, byte c of the packed head
    block holds feature c as lo and feature c + dh/2 as hi.
    q: [..., D] -> [..., D/2] int8."""
    d = q.shape[-1]
    dh = d // n_heads
    assert dh % 2 == 0
    heads = q.to(torch.int32).reshape(*q.shape[:-1], n_heads, dh)
    lo = heads[..., : dh // 2]
    hi = heads[..., dh // 2:]
    return (16 * hi + lo).to(torch.int8).reshape(*q.shape[:-1], d // 2)


def unpack_int4(packed, n_heads: int):
    """Inverse of pack_int4_rows: [..., D/2] int8 -> [..., D] float32 with
    integer values; hi = round(byte/16) is exact since |lo| <= 7 < 8."""
    dp = packed.shape[-1]
    b = packed.float().reshape(*packed.shape[:-1], n_heads, dp // n_heads)
    hi = torch.round(b * (1.0 / 16.0))
    lo = b - 16.0 * hi
    return torch.cat([lo, hi], dim=-1).reshape(*packed.shape[:-1], 2 * dp)


def quantize_rows(x):
    """Per-row symmetric int8: x [..., D] -> (q int8 [..., D], scales f32
    [...]), scale = absmax / 127 (divided, as a float32 tensor, so that
    CUDA divides too), q = clip(round(x / scale), +-127); a zero row gets
    scale 0 and dequantizes to exact zeros."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / torch.full(
        (), INT8_MAX, dtype=torch.float32, device=xf.device)
    return quantize_against(xf, inv_scale(scale)[..., None], INT8_MAX), scale


def dequantize_rows(q, scales):
    """q: [..., D] int values; scales: [...] f32 -> [..., D] f32."""
    return q.float() * scales[..., None].float()


def update_page_scales(page_scales, rows, row_pid, qmax=INT8_MAX,
                       absmax_reduce=None):
    """In place: set the scale of each page in row_pid (out of range = no
    update) from its row-0 write, absmax(row) * PAGE_SCALE_HEADROOM / qmax.
    Valid row_pids are unique within a call. Returns page_scales.

    absmax_reduce: a max over tensor-parallel ranks of the [N] absmax
    vector (each rank holds D/tp features of a row), which makes every
    rank's scale the full row's, as on one device."""
    absmax = rows.float().abs().amax(dim=-1)
    if absmax_reduce is not None:
        absmax = absmax_reduce(absmax)
    cand = absmax * float(np.float32(PAGE_SCALE_HEADROOM / qmax))
    return index_set_drop_(page_scales, row_pid, cand)


def quantize_rows_against_pages(values, flat_idx, page_scales, page_size,
                                qmax=INT8_MAX):
    """Quantize token rows against their page's (already updated) scale;
    rows beyond the scale clip. values: [N, D]; flat_idx: [N] token index
    page*P + row (out of range reads a clamped page; callers drop the
    row)."""
    n_pages = page_scales.shape[0]
    pid = torch.clamp(torch.div(flat_idx, page_size, rounding_mode="floor"),
                      0, n_pages - 1)
    return quantize_against(values, inv_scale(page_scales[pid])[:, None],
                            qmax)


def quantize_tokens_per_page(values, flat_idx, page_scales, page_size,
                             valid_pos):
    """Per-page int8 quantization of paged-KV token rows: a page's scale is
    set from its row-0 write (the row at an in-slot position that is a
    page multiple and lands in the pool), every row then quantizes against
    its page's scale (later rows clip to it).

    values: [N, D]; flat_idx: [N] token index page*P + row (out of range =
    dropped row); page_scales: [n_pages] f32, not written; valid_pos: [N]
    the rows' in-slot positions. Returns (q int8 [N, D], the new scales),
    as the JAX function returns them."""
    n_pages = page_scales.shape[0]
    pid = torch.div(flat_idx, page_size, rounding_mode="floor")
    fresh = (valid_pos % page_size == 0) & (flat_idx < n_pages * page_size)
    new_scales = update_page_scales(page_scales.clone(), values,
                                    torch.where(fresh, pid, n_pages))
    q = quantize_rows_against_pages(values, flat_idx, new_scales, page_size)
    return q, new_scales


# ---- weight-only quantization: {"q", "scale"} leaves ----

FP8_MAX = 448.0  # float8_e4m3fn


def _column_scales(w, qmax: float):
    """Per-output-column absmax / qmax of w [D_in, D_out] in float32, and
    its IEEE reciprocal (0 for an all-zero column). qmax divides as a
    tensor: CUDA turns a Python scalar divisor into a reciprocal
    multiply."""
    wf = w.float()
    scale = wf.abs().amax(dim=0) / torch.full((), qmax, dtype=torch.float32,
                                              device=wf.device)
    return wf, scale, inv_scale(scale)


def quantize_weight(w):
    """Weight-only int8: w [D_in, D_out] -> (q int8 [D_in, D_out], scale f32
    [D_out]), q = clip(round(w / scale), +-127), round half to even."""
    wf, scale, inv = _column_scales(w, INT8_MAX)
    return quantize_against(wf, inv[None, :], INT8_MAX), scale


def quantize_weight_fp8(w):
    """Weight-only fp8 (e4m3): the column absmax scaled to FP8_MAX, then
    one rounding to float8_e4m3fn. -> (q [D_in, D_out], scale f32
    [D_out])."""
    wf, scale, inv = _column_scales(w, FP8_MAX)
    return (wf * inv[None, :]).to(torch.float8_e4m3fn), scale


def dequantize_weight(q, scale, dtype=torch.bfloat16):
    """q * scale per column, in float32, cast to ``dtype``."""
    return (q.float() * scale[None, :].float()).to(dtype)


def quantize_params(params, mode: str = "int8"):
    """Every 2-D weight of a parameter tree as a {"q", "scale"} leaf
    (embeddings included: the tied LM head reads wte through the same
    dequantization). mode: "int8" or "fp8". Returns a new tree."""
    if mode not in ("int8", "fp8"):
        raise ValueError(f"mode must be int8 or fp8, got {mode!r}")
    fn = quantize_weight if mode == "int8" else quantize_weight_fp8

    def conv(x):
        if isinstance(x, torch.Tensor) and x.dim() == 2:
            q, s = fn(x)
            return {"q": q, "scale": s}
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        return x

    return conv(params)


def is_quantized_leaf(w) -> bool:
    return isinstance(w, dict) and "q" in w


def maybe_dequant(w, dtype):
    """A possibly weight-quantized leaf as a dense matrix in ``dtype``."""
    if is_quantized_leaf(w):
        return dequantize_weight(w["q"], w["scale"], dtype)
    return w


def gather_rows(w, idx, dtype):
    """Rows ``idx`` of a possibly weight-quantized table; a quantized
    table's rows are dequantized in float32, then cast to ``dtype``."""
    if is_quantized_leaf(w):
        q = w["q"]
        if q.dtype == torch.float8_e4m3fn:
            # gather the bytes (an integer gather runs on every backend)
            rows = q.view(torch.uint8)[idx].view(q.dtype)
        else:
            rows = q[idx]
        return (rows.float() * w["scale"][None, :]).to(dtype)
    return w[idx]
