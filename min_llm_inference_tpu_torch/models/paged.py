"""Paged-KV backend (counterpart of min_llm_inference_tpu/models/paged.py).

The page table is an integer index table ``[n_slots, pages_per_slot]`` into
one pooled KV tensor per layer, ``[n_pages, 2, page_size, feat]`` (index
0 = K rows, 1 = V rows; feat = emb/2 for packed int4). Quantized pools
carry one float32 scale per page per side (``k_scales``/``v_scales``
``[n_pages]``), set from the page's row-0 write.

Unlike the JAX functions, which return new arrays, the port writes pools
and scales IN PLACE (the engine owns them and never needs the old
contents); the functions still return them so call sites read like the
JAX ones.

Two interchangeable decode attentions:
  * ``torch``   -- scatter the new row, then gather every slot's pages into
    a contiguous view and run the masked attention oracle;
  * ``grouped`` -- the fused-write kernel (ops/paged_attention_grouped.py):
    quantize + insert the new row and attend in one launch.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import EngineConfig, ModelConfig, resolve_device
from ..ops.indexing import index_set_drop_
from ..ops.paged_attention_grouped import paged_decode_attention_grouped
from ..ops.quant import (
    dequantize_rows,
    inv_scale,
    kv_qmax,
    pack_int4_rows,
    quantize_against,
    quantize_rows_against_pages,
    unpack_int4,
    update_page_scales,
)
from ..ops.reference import masked_attention


class PagedKVState(NamedTuple):
    # per-layer pools [n_pages, 2, page_size, feat]; per-layer page scales
    # [n_pages] f32 for int8/int4 pools (None entries otherwise)
    kv_pages: Tuple[torch.Tensor, ...]
    k_scales: Tuple = ()
    v_scales: Tuple = ()


def init_paged_state(model_cfg: ModelConfig, engine_cfg: EngineConfig,
                     device=None) -> PagedKVState:
    """Zeroed pools (and scales) on ``device`` (``cuda`` unless the caller
    names another; raises without a GPU)."""
    dev = resolve_device(device)
    feat = model_cfg.emb_dim // 2 if engine_cfg.kv_packed else model_cfg.emb_dim
    shape = (engine_cfg.n_pages, 2, engine_cfg.page_size, feat)
    L = model_cfg.n_layers
    kv = tuple(torch.zeros(shape, dtype=engine_cfg.kv_torch_dtype, device=dev)
               for _ in range(L))
    if engine_cfg.kv_quantized:
        def scales():
            return tuple(torch.zeros(engine_cfg.n_pages, dtype=torch.float32,
                                     device=dev) for _ in range(L))
        return PagedKVState(kv, scales(), scales())
    return PagedKVState(kv, (None,) * L, (None,) * L)


def _page_of(page_rows, positions, page_size):
    """page_rows[..., positions // page_size], the column clamped into the
    row (JAX clamps an out-of-range gather; torch raises)."""
    col = torch.div(positions, page_size, rounding_mode="floor")
    col = col.clamp(0, page_rows.shape[-1] - 1).long()
    return torch.gather(page_rows, -1, col[..., None])[..., 0]


def _flat_scatter_indices(page_rows, positions, valid, page_size, n_pages):
    """Map slot-local positions to flat token indices page*P + row; invalid
    entries map out of range so the scatter drops them (a dead slot's stale
    page ids may belong to a live slot: dropped, never clamped)."""
    flat = (_page_of(page_rows, positions, page_size) * page_size
            + positions % page_size)
    return torch.where(valid, flat, n_pages * page_size)


def _kv_row_indices(flat_idx, page_size):
    """Token flat idx -> (k_row, v_row) into the [n_pages*2*P, D] flat view;
    out-of-range token indices stay out of range."""
    page = torch.div(flat_idx, page_size, rounding_mode="floor")
    k_row = page * (2 * page_size) + flat_idx % page_size
    return k_row, k_row + page_size


def _scatter_kv(pool, flat_idx, k, v):
    """pool [NP, 2, P, D]; flat_idx [N] (out of range = drop); k/v [N, D].
    One scatter writes both sides, in place."""
    NP_, _, P, D = pool.shape
    ki, vi = _kv_row_indices(flat_idx, P)
    index_set_drop_(pool.view(NP_ * 2 * P, D), torch.cat([ki, vi]),
                    torch.cat([k, v]))
    return pool


def _write_kv_tokens(pool, k_scales, v_scales, flat_idx, k, v, fresh_pid,
                     n_heads: int = 1):
    """Scatter K and V token rows into the pool. For int8/int4 pools the
    pages in fresh_pid (their row 0 is among these writes; out of range =
    none) first get their scale from that row; every row then quantizes
    against its page's scale, and int4 packs two values per byte."""
    if k_scales is None:
        return _scatter_kv(pool, flat_idx, k, v), None, None
    P = pool.shape[2]
    packed = pool.shape[-1] * 2 == k.shape[-1]
    qmax = kv_qmax(packed)
    update_page_scales(k_scales, k, fresh_pid, qmax)
    update_page_scales(v_scales, v, fresh_pid, qmax)
    qk = quantize_rows_against_pages(k, flat_idx, k_scales, P, qmax)
    qv = quantize_rows_against_pages(v, flat_idx, v_scales, P, qmax)
    if packed:
        qk = pack_int4_rows(qk, n_heads)
        qv = pack_int4_rows(qv, n_heads)
    return _scatter_kv(pool, flat_idx, qk, qv), k_scales, v_scales


def decode_fresh_pid(page_table, pos, live, page_size, n_pages):
    """Page whose scale a decode append resets: the write lands on row 0
    (pos % P == 0) of a live slot; out of range = none."""
    page = _page_of(page_table, pos, page_size)
    return torch.where(live & (pos % page_size == 0), page, n_pages)


def gather_kv_context(pool, page_table, page_size):
    """pool [NP, 2, P, D] -> (k_ctx, v_ctx), each [B, W*P, D]. Stale table
    entries are clamped in bounds; the garbage is masked by length."""
    NP_, _, P, D = pool.shape
    B, W = page_table.shape
    flat = pool.view(NP_ * 2 * P, D)
    base = page_table.clamp(0, NP_ - 1).long()[:, :, None] * (2 * P)
    offs = torch.arange(P, device=pool.device)[None, None, :]
    kidx = (base + offs).reshape(B, W * P)
    return flat[kidx], flat[kidx + P]


def gather_scales(scales, page_table, page_size):
    """Per-page scales [n_pages] -> per-token [B, W*page_size]."""
    per_page = scales[page_table.clamp(0, scales.shape[0] - 1).long()]
    return per_page.repeat_interleave(page_size, dim=1)


def prefill_fresh_pid(page_rows, prompt_lengths, s_pre, page_size, n_pages):
    """Fresh-page ids of a compact prefill block: positions 0, P, 2P, ...
    below the prompt length start their pages. Returns [M*F]."""
    F = -(-s_pre // page_size)
    fresh_positions = torch.arange(F, dtype=torch.int32,
                                   device=page_rows.device) * page_size
    valid = fresh_positions[None, :] < prompt_lengths[:, None]
    pid = torch.where(valid, page_rows[:, :F], n_pages)
    return pid.reshape(-1)


def _quantize_block_per_page(x, page_scales, safe_pid, page_size,
                             qmax=127.0):
    """Quantize a [M, W_pre*P, D] prefill block against per-page scales
    gathered at safe_pid [M, W_pre]."""
    M, S, D = x.shape
    W_pre = S // page_size
    inv = inv_scale(page_scales[safe_pid.long()])
    q = quantize_against(x.reshape(M, W_pre, page_size, D),
                         inv[:, :, None, None], qmax)
    return q.reshape(M, S, D)


def make_prefill_kv_writer(
    state: PagedKVState,
    page_rows,        # [M, W] page-table rows of the new slots
    prompt_lengths,   # [M] int32 (0 = inert padding row)
    s_pre: int,       # prompt-block width (prompts.shape[1])
    page_size: int,
    n_pages: int,
    n_heads: int = 1,  # int4 packs per head
):
    """Build the write_kv_block callback of prefill_write_kv over this
    paged state. Prefill writes whole pages from their row 0, so the fresh
    rows are the stride-P rows of the block. When the block width is a page
    multiple the write is page-granular: each covered page lands as one
    [P, D] window (rows past the prompt carry garbage that every consumer
    masks by length). Otherwise rows scatter one by one.

    int8 pools take the plain quantize + window scatter: the JAX package
    makes its fused prefill kernel bit-identical to exactly this path.

    Returns (write_kv_block, finalize); finalize() -> the PagedKVState."""
    kv_pages = list(state.kv_pages)
    k_scales = list(state.k_scales)
    v_scales = list(state.v_scales)
    P = page_size
    M = page_rows.shape[0]
    dev = page_rows.device
    fresh_pid = prefill_fresh_pid(page_rows, prompt_lengths, s_pre, P, n_pages)
    paged_write = s_pre % P == 0
    if paged_write:
        W_pre = s_pre // P
        covered = (torch.arange(W_pre, dtype=torch.int32, device=dev)[None, :]
                   * P < prompt_lengths[:, None])      # [M, W_pre]
        pid = torch.where(covered, page_rows[:, :W_pre], n_pages)
        # window index into the [(NP*2), P, D] view: page p side s -> 2p+s
        k_win = torch.where(covered, pid * 2, 2 * n_pages).reshape(-1)
        v_win = torch.where(covered, pid * 2 + 1, 2 * n_pages).reshape(-1)
        safe_pid = pid.clamp(0, n_pages - 1)
    else:
        positions = torch.arange(s_pre, dtype=torch.int32,
                                 device=dev)[None, :].expand(M, s_pre)
        valid = positions < prompt_lengths[:, None]
        rows3 = page_rows[:, None, :].expand(M, s_pre, page_rows.shape[1])
        flat_idx = _flat_scatter_indices(
            rows3, positions, valid, P, n_pages).reshape(-1)

    def scatter_pages(pool, k, v):
        D = k.shape[-1]
        index_set_drop_(
            pool.view(n_pages * 2, P, D), torch.cat([k_win, v_win]),
            torch.cat([k.reshape(-1, P, D), v.reshape(-1, P, D)]),
        )

    def scatter_rows(pool, k, v):
        D = k.shape[-1]
        _scatter_kv(pool, flat_idx, k.reshape(-1, D), v.reshape(-1, D))

    scatter = scatter_pages if paged_write else scatter_rows

    def write_kv_block(li, k, v):
        # k/v: [M, S, D]
        D = k.shape[-1]
        if k_scales[li] is None:
            scatter(kv_pages[li], k, v)
            return
        packed = kv_pages[li].shape[-1] * 2 == D
        qmax = kv_qmax(packed)
        update_page_scales(k_scales[li], k[:, ::P].reshape(-1, D), fresh_pid,
                           qmax)
        update_page_scales(v_scales[li], v[:, ::P].reshape(-1, D), fresh_pid,
                           qmax)
        if paged_write:
            qk = _quantize_block_per_page(k, k_scales[li], safe_pid, P, qmax)
            qv = _quantize_block_per_page(v, v_scales[li], safe_pid, P, qmax)
        else:
            qk = quantize_rows_against_pages(
                k.reshape(-1, D), flat_idx, k_scales[li], P, qmax
            ).reshape(k.shape)
            qv = quantize_rows_against_pages(
                v.reshape(-1, D), flat_idx, v_scales[li], P, qmax
            ).reshape(v.shape)
        if packed:
            qk = pack_int4_rows(qk, n_heads)
            qv = pack_int4_rows(qv, n_heads)
        scatter(kv_pages[li], qk, qv)

    def finalize() -> PagedKVState:
        return PagedKVState(tuple(kv_pages), tuple(k_scales), tuple(v_scales))

    return write_kv_block, finalize


def torch_paged_attend(pool, ks, vs, q, lengths, page_table, page_size,
                       n_heads):
    """The gather-based (oracle) paged attention for one layer: the JAX
    package's ``jnp_paged_attend``."""
    kctx, vctx = gather_kv_context(pool, page_table, page_size)
    if pool.shape[-1] * 2 == q.shape[-1]:
        kctx = unpack_int4(kctx, n_heads)
        vctx = unpack_int4(vctx, n_heads)
    if ks is not None:
        kctx = dequantize_rows(kctx, gather_scales(ks, page_table, page_size))
        vctx = dequantize_rows(vctx, gather_scales(vs, page_table, page_size))
    return masked_attention(q, kctx, vctx, lengths, n_heads)


def make_round_kv_callbacks(
    model_cfg: ModelConfig,
    engine_cfg: EngineConfig,
    attention_impl: str,
    page_table,
    kv_pages: list,
    k_scales: list,
    v_scales: list,
    lengths,
    n_heads=None,
):
    """The (write_kv, attend) pair of ONE decode round.

    ``grouped``: the decode KV write is fused into the attention kernel.
    write_kv only updates the fresh pages' scales (the kernel quantizes
    against the UPDATED scale) and stashes the raw rows; attend hands them
    to the kernel, which inserts the row at lengths-1 in place and attends
    over it. ``torch``: scatter the row, then the gather oracle. Both give
    the same pool bytes (tests/test_torch_grouped_attention.py)."""
    P = engine_cfg.page_size
    NP = engine_cfg.n_pages
    heads = n_heads or model_cfg.n_heads
    live = lengths > 0
    pos = torch.clamp_min(lengths - 1, 0)
    fresh_pid = decode_fresh_pid(page_table, pos, live, P, NP)

    if attention_impl == "grouped":
        pending = {}
        qmax = kv_qmax(engine_cfg.kv_packed)

        def write_kv(li, pos_, k, v, live_):
            if k_scales[li] is not None:
                update_page_scales(k_scales[li], k, fresh_pid, qmax)
                update_page_scales(v_scales[li], v, fresh_pid, qmax)
            pending[li] = (k, v)

        def attend(li, q, lens):
            k, v = pending.pop(li)
            out, _ = paged_decode_attention_grouped(
                q, kv_pages[li], lens, page_table,
                k_scales[li], v_scales[li], k, v,
                n_heads=heads, packed_int4=engine_cfg.kv_packed,
            )
            return out.to(q.dtype)

        return write_kv, attend

    if attention_impl != "torch":
        raise ValueError(f"unknown attention_impl {attention_impl!r}")
    flat_idx = _flat_scatter_indices(page_table, pos, live, P, NP)

    def write_kv(li, pos_, k, v, live_):
        _write_kv_tokens(kv_pages[li], k_scales[li], v_scales[li],
                         flat_idx, k, v, fresh_pid, n_heads=heads)

    def attend(li, q, lens):
        return torch_paged_attend(kv_pages[li], k_scales[li], v_scales[li],
                                  q, lens, page_table, P, heads)

    return write_kv, attend
