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

Three interchangeable decode attentions (``attention_impl``), named for
what runs; the JAX package's names in brackets:
  * ``torch``   [``jnp``] -- scatter the new row, then gather every slot's
    pages into a contiguous view and run the masked attention oracle;
  * ``paged``   [``pallas``] -- scatter the new row, then the one-slot
    kernel (ops/paged_attention.py): float32, bfloat16 or int8 pools, no
    packed int4;
  * ``grouped`` [``grouped``] -- the fused-write kernel
    (ops/paged_attention_grouped.py): quantize + insert the new row and
    attend in one launch. It reads one page id per page, so fragmented
    host tables are fine.

The host-scheduled engines (runtime/engine.py) call ``_prefill`` and
``_decode_rounds`` through ``make_paged_fns``: compact [M, n_seq] prefill
over fragmented page rows, then n_forward_rounds greedy rounds driven by a
packed [B, 2+W] scheduler operand.

Latent attention (``DeepSeekV2Config``, models/deepseek_v2.py) keeps one
pool per layer of ``[n_pages, page_size, latent]`` rows instead: one row a
token shared by every head (the normed c_kv, then the roped k_pe), no K/V
planes and no scales. ``make_latent_prefill_writer`` and
``make_latent_round_callbacks`` write and read it (ops/mla_decode.py).

Ring decode (``make_ring_round_callbacks``): each round's K/V rows go to a
per-layer ring ``[B, R_pad, 2*Dk]`` (K columns first) instead of the pool;
a kernel computes the page partial over positions < ring_start (pool
read-only), ``merge_ring_partial`` folds in the ring's rows, and the ring
lands in the pages once per burst (ops/ring_flush.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from ..config import EngineConfig, ModelConfig, resolve_device
from ..ops.indexing import index_set_drop_
from ..ops.mla_decode import mla_decode_attention
from ..ops.paged_attention import paged_decode_attention
from ..ops.paged_attention_dense import dense_paged_partial
from ..ops.paged_attention_dgrid import dgrid_paged_partial
from ..ops.paged_attention_flat import paged_decode_attention_flat
from ..ops.paged_attention_grouped import paged_decode_attention_grouped
from ..ops.prefill_scatter import prefill_quant_scatter
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
from ..ops.reference import inv_sqrt, masked_attention
from ..utils.profiling import phase
from .model import DEFAULT_CTX, decode_round_tokens, prefill_write_kv

_TINY = torch.finfo(torch.float32).tiny


class PagedKVState(NamedTuple):
    # per-layer pools [n_pages, 2, page_size, feat]; per-layer page scales
    # [n_pages] f32 for int8/int4 pools (None entries otherwise)
    kv_pages: Tuple[torch.Tensor, ...]
    k_scales: Tuple = ()
    v_scales: Tuple = ()


def init_paged_state(model_cfg: ModelConfig, engine_cfg: EngineConfig,
                     device=None, tp: int = 1) -> PagedKVState:
    """Zeroed pools (and scales) on ``device`` (``cuda`` unless the caller
    names another; raises without a GPU). ``tp`` > 1: one tensor-parallel
    rank's pools, which hold D/tp features (D/2/tp packed)."""
    dev = resolve_device(device)
    L = model_cfg.n_layers
    if model_cfg.is_mla:
        shape = (engine_cfg.n_pages, engine_cfg.page_size,
                 model_cfg.latent_dim)
        return PagedKVState(
            tuple(torch.zeros(shape, dtype=engine_cfg.kv_torch_dtype,
                              device=dev) for _ in range(L)),
            (None,) * L, (None,) * L)
    feat = model_cfg.emb_dim // tp
    if engine_cfg.kv_packed:
        feat //= 2
    shape = (engine_cfg.n_pages, 2, engine_cfg.page_size, feat)
    kv = tuple(torch.zeros(shape, dtype=engine_cfg.kv_torch_dtype, device=dev)
               for _ in range(L))
    if engine_cfg.kv_quantized:
        def scales():
            return tuple(torch.zeros(engine_cfg.n_pages, dtype=torch.float32,
                                     device=dev) for _ in range(L))
        return PagedKVState(kv, scales(), scales())
    return PagedKVState(kv, (None,) * L, (None,) * L)


def scale_reduce_of(ctx):
    """The page-scale reduce of a parallel context: its max over
    tensor-parallel ranks, or None on one device (no collective)."""
    return ctx.pmax if ctx.tp > 1 else None


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
                     scale_reduce=None, n_heads: int = 1):
    """Scatter K and V token rows into the pool. For int8/int4 pools the
    pages in fresh_pid (their row 0 is among these writes; out of range =
    none) first get their scale from that row; every row then quantizes
    against its page's scale, and int4 packs two values per byte.
    scale_reduce: the max over tensor-parallel ranks of the rows' absmax
    (ops/quant.update_page_scales), None on one device."""
    if k_scales is None:
        return _scatter_kv(pool, flat_idx, k, v), None, None
    P = pool.shape[2]
    packed = pool.shape[-1] * 2 == k.shape[-1]
    qmax = kv_qmax(packed)
    update_page_scales(k_scales, k, fresh_pid, qmax, scale_reduce)
    update_page_scales(v_scales, v, fresh_pid, qmax, scale_reduce)
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


def combine_kv_pools(k_pages, v_pages):
    """[NP, P, D] K pages and V pages -> one pooled [NP, 2, P, D] (a test
    and fixture helper)."""
    return torch.stack([k_pages, v_pages], dim=1)


def make_prefill_kv_writer(
    state: PagedKVState,
    page_rows,        # [M, W] page-table rows of the new slots
    prompt_lengths,   # [M] int32 (0 = inert padding row)
    s_pre: int,       # prompt-block width (prompts.shape[1])
    page_size: int,
    n_pages: int,
    scale_reduce=None,  # tp max of the absmax (_write_kv_tokens)
    n_heads: int = 1,  # int4 packs per head
):
    """Build the write_kv_block callback of prefill_write_kv over this
    paged state. Prefill writes whole pages from their row 0, so the fresh
    rows are the stride-P rows of the block. When the block width is a page
    multiple the write is page-granular: each covered page lands as one
    [P, D] window (rows past the prompt carry garbage that every consumer
    masks by length). Otherwise rows scatter one by one.

    int8 pools with a page-multiple block take the fused quantize + page
    scatter (ops/prefill_scatter.py), bit-identical to the plain quantize +
    window scatter that int4 pools take.

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
                           qmax, scale_reduce)
        update_page_scales(v_scales[li], v[:, ::P].reshape(-1, D), fresh_pid,
                           qmax, scale_reduce)
        if paged_write and not packed:
            prefill_quant_scatter(
                kv_pages[li], k, v, pid,
                inv_scale(k_scales[li][safe_pid.long()]),
                inv_scale(v_scales[li][safe_pid.long()]))
            return
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


def make_latent_prefill_writer(state: PagedKVState, page_rows,
                               prompt_lengths, s_pre: int, page_size: int,
                               n_pages: int):
    """The prefill writer of a latent pool: ``write(li, rows [M, S, Dl])``
    puts the rows of positions < prompt_lengths into layer li's pool
    (whole pages when S is a page multiple, rows past the prompt carrying
    garbage that every reader masks by length; else row by row). Returns
    (write, finalize) as make_prefill_kv_writer does."""
    pools = state.kv_pages
    P = page_size
    M = page_rows.shape[0]
    dev = page_rows.device
    if s_pre % P == 0:
        W_pre = s_pre // P
        covered = (torch.arange(W_pre, dtype=torch.int32, device=dev)[None, :]
                   * P < prompt_lengths[:, None])
        idx = torch.where(covered, page_rows[:, :W_pre], n_pages).reshape(-1)
        unit = P
    else:
        positions = torch.arange(s_pre, dtype=torch.int32,
                                 device=dev)[None, :].expand(M, s_pre)
        rows3 = page_rows[:, None, :].expand(M, s_pre, page_rows.shape[1])
        idx = _flat_scatter_indices(
            rows3, positions, positions < prompt_lengths[:, None], P,
            n_pages).reshape(-1)
        unit = 1

    def write(li, rows):
        Dl = rows.shape[-1]
        index_set_drop_(pools[li].view(-1, unit, Dl), idx,
                        rows.reshape(-1, unit, Dl))

    return write, lambda: state


def make_latent_round_callbacks(page_table, pools, lengths, page_size: int,
                                n_pages: int, scale: float, latent: int):
    """The (write_kv, attend) pair of one decode round over latent pools:
    write_kv(li, pos, row [B, Dl], live) puts each live slot's row at its
    position (dead slots' writes dropped), then attend(li, q [B, H, Dl],
    lengths) -> [B, H, latent] reads the pool through the latent decode
    kernel (ops/mla_decode.py; its plain version on the CPU)."""
    live = lengths > 0
    pos = torch.clamp_min(lengths - 1, 0)
    flat_idx = _flat_scatter_indices(page_table, pos, live, page_size,
                                     n_pages)

    def write_kv(li, pos_, row, live_):
        index_set_drop_(pools[li].view(-1, row.shape[-1]), flat_idx, row)

    def attend(li, q, lens):
        return mla_decode_attention(q, pools[li], lens, page_table, scale,
                                    latent)

    return write_kv, attend


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


def torch_paged_partial(pool, ks, vs, q, ring_start, lengths, page_table,
                        page_size, n_heads):
    """The gather-based (oracle) page partial of ring decode: the
    online-softmax state of q over each live slot's page positions <
    ring_start, as (o [B, D] normalized, m [B, H], l [B, H]) in float32.
    Scores are (q . K) / sqrt(dh) * k_scale and probabilities take v_scale
    before PV, the order of the JAX kernels. Rows with no such position
    (dead slots, ring_start == 0) are o = 0, m = -inf, l = 0."""
    kctx, vctx = gather_kv_context(pool, page_table, page_size)
    B, D = q.shape
    if pool.shape[-1] * 2 == D:
        kctx = unpack_int4(kctx, n_heads)
        vctx = unpack_int4(vctx, n_heads)
    L = kctx.shape[1]
    dh = D // n_heads
    pos = torch.arange(L, device=q.device)
    valid = (pos[None, :] < ring_start[:, None]) & (lengths > 0)[:, None]
    qh = q.float().reshape(B, n_heads, dh)
    kh = kctx.float().reshape(B, L, n_heads, dh)
    # masked rows may hold anything a dead or stale page held
    vh = torch.where(valid[:, :, None], vctx.float(), 0.0)
    vh = vh.reshape(B, L, n_heads, dh)
    s = torch.einsum("bhd,blhd->bhl", qh, kh) * inv_sqrt(dh)
    if ks is not None:
        s = s * gather_scales(ks, page_table, page_size)[:, None, :]
    vmask = valid[:, None, :]
    m = torch.where(vmask, s, float("-inf")).amax(dim=-1)
    safe_m = torch.where(torch.isinf(m), 0.0, m)
    p = torch.where(vmask, torch.exp(s - safe_m[..., None]), 0.0)
    l = p.sum(dim=-1)
    if vs is not None:
        p = p * gather_scales(vs, page_table, page_size)[:, None, :]
    o = torch.einsum("bhl,blhd->bhd", p, vh) / l.clamp_min(_TINY)[..., None]
    return o.reshape(B, D), m, l


def ring_pad_rows(n_forward_rounds: int) -> int:
    """Ring rows: one per decode round, padded to a multiple of 8 (the JAX
    ring's tile rule, kept so the two rings have one shape)."""
    return max(8, -(-n_forward_rounds // 8) * 8)


def pack_ring_for_flush(ring, n_heads: int):
    """[B, R, 2*D] unpacked int4-value ring -> [B, R, D] packed (two
    nibbles per byte, per-head halves) for the page flush, once per
    burst."""
    B, R, two_d = ring.shape
    D = two_d // 2
    qk = pack_int4_rows(ring[:, :, :D].reshape(B * R, D), n_heads)
    qv = pack_int4_rows(ring[:, :, D:].reshape(B * R, D), n_heads)
    return torch.cat([qk.reshape(B, R, D // 2), qv.reshape(B, R, D // 2)],
                     dim=-1)


def merge_ring_partial(o_p, m_p, l_p, q, ring, ring_sc, ring_start, lens,
                       heads, packed, ring_r0=None):
    """Merge the page partial (o_p [B, D] normalized, m_p/l_p [B, H]) with
    the ring's contribution: a two-block flash merge of normalized
    partials, over the same dequantized values as the scatter paths.

    Ring column r holds position ring_start + (r - r0), valid inside the
    length and only from the occupant's first column r0 on (ring_r0 None:
    r0 = 0). ring_sc [B, 128]: column r is row r's K scale, 64 + r its V
    scale."""
    B = q.shape[0]
    dh = q.shape[1] // heads
    R = ring.shape[1]
    Dk = ring.shape[2] // 2
    kq, vq = ring[:, :, :Dk], ring[:, :, Dk:]
    if packed:
        kd, vd = unpack_int4(kq, heads), unpack_int4(vq, heads)
    else:
        kd, vd = kq.float(), vq.float()
    if ring_sc is not None:
        kd = kd * ring_sc[:, :R, None]
        vsc = ring_sc[:, 64:64 + R]
    qh = q.float().reshape(B, heads, dh)
    kh = kd.reshape(B, R, heads, dh)
    vh = vd.reshape(B, R, heads, dh)
    s = torch.einsum("brhd,bhd->bhr", kh, qh) * inv_sqrt(dh)
    col = torch.arange(R, dtype=torch.int32, device=q.device)[None, None, :]
    rs = ring_start[:, None, None]
    if ring_r0 is None:
        valid = (rs + col) < lens[:, None, None]
    else:
        r0b = ring_r0[:, None, None]
        valid = (col >= r0b) & ((rs - r0b + col) < lens[:, None, None])
    m_r = torch.where(valid, s, float("-inf")).amax(dim=-1)
    w = torch.where(valid, torch.exp(s - m_r[..., None]), 0.0)
    l_r = w.sum(dim=-1)
    if ring_sc is not None:
        w = w * vsc[:, None, :]
    o_r = torch.einsum("bhr,brhd->bhd", w, vh)
    o_r = o_r / l_r.clamp_min(_TINY)[..., None]
    m = torch.maximum(m_p, m_r)

    def coef(m_x, l_x):
        return torch.where(torch.isinf(m_x) & (m_x < 0), 0.0,
                           torch.exp(m_x - m)) * l_x

    a, b = coef(m_p, l_p), coef(m_r, l_r)
    out = (a[..., None] * o_p.reshape(B, heads, dh) + b[..., None] * o_r
           ) / (a + b).clamp_min(_TINY)[..., None]
    return out.reshape(B, heads * dh)


def flush_ring_to_pages(pool, ring, ring_start, lengths, n_rounds,
                        page_table, page_size, n_pages, ring_r0=None):
    """The oracle of the ring flush, in place: gather both candidate pages
    of each slot, merge its valid ring rows, window-scatter them back.

    A live slot's valid ring rows r in [r0, r0 + min(length - ring_start,
    n_rounds - r0)) hold positions ring_start + (r - r0), spanning at most
    two pages (n_rounds <= page_size). Slots dead at flush time are
    dropped: their pages are freed at the next burst start and re-prefilled
    before anything reads them. Returns pool."""
    B, R, two_dk = ring.shape
    Dk = two_dk // 2
    NP_, _, P, _ = pool.shape
    W = page_table.shape[1]
    dev = pool.device
    live = lengths > 0
    r0 = (torch.zeros_like(ring_start) if ring_r0 is None
          else ring_r0.to(ring_start.dtype))
    nv = torch.where(live, torch.minimum(lengths - ring_start, n_rounds - r0),
                     0)
    p0 = torch.div(ring_start.clamp_min(0), P, rounding_mode="floor")
    cand = p0[:, None] + torch.arange(2, dtype=p0.dtype, device=dev)[None, :]
    cand_ok = (live[:, None] & (cand * P < (ring_start + nv)[:, None])
               & (cand < W))
    pid = torch.gather(page_table, 1, cand.clamp(0, W - 1).long())
    flat = pool.view(NP_ * 2, P, Dk)
    win = pid.clamp(0, NP_ - 1).long() * 2
    cur_k, cur_v = flat[win], flat[win + 1]                  # [B, 2, P, Dk]
    prow = torch.arange(P, dtype=p0.dtype, device=dev)[None, None, :]
    r = cand[:, :, None] * P + prow - ring_start[:, None, None]  # [B, 2, P]
    use = (r >= 0) & (r < nv[:, None, None])
    rc = (r + r0[:, None, None]).clamp(0, R - 1).reshape(B, 2 * P, 1).long()

    def merge(cur, side):
        rows = torch.gather(ring[:, :, side * Dk:(side + 1) * Dk], 1,
                            rc.expand(B, 2 * P, Dk)).reshape(B, 2, P, Dk)
        return torch.where(use[..., None], rows, cur)

    idx = torch.cat([torch.where(cand_ok, pid * 2, 2 * NP_).reshape(-1),
                     torch.where(cand_ok, pid * 2 + 1, 2 * NP_).reshape(-1)])
    vals = torch.cat([merge(cur_k, 0).reshape(-1, P, Dk),
                      merge(cur_v, 1).reshape(-1, P, Dk)])
    index_set_drop_(flat, idx, vals)
    return pool


def check_attention_impl(engine_cfg: EngineConfig,
                         attention_impl: str) -> None:
    """Raise for an unknown ``attention_impl`` of the host engines, or for
    the one-slot kernel (``paged``) on a packed int4 pool, which it does
    not take, as the JAX engine asserts."""
    if attention_impl not in ("paged", "grouped", "torch"):
        raise ValueError(f"unknown attention_impl {attention_impl!r}")
    if attention_impl == "paged" and engine_cfg.kv_packed:
        raise ValueError("int4 KV is supported by attention_impl "
                         "'grouped' or 'torch' only")


def make_attend_impl(model_cfg: ModelConfig, engine_cfg: EngineConfig,
                     attention_impl: str, page_table, n_heads=None):
    """attend(pool, ks, vs, q, lengths) -> [B, D] in q's dtype for a fixed
    page table: the one-slot kernel (``paged``), the grouped kernel without
    the fused write (``grouped``, mode a) or the gather oracle
    (``torch``)."""
    check_attention_impl(engine_cfg, attention_impl)
    P = engine_cfg.page_size
    heads = n_heads or model_cfg.n_heads
    if attention_impl == "paged":
        def attend(pool, ks, vs, q, lens):
            return paged_decode_attention(
                q, pool, lens, page_table, ks, vs, n_heads=heads,
            ).to(q.dtype)
    elif attention_impl == "grouped":
        def attend(pool, ks, vs, q, lens):
            return paged_decode_attention_grouped(
                q, pool, lens, page_table, ks, vs, n_heads=heads,
                packed_int4=engine_cfg.kv_packed,
            ).to(q.dtype)
    else:
        def attend(pool, ks, vs, q, lens):
            return torch_paged_attend(pool, ks, vs, q, lens, page_table, P,
                                      heads)
    return attend


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
    scale_reduce=None,
):
    """The (write_kv, attend) pair of ONE decode round.

    ``grouped``: the decode KV write is fused into the attention kernel.
    write_kv only updates the fresh pages' scales (the kernel quantizes
    against the UPDATED scale) and stashes the raw rows; attend hands them
    to the kernel, which inserts the row at lengths-1 in place and attends
    over it. ``torch`` and ``paged``: scatter the row, then attend with the
    gather oracle or the one-slot kernel (``make_attend_impl``). All give
    the same pool bytes (tests/test_torch_grouped_attention.py,
    tests/test_torch_paged_attention.py)."""
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
                update_page_scales(k_scales[li], k, fresh_pid, qmax,
                                   scale_reduce)
                update_page_scales(v_scales[li], v, fresh_pid, qmax,
                                   scale_reduce)
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

    attend_impl = make_attend_impl(model_cfg, engine_cfg, attention_impl,
                                   page_table, n_heads=heads)
    flat_idx = _flat_scatter_indices(page_table, pos, live, P, NP)

    def write_kv(li, pos_, k, v, live_):
        _write_kv_tokens(kv_pages[li], k_scales[li], v_scales[li],
                         flat_idx, k, v, fresh_pid, scale_reduce,
                         n_heads=heads)

    def attend(li, q, lens):
        return attend_impl(kv_pages[li], k_scales[li], v_scales[li], q, lens)

    return write_kv, attend


def make_ring_round_callbacks(
    model_cfg: ModelConfig,
    engine_cfg: EngineConfig,
    page_table,
    kv_pages: list,
    k_scales: list,
    v_scales: list,
    rings: list,      # per-layer [B, R, 2*Dk], written in place
    ring_scs: list,   # per-layer [B, 128] f32 scale columns (quantized only)
    lengths,
    ring_start,       # [B] i32, pages hold positions < ring_start
    round_idx: int,   # ring column written this round
    ring_r0=None,
    n_heads=None,
    scale_reduce=None,
):
    """Ring-mode (write_kv, attend) for ONE decode round of a burst.

    write_kv quantizes the K|V row in plain PyTorch against its page's
    (just updated) scale, records the scale in the [B, 128] column buffer
    (column r = K, 64 + r = V) and writes ring column ``round_idx``; int4
    rows stay unpacked (the flush packs them once per burst). attend takes
    the page partial, the pool read-only, in the JAX engine's order of
    formulations: ``dgrid_paged_partial`` (``attn_dgrid``), the dense view
    (``attn_dense``; both need full-grant group rows), the flat kernel
    (``attn_flat``), else the grouped kernel's mode (c); then merges the
    ring's rows into it. The flat and grouped kernels read one page id per
    page, so overcommit's half-group rows need no run limit
    (``max_run_pages`` of the JAX kernels). ``ring_r0`` [B] i32: the first
    valid ring column per slot (None = 0)."""
    P = engine_cfg.page_size
    NP = engine_cfg.n_pages
    heads = n_heads or model_cfg.n_heads
    live = lengths > 0
    pos = torch.clamp_min(lengths - 1, 0)
    fresh_pid = decode_fresh_pid(page_table, pos, live, P, NP)
    quantized = engine_cfg.kv_quantized
    qmax = kv_qmax(engine_cfg.kv_packed)
    if quantized:
        flat_idx = _flat_scatter_indices(page_table, pos, live, P, NP)
        pidr = torch.div(flat_idx, P, rounding_mode="floor").clamp(
            0, NP - 1).long()

    def write_kv(li, pos_, k, v, live_):
        with phase("ring"):
            if quantized:
                update_page_scales(k_scales[li], k, fresh_pid, qmax,
                                   scale_reduce)
                update_page_scales(v_scales[li], v, fresh_pid, qmax,
                                   scale_reduce)
                sk, sv = k_scales[li][pidr], v_scales[li][pidr]
                qk = quantize_against(k, inv_scale(sk)[:, None], qmax)
                qv = quantize_against(v, inv_scale(sv)[:, None], qmax)
                ring_scs[li][:, round_idx] = sk
                ring_scs[li][:, 64 + round_idx] = sv
            else:
                qk, qv = k, v
            Dk = qk.shape[-1]
            rings[li][:, round_idx, :Dk] = qk
            rings[li][:, round_idx, Dk:] = qv

    def attend(li, q, lens):
        ks = k_scales[li] if quantized else None
        vs = v_scales[li] if quantized else None
        if engine_cfg.attn_dgrid:
            o_p, m_p, l_p = dgrid_paged_partial(
                q, kv_pages[li], ks, vs, ring_start, lens, page_table,
                n_heads=heads, page_size=P)
        elif engine_cfg.attn_dense:
            o_p, m_p, l_p = dense_paged_partial(
                q, kv_pages[li], ks, vs, ring_start, lens, page_table,
                n_heads=heads, page_size=P, packed_int4=engine_cfg.kv_packed)
        elif engine_cfg.attn_flat:
            o_p, m_p, l_p = paged_decode_attention_flat(
                q, kv_pages[li], lens, page_table, ks, vs, ring_start,
                n_heads=heads, packed_int4=engine_cfg.kv_packed)
        else:
            o_p, m_p, l_p = paged_decode_attention_grouped(
                q, kv_pages[li], lens, page_table, ks, vs,
                ring_start=ring_start, n_heads=heads,
                packed_int4=engine_cfg.kv_packed)
        # the ring rides unpacked even for int4 pools: packed=False
        with phase("ring"):
            return merge_ring_partial(
                o_p, m_p, l_p, q, rings[li],
                ring_scs[li] if quantized else None, ring_start, lens, heads,
                False, ring_r0=ring_r0,
            ).to(q.dtype)

    return write_kv, attend


def _prefill(
    model_cfg: ModelConfig,
    engine_cfg: EngineConfig,
    params,
    state: PagedKVState,
    prompts,         # [M, S] int32, compact new slots (padded rows: length 0)
    prompt_lengths,  # [M] int32
    page_rows,       # [M, W] int32 page-table rows of those slots
    ctx=DEFAULT_CTX,
) -> PagedKVState:
    """Compact prefill of the newly admitted slots into their (possibly
    fragmented) pages, in place. With S a page multiple the int8 write is
    the page-granular ``prefill_quant_scatter``."""
    write_kv_block, finalize = make_prefill_kv_writer(
        state, page_rows, prompt_lengths, prompts.shape[1],
        engine_cfg.page_size, engine_cfg.n_pages, scale_reduce_of(ctx),
        n_heads=ctx.local_heads(model_cfg),
    )
    prefill_write_kv(params, model_cfg, prompts, prompt_lengths,
                     write_kv_block, ctx)
    return finalize()


def _decode_rounds(
    model_cfg: ModelConfig,
    engine_cfg: EngineConfig,
    attention_impl: str,
    params,
    state: PagedKVState,
    sched_packed,  # [B, 2+W] int32: col 0 length update (-1 = keep), col 1
                   # last-token update, cols 2: the page table. One packed
                   # upload carries every scheduler decision per host step.
    lengths,       # [B] int32 (device-chained)
    last_tokens,   # [B] int32 (device-chained)
    ctx=DEFAULT_CTX,
):
    """n_forward_rounds greedy decode rounds over the paged pools (written
    in place). Returns (state, lengths, last_tokens, tokens [B, R]) with
    EMPTY_ROW_TOKEN_ID in the rows of dead slots."""
    upd = sched_packed[:, 0]
    lengths = torch.where(upd >= 0, upd, lengths)
    last_tokens = torch.where(upd >= 0, sched_packed[:, 1], last_tokens)
    page_table = sched_packed[:, 2:].contiguous()
    kv_pages = list(state.kv_pages)
    k_scales, v_scales = list(state.k_scales), list(state.v_scales)
    heads = ctx.local_heads(model_cfg)
    scale_reduce = scale_reduce_of(ctx)
    toks = []
    for _ in range(engine_cfg.n_forward_rounds):
        live = lengths > 0
        write_kv, attend = make_round_kv_callbacks(
            model_cfg, engine_cfg, attention_impl, page_table,
            kv_pages, k_scales, v_scales, lengths, n_heads=heads,
            scale_reduce=scale_reduce,
        )
        tok, lengths_next = decode_round_tokens(
            params, model_cfg, lengths, last_tokens, write_kv, attend, ctx)
        last_tokens = torch.where(live, tok, last_tokens)
        lengths = lengths_next
        toks.append(tok)
    state = PagedKVState(tuple(kv_pages), tuple(k_scales), tuple(v_scales))
    return state, lengths, last_tokens, torch.stack(toks, dim=1)


def make_paged_fns(model_cfg: ModelConfig, engine_cfg: EngineConfig,
                   attention_impl: str = "torch", ctx=DEFAULT_CTX):
    """(prefill, decode_rounds) of the host engines for a config pair:
    plain functions (eager PyTorch has nothing to compile or cache). A
    tensor-parallel ``ctx`` (parallel/sharded.TpShardCtx) makes them one
    rank's functions at local shapes."""
    check_attention_impl(engine_cfg, attention_impl)
    return (functools.partial(_prefill, model_cfg, engine_cfg, ctx=ctx),
            functools.partial(_decode_rounds, model_cfg, engine_cfg,
                              attention_impl, ctx=ctx))
