"""Paged decode attention with the fused KV write, and the ring partial:
the wrapper of the hand-written Hopper kernel
``csrc/paged_attention_grouped.cu`` and its plain PyTorch version.

Counterpart of min_llm_inference_tpu/ops/paged_attention_grouped.py
(the Pallas TPU kernel) in its three modes: (a) plain, (b) fused write,
(c) ring partial. Any context width W*P, rows of at most 65536 features.

The wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._build import check_contig, check_rows
from .quant import kv_qmax, pack_int4_rows, quantize_rows_against_pages
from .reference import inv_sqrt

_SOURCE = "paged_attention_grouped.cu"
_POOL_KINDS = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 3}
_IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_decode_attention_grouped(
    q,            # [B, D]
    kv_pages,     # [NP, 2, P, Dk] (0 = K rows, 1 = V rows); Dk = D/2 if int4
    lengths,      # [B] int32 (0 = dead slot)
    page_table,   # [B, W] int32
    k_scales=None,  # [NP] f32 per-page scales (int8/int4 pools)
    v_scales=None,
    k_new=None,   # [B, D] raw new-token K rows -> fused write at lengths-1
    v_new=None,
    *,
    ring_start=None,  # [B] int32 -> mode (c): pages hold positions < it
    n_heads: int = 1,
    packed_int4: bool = False,
):
    """Length-masked decode attention of q over each slot's pages, returning
    f32 ``[B, D]`` (exact zeros for dead slots). With ``k_new``/``v_new``
    the new rows are first quantized against the ALREADY UPDATED page
    scales, packed for int4, and written in place at position lengths-1;
    the call then returns ``(o, kv_pages)``, the row included in o.

    Mode (c), ``ring_start`` given (never with ``k_new``): the pool is
    read-only and holds positions < ring_start; the call returns the
    online-softmax partial ``(o [B, D] normalized, m [B, H], l [B, H])``
    over them, f32, for merge_ring_partial. Rows without such a position
    (dead slots, ring_start == 0) are o = 0, m = -inf, l = 0."""
    if (k_new is None) != (v_new is None):
        raise ValueError("k_new and v_new go together")
    if ring_start is not None and k_new is not None:
        raise ValueError("the ring partial (ring_start) replaces the fused "
                         "write (k_new/v_new)")
    if q.device.type == "cpu":
        return paged_decode_attention_grouped_plain(
            q, kv_pages, lengths, page_table, k_scales, v_scales, k_new,
            v_new, ring_start=ring_start, n_heads=n_heads,
            packed_int4=packed_int4,
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, kv_pages, lengths, page_table, k_scales, v_scales,
                   k_new, v_new, ring_start, n_heads, packed_int4)


# kernel launches since the last reset (launches made by the wrapper only)
_build.counted(paged_decode_attention_grouped)


def paged_decode_attention_grouped_plain(
    q, kv_pages, lengths, page_table, k_scales=None, v_scales=None,
    k_new=None, v_new=None, *, ring_start=None, n_heads: int = 1,
    packed_int4: bool = False,
):
    """The plain version: quantize + pack + scatter of the new rows at
    lengths-1 (pool written in place), then the gather oracle; in mode (c)
    the gather oracle of the page partial."""
    from ..models.paged import _flat_scatter_indices, _scatter_kv
    from ..models.paged import torch_paged_attend, torch_paged_partial

    NP, _, P, _ = kv_pages.shape
    if ring_start is not None:
        return torch_paged_partial(kv_pages, k_scales, v_scales, q,
                                   ring_start, lengths, page_table, P,
                                   n_heads)
    if k_new is not None:
        pos = torch.clamp_min(lengths - 1, 0)
        flat_idx = _flat_scatter_indices(page_table, pos, lengths > 0, P, NP)
        qk, qv = k_new, v_new
        if k_scales is not None:
            qmax = kv_qmax(packed_int4)
            qk = quantize_rows_against_pages(k_new, flat_idx, k_scales, P, qmax)
            qv = quantize_rows_against_pages(v_new, flat_idx, v_scales, P, qmax)
            if packed_int4:
                qk = pack_int4_rows(qk, n_heads)
                qv = pack_int4_rows(qv, n_heads)
        _scatter_kv(kv_pages, flat_idx, qk, qv)
    o = torch_paged_attend(kv_pages, k_scales, v_scales, q.float(), lengths,
                           page_table, P, n_heads)
    return o if k_new is None else (o, kv_pages)


@functools.cache
def _library(defines: tuple = ()) -> ctypes.CDLL:
    """The kernel's library (built on first use, with the preprocessor
    ``defines`` of a timing variant) with its C signatures."""
    lib = _build.load(_SOURCE, defines)
    vp, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.mli_grouped_attention.argtypes = [
        vp, ll, vp, vp, vp, vp, vp, vp, ll, vp, ll, vp, vp, vp, vp,
        i, i, i, i, i, i, i, i, f, vp,
    ]
    lib.mli_grouped_attention.restype = ctypes.c_int
    lib.mli_grouped_attention_smem.argtypes = [i, i, i, i]
    lib.mli_grouped_attention_smem.restype = ctypes.c_longlong
    lib.mli_error_string.argtypes = [i]
    lib.mli_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, kv_pages, lengths, page_table, k_scales, v_scales, k_new,
            v_new, ring_start, n_heads, packed_int4, defines=()):
    """Check the inputs and launch the kernel (``defines``: a timing variant
    of it, whose output is meaningless)."""
    dev = q.device
    if q.dim() != 2 or kv_pages.dim() != 4:
        raise ValueError("q must be [B, D] and kv_pages [NP, 2, P, Dk]")
    B, D = q.shape
    NP, two, P, Dk = kv_pages.shape
    W = page_table.shape[-1]
    if q.dtype not in _IN_DTYPES:
        raise ValueError(f"q dtype {q.dtype} not supported by the kernel")
    if kv_pages.dtype not in _POOL_KINDS:
        raise ValueError(f"pool dtype {kv_pages.dtype} not supported by "
                         "the kernel (float32, bfloat16, int8, packed int4)")
    quantized = kv_pages.dtype == torch.int8
    if two != 2 or D % n_heads or Dk != (D // 2 if packed_int4 else D):
        raise ValueError("pool shape does not match q / n_heads / packing")
    if packed_int4 and (not quantized or (D // n_heads) % 2):
        raise ValueError("packed int4 needs an int8 pool and an even head dim")
    if quantized != (k_scales is not None) or quantized != (v_scales is not None):
        raise ValueError("int8/int4 pools need k_scales and v_scales, float "
                         "pools take none")
    check_rows("q", q, B, D, q.dtype, dev)
    check_contig("kv_pages", kv_pages, (NP, 2, P, Dk), kv_pages.dtype, dev)
    check_contig("lengths", lengths, (B,), torch.int32, dev)
    check_contig("page_table", page_table, (B, W), torch.int32, dev)
    if quantized:
        check_contig("k_scales", k_scales, (NP,), torch.float32, dev)
        check_contig("v_scales", v_scales, (NP,), torch.float32, dev)
    fused = k_new is not None
    if fused:
        check_rows("k_new", k_new, B, D, q.dtype, dev)
        check_rows("v_new", v_new, B, D, q.dtype, dev)
    ring = ring_start is not None
    if ring:
        check_contig("ring_start", ring_start, (B,), torch.int32, dev)
    pool_kind = 2 if packed_int4 else _POOL_KINDS[kv_pages.dtype]
    lib = _library(defines)
    smem = lib.mli_grouped_attention_smem(D, n_heads, P, pool_kind)
    if not 0 < smem <= _build.MAX_SMEM:
        raise ValueError(f"the kernel does not take rows of {D} features "
                         f"in {n_heads} heads (at most {_build.MAX_FEATURES})")
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    if ring:
        m = torch.empty((B, n_heads), dtype=torch.float32, device=dev)
        l = torch.empty((B, n_heads), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mli_grouped_attention(
            q.data_ptr(), q.stride(0), kv_pages.data_ptr(),
            lengths.data_ptr(), page_table.data_ptr(),
            k_scales.data_ptr() if quantized else None,
            v_scales.data_ptr() if quantized else None,
            k_new.data_ptr() if fused else None,
            k_new.stride(0) if fused else 0,
            v_new.data_ptr() if fused else None,
            v_new.stride(0) if fused else 0,
            out.data_ptr(),
            ring_start.data_ptr() if ring else None,
            m.data_ptr() if ring else None,
            l.data_ptr() if ring else None,
            B, D, NP, P, W, n_heads, pool_kind,
            _IN_DTYPES[q.dtype], inv_sqrt(D // n_heads), stream,
        )
    _build.check(lib, rc, "paged_decode_attention_grouped kernel")
    _build.count_launch(paged_decode_attention_grouped)
    if ring:
        return out, m, l
    return (out, kv_pages) if fused else out
