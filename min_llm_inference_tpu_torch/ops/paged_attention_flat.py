"""Cross-slot ("flat") ring partial of paged decode attention: the wrapper
of the hand-written Hopper kernel ``csrc/paged_attention_flat.cu`` and its
plain PyTorch version.

Counterpart of min_llm_inference_tpu/ops/paged_attention_flat.py
(``paged_decode_attention_flat``, the Pallas TPU kernel). Contract: the
pool is read-only and holds positions < ring_start; the call returns the
online-softmax partial over them for ``merge_ring_partial``. Token t of a
slot is read from page ``page_table[b, t // P]``, so any table works: full
groups, overcommit's half-groups, fragmented rows. float32, bfloat16, int8
and packed int4 pools, any number of heads and any table width, rows of at
most 65536 features (rows past 4096 features are cut into feature slices,
one block each, in a thread block cluster).

The TPU kernel's arguments that chose its DMA runs, VMEM blocks and
layout (``group_size``, ``pages_per_compute_block``, ``pages_per_dma``,
``max_run_pages``, the lane padding of m/l and the padding of B to 8) have
no counterpart here.

The wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._build import check_contig, check_rows
from .reference import inv_sqrt

_SOURCE = "paged_attention_flat.cu"
_POOL_KINDS = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 3}
_IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_decode_attention_flat(
    q,            # [B, D]
    kv_pages,     # [NP, 2, P, Dk] (0 = K rows, 1 = V rows); Dk = D/2 if int4
    lengths,      # [B] int32 (0 = dead slot)
    page_table,   # [B, W] int32
    k_scales=None,  # [NP] f32 per-page scales (int8/int4 pools)
    v_scales=None,
    ring_start=None,  # [B] int32, pages hold positions < ring_start
    *,
    n_heads: int = 1,
    packed_int4: bool = False,
):
    """Online-softmax page partial of q over each live slot's positions <
    ring_start: ``(o [B, D] normalized, m [B, H], l [B, H])``, float32, in
    slot order. Rows without such a position (dead slots, whatever their
    ring_start, and ring_start == 0) are o = 0, m = -inf, l = 0."""
    if ring_start is None:
        raise ValueError("the flat kernel computes the ring partial only: "
                         "ring_start is required")
    if q.device.type == "cpu":
        return paged_decode_attention_flat_plain(
            q, kv_pages, lengths, page_table, k_scales, v_scales, ring_start,
            n_heads=n_heads, packed_int4=packed_int4)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, kv_pages, lengths, page_table, k_scales, v_scales,
                   ring_start, n_heads, packed_int4)


# kernel launches since the last reset (launches made by the wrapper only)
_build.counted(paged_decode_attention_flat)


def paged_decode_attention_flat_plain(q, kv_pages, lengths, page_table,
                                      k_scales, v_scales, ring_start, *,
                                      n_heads: int = 1,
                                      packed_int4: bool = False):
    """The plain version: the gather oracle of the page partial on the
    given table (``packed_int4`` is read from the pool's width)."""
    from ..models.paged import torch_paged_partial

    return torch_paged_partial(kv_pages, k_scales, v_scales, q, ring_start,
                               lengths, page_table, kv_pages.shape[2],
                               n_heads)


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library (built on first use) with its C signatures."""
    lib = _build.load(_SOURCE)
    vp, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.mli_flat_partial.argtypes = [
        vp, ll, vp, vp, vp, vp, vp, vp, vp, vp, vp,
        i, i, i, i, i, i, i, i, f, vp,
    ]
    lib.mli_flat_partial.restype = ctypes.c_int
    lib.mli_flat_partial_smem.argtypes = [i, i, i, i]
    lib.mli_flat_partial_smem.restype = ctypes.c_longlong
    lib.mli_error_string.argtypes = [i]
    lib.mli_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, kv_pages, lengths, page_table, k_scales, v_scales, ring_start,
            n_heads, packed_int4):
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
    check_contig("ring_start", ring_start, (B,), torch.int32, dev)
    if quantized:
        check_contig("k_scales", k_scales, (NP,), torch.float32, dev)
        check_contig("v_scales", v_scales, (NP,), torch.float32, dev)
    pool_kind = 2 if packed_int4 else _POOL_KINDS[kv_pages.dtype]
    lib = _library()
    smem = lib.mli_flat_partial_smem(D, n_heads, P, pool_kind)
    if not 0 < smem <= _build.MAX_SMEM:
        raise ValueError(f"the kernel does not take rows of {D} features "
                         f"in {n_heads} heads (at most {_build.MAX_FEATURES})")
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    m = torch.empty((B, n_heads), dtype=torch.float32, device=dev)
    l = torch.empty((B, n_heads), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mli_flat_partial(
            q.data_ptr(), q.stride(0), kv_pages.data_ptr(),
            lengths.data_ptr(), page_table.data_ptr(),
            k_scales.data_ptr() if quantized else None,
            v_scales.data_ptr() if quantized else None,
            ring_start.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
            B, D, NP, P, W, n_heads, pool_kind, _IN_DTYPES[q.dtype],
            inv_sqrt(D // n_heads), stream,
        )
    _build.check(lib, rc, "paged_decode_attention_flat kernel")
    _build.count_launch(paged_decode_attention_flat)
    return out, m, l
