"""Ring-decode page partial over the full-grant group view: the wrapper of
the hand-written Hopper kernel ``csrc/paged_attention_dgrid.cu`` and its
plain PyTorch version.

Counterpart of min_llm_inference_tpu/ops/paged_attention_dgrid.py
(``dgrid_paged_partial``, the Pallas TPU kernel). Contract: every live
slot's page-table row is ``gid * W + arange(W)`` (the engine's full-grant
group allocator), so the pool ``[NP, 2, P, D]`` is also the dense group
view ``[NG, W, 2, P, D]``; the pool is read-only and holds positions <
ring_start. float32 and int8 pools (packed int4 is rejected, as in the
JAX package), any number of heads and any table width, rows of at most
65536 features (rows past 4096 features are cut into feature slices,
one block each, in a thread block cluster).

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

_SOURCE = "paged_attention_dgrid.cu"
_POOL_KINDS = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 3}
_IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def dgrid_paged_partial(
    q,            # [B, D]
    kv_pages,     # [NP, 2, P, D] pool (float32, bfloat16 or int8)
    k_scales,     # [NP] f32 or None
    v_scales,
    ring_start,   # [B] i32, pages hold positions < ring_start
    lengths,      # [B] i32 (liveness: 0 = dead)
    page_table,   # [B, W] i32, full-grant group rows
    *,
    n_heads: int,
    page_size: int,
):
    """Online-softmax page partial of q over each live slot's positions <
    ring_start: ``(o [B, D] normalized, m [B, H], l [B, H])``, float32, in
    slot order. Rows without such a position (dead slots, ring_start == 0)
    are o = 0, m = -inf, l = 0."""
    if kv_pages.shape[-1] != q.shape[-1]:
        raise ValueError("dgrid: packed int4 pools are not supported")
    if kv_pages.shape[2] != page_size or kv_pages.shape[0] % page_table.shape[1]:
        raise ValueError("dgrid: pool pages must be P rows and NP a multiple "
                         "of the table width")
    if q.device.type == "cpu":
        return dgrid_paged_partial_plain(
            q, kv_pages, k_scales, v_scales, ring_start, lengths, page_table,
            n_heads=n_heads, page_size=page_size)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, kv_pages, k_scales, v_scales, ring_start, lengths,
                   page_table, n_heads)


# kernel launches since the last reset (launches made by the wrapper only)
_build.counted(dgrid_paged_partial)


def dgrid_paged_partial_plain(q, kv_pages, k_scales, v_scales, ring_start,
                              lengths, page_table, *, n_heads: int,
                              page_size: int):
    """The plain version: the gather oracle of the page partial over the
    group view (each slot's row rebuilt as gid * W + arange(W))."""
    from ..models.paged import torch_paged_partial

    W = page_table.shape[1]
    gid = torch.div(page_table[:, :1], W, rounding_mode="floor")
    rows = gid * W + torch.arange(W, dtype=page_table.dtype,
                                  device=page_table.device)
    return torch_paged_partial(kv_pages, k_scales, v_scales, q, ring_start,
                               lengths, rows, page_size, n_heads)


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library (built on first use) with its C signatures."""
    lib = _build.load(_SOURCE)
    vp, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.mli_dgrid_partial.argtypes = [
        vp, ll, vp, vp, vp, vp, vp, vp, vp, vp, vp,
        i, i, i, i, i, i, i, i, f, vp,
    ]
    lib.mli_dgrid_partial.restype = ctypes.c_int
    lib.mli_dgrid_partial_smem.argtypes = [i, i, i, i]
    lib.mli_dgrid_partial_smem.restype = ctypes.c_longlong
    lib.mli_error_string.argtypes = [i]
    lib.mli_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, kv_pages, k_scales, v_scales, ring_start, lengths, page_table,
            n_heads):
    dev = q.device
    if q.dim() != 2 or kv_pages.dim() != 4:
        raise ValueError("q must be [B, D] and kv_pages [NP, 2, P, D]")
    B, D = q.shape
    NP, two, P, _ = kv_pages.shape
    W = page_table.shape[-1]
    if q.dtype not in _IN_DTYPES:
        raise ValueError(f"q dtype {q.dtype} not supported by the kernel")
    if kv_pages.dtype not in _POOL_KINDS:
        raise ValueError(f"pool dtype {kv_pages.dtype} not supported by "
                         "the kernel (float32, bfloat16, int8)")
    quantized = kv_pages.dtype == torch.int8
    if two != 2 or D % n_heads:
        raise ValueError("pool shape does not match q / n_heads")
    if quantized != (k_scales is not None) or quantized != (v_scales is not None):
        raise ValueError("int8 pools need k_scales and v_scales, float "
                         "pools take none")
    check_rows("q", q, B, D, q.dtype, dev)
    check_contig("kv_pages", kv_pages, (NP, 2, P, D), kv_pages.dtype, dev)
    check_contig("ring_start", ring_start, (B,), torch.int32, dev)
    check_contig("lengths", lengths, (B,), torch.int32, dev)
    check_contig("page_table", page_table, (B, W), torch.int32, dev)
    if quantized:
        check_contig("k_scales", k_scales, (NP,), torch.float32, dev)
        check_contig("v_scales", v_scales, (NP,), torch.float32, dev)
    lib = _library()
    kind = _POOL_KINDS[kv_pages.dtype]
    smem = lib.mli_dgrid_partial_smem(D, n_heads, P, kind)
    if not 0 < smem <= _build.MAX_SMEM:
        raise ValueError(f"the kernel does not take rows of {D} features "
                         f"in {n_heads} heads (at most {_build.MAX_FEATURES})")
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    m = torch.empty((B, n_heads), dtype=torch.float32, device=dev)
    l = torch.empty((B, n_heads), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mli_dgrid_partial(
            q.data_ptr(), q.stride(0), kv_pages.data_ptr(),
            k_scales.data_ptr() if quantized else None,
            v_scales.data_ptr() if quantized else None,
            ring_start.data_ptr(), lengths.data_ptr(), page_table.data_ptr(),
            out.data_ptr(), m.data_ptr(), l.data_ptr(),
            B, D, NP, P, W, n_heads, kind, _IN_DTYPES[q.dtype],
            inv_sqrt(D // n_heads), stream,
        )
    _build.check(lib, rc, "dgrid_paged_partial kernel")
    _build.count_launch(dgrid_paged_partial)
    return out, m, l
