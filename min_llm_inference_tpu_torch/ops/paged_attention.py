"""One-slot paged decode attention: the wrapper of the hand-written Hopper
kernel ``csrc/paged_attention.cu`` and its plain PyTorch version.

Counterpart of min_llm_inference_tpu/ops/paged_attention.py
(``paged_decode_attention``, the Pallas TPU kernel of the host-scheduled
``PagedEngine``). Same layout:
  q:          [B, D]                f32 or bf16 (D = n_heads * head_dim)
  kv_pages:   [NP, 2, P, D]         one pool, 0 = K rows, 1 = V rows;
                                    float32, bfloat16 or int8 (no
                                    packed int4)
  lengths:    [B] int32             0 = dead slot
  page_table: [B, W] int32          any page ids (fragmented tables)
  k/v_scales: [NP] f32              per-page scales (int8 pools only)
Returns [B, D] float32, exact zeros for dead slots. Any context width W*P,
rows of at most 65536 features.

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

_SOURCE = "paged_attention.cu"
_POOL_KINDS = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 3}
_IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_decode_attention(q, kv_pages, lengths, page_table, k_scales=None,
                           v_scales=None, *, n_heads: int = 1):
    """Length-masked attention of each slot's q over its pages, int8 rows
    scaled by their page's scale (the plain version and the JAX kernel
    scale the rows before the dots, the CUDA kernel the scores and the
    weights after them: equal up to float32 rounding). Raises for a packed
    int4 pool (feature width D/2), as the JAX engine asserts: int4 goes to
    the grouped kernel."""
    if q.dim() != 2 or kv_pages.dim() != 4:
        raise ValueError("q must be [B, D] and kv_pages [NP, 2, P, D]")
    if kv_pages.shape[-1] != q.shape[-1]:
        raise ValueError("the one-slot kernel takes float32, bfloat16 or "
                         "int8 pools of q's width, not packed int4 (use "
                         "'grouped')")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales go together")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, kv_pages, lengths, page_table,
                                            k_scales, v_scales,
                                            n_heads=n_heads)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, kv_pages, lengths, page_table, k_scales, v_scales,
                   n_heads)


# kernel launches since the last reset (launches made by the wrapper only)
_build.counted(paged_decode_attention)


def paged_decode_attention_plain(q, kv_pages, lengths, page_table,
                                 k_scales=None, v_scales=None, *,
                                 n_heads: int = 1):
    """The plain version: the gather oracle (``torch_paged_attend``) in
    float32, which dequantizes the gathered rows before the dots."""
    from ..models.paged import torch_paged_attend

    return torch_paged_attend(kv_pages, k_scales, v_scales, q.float(),
                              lengths, page_table, kv_pages.shape[2], n_heads)


@functools.cache
def _library(defines: tuple = ()) -> ctypes.CDLL:
    """The kernel's library (built on first use, with the preprocessor
    ``defines`` of a timing variant) with its C signatures."""
    lib = _build.load(_SOURCE, defines)
    vp, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.mli_paged_attention.argtypes = [
        vp, ll, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, f, vp,
    ]
    lib.mli_paged_attention.restype = ctypes.c_int
    lib.mli_paged_attention_smem.argtypes = [i, i, i, i]
    lib.mli_paged_attention_smem.restype = ctypes.c_longlong
    lib.mli_error_string.argtypes = [i]
    lib.mli_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, kv_pages, lengths, page_table, k_scales, v_scales, n_heads,
            defines=()):
    """Check the inputs and launch the kernel (``defines``: a timing variant
    of it, whose output is meaningless)."""
    dev = q.device
    B, D = q.shape
    NP, two, P, _ = kv_pages.shape
    W = page_table.shape[-1]
    if q.dtype not in _IN_DTYPES:
        raise ValueError(f"q dtype {q.dtype} not supported by the kernel")
    if kv_pages.dtype not in _POOL_KINDS:
        raise ValueError(f"pool dtype {kv_pages.dtype} not supported by the "
                         "kernel (float32, bfloat16, int8)")
    quantized = kv_pages.dtype == torch.int8
    if two != 2 or n_heads <= 0 or D % n_heads:
        raise ValueError("pool shape does not match q / n_heads")
    if quantized != (k_scales is not None):
        raise ValueError("int8 pools need k_scales and v_scales, float and "
                         "bfloat16 pools take none")
    check_rows("q", q, B, D, q.dtype, dev)
    check_contig("kv_pages", kv_pages, (NP, 2, P, D), kv_pages.dtype, dev)
    check_contig("lengths", lengths, (B,), torch.int32, dev)
    check_contig("page_table", page_table, (B, W), torch.int32, dev)
    if quantized:
        check_contig("k_scales", k_scales, (NP,), torch.float32, dev)
        check_contig("v_scales", v_scales, (NP,), torch.float32, dev)
    lib = _library(defines)
    kind = _POOL_KINDS[kv_pages.dtype]
    smem = lib.mli_paged_attention_smem(D, n_heads, P, kind)
    if not 0 < smem <= _build.MAX_SMEM:
        raise ValueError(f"the kernel does not take rows of {D} features "
                         f"in {n_heads} heads (at most {_build.MAX_FEATURES})")
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mli_paged_attention(
            q.data_ptr(), q.stride(0), kv_pages.data_ptr(),
            lengths.data_ptr(), page_table.data_ptr(),
            k_scales.data_ptr() if quantized else None,
            v_scales.data_ptr() if quantized else None,
            out.data_ptr(), B, D, NP, P, W, n_heads, kind,
            _IN_DTYPES[q.dtype], inv_sqrt(D // n_heads), stream,
        )
    _build.check(lib, rc, "paged_decode_attention kernel")
    _build.count_launch(paged_decode_attention)
    return out
