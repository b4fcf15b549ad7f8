"""Ring flush: land a burst's decode ring in its KV pages, in place. The
wrapper of the hand-written Hopper kernel ``csrc/ring_flush.cu`` and its
plain PyTorch version (models/paged.flush_ring_to_pages, the oracle).

Counterpart of min_llm_inference_tpu/ops/ring_flush.py (``ring_flush``,
the Pallas TPU kernel). Unlike the JAX function, which returns a new pool,
this writes ``kv_pages`` in place and returns it.

The wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._build import check_contig

_SOURCE = "ring_flush.cu"


def ring_flush(kv_pages, ring, ring_start, lengths, page_table, *,
               n_rounds: int, ring_r0=None):
    """kv_pages: [NP, 2, P, Dk] (updated in place and returned); ring:
    [B, R, 2*Dk] (columns :Dk = K, Dk: = V), the pool's dtype;
    ring_start/lengths: [B] i32; page_table: [B, W]; ring_r0: [B] i32
    first valid ring column per slot (None = 0). A live slot's rows live
    at columns r0 + (pos - ring_start) for pos in [ring_start, ring_start +
    min(length - ring_start, n_rounds - r0)); dead slots are skipped."""
    NP, two, P, Dk = kv_pages.shape
    B, R, two_dk = ring.shape
    if two != 2 or two_dk != 2 * Dk or ring.dtype != kv_pages.dtype:
        raise ValueError("ring must be [B, R, 2*Dk] in the pool's dtype")
    if not 0 < n_rounds <= min(R, P):
        raise ValueError(f"need 0 < n_rounds <= ring rows and page_size, "
                         f"got {n_rounds}, {R}, {P}")
    if kv_pages.device.type == "cpu":
        return ring_flush_plain(kv_pages, ring, ring_start, lengths,
                                page_table, n_rounds=n_rounds,
                                ring_r0=ring_r0)
    if kv_pages.device.type != "cuda":
        raise ValueError(f"unsupported device {kv_pages.device}")
    return _launch(kv_pages, ring, ring_start, lengths, page_table, n_rounds,
                   ring_r0)


# kernel launches since the last reset (launches made by the wrapper only)
_build.counted(ring_flush)


def ring_flush_plain(kv_pages, ring, ring_start, lengths, page_table, *,
                     n_rounds: int, ring_r0=None):
    """The plain version: the gather/merge/window-scatter oracle."""
    from ..models.paged import flush_ring_to_pages

    return flush_ring_to_pages(kv_pages, ring, ring_start, lengths, n_rounds,
                               page_table, kv_pages.shape[2],
                               kv_pages.shape[0], ring_r0=ring_r0)


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library (built on first use) with its C signatures."""
    lib = _build.load(_SOURCE)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.mli_ring_flush.argtypes = [vp, vp, vp, vp, vp, vp,
                                   i, i, i, i, i, i, i, i, vp]
    lib.mli_ring_flush.restype = ctypes.c_int
    lib.mli_error_string.argtypes = [i]
    lib.mli_error_string.restype = ctypes.c_char_p
    return lib


def _launch(kv_pages, ring, ring_start, lengths, page_table, n_rounds,
            ring_r0):
    dev = kv_pages.device
    NP, _, P, Dk = kv_pages.shape
    B, R, _ = ring.shape
    W = page_table.shape[-1]
    check_contig("kv_pages", kv_pages, (NP, 2, P, Dk), kv_pages.dtype, dev)
    check_contig("ring", ring, (B, R, 2 * Dk), kv_pages.dtype, dev)
    check_contig("ring_start", ring_start, (B,), torch.int32, dev)
    check_contig("lengths", lengths, (B,), torch.int32, dev)
    check_contig("page_table", page_table, (B, W), torch.int32, dev)
    if ring_r0 is not None:
        check_contig("ring_r0", ring_r0, (B,), torch.int32, dev)
    row_bytes = Dk * kv_pages.element_size()
    vec16 = int(row_bytes % 16 == 0 and kv_pages.data_ptr() % 16 == 0
                and ring.data_ptr() % 16 == 0)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mli_ring_flush(
            kv_pages.data_ptr(), ring.data_ptr(), ring_start.data_ptr(),
            ring_r0.data_ptr() if ring_r0 is not None else None,
            lengths.data_ptr(), page_table.data_ptr(),
            B, R, W, P, NP, row_bytes, n_rounds, vec16, stream,
        )
    _build.check(lib, rc, "ring_flush kernel")
    _build.count_launch(ring_flush)
    return kv_pages
