"""Fused int8 prefill quantize + page scatter, in place: the wrapper of the
hand-written Hopper kernel ``csrc/prefill_scatter.cu`` and its plain
PyTorch version.

Counterpart of min_llm_inference_tpu/ops/prefill_scatter.py
(``prefill_quant_scatter``, the Pallas TPU kernel). Unlike the JAX
function, which returns a new pool, this writes ``pool`` in place and
returns it. Page scales must already be updated (ops/quant
.update_page_scales); the kernel takes their inverses.

The wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._build import check_contig
from .indexing import index_set_drop_
from .quant import quantize_against

_SOURCE = "prefill_scatter.cu"
_IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def prefill_quant_scatter(pool, k, v, pid, inv_k, inv_v):
    """pool: [NP, 2, P, D] int8 (written in place and returned); k, v:
    [M, W_pre * P, D] float blocks (unit inner stride); pid: [M, W_pre] i32
    page ids, NP = skip; inv_k/inv_v: [M, W_pre] f32 inverse page scales.
    Each covered page gets clip(round(x * inv), +-127) of its P rows."""
    NP, two, P, D = pool.shape
    M, S_pre, Dk = k.shape
    if two != 2 or Dk != D or pool.dtype != torch.int8 or S_pre % P:
        raise ValueError("need an int8 pool [NP, 2, P, D] and [M, W_pre*P, "
                         "D] blocks")
    if tuple(v.shape) != tuple(k.shape) or tuple(pid.shape) != (M, S_pre // P):
        raise ValueError("k, v, pid shapes do not match")
    if pool.device.type == "cpu":
        return prefill_quant_scatter_plain(pool, k, v, pid, inv_k, inv_v)
    if pool.device.type != "cuda":
        raise ValueError(f"unsupported device {pool.device}")
    return _launch(pool, k, v, pid, inv_k, inv_v)


# kernel launches since the last reset (launches made by the wrapper only)
_build.counted(prefill_quant_scatter)


def prefill_quant_scatter_plain(pool, k, v, pid, inv_k, inv_v):
    """The plain version: per-page quantize, then one [P, D]-window scatter
    per covered page and side (pid == NP dropped)."""
    NP, _, P, D = pool.shape
    M, W_pre = pid.shape

    def quant(x, inv):
        return quantize_against(x.reshape(M, W_pre, P, D),
                                inv[:, :, None, None], 127.0)

    ok = (pid >= 0) & (pid < NP)
    # window index into the [NP * 2, P, D] view: page p side s -> 2p + s
    k_win = torch.where(ok, pid * 2, 2 * NP).reshape(-1)
    v_win = torch.where(ok, pid * 2 + 1, 2 * NP).reshape(-1)
    index_set_drop_(pool.view(NP * 2, P, D), torch.cat([k_win, v_win]),
                    torch.cat([quant(k, inv_k).reshape(-1, P, D),
                               quant(v, inv_v).reshape(-1, P, D)]))
    return pool


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library (built on first use) with its C signatures."""
    lib = _build.load(_SOURCE)
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.mli_prefill_quant_scatter.argtypes = [
        vp, vp, vp, ll, ll, ll, ll, vp, vp, vp, i, i, i, i, i, i, i, vp,
    ]
    lib.mli_prefill_quant_scatter.restype = ctypes.c_int
    lib.mli_error_string.argtypes = [i]
    lib.mli_error_string.restype = ctypes.c_char_p
    return lib


def _launch(pool, k, v, pid, inv_k, inv_v):
    dev = pool.device
    NP, _, P, D = pool.shape
    M, S_pre, _ = k.shape
    W_pre = S_pre // P
    if k.dtype not in _IN_DTYPES or v.dtype != k.dtype:
        raise ValueError(f"k/v dtype {k.dtype} not supported by the kernel")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev or t.stride(2) != 1:
            raise ValueError(f"{name} must be on {dev} with unit inner stride")
    check_contig("pool", pool, (NP, 2, P, D), torch.int8, dev)
    check_contig("pid", pid, (M, W_pre), torch.int32, dev)
    check_contig("inv_k", inv_k, (M, W_pre), torch.float32, dev)
    check_contig("inv_v", inv_v, (M, W_pre), torch.float32, dev)
    # 16-byte loads: D and the row strides a multiple of the vector, bases
    # 16-byte aligned (the 8- or 4-byte int8 stores then align too)
    n = 16 // k.element_size()
    vec16 = (D % n == 0 and pool.data_ptr() % 16 == 0
             and all(t.data_ptr() % 16 == 0 and t.stride(0) % n == 0
                     and t.stride(1) % n == 0 for t in (k, v)))
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mli_prefill_quant_scatter(
            pool.data_ptr(), k.data_ptr(), v.data_ptr(), k.stride(0),
            k.stride(1), v.stride(0), v.stride(1), pid.data_ptr(),
            inv_k.data_ptr(), inv_v.data_ptr(), M, W_pre, P, D, NP,
            _IN_DTYPES[k.dtype], 0 if vec16 else 1, stream,
        )
    _build.check(lib, rc, "prefill_quant_scatter kernel")
    _build.count_launch(prefill_quant_scatter)
    return pool
