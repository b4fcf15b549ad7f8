"""Causal prefill attention over a prompt block: the wrapper of the
hand-written Hopper kernel ``csrc/prefill_attention.cu``, and the
predicate that picks it.

No Pallas counterpart: the JAX package's prefill attention is XLA
(min_llm_inference_tpu/models/model.py ``causal_masked_attention``). The
plain version is the port's ``models/model.causal_masked_attention``,
which materialises float32 scores of [M, H, S, S]; the kernel keeps them on
chip and computes only the key tiles that some valid (row, key) pair
needs. Rows at or past a prompt's length come out as zeros (the plain
version leaves them garbage; callers mask their use).

``prefill_write_kv`` chooses between the two by ``kernel_takes``. The
wrapper launches the kernel or raises; it never falls back. Latent
attention's prefill (models/deepseek_v2.py) gives it q . k 192 wide and v
128 (its plain version there is ``causal_attention``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .reference import inv_sqrt

_SOURCE = "prefill_attention.cu"
_OUT_DTYPES = {torch.float32: 1, torch.bfloat16: 0}
# head dims the kernel is built for: 16, 32, ..., 128 with the v width
# equal, and latent attention's q . k width of 192 with v 128
HEAD_DIMS = tuple(range(16, 129, 16))
WIDTHS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)


def kernel_takes(device: torch.device, dtype: torch.dtype, head_dim: int,
                 v_dim: int | None = None) -> bool:
    """Whether ``prefill_write_kv`` gives a block's attention to the kernel:
    CUDA tensors in bfloat16 with a head dim of 16, 32, ..., 128 (and v of
    the same width), or a q . k width of 192 with a v width of 128. Other
    inputs (float32 models, the CPU, other head dims) keep
    ``causal_masked_attention``."""
    dv = head_dim if v_dim is None else v_dim
    return (device.type == "cuda" and dtype == torch.bfloat16
            and (head_dim, dv) in WIDTHS)


def prefill_causal_attention(q, k, v, lengths, n_heads: int, out=None,
                             scale: float | None = None):
    """q, k: [M, S, H dk], v: [M, S, H dv] (unit inner stride; k and v may
    be column slices of one fused projection); lengths: [M] int32 at any
    stride (a column of an uploaded block will do). Position i of prompt m
    attends to j <= i, j < lengths[m], scores scaled by ``scale`` (default
    1/sqrt(dk)). Returns [M, S, H dv] in q's dtype, or writes ``out``
    (float32 or bfloat16 [M, S, H dv]) and returns it. Rows at or past a
    prompt's length are zeros. Raises for inputs that ``kernel_takes``
    refuses."""
    M, S, D = q.shape
    Dv = v.shape[-1]
    if tuple(k.shape) != (M, S, D) or tuple(v.shape[:2]) != (M, S):
        raise ValueError("q and k must share their [M, S, D] shape, v its "
                         "[M, S]")
    if D % n_heads or Dv % n_heads:
        raise ValueError(f"{D} and {Dv} features do not split into "
                         f"{n_heads} heads")
    dev = q.device
    dh, dv = D // n_heads, Dv // n_heads
    if not kernel_takes(dev, q.dtype, dh, dv):
        raise ValueError(f"the kernel takes bfloat16 with head widths in "
                         f"{WIDTHS}, got {q.dtype} and {(dh, dv)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_rows(name, t, (torch.bfloat16,), dev)
    if (lengths.device != dev or lengths.dtype != torch.int32
            or tuple(lengths.shape) != (M,)):
        raise ValueError(f"lengths must be int32 ({M},) on {dev}, got "
                         f"{lengths.dtype} {tuple(lengths.shape)} on "
                         f"{lengths.device}")
    if out is None:
        out = torch.empty((M, S, Dv), dtype=q.dtype, device=dev)
    elif tuple(out.shape) != (M, S, Dv):
        raise ValueError(f"out must be [{M}, {S}, {Dv}]")
    _check_rows("out", out, tuple(_OUT_DTYPES), dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mli_prefill_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), out.stride(0), out.stride(1), lengths.data_ptr(),
            lengths.stride(0), M, S, n_heads, dh, dv,
            inv_sqrt(dh) if scale is None else float(scale),
            _OUT_DTYPES[out.dtype], stream,
        )
    _build.check(lib, rc, "prefill_causal_attention kernel")
    _build.count_launch(prefill_causal_attention)
    return out


# kernel launches since the last reset (launches made by the wrapper only)
_build.counted(prefill_causal_attention)


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library (built on first use) with its C signatures."""
    lib = _build.load(_SOURCE)
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.mli_prefill_attention.argtypes = [
        vp, vp, vp, vp, ll, ll, ll, ll, ll, ll, ll, ll, vp, ll, i, i, i, i, i,
        ctypes.c_float, i, vp,
    ]
    lib.mli_prefill_attention.restype = ctypes.c_int
    lib.mli_error_string.argtypes = [i]
    lib.mli_error_string.restype = ctypes.c_char_p
    return lib


def _check_rows(name, t, dtypes, dev) -> None:
    """Raise unless t is a 3-d ``dtypes`` tensor on ``dev`` with unit inner
    stride, a 16-byte aligned base and row strides of whole 16-byte
    chunks (the kernel's cp.async and vector stores)."""
    if t.device != dev or t.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {dtypes} on {dev}, got "
                         f"{t.dtype} on {t.device}")
    n = 16 // t.element_size()
    if (t.stride(2) != 1 or t.data_ptr() % 16 or t.stride(0) % n
            or t.stride(1) % n):
        raise ValueError(f"{name} needs unit inner stride, a 16-byte "
                         "aligned base and row strides of 16-byte multiples")
