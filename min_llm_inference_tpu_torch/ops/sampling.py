"""One decode round's sampled tokens: the wrapper of the hand-written
Hopper kernel ``csrc/sample_next_token.cu`` and its plain PyTorch version.

The JAX package samples with XLA, no Pallas kernel: each round of its
burst runs ``key, sub = jax.random.split(key)`` and then
ops/reference.sample_next_token with ``sub``
(min_llm_inference_tpu/runtime/autonomous.py). This wrapper takes the
round's carried key and does both: it returns the tokens, the new lengths
and the key carried to the next round. The kernel splits the key itself,
so a round adds one launch to the burst and no host read.

The wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._build import check_contig
from .random import split
from .reference import sample_next_token as sample_with_key

_SOURCE = "sample_next_token.cu"
# select_out's codes: which select found a row's k-th value
SELECT_NONE, SELECT_CANDIDATES, SELECT_WHOLE_ROW = 0, 1, 2
# the launcher's path under top-k (a check option of _launch): the
# kernel's own choice by width (narrow_max_v()), a warp per row, or a
# block per row
PATH_AUTO, PATH_NARROW, PATH_WIDE = 0, 1, 2


def sample_next_token(logits, lengths, key, *, n_seq: int, eof_token_id: int,
                      temperature: float, top_k: int = 0, bits_out=None,
                      select_out=None):
    """logits: [B, V] float32 (unit inner stride); lengths: [B] i32 (0 =
    dead); key: int64 [2] (ops/random), the key carried into this round.
    Returns (tokens [B] i32, new lengths [B] i32, the next round's key):
    ``key, sub = split(key)``, then ops/reference.sample_next_token with
    ``sub``. Check outputs, CUDA only: ``bits_out``, an int32 [B, V]
    tensor that receives the kernel's raw draws, ``random_bits(sub, [B,
    V])`` as int32; ``select_out``, an int32 [B] tensor that receives the
    select each row took (SELECT_NONE for a dead row or no top-k,
    SELECT_CANDIDATES, SELECT_WHOLE_ROW)."""
    if temperature <= 0:
        raise ValueError("sampling needs temperature > 0")
    B, V = logits.shape
    if logits.dtype != torch.float32 or tuple(lengths.shape) != (B,):
        raise ValueError("need float32 logits [B, V] and lengths [B]")
    if logits.device.type == "cpu":
        if bits_out is not None or select_out is not None:
            raise ValueError("bits_out and select_out are the kernel's "
                             "check outputs")
        return sample_next_token_plain(logits, lengths, key, n_seq=n_seq,
                                       eof_token_id=eof_token_id,
                                       temperature=temperature, top_k=top_k)
    if logits.device.type != "cuda":
        raise ValueError(f"unsupported device {logits.device}")
    return _launch(logits, lengths, key, n_seq, eof_token_id, temperature,
                   top_k, bits_out, select_out)


# kernel launches since the last reset (launches made by the wrapper only)
_build.counted(sample_next_token)


def sample_next_token_plain(logits, lengths, key, *, n_seq: int,
                            eof_token_id: int, temperature: float,
                            top_k: int = 0):
    """The plain version: the JAX round's split, then the reference
    draw."""
    keys = split(key)
    tok, new_lengths = sample_with_key(logits, lengths, n_seq, eof_token_id,
                                       keys[1], temperature, top_k)
    return tok, new_lengths, keys[0]


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library (built on first use) with its C signatures."""
    lib = _build.load(_SOURCE)
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mli_sample_next_token.argtypes = [
        vp, ll, vp, vp, vp, vp, vp, vp, vp, i, i, ctypes.c_float, i, i, i, i,
        vp]
    lib.mli_sample_next_token.restype = ctypes.c_int
    lib.mli_sample_narrow_max_v.argtypes = []
    lib.mli_sample_narrow_max_v.restype = i
    lib.mli_error_string.argtypes = [i]
    lib.mli_error_string.restype = ctypes.c_char_p
    return lib


def narrow_max_v() -> int:
    """The widest row that the kernel samples with a warp per row under
    top-k; wider rows run a block per row (builds the kernel). On an H100
    the warp beats the block at 1024 and 2048 columns under top_k 16
    (chip_smoke.py's [sample-switch] lines; PERF.md)."""
    return _library().mli_sample_narrow_max_v()


def _launch(logits, lengths, key, n_seq, eof_token_id, temperature, top_k,
            bits_out, select_out, path=PATH_AUTO):
    """The kernel's launch on CUDA tensors; ``path`` forces a warp or a
    block per row under top-k, for checks that hold the two alike."""
    dev = logits.device
    B, V = logits.shape
    _build.check_rows("logits", logits, B, V, torch.float32, dev)
    check_contig("lengths", lengths, (B,), torch.int32, dev)
    check_contig("key", key, (2,), torch.int64, dev)
    if bits_out is not None:
        check_contig("bits_out", bits_out, (B, V), torch.int32, dev)
    if select_out is not None:
        check_contig("select_out", select_out, (B,), torch.int32, dev)
    tok = torch.empty(B, dtype=torch.int32, device=dev)
    new_lengths = torch.empty(B, dtype=torch.int32, device=dev)
    next_key = torch.empty(2, dtype=torch.int64, device=dev)
    lib = _library()
    # ctypes rounds the divisor to float32, as the plain version's is
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mli_sample_next_token(
            logits.data_ptr(), logits.stride(0), lengths.data_ptr(),
            key.data_ptr(), tok.data_ptr(), new_lengths.data_ptr(),
            next_key.data_ptr(),
            bits_out.data_ptr() if bits_out is not None else None,
            select_out.data_ptr() if select_out is not None else None,
            B, V, max(temperature, 1e-6), int(top_k), n_seq,
            eof_token_id, path, stream,
        )
    _build.check(lib, rc, "sample_next_token kernel")
    _build.count_launch(sample_next_token)
    return tok, new_lengths, next_key
