"""Absorbed multi-head latent attention over a paged latent pool (one
decode round): the wrapper of the hand-written Hopper kernel
``csrc/mla_decode.cu`` and its plain version.

No Pallas counterpart: the JAX package has no latent attention. The
wrapper launches the kernel for CUDA tensors and runs the plain version,
which gathers each slot's pages and attends in float32, for CPU tensors;
it never falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_SOURCE = "mla_decode.cu"
# the shapes the kernel is built for: 16 heads over a 512 + 64 row
HEADS, LATENT, ROPE = 16, 512, 64
_TILE = 32
# resident blocks a card keeps busy (132 SMs x 2); splits aim at ~4 waves
_RESIDENT = 264


def plain_mla_decode(q, pool, lengths, page_table, scale: float,
                     latent: int):
    """q [B, H, L + R]; pool [NP, P, L + R]; lengths [B] (0 = dead);
    page_table [B, W]. Returns [B, H, L] in q's dtype: each head's softmax
    over positions < length of scale * q . row, times the rows' first L
    features, in float32; dead slots' rows are zeros."""
    NP, P, Dl = pool.shape
    B, W = page_table.shape
    rows = pool[page_table.clamp(0, NP - 1).long()].reshape(B, W * P, Dl)
    s = torch.einsum("bhd,btd->bht", q.float(), rows.float()) * scale
    valid = (torch.arange(W * P, device=q.device)[None, :]
             < lengths[:, None])
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    live = lengths > 0
    p = torch.softmax(torch.where(live[:, None, None], s, 0.0), dim=-1)
    o = torch.einsum("bht,btd->bhd", p, rows[..., :latent].float())
    return torch.where(live[:, None, None], o, 0.0).to(q.dtype)


def kernel_takes(q, pool) -> bool:
    """CUDA bfloat16 queries of 16 heads over a 576-wide bfloat16 pool."""
    return (q.device.type == "cuda" and q.dtype == torch.bfloat16
            and pool.dtype == torch.bfloat16
            and tuple(q.shape[1:]) == (HEADS, LATENT + ROPE)
            and pool.shape[-1] == LATENT + ROPE)


def splits(B: int, W: int, P: int) -> tuple:
    """(splits a slot, tokens a split): whole pages a split, enough blocks
    for ~4 waves of the card's resident blocks."""
    n = max(1, min(W, -(-4 * _RESIDENT // B)))
    pages = -(-W // n)
    tokens = -(-pages * P // _TILE) * _TILE
    return -(-W * P // tokens), tokens


def mla_decode_attention(q, pool, lengths, page_table, scale: float,
                         latent: int = LATENT):
    """q: [B, 16, 576] (each head's q_nope . W_UK, then its roped q_pe);
    pool: [NP, P, 576], one latent row a token (c_kv, then k_pe);
    lengths: [B] int32 (0 = dead); page_table: [B, W] int32. Returns
    o_lat [B, 16, 512]: per head, softmax(scale * q . row) over positions
    < length times c_kv (the row's first ``latent`` features). CPU
    tensors take the plain version (any head count and widths); CUDA
    tensors take the kernel or raise."""
    if q.device.type == "cpu":
        return plain_mla_decode(q, pool, lengths, page_table, scale, latent)
    if latent != LATENT or not kernel_takes(q, pool):
        raise ValueError(f"the kernel takes bfloat16 q [B, {HEADS}, "
                         f"{LATENT + ROPE}] over a bfloat16 pool of the same "
                         f"width, got {q.dtype} {tuple(q.shape)} and "
                         f"{pool.dtype} {tuple(pool.shape)}")
    dev = q.device
    B = q.shape[0]
    NP, P, _ = pool.shape
    W = page_table.shape[1]
    if P & (P - 1):
        raise ValueError(f"the page size {P} must be a power of two")
    _build.check_contig("q", q, (B, HEADS, LATENT + ROPE), torch.bfloat16, dev)
    _build.check_contig("pool", pool, pool.shape, torch.bfloat16, dev)
    _build.check_rows("page_table", page_table, B, W, torch.int32, dev)
    _build.check_contig("lengths", lengths, (B,), torch.int32, dev)
    nsplit, split_tokens = splits(B, W, P)
    o_part = torch.empty((B, nsplit, HEADS, LATENT), dtype=torch.float32,
                         device=dev)
    ml = torch.empty((B, nsplit, HEADS, 2), dtype=torch.float32, device=dev)
    out = torch.empty((B, HEADS, LATENT), dtype=torch.bfloat16, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mli_mla_decode(
            q.data_ptr(), pool.data_ptr(), page_table.data_ptr(),
            page_table.stride(0), lengths.data_ptr(), o_part.data_ptr(),
            ml.data_ptr(), out.data_ptr(), B, W, P.bit_length() - 1, NP,
            nsplit, split_tokens, float(scale), stream)
    _build.check(lib, rc, "mla_decode_attention kernel")
    _build.count_launch(mla_decode_attention)
    return out


# CUDA calls since the last reset (a kernel pair a call)
_build.counted(mla_decode_attention)


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library (built on first use) with its C signature."""
    lib = _build.load(_SOURCE)
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.mli_mla_decode.argtypes = [vp, vp, vp, ll, vp, vp, vp, vp, i, i, i, i,
                                   i, i, ctypes.c_float, vp]
    lib.mli_mla_decode.restype = ctypes.c_int
    lib.mli_error_string.argtypes = [i]
    lib.mli_error_string.restype = ctypes.c_char_p
    return lib
