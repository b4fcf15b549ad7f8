"""The part of ``jax.random`` the package uses, bit for bit, in plain
PyTorch: threefry2x32 keys, ``split``, ``random_bits``, ``uniform`` and
``gumbel``, under JAX's default ``jax_threefry_partitionable=True`` and
with 64-bit mode off (the JAX package's settings).

A key is JAX's raw ``uint32[2]``, held as an int64 tensor of two values in
[0, 2**32). Element ``i`` (row-major) of ``random_bits(key, shape)`` is
``x0 ^ x1`` of ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``, and
``split(key, n)`` is the pair (x0, x1) at counters 0..n-1
(jax/_src/prng.py: ``_threefry_random_bits_partitionable``,
``_threefry_split_foldlike``). Uint32 wrap-around is int64 arithmetic
masked to 32 bits. Everything here is tensor code that runs on any device;
``csrc/sample_next_token.cu`` repeats ``threefry2x32`` and ``gumbel`` in
registers.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: (0, seed mod
    2**32) as an int64 [2] tensor, filled on its device (a fill takes its
    value as a kernel argument; an item assignment would copy from the
    host and sync on CUDA)."""
    key = torch.zeros(2, dtype=torch.int64, device=device)
    key[1:].fill_(int(seed) & MASK32)
    return key


def _rotl_(x, d: int):
    """In place: x (int64 holding uint32) rotated left by d bits."""
    hi = x >> (32 - d)
    return x.bitwise_left_shift_(d).bitwise_and_(MASK32).bitwise_or_(hi)


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under ``key``. key: int64 [2]; x0, x1: int64 tensors of one shape
    holding uint32 values. Returns the pair of hashed words, int64."""
    k0, k1 = key[0], key[1]
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]).bitwise_and_(MASK32)
    x1 = (x1 + ks[1]).bitwise_and_(MASK32)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK32)
            _rotl_(x1, r).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK32)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(MASK32)
    return x0, x1


def _counters(n: int, device):
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & MASK32


def split(key, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: int64 [n, 2] keys."""
    b0, b1 = threefry2x32(key, *_counters(n, key.device))
    return torch.stack([b0, b1], dim=1)


def random_bits(key, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32), as int64."""
    b0, b1 = threefry2x32(key, *_counters(math.prod(shape), key.device))
    return b0.bitwise_xor_(b1).reshape(shape)


def _unit_float(bits) -> torch.Tensor:
    """Float32 in [0, 1) from 32 random bits (held as int64): the top 23
    bits as the mantissa of a float in [1, 2), minus one."""
    mant = (bits >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform(key, shape, float32, minval, maxval)``:
    ``max(minval, fma(f, maxval - minval, minval))`` in float32. XLA fuses
    the multiply and the add (one rounding). Here the product of f (23
    significant bits) and the float32 width is exact in float64, and so is
    the sum when the product and minval lie within a few binades of each
    other, as for (-1, 1) and (tiny, 1): one rounding to float32 then gives
    the fused result."""
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    f = _unit_float(random_bits(key, shape))
    fused = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, fused)


def gumbel(key, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (mode "low"):
    ``-log(-log(u))`` with u uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))
