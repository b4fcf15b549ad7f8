"""The yardstick's shared arithmetic: one H100's published peaks and the
least time of a stretch of work (``bound_s``, a copy of ``chip_smoke.py``'s
``bound_of``). What a model's kernels and steps need, in bytes and
operations, is its architecture module's (``archs/<name>.py``:
``attention_bound_s``, ``model_flops``).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least seconds for ``nbytes`` of HBM traffic and ``flops``
    float32 operations."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)
