"""What every model's plain reference shares: float32 products kept out
of TF32, the rounding of stored activations to the served dtype, the
control's float8 weights and the per-page KV quantization. Each model's
reference is in ``archs/<name>.py``; this file defines no model and
imports nothing of the program under test.

A quantized page's scale is set by the row at the page's first position:
``absmax(row) * 2 / qmax`` (``qmax`` 127 for int8, 7 for int4); every row
of the page is ``clip(round_half_even(x / scale), -qmax, qmax)``, read
back as ``q * scale``.
"""

from __future__ import annotations

import numpy as np
import torch

QMAX = {"int8": 127.0, "int4": 7.0}
PAGE_HEADROOM = 2.0
FP8_MAX = 448.0


def no_tf32() -> None:
    """Keep float32 matrix products in float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_to(dtype: str):
    """The rounding applied to every stored activation: to ``dtype`` and
    back to float32 (``float32``: none)."""
    if dtype == "float32":
        return lambda x: x
    td = getattr(torch, dtype)
    return lambda x: x.to(td).to(torch.float32)


def fp8_weights(w: torch.Tensor) -> torch.Tensor:
    """A weight matrix [D_in, D_out] as float8 e4m3 with one float32 scale
    per output column (absmax / 448), read back in float32: the control's
    precision, one step below bfloat16."""
    wf = w.float()
    scale = wf.abs().amax(dim=0) / FP8_MAX
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = (wf / safe[None, :]).to(torch.float8_e4m3fn)
    return q.float() * scale[None, :]


def quantize_pages(x, page_size: int, qmax: float):
    """Rows x [T, D] of one request's cache, position t in page t // P:
    each page's scale from its first row, every row quantized against its
    page's scale and read back. Returns the dequantized rows."""
    T, D = x.shape
    starts = torch.arange(0, T, page_size, device=x.device)
    cand = x[starts].abs().amax(dim=-1) * float(
        np.float32(PAGE_HEADROOM / qmax))
    scale = cand.repeat_interleave(page_size)[:T]
    inv = torch.where(scale > 0, 1.0 / torch.where(scale > 0, scale, 1.0),
                      0.0)
    q = torch.clamp(torch.round(x * inv[:, None]), -qmax, qmax)
    return q * scale[:, None]
